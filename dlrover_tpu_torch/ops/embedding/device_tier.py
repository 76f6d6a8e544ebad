"""Device-resident hot tier: embedding rows pinned in the card's memory,
moved by hand-written CUDA gather/scatter kernels, over any host-side
KvEmbedding store (counterpart of
``dlrover_tpu/ops/embedding/device_tier.py``).

Zipfian access means a small hot set absorbs almost all traffic: this
module keeps that hot set on the device and serves it with the
``emb_gather`` / ``emb_scatter`` kernels (``ops/embedding_rows.py``),
leaving the host store (``ShardedKvEmbedding``) as the warm tier::

    device hot tier (this module)  --spill/fault-->  host C++ store

Design (the JAX module's, carried over):

- The tier is ONE device table ``[capacity + 1, row_floats]`` (values +
  optimizer slots: update state travels with the row, the C++ store's
  fused layout); ``capacity`` comes from a device byte budget. The
  extra row is a scratch row that pads slot lists to power-of-two
  buckets.
- Gather/scatter run over **sorted unique ids**: the id→slot map lives
  host-side (numpy on deduped ids); the kernels move whole rows. A
  table on a card always takes the kernels, a table on the CPU their
  plain versions; nothing falls back from one to the other.
- Missing rows FAULT IN from the host store (full rows incl. slots via
  ``export_rows``: a state read, no freq/ts bump), staged through
  pinned memory and copied without blocking. LRU victims spill back
  with an async D2H: their rows are gathered into a separate tensor on
  the table's stream BEFORE the fault-in scatter reuses their slots,
  copied into pinned memory behind a recorded CUDA event, and handed
  to a drain thread that waits on the event before it reads.
- The sparse optimizer (adagrad / momentum / adam over the gathered
  rows) runs on the device as plain PyTorch ops, duplicate ids summed
  deterministically; the scatter then writes the new rows back into
  the table in place (no table-sized copy per step).

Coherency contract: while a row is device-resident its device copy is
authoritative and the host copy is stale; ``flush()`` (checkpoint
cadence) and spills write it back. The card also keeps each resident
row's freq and ts (the host store's lookup count and last lookup
second): taken from the host at the fault-in, counted and stamped by
every ``prepare``, carried back by the write-backs. A host tier's
``evict_cold(ts_limit)`` then sees when the card last touched a row (the
JAX package writes 0 for both, so every row the card writes back goes
to disk at the next ``evict_cold``). A row only read on the card is
never written back, and its lookups leave no trace host-side. ``export_state`` flushes first so a
checkpoint can never lose device-only training.

Host-link arbitration (``parallel/transfer_sched``): the fault-in leg
is the ``emb_fault:<table>`` stream (host-to-card, BACKPRESSURE: a
consumer waits on it), the spill leg ``emb_spill:<table>``
(card-to-host, BACKGROUND, BACKPRESSURE while two or more spills are
queued). Grants wrap whole transfers and order them, never change a
row. The lock order is always link, then the tier's locks: the fault
grant is taken outside the tier's lock (after joining a racing spill),
the drain thread holds no lock when it asks, and the synchronous spill
(``async_spill=False``) runs under the tier's lock and never waits on
the link. A spill of at least ``spill_stripe_min_bytes`` leaves its
card-to-host copy to the drain thread, which stripes it by row ranges
across the local card-to-host rails when two or more admit it (one
host has one: ``transfer_sched.local_rails``). Both legs are priced
through the ``LinkModel`` host leg (``emb_host_leg_ms``), and
``export_metrics`` refreshes the streams' standing demand.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ops import embedding_rows
from dlrover_tpu_torch.ops.embedding import store as _store
from dlrover_tpu_torch.parallel import transfer_sched
from dlrover_tpu_torch.utils.device import resolve_device

_DEF_HBM_BUDGET = 64 << 20  # 64 MiB of rows unless the caller budgets


def _bucket(n: int, floor: int = 64) -> int:
    """Next power of two ≥ n (≥ floor): the slot-list lengths, so the
    kernels see a handful of shapes across variable unique-id counts."""
    b = floor
    while b < n:
        b <<= 1
    return b


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a card the bytes are
    staged in pinned memory and copied without blocking on the current
    stream: the numpy source may go as soon as this returns, and
    PyTorch's pinned allocator holds the staging buffer until the copy
    has run (it records the copy's stream). A copy from pageable memory
    would serialize with the host instead."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _d2h_async(t: torch.Tensor) -> Tuple[torch.Tensor, Optional[Any]]:
    """Start a copy of ``t`` into pinned host memory; returns the host
    tensor and the CUDA event to wait on before reading it (None on the
    CPU, where ``t`` is already host memory)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- kernels -----------------------------------------------------------------


class _Kernels:
    """Gather/scatter over a ``[capacity + 1, row_floats]`` table: the
    CUDA kernels for a table on a card, their plain versions for a
    table on the CPU. A kernel that fails to build or launch raises;
    there is no fallback and no mode to choose."""

    def __init__(self, mode: Optional[str] = None):
        if mode not in (None, "auto"):
            raise ValueError(
                f"kernel_mode {mode!r}: the port has one mode (the table's "
                "device picks the kernels or their plain versions)"
            )

    @staticmethod
    def _slots(table: torch.Tensor, slots) -> torch.Tensor:
        if isinstance(slots, torch.Tensor):
            return slots
        return _h2d(np.asarray(slots, np.int32), table.device)

    def gather(self, table: torch.Tensor, slots) -> torch.Tensor:
        """rows[i] = table[slots[i]]: slots are sorted unique device
        slot ids, padded with the scratch slot."""
        return embedding_rows.emb_gather(table, self._slots(table, slots))

    def scatter(self, table: torch.Tensor, slots, rows: torch.Tensor) -> torch.Tensor:
        """table[slots[i]] = rows[i], in place; returns the table. Real
        slots are unique; padding entries all name the scratch row and
        carry identical values."""
        return embedding_rows.emb_scatter_(table, self._slots(table, slots), rows)


# -- stats -------------------------------------------------------------------


@dataclass
class EmbeddingTierStats:
    """Per-table hot-tier telemetry; the trainer forwards the scalars
    to the master through its train-metrics report."""

    gathers: int = 0
    unique_ids: int = 0
    hits: int = 0  # unique ids already device-resident
    faults: int = 0  # unique ids faulted in from the host tier
    fault_batches: int = 0  # prepares that scattered faulted rows in
    fault_bytes: int = 0  # H2D row traffic
    spill_rows: int = 0
    spill_bytes: int = 0  # D2H row traffic
    scatter_lag_s: float = 0.0  # enqueue→host-import latency (sum)
    scatter_drains: int = 0
    host_leg_s: float = 0.0  # LinkModel-priced host-link seconds

    @property
    def hit_pct(self) -> float:
        total = self.hits + self.faults
        return 100.0 * self.hits / total if total else 0.0

    @property
    def scatter_lag_ms(self) -> float:
        if not self.scatter_drains:
            return 0.0
        return 1e3 * self.scatter_lag_s / self.scatter_drains

    def as_dict(self) -> Dict[str, float]:
        return {
            "emb_gather_hit_pct": round(self.hit_pct, 3),
            "emb_faults": float(self.faults),
            "emb_fault_bytes": float(self.fault_bytes),
            "emb_spill_rows": float(self.spill_rows),
            "emb_spill_bytes": float(self.spill_bytes),
            "emb_scatter_lag_ms": round(self.scatter_lag_ms, 3),
            "emb_host_leg_ms": round(1e3 * self.host_leg_s, 3),
        }


# -- hot tier ----------------------------------------------------------------


class DeviceHotTier:
    """The device row cache: device table + host-side id→slot map + LRU.

    Not thread-safe by itself: :class:`DeviceSparseEmbedding` owns the
    lock that serializes table mutations (the pipeline's fault-in
    thread vs the train thread's grad scatter)."""

    def __init__(
        self,
        dim: int,
        num_slots: int = 1,
        hbm_budget_bytes: int = _DEF_HBM_BUDGET,
        capacity: Optional[int] = None,
        kernels: Optional[_Kernels] = None,
        devices=None,
    ):
        self.dim = dim
        self.num_slots = num_slots
        self.row_floats = dim * (1 + num_slots)
        row_bytes = self.row_floats * 4
        self.capacity = int(
            capacity
            if capacity is not None
            else max(64, hbm_budget_bytes // row_bytes)
        )
        self.hbm_bytes = self.capacity * row_bytes
        self.device = resolve_device(devices)
        # one extra SCRATCH row at index ``capacity``: batches pad
        # their unique-id slot lists up to a power-of-two bucket with
        # it. Padding entries carry zero gradients, so the scratch
        # row's update is the identity and concurrent identical writes
        # to it are benign.
        self.scratch_slot = self.capacity
        self.table = torch.zeros(
            (self.capacity + 1, self.row_floats), dtype=torch.float32,
            device=self.device,
        )
        self._kernels = kernels or _Kernels()
        self._slot_of: Dict[int, int] = {}
        # bookkeeping arrays include the scratch slot so padded slot
        # lists can index them; the scratch entry never binds an id, so
        # occupancy/dirty scans (keyed on _id_of >= 0) exclude it
        self._id_of = np.full(self.capacity + 1, -1, np.int64)
        self._dirty = np.zeros(self.capacity + 1, bool)
        self._last_used = np.zeros(self.capacity + 1, np.int64)
        # each resident row's freq / ts (the module's coherency contract)
        self._freq = np.zeros(self.capacity + 1, np.int64)
        self._ts = np.zeros(self.capacity + 1, np.int64)
        # pin refcounts: slots referenced by an outstanding
        # PreparedBatch must not be LRU victims — the pipeline thread's
        # fault-in for step N+1 would otherwise evict rows step N is
        # about to update, silently reusing the slot for another id
        self._pins = np.zeros(self.capacity + 1, np.int32)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._tick = 0

    def __len__(self) -> int:
        return len(self._slot_of)

    @property
    def kernel_mode(self) -> str:
        """``"cuda"`` (the kernels) for a table on a card, ``"plain"``
        for a table on the CPU."""
        return "cuda" if self.table.device.type == "cuda" else "plain"

    def lookup(self, unique_ids: np.ndarray) -> np.ndarray:
        """slots for ``unique_ids`` (-1 = not resident). Read-only."""
        slots = np.empty(len(unique_ids), np.int64)
        get = self._slot_of.get
        for i, k in enumerate(unique_ids):
            slots[i] = get(int(k), -1)
        return slots

    def touch(self, slots: np.ndarray):
        self._tick += 1
        self._last_used[slots] = self._tick

    def access(self, slots: np.ndarray, counts: np.ndarray):
        """``counts`` lookups of each of ``slots``, stamped with the host
        store's clock, as the host store's gather counts and stamps."""
        self._freq[slots] += counts
        self._ts[slots] = _store._now()

    def pin(self, slots: np.ndarray):
        self._pins[slots] += 1

    def unpin(self, slots: np.ndarray):
        self._pins[slots] = np.maximum(self._pins[slots] - 1, 0)

    def recency_snapshot(self) -> Dict[str, Any]:
        """Copy of the residency/LRU/pin bookkeeping. A read-only probe
        (``gather(insert_missing=False)``) must leave two snapshots
        bit-identical: no admissions, no recency touches, no pin drift,
        so serving traffic can never evict or age what training needs
        resident."""
        return {
            "tick": self._tick,
            "resident": dict(self._slot_of),
            "last_used": self._last_used.copy(),
            "pins": self._pins.copy(),
        }

    def _allocate(
        self, n: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """n free slots, evicting coldest UNPINNED residents if needed.
        Returns (slots, victim_slots, victim_ids) — victim ids are
        captured BEFORE the unbind, and the victims' rows must be read
        out by the caller before anything scatters over them."""
        n_free = len(self._free)
        victims = np.empty(0, np.int64)
        victim_ids = np.empty(0, np.int64)
        if n > n_free:
            need = n - n_free
            occupied = np.nonzero(
                (self._id_of >= 0) & (self._pins == 0)
            )[0]
            order = np.argsort(self._last_used[occupied], kind="stable")
            victims = occupied[order[:need]]
            if len(victims) < need:
                raise ValueError(
                    f"hot tier capacity {self.capacity} cannot hold "
                    f"{n} new rows ({int((self._pins > 0).sum())} "
                    f"pinned by in-flight steps) — raise the HBM "
                    f"budget or lower the pipeline depth"
                )
            victim_ids = self._id_of[victims].copy()
            for s in victims:
                del self._slot_of[int(self._id_of[s])]
                self._id_of[s] = -1
                self._free.append(int(s))
        slots = np.array(
            [self._free.pop() for _ in range(n)], np.int64
        )
        return slots, victims, victim_ids

    def _padded(self, slots: np.ndarray) -> np.ndarray:
        p = np.full(_bucket(len(slots)), self.scratch_slot, np.int32)
        p[: len(slots)] = slots
        return p

    def gather_rows(self, slots: np.ndarray, slots_t: Optional[torch.Tensor] = None):
        """Full rows (values + slots) at device ``slots``. Exact
        power-of-two slot lists (the PreparedBatch path, which passes
        the same slots already on the device as ``slots_t``) return a
        device tensor straight from the kernel; ragged lists (spill /
        flush / probe) are padded to a bucket against the scratch slot
        and returned as host numpy rows."""
        n = len(slots)
        if _bucket(n) != n:
            rows = self._kernels.gather(self.table, self._padded(slots))
            return _to_numpy(rows)[:n]
        return self._kernels.gather(
            self.table, slots_t if slots_t is not None else np.asarray(slots, np.int32)
        )

    def scatter_rows(self, slots: np.ndarray, rows, dirty: bool = True,
                     slots_t: Optional[torch.Tensor] = None):
        """Overwrite rows at unique device ``slots`` in place (padding
        writes land on the scratch row, whose content is immaterial).
        Ragged host rows are padded HOST-side with zeros, so the device
        only ever sees bucket-length lists; device rows come at bucket
        length (``slots_t`` then names the same slots on the device)."""
        n = len(slots)
        if _bucket(n) != n:
            padded = np.zeros((_bucket(n), self.row_floats), np.float32)
            padded[:n] = _to_numpy(rows).reshape(n, self.row_floats)
            rows, slots_t = padded, None
            s = self._padded(slots)
        else:
            s = np.asarray(slots, np.int32) if slots_t is None else slots_t
        if not isinstance(rows, torch.Tensor):
            rows = _h2d(np.asarray(rows, np.float32).reshape(-1, self.row_floats),
                        self.table.device)
        self._kernels.scatter(self.table, s, rows)
        if dirty:
            self._dirty[slots] = True

    def bind(self, ids: np.ndarray, slots: np.ndarray):
        for k, s in zip(ids, slots):
            self._slot_of[int(k)] = int(s)
            self._id_of[s] = k
        self.touch(slots)

    def dirty_slots(self) -> np.ndarray:
        # padded scatters may mark the scratch slot dirty; only bound
        # slots carry rows that need a write-back
        return np.nonzero(self._dirty & (self._id_of >= 0))[0]

    def clear_dirty(self, slots: np.ndarray):
        self._dirty[slots] = False

    def drop(self, slots: np.ndarray):
        """Unbind slots (rows must already be safe host-side)."""
        for s in slots:
            k = int(self._id_of[s])
            if k >= 0:
                del self._slot_of[k]
            self._id_of[s] = -1
            self._dirty[s] = False
            self._pins[s] = 0
            self._free.append(int(s))


# -- prepared step -----------------------------------------------------------


@dataclass
class PreparedBatch:
    """Everything the train step needs for one batch of ids, built by
    ``prepare`` (possibly on the pipeline thread one step ahead):
    sorted unique ids, their device slots, and the inverse map back to
    the per-occurrence order — the last two also already on the
    device (``slots_t`` int32, ``inverse_t`` int64)."""

    ids: np.ndarray
    unique_ids: np.ndarray
    inverse: np.ndarray
    slots: np.ndarray  # padded to a power-of-two bucket (scratch slot)
    n_unique: int = 0  # real entries in ``slots`` before padding
    generation: int = 0
    released: bool = False  # pins returned (apply_grads or release)
    slots_t: Optional[torch.Tensor] = None
    inverse_t: Optional[torch.Tensor] = None


# -- the tiered facade -------------------------------------------------------


class DeviceSparseEmbedding:
    """Device hot tier over a host KvEmbedding store, with the sparse
    optimizer running on the device.

    The train cycle becomes::

        prep = emb.prepare(ids)          # pipeline thread, step N+1
        rows = emb.gather_for(prep)      # device gather, step N
        ... dense step produces row_grads ...
        emb.apply_grads(prep, row_grads) # on-device update + scatter

    ``sparse_optimizer`` ∈ {adagrad, momentum, adam} — the on-device
    subset of the host store's fused family (rows carry the same
    [value | slot…] layout, so a row can move tiers mid-training and
    keep its optimizer state). The table lives on the card unless
    ``devices="cpu"``.
    """

    SUPPORTED_OPTS = ("adagrad", "momentum", "adam")

    def __init__(
        self,
        host,
        hbm_budget_bytes: int = _DEF_HBM_BUDGET,
        capacity: Optional[int] = None,
        sparse_optimizer: str = "adagrad",
        lr: float = 0.05,
        eps: float = 1e-8,
        momentum: float = 0.9,
        beta1: float = 0.9,
        beta2: float = 0.999,
        table_name: str = "t0",
        kernel_mode: Optional[str] = None,
        async_spill: bool = True,
        spill_stripe_min_bytes: Optional[int] = None,
        devices=None,
    ):
        if sparse_optimizer not in self.SUPPORTED_OPTS:
            raise ValueError(
                f"device tier supports {self.SUPPORTED_OPTS}, got "
                f"{sparse_optimizer!r} (use the host-path SparseTrainer "
                f"cycle for the full fused family)"
            )
        need_slots = {"adagrad": 1, "momentum": 1, "adam": 2}[
            sparse_optimizer
        ]
        if host.num_slots < need_slots:
            raise ValueError(
                f"{sparse_optimizer} needs num_slots >= {need_slots}"
            )
        self.host = host
        self.table_name = table_name
        self.hot = DeviceHotTier(
            host.dim,
            host.num_slots,
            hbm_budget_bytes=hbm_budget_bytes,
            capacity=capacity,
            kernels=_Kernels(kernel_mode),
            devices=devices,
        )
        self.device = self.hot.device
        self._opt = sparse_optimizer
        self._lr = float(lr)
        self._eps = float(eps)
        self._momentum = float(momentum)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self.stats = EmbeddingTierStats()
        # host-link arbitration: see the module's doc
        arbiter = transfer_sched.get_arbiter()
        self._fault_stream = arbiter.register(
            f"emb_fault:{table_name}",
            transfer_sched.Priority.BACKPRESSURE,
            direction="h2d",
        )
        self._spill_stream = arbiter.register(
            f"emb_spill:{table_name}",
            transfer_sched.Priority.BACKGROUND,
            direction="d2h",
        )
        self._spill_stripe_min_bytes = (
            transfer_sched.DEFAULT_STRIPE_MIN_BYTES
            if spill_stripe_min_bytes is None
            else max(int(spill_stripe_min_bytes), 1)
        )
        # one lock serializes every table mutation: the pipeline
        # thread's fault-in scatter vs the train thread's grad scatter.
        # The table is mutable in place, so the lock also orders the
        # launches on the stream: a spill's victim gather is enqueued
        # before the fault-in scatter that reuses its slots.
        self._lock = threading.RLock()
        self._gen = 0
        # async spill drain: victims leave _allocate as pinned host
        # tensors behind a recorded event; this thread waits on the
        # event and imports them so the step never blocks on the D2H
        self._spill_q: "queue.Queue" = queue.Queue()
        self._spill_err: Optional[BaseException] = None
        # spill lifetime tracking (both under self._lock): ids whose
        # dirty rows are queued/in-flight to the host — a fault-in for
        # one of them must wait, or it would read the PRE-spill host
        # value and silently lose the victim's training; and an
        # explicit in-flight count, because Queue.empty() flips False
        # the moment the drain DEQUEUES an item, not when its import
        # lands
        self._pending_spill_ids: set = set()
        self._spills_inflight = 0
        self._async_spill = async_spill
        self._spill_thread: Optional[threading.Thread] = None
        if async_spill:
            self._spill_thread = threading.Thread(
                target=self._drain_spills,
                daemon=True,
                name=f"emb-spill-{table_name}",
            )
            self._spill_thread.start()

    # -- spill drain ---------------------------------------------------
    def _drain_spills(self):
        while True:
            item = self._spill_q.get()
            if item is None:
                return
            try:
                self._import_spill(*item)
            except BaseException as e:  # surfaced on next flush()
                self._spill_err = e
                logger.error(f"embedding spill drain failed: {e!r}")
                with self._lock:
                    self._spills_inflight -= 1
                    self._pending_spill_ids.difference_update(
                        int(k) for k in item[1]
                    )

    def _spill_rails(self) -> List[str]:
        return transfer_sched.local_rails(
            "d2h", transfer_sched.Priority.BACKGROUND, self._spill_stream.arbiter
        )

    def _import_spill(
        self, t_enq: float, ids, rows_t, event, n: int, freq, ts,
        arbitrate: bool = True, striped: bool = False,
    ):
        """Land one spill host-side, with the rows' ``freq`` / ``ts``.
        ``rows_t`` is the pinned host copy
        behind ``event`` (its D2H already issued), or with ``striped``
        the device rows themselves behind the gather's event: their
        card-to-host copy is striped here by row ranges. ``arbitrate``
        is False on the synchronous path, which runs under the tier's
        lock and must not wait on the link (link, then tier locks)."""
        prio = transfer_sched.Priority.BACKGROUND
        # a deep spill queue is about to stall _allocate (the step
        # path), so it outranks background checkpoint staging
        if arbitrate and self._spill_q.qsize() >= 2:
            prio = transfer_sched.Priority.BACKPRESSURE
        # the copy was issued on the table's stream (or the gather, when
        # striped); reading before its event completes returns garbage
        if event is not None:
            event.synchronize()
        if striped:
            rows_host = torch.empty(
                (n,) + tuple(rows_t.shape[1:]), dtype=rows_t.dtype,
                pin_memory=rows_t.device.type == "cuda",
            )
            striper = transfer_sched.StripedTransfer(
                self._spill_stream.arbiter,
                name=self._spill_stream.name,
                direction="d2h",
                priority=transfer_sched.Priority.BACKGROUND,
                rails=self._spill_rails(),
                ignore_window=True,
            )
            rowb = max(1, rows_t[0].numel() * rows_t.element_size())
            step = max(1, striper.chunk_bytes // rowb)
            ranges = [
                ((lo, min(lo + step, n)), (min(lo + step, n) - lo) * rowb)
                for lo in range(0, n, step)
            ]

            def stage(rail, rng):
                rows_host[rng[0]:rng[1]].copy_(rows_t[rng[0]:rng[1]])

            striper.run_items(ranges, stage, priority=prio)
            rows = rows_host.numpy()
            self.host.import_rows(ids, rows, freq, ts)
        else:
            grant = (
                self._spill_stream.transfer(int(n * rows_t[0].numel() * 4), priority=prio)
                if arbitrate
                else nullcontext()
            )
            with grant:
                rows = rows_t.numpy()[:n]  # bucket-padded: the tail is filler
                self.host.import_rows(ids, rows, freq, ts)
        self.stats.spill_rows += len(ids)
        self.stats.spill_bytes += rows.nbytes
        self.stats.scatter_lag_s += time.perf_counter() - t_enq
        self.stats.scatter_drains += 1
        self.stats.host_leg_s += self._price(rows.nbytes, h2d=False)
        with self._lock:
            self._spills_inflight -= 1
            self._pending_spill_ids.difference_update(
                int(k) for k in ids
            )

    @staticmethod
    def _price(nbytes: int, h2d: bool) -> float:
        try:
            from dlrover_tpu_torch.parallel.topology import price_host_transfer

            return price_host_transfer(nbytes, h2d=h2d)
        except Exception:
            return 0.0

    def _spill(
        self,
        victim_slots: np.ndarray,
        victim_ids: Optional[np.ndarray] = None,
    ):
        """Read victims' rows and hand them to the drain (async D2H).
        ``victim_ids`` must be passed when the caller already unbound
        the slots (the ``_allocate`` path clears ``_id_of`` first).
        Callers hold ``self._lock``."""
        if len(victim_slots) == 0:
            return
        ids = (
            victim_ids
            if victim_ids is not None
            else self.hot._id_of[victim_slots].copy()
        )
        # only dirty victims need the write-back; clean ones are
        # byte-identical host-side already
        dirty = self.hot._dirty[victim_slots]
        if dirty.any():
            d_slots = victim_slots[dirty]
            n = len(d_slots)
            # a bucket-padded gather into a tensor of its own, enqueued
            # before the caller's fault-in scatter overwrites the slots
            dev_rows = self.hot._kernels.gather(
                self.hot.table, self.hot._padded(d_slots)
            )
            striped = (
                self._async_spill
                and n * self.hot.row_floats * 4 >= self._spill_stripe_min_bytes
                and len(self._spill_rails()) >= 2
            )
            if striped:
                # the drain stripes the copy: it waits for the gather
                event = None
                if dev_rows.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev_rows.device))
                item = (time.perf_counter(), ids[dirty], dev_rows, event, n)
            else:
                host_rows, event = _d2h_async(dev_rows)
                item = (time.perf_counter(), ids[dirty], host_rows, event, n)
            item += (self.hot._freq[d_slots].copy(), self.hot._ts[d_slots].copy())
            # bookkeeping BEFORE dispatch: _import_spill decrements /
            # clears on completion either way
            self._spills_inflight += 1
            self._pending_spill_ids.update(int(k) for k in ids[dirty])
            if self._async_spill:
                self._spill_q.put(item + (True, striped))
            else:
                self._import_spill(*item, arbitrate=False)
        self.hot.clear_dirty(victim_slots)

    # -- prepare / gather / update -------------------------------------
    def prepare(self, ids) -> PreparedBatch:
        """Dedup ``ids`` (sorted unique) and make every unique id
        device-resident, faulting missing rows in from the host tier.
        Safe to call from the pipeline thread one step ahead of the
        compute that will consume it. Its host legs are marked for
        ``torch.profiler`` (``emb_lookup``, ``emb_host_rows``,
        ``emb_admit``)."""
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        unique, inverse = np.unique(ids, return_inverse=True)
        counts = np.bincount(inverse.ravel(), minlength=len(unique))
        while True:
            with self._lock, record_function("emb_lookup"):
                gen0 = self._gen
                slots = self.hot.lookup(unique)
                missing_mask = slots < 0
                missing = unique[missing_mask]
                self.stats.gathers += 1
                self.stats.unique_ids += len(unique)
                self.stats.hits += int((~missing_mask).sum())
            if not len(missing):
                with self._lock:
                    if self._gen != gen0:
                        continue  # resident set changed under us
                    self.hot.touch(slots)
                    self.hot.access(slots, counts)
                    self.hot.pin(slots)
                    gen = gen0
                break
            # host leg OUTSIDE the lock: the C++ gather/export is the
            # slow part and must overlap the train thread's compute,
            # not serialize against its scatter
            if self._spills_racing(missing):
                # one of these ids was just evicted and its spill has
                # not landed host-side: reading now would fault the
                # PRE-spill value back in and lose the victim's training.
                # Joined BEFORE the link grant: the drain needs the link
                # to land its import
                self.join_spills()
            with self._fault_stream.transfer(
                len(missing) * self.hot.row_floats * 4
            ), record_function("emb_host_rows"):
                rows_np, freq_np, ts_np = self._host_rows(missing)
            with self._lock, record_function("emb_admit"):
                if self._gen != gen0 or self._spills_racing(missing):
                    # an import_state/evict resharded the world while
                    # the rows were in flight, or a concurrent prepare
                    # faulted one of these ids in and evicted it again:
                    # binding these rows would install stale values —
                    # discard and re-read
                    continue
                # re-check residency: a concurrent prepare may have
                # faulted some of these in meanwhile, or evicted one of
                # this batch's hits (then its row was never read: retry)
                slots = self.hot.lookup(unique)
                if (slots[~missing_mask] < 0).any():
                    continue
                still = slots[missing_mask] < 0
                if still.any():
                    new_ids = missing[still]
                    # this batch's resident rows must not be the
                    # allocation's victims: the JAX code lets them be,
                    # and their slots then read -1 (ROADMAP C)
                    hit_slots = slots[slots >= 0]
                    self.hot.pin(hit_slots)
                    try:
                        new_slots, victims, victim_ids = self.hot._allocate(
                            int(still.sum())
                        )
                    finally:
                        self.hot.unpin(hit_slots)
                    self._spill(victims, victim_ids)
                    self.hot.scatter_rows(
                        new_slots, rows_np[still], dirty=False
                    )
                    self.hot.bind(new_ids, new_slots)
                    self.hot._freq[new_slots] = freq_np[still]
                    self.hot._ts[new_slots] = ts_np[still]
                    slots[np.nonzero(missing_mask)[0][still]] = new_slots
                    self.stats.fault_batches += 1
                self.stats.faults += len(missing)
                self.stats.fault_bytes += rows_np.nbytes
                self.stats.host_leg_s += self._price(rows_np.nbytes, h2d=True)
                self.hot.touch(slots)
                self.hot.access(slots, counts)
                self.hot.pin(slots)
                gen = gen0
            break
        padded = self.hot._padded(slots)
        dev = self.hot.table.device
        return PreparedBatch(
            ids=ids,
            unique_ids=unique,
            inverse=inverse.astype(np.int32),
            slots=padded.astype(np.int64),
            n_unique=len(unique),
            generation=gen,
            slots_t=_h2d(padded, dev),
            inverse_t=_h2d(inverse.astype(np.int64), dev),
        )

    def _spills_racing(self, ids: np.ndarray) -> bool:
        """True if any of ``ids`` has an in-flight spill whose import
        has not landed host-side yet (reading it now would return the
        pre-spill value)."""
        with self._lock:
            return bool(
                self._pending_spill_ids.intersection(
                    int(k) for k in ids
                )
            )

    def _host_rows(self, missing: np.ndarray):
        """Full rows, freq and ts for ``missing`` from the host tier;
        keys the host has never seen are created there first
        (deterministic C++ init) so both tiers agree on the row's birth
        value. Callers must have joined any racing spill of these ids
        first."""
        rows, freq, ts, present = self.host.export_rows(missing)
        absent = missing[~present]
        if len(absent):
            self.host.gather(absent, insert_missing=True)
            rows2, _f2, ts2, _present2 = self.host.export_rows(missing)
            rows[~present] = rows2[~present]
            # the creating lookup is this batch's, which the card counts
            freq[~present] = 0
            ts[~present] = ts2[~present]
        return rows, freq, ts

    def _check_gen(self, prep: PreparedBatch):
        if prep.generation != self._gen:
            raise RuntimeError(
                "PreparedBatch is stale: the embedding was flushed/"
                "resharded after prepare() — re-prepare this batch"
            )

    def gather_for(self, prep: PreparedBatch) -> torch.Tensor:
        """Values for every occurrence in ``prep.ids`` as a device
        tensor ``[len(ids), dim]`` (what the dense step consumes)."""
        with self._lock:
            self._check_gen(prep)
            rows = self.hot.gather_rows(prep.slots, prep.slots_t)
        return rows[:, : self.host.dim].index_select(0, prep.inverse_t)

    def gather(self, ids, insert_missing: bool = True) -> torch.Tensor:
        """One-call gather (prepare inline): host-store-compatible
        surface for code that does not pipeline.

        ``insert_missing=False`` is the read-only probe the host
        stores honor, so it must not create keys OR promote rows into
        the device tier: resident rows read from the device, the rest
        read through the host path (which never invents keys), absent
        keys read zeros."""
        if insert_missing:
            prep = self.prepare(ids)
            try:
                return self.gather_for(prep)
            finally:
                self.release(prep)
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        unique, inverse = np.unique(ids, return_inverse=True)
        dim = self.host.dim
        vals = np.zeros((len(unique), dim), np.float32)
        with self._lock:
            slots = self.hot.lookup(unique)
            resident = slots >= 0
            if resident.any():
                rows = _to_numpy(self.hot.gather_rows(slots[resident]))
                vals[resident] = rows[:, :dim]
        missing = unique[~resident]
        if len(missing):
            if self._spills_racing(missing):
                self.join_spills()
            vals[~resident] = self.host.gather(
                missing, insert_missing=False
            )
        return _h2d(vals[inverse], self.hot.table.device)

    def release(self, prep: PreparedBatch):
        """Return the pins a ``prepare`` took. ``apply_grads`` does
        this implicitly; gather-only consumers (eval) call it once the
        step no longer needs the rows resident. Idempotent."""
        with self._lock:
            if prep.released:
                return
            prep.released = True
            if prep.generation == self._gen:
                self.hot.unpin(prep.slots[: prep.n_unique])

    def _update(self, rows: torch.Tensor, grads_occ: torch.Tensor,
                inverse_t: torch.Tensor, step: int) -> torch.Tensor:
        """New padded rows for this optimizer, written into ``rows``
        (the gather's own output). Duplicate occurrences are summed onto
        their unique row by ``index_put_(accumulate=True)``, which is
        deterministic on both devices (serial in occurrence order on the
        CPU, sort-based on CUDA; ``index_add_`` on CUDA adds atomically
        in no fixed order). Padded rows receive zero gradient, so their
        update is the identity."""
        dim = self.host.dim
        lr, eps = self._lr, self._eps
        grads = torch.zeros(
            (rows.shape[0], dim), dtype=torch.float32, device=rows.device
        ).index_put_((inverse_t,), grads_occ, accumulate=True)
        w = rows[:, :dim]
        if self._opt == "adagrad":
            acc = rows[:, dim : 2 * dim] + grads * grads
            w = w - lr * grads / (torch.sqrt(acc) + eps)
            rows[:, dim : 2 * dim] = acc
        elif self._opt == "momentum":
            m = self._momentum * rows[:, dim : 2 * dim] + grads
            w = w - lr * m
            rows[:, dim : 2 * dim] = m
        else:  # adam
            b1, b2 = self._beta1, self._beta2
            m = b1 * rows[:, dim : 2 * dim] + (1.0 - b1) * grads
            v = b2 * rows[:, 2 * dim : 3 * dim] + (1.0 - b2) * grads * grads
            sf = np.float32(step)
            bc1 = float(np.float32(1.0) - np.float32(b1) ** sf)
            bc2 = float(np.float32(1.0) - np.float32(b2) ** sf)
            w = w - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            rows[:, dim : 2 * dim] = m
            rows[:, 2 * dim : 3 * dim] = v
        rows[:, :dim] = w
        return rows

    def apply_grads(self, prep: PreparedBatch, row_grads, step: int = 1):
        """On-device sparse update: sum duplicate occurrences onto the
        unique rows, run the optimizer math, scatter the new rows back
        into the device table. Never touches the host link."""
        dev = self.hot.table.device
        if isinstance(row_grads, torch.Tensor):
            grads = row_grads.detach().to(device=dev, dtype=torch.float32)
        else:
            grads = _h2d(np.asarray(row_grads, np.float32), dev)
        grads = grads.reshape(len(prep.ids), self.host.dim)
        with self._lock:
            self._check_gen(prep)
            rows = self.hot.gather_rows(prep.slots, prep.slots_t)
            new_rows = self._update(
                rows, grads, prep.inverse_t, max(1, int(step))
            )
            self.hot.scatter_rows(
                prep.slots, new_rows, dirty=True, slots_t=prep.slots_t
            )
            if not prep.released:
                prep.released = True
                self.hot.unpin(prep.slots[: prep.n_unique])

    # -- spill / flush / checkpoint ------------------------------------
    def evict_to_host(self, keep_rows: Optional[int] = None) -> int:
        """Spill coldest resident rows until at most ``keep_rows``
        remain (default: half the capacity), run at checkpoint cadence."""
        with self._lock:
            keep = (
                self.hot.capacity // 2 if keep_rows is None else keep_rows
            )
            occupied = np.nonzero(
                (self.hot._id_of >= 0) & (self.hot._pins == 0)
            )[0]
            excess = len(occupied) - max(0, keep)
            if excess <= 0:
                return 0
            order = np.argsort(
                self.hot._last_used[occupied], kind="stable"
            )
            victims = occupied[order[:excess]]
            self._spill(victims)
            self.hot.drop(victims)
            self._bump_gen()
        return int(excess)

    def _bump_gen(self):
        """Invalidate every outstanding PreparedBatch (they must
        re-prepare) and reset ALL pins with them: a stale prep's
        release() is a no-op by design, so leaving its pins in place
        would leak one batch of un-evictable slots per bump."""
        self._gen += 1
        self.hot._pins[:] = 0

    def flush(self) -> int:
        """Write every dirty resident row back to the host store and
        wait for the spill drain: after flush the host tier holds the
        complete, current state (the checkpoint precondition). Rows
        STAY resident (and clean)."""
        with self._lock:
            dirty = self.hot.dirty_slots()
            if len(dirty):
                ids = self.hot._id_of[dirty].copy()
                rows = _to_numpy(self.hot.gather_rows(dirty))
                self.host.import_rows(
                    ids, rows, self.hot._freq[dirty], self.hot._ts[dirty]
                )
                self.stats.spill_rows += len(ids)
                self.stats.spill_bytes += rows.nbytes
                self.stats.host_leg_s += self._price(rows.nbytes, h2d=False)
                self.hot.clear_dirty(dirty)
        self.join_spills()
        return int(len(dirty))

    def join_spills(self, timeout: float = 30.0):
        """Barrier on the async spill drain (checkpoint/teardown).
        Waits on the in-flight COUNT, not the queue: the queue empties
        the moment the drain dequeues, while the import of that last
        item may still be running."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._spills_inflight == 0:
                    break
            if time.monotonic() > deadline:
                raise TimeoutError("embedding spill drain wedged")
            time.sleep(0.002)
        if self._spill_err is not None:
            err, self._spill_err = self._spill_err, None
            raise err

    def close(self):
        if self._spill_thread is not None:
            self._spill_q.put(None)
            self._spill_thread.join(timeout=5.0)
            self._spill_thread = None

    # -- host-store passthrough (checkpoint / reshard surface) ---------
    def export_state(self, since_versions=None):
        """Flush-then-export: the host store's merged view IS the
        checkpoint (device-resident training included)."""
        self.flush()
        return self.host.export_state(since_versions)

    def shard_versions(self):
        return self.host.shard_versions()

    def import_state(self, state):
        """Restore into the host tier and invalidate the device tier:
        resident rows may now be stale, so they are dropped (clean —
        the import is authoritative) and will fault back in."""
        with self._lock:
            occupied = np.nonzero(self.hot._id_of >= 0)[0]
            self.hot.drop(occupied)
            self._bump_gen()
        self.host.import_state(state)

    def warm_reshard(self, new_num_shards: int):
        """Flush, then warm-reshard the host store (move-only): the
        device tier keeps serving — residency survives a reshard
        because the id→slot map is independent of host routing."""
        self.flush()
        return self.host.warm_reshard(new_num_shards)

    def __len__(self) -> int:
        return len(self.host)

    @property
    def dim(self) -> int:
        return self.host.dim

    @property
    def num_slots(self) -> int:
        return self.host.num_slots

    # -- telemetry -----------------------------------------------------
    def export_metrics(self, registry=None) -> Dict[str, float]:
        """Publish per-table gauges (``dlrover_embedding_*{table}``, into
        the default registry unless one is given); returns the scalar
        dict the trainer forwards to the master."""
        if registry is None:
            from dlrover_tpu_torch.obs.metrics import default_registry

            registry = default_registry()
        scalars = self.stats.as_dict()
        scalars["emb_hot_rows"] = float(len(self.hot))
        scalars["emb_hbm_bytes"] = float(self.hot.hbm_bytes)
        # the arbiter's standing-demand hints (the dry runner prices the
        # aggregate host traffic from them): bytes per gather so far
        gathers = max(self.stats.gathers, 1)
        self._fault_stream.demand_bytes_per_step = self.stats.fault_bytes // gathers
        self._spill_stream.demand_bytes_per_step = self.stats.spill_bytes // gathers
        for name, value in scalars.items():
            registry.gauge(
                f"dlrover_embedding_{name[4:]}",
                f"embedding hot tier: {name[4:]}",
                labelnames=("table",),
            ).labels(self.table_name).set(value)
        return scalars
