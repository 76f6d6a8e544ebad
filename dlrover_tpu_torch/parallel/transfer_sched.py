"""Multi-rail transfer scheduling: one arbiter owns every idle link
(the port of ``dlrover_tpu/parallel/transfer_sched.py``: the same names,
enums, constants, switches and scheduling rules, host-side logic only;
no ``torch`` at module level).

Without it the host link's consumers are invisible to each other: the
checkpoint stager (``ckpt/engine.py``) copies the state card-to-host,
the sparse tier (``ops/embedding/device_tier.py``) faults rows in and
spills victims out from its own threads, and each would price itself as
if it had the link alone. The arbiter makes the links one scheduled
resource, over the set of **rails** this host can move bytes over
(FlexLink, PAPERS.md 2510.15882: heterogeneous paths should carry large
transfers *simultaneously*, not just the fastest one):

- **Rails** are physical paths with a direction and a ``LinkModel``
  price: ``host_d2h`` and ``host_h2d`` are independent wires (staging
  out and faulting in do not contend; on an H100 they are the two
  directions of its PCIe link), and ``dcn`` is the peer path to other
  hosts, which admits payloads of either direction. Each rail has its
  own holder/queue; scheduling semantics (priority, preemption, compute
  windows, aging, shutdown) are per rail, all under the arbiter's one
  condition variable.
- **Streams** register once (``register(name, priority, direction)``)
  and wrap each physical transfer in ``with stream.transfer(nbytes):``.
  A grant names the rail it holds; by default a stream routes to the
  rail matching its direction.
- **Striping**: :class:`StripedTransfer` splits a large payload into
  completion-time-balanced chunks across every rail whose priority
  class admits them (``bytes_i ∝ rail_i GB/s``, so all rails finish
  together), acquires a grant per chunk, and folds per-chunk crc32s
  with :func:`crc32_combine` so the combined digest is bitwise equal
  to the single-rail crc of the whole payload. A rail that fails
  mid-stripe has its remaining chunks re-sent on the survivors
  (``transfer.stripe`` fault site); arbiter shutdown mid-stripe
  degrades every chunk grant to pass-through — never a deadlock. A
  copy between this host and its own card rides only the rails of its
  direction (:func:`local_rails`): the peer rail leads to another host.
- **Preemption** is cooperative: a higher-priority waiter flags the
  rail's current holder, which checks ``grant.should_yield()`` at
  chunk boundaries and releases early. The arbiter reorders transfers,
  NEVER contents — bitwise checkpoint/spill correctness is untouched.
- **Compute windows**: the trainer marks its compute span
  (``note_compute``); while the marks are fresh, BACKGROUND grants
  outside a window wait (the inter-step host section belongs to the
  step's own host work) until priority aging rescues them. Marks
  expire after ``WINDOW_TTL_S`` so a finished/absent trainer can never
  gate anything — standalone users see a pass-through arbiter. On the
  card the trainer marks from the card's state, not the host's: the
  window is open from a step's dispatch until its end event has passed.
- **Aging** bounds starvation: a waiter's effective priority improves
  by one class per ``aging_s`` waited, so even a BACKGROUND stream
  under a constant EMERGENCY storm is granted within
  ``~2 * aging_s``.
- **Shutdown** mid-transfer releases every rail: waiters wake with
  pass-through grants, new acquires never block, holders' release
  becomes a no-op. Teardown cannot deadlock on a wedged transfer.

Pricing: registered streams carry a ``demand_bytes_per_step`` hint;
``aggregate_host_exposed_s`` prices each direction's demand through
the ``LinkModel`` host leg (``topology.price_host_transfer``)
SEPARATELY (D2H and H2D are different wires), exposes
``(1 - hidden_fraction)`` of the busier direction when the arbiter
schedules, and the full serialized sum when it does not. The hidden
fraction is **measured**, not assumed: a scheduled-vs-serialized A/B
(:func:`calibrate_hidden_fraction`) writes the observed per-rail
fraction into the topology cache under the device fingerprint, and
``HOST_HIDDEN_FRACTION`` survives only as the labeled no-cache fallback
(:func:`note_calibration_fallback`, the ``note_fallback_use`` pattern).
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger


class Priority(IntEnum):
    """Lower value = more urgent."""

    EMERGENCY = 0     # eviction-window emergency checkpoint drain
    BACKPRESSURE = 1  # spill backlog / fault-in a consumer waits on
    BACKGROUND = 2    # steady-state staging, warmup prefetch


# fraction of aggregate host wire time hidden behind compute when the
# arbiter schedules transfers into compute windows. This is the
# documented NO-CACHE FALLBACK only: the scheduled-vs-serialized A/B
# (calibrate_hidden_fraction) measures the real per-rail fraction and
# persists it in the topology cache; consumers that still land here log
# once through note_calibration_fallback.
HOST_HIDDEN_FRACTION = 0.7

# compute-window marks older than this are ignored: a trainer that
# stopped marking (exit, crash, not wired) must not gate background
# streams forever
WINDOW_TTL_S = 10.0

ENV_ARBITER = "DLROVER_TPU_TRANSFER_ARBITER"
ENV_CALIBRATE = "DLROVER_TPU_ARBITER_CALIBRATE"

# payloads below this never stripe: the per-chunk grant + thread cost
# only pays for itself on bulk movement, and small transfers keep the
# exact single-rail code path (and its byte-identical behavior)
DEFAULT_STRIPE_MIN_BYTES = 32 << 20


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's ``crc32_combine``: the crc of ``A + B`` from ``crc(A)``,
    ``crc(B)`` and ``len(B)`` — GF(2) matrix multiplication applying
    ``len2`` zero-byte shifts to ``crc1``. Lets striped chunks be
    crc'd independently (any rail, any order) and folded by offset into
    the exact digest the single-rail incremental fold produces.
    ``crc32_combine(0, c, n) == c``, so a running fold seeds from 0
    like ``zlib.crc32`` itself."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF

    def times(mat: List[int], vec: int) -> int:
        s = 0
        i = 0
        while vec:
            if vec & 1:
                s ^= mat[i]
            vec >>= 1
            i += 1
        return s

    def square(dst: List[int], src: List[int]) -> None:
        for n in range(32):
            dst[n] = times(src, src[n])

    even = [0] * 32
    odd = [0] * 32
    odd[0] = 0xEDB88320  # CRC-32 polynomial, reflected
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    square(even, odd)   # odd -> 2 zero bits
    square(odd, even)   # -> 4 zero bits
    crc1 &= 0xFFFFFFFF
    while True:
        square(even, odd)
        if len2 & 1:
            crc1 = times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        square(odd, even)
        if len2 & 1:
            crc1 = times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


class Rail:
    """One physical transfer path the arbiter schedules: its own
    holder, its own queue position, its own counters. ``direction`` is
    ``"d2h"`` / ``"h2d"`` / ``"peer"`` (the DCN path carries payloads
    of either direction). ``admit`` limits which priority classes may
    stripe onto it (None = all); ``gbps`` overrides the LinkModel
    price (bench/emulation)."""

    __slots__ = ("name", "direction", "gbps", "admit", "holder",
                 "grants", "bytes_total", "busy_s", "yields",
                 "stripe_chunks")

    def __init__(self, name: str, direction: str = "d2h"):
        self.name = name
        self.direction = direction
        self.gbps: Optional[float] = None
        self.admit: Optional[frozenset] = None
        self.holder: Optional["Grant"] = None
        self.grants = 0
        self.bytes_total = 0
        self.busy_s = 0.0
        self.yields = 0
        self.stripe_chunks = 0

    def admits(self, priority: Priority) -> bool:
        return self.admit is None or Priority(priority) in self.admit


class Grant:
    """One granted (or pass-through) hold of a rail."""

    __slots__ = ("stream", "nbytes", "priority", "passthrough",
                 "rail", "_preempt", "_released", "t0")

    def __init__(self, stream, nbytes, priority, passthrough=False,
                 rail: Optional[str] = None):
        self.stream = stream
        self.nbytes = int(nbytes)
        self.priority = priority
        self.passthrough = passthrough
        self.rail = rail
        self._preempt = False
        self._released = False
        self.t0 = time.perf_counter()

    def should_yield(self) -> bool:
        """A higher-priority waiter wants the rail: release at the next
        chunk boundary and re-acquire. Cooperative — ignoring it only
        costs latency, never correctness."""
        return self._preempt

    def release(self):
        if self.stream is not None:
            self.stream.arbiter.release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TransferStream:
    """One registered consumer of the transfer rails."""

    def __init__(self, arbiter: "TransferArbiter", name: str,
                 priority: Priority, direction: str):
        self.arbiter = arbiter
        self.name = name
        self.priority = Priority(priority)
        self.direction = direction  # "d2h" | "h2d"
        # pricing hint for the dry-runner: average bytes this stream
        # moves per train step (0 = no standing demand)
        self.demand_bytes_per_step = 0
        self.bytes_total = 0
        self.grants = 0
        self.wait_s = 0.0
        self.yields = 0
        # each scheduled grant's wait (the newest few thousand), for the
        # median and the worst in ``TransferArbiter.stats``
        self.waits: deque = deque(maxlen=4096)

    def acquire(
        self,
        nbytes: int,
        priority: Optional[Priority] = None,
        timeout: Optional[float] = None,
        ignore_window: bool = False,
        rail: Optional[str] = None,
    ) -> Grant:
        return self.arbiter.acquire(
            self, nbytes,
            priority=self.priority if priority is None else priority,
            timeout=timeout,
            ignore_window=ignore_window,
            rail=rail,
        )

    def transfer(
        self,
        nbytes: int,
        priority: Optional[Priority] = None,
        ignore_window: bool = False,
        rail: Optional[str] = None,
    ):
        """``with stream.transfer(n):`` — acquire around one physical
        transfer. ``ignore_window=True`` for transfers the TRAIN THREAD
        issues inside its own budget (the stager's advance): the
        compute-window gate exists to keep background threads off the
        inter-step host section, and deferring the section's own work
        behind its own gate would put the aging bound on the step's
        critical path. ``rail`` pins the grant to a named rail (stripe
        chunks); default routes by the stream's direction."""
        return self.acquire(
            nbytes, priority=priority, ignore_window=ignore_window,
            rail=rail,
        )


class _Waiter:
    __slots__ = ("stream", "priority", "enq", "grant", "ignore_window",
                 "rail")

    def __init__(self, stream, priority, ignore_window=False,
                 rail: str = "host_d2h"):
        self.stream = stream
        self.priority = priority
        self.enq = time.perf_counter()
        self.grant: Optional[Grant] = None
        self.ignore_window = ignore_window
        self.rail = rail


class TransferArbiter:
    """See module docstring. ``aging_s`` is the starvation knob: one
    priority class of credit per ``aging_s`` seconds waited."""

    # forced-grant backstop: an acquire never blocks longer than this
    # even if the holder wedges — the link is an optimization, not a
    # correctness gate, so a stuck arbiter must degrade to pass-through
    DEFAULT_TIMEOUT_S = 30.0

    def __init__(self, aging_s: float = 2.0, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.getenv(ENV_ARBITER, "1").strip().lower() not in (
                "0", "false", "no", "off"
            )
        self.enabled = enabled
        self.aging_s = max(float(aging_s), 1e-3)
        self._cond = threading.Condition()
        self._streams: Dict[str, TransferStream] = {}
        self._rails: Dict[str, Rail] = {}
        for rn, rd in (
            ("host_d2h", "d2h"), ("host_h2d", "h2d"), ("dcn", "peer")
        ):
            self._rails[rn] = Rail(rn, rd)
        self._waiters: List[_Waiter] = []
        self._shutdown = False
        # compute-window marks (note_compute); 0.0 = never marked
        self._in_compute = False
        self._last_mark = 0.0
        self._last_stripe_balance = 1.0
        self._t0 = time.perf_counter()
        self.preemptions = 0
        self.forced_grants = 0

    # -- registration --------------------------------------------------
    def register(
        self,
        name: str,
        priority: Priority = Priority.BACKGROUND,
        direction: str = "d2h",
    ) -> TransferStream:
        """Get-or-create a stream (call sites don't coordinate)."""
        with self._cond:
            st = self._streams.get(name)
            if st is None:
                st = TransferStream(self, name, priority, direction)
                self._streams[name] = st
            return st

    def streams(self) -> List[TransferStream]:
        with self._cond:
            return list(self._streams.values())

    def register_rail(
        self,
        name: str,
        direction: str = "d2h",
        gbps: Optional[float] = None,
        admit: Optional[Sequence[Priority]] = None,
    ) -> Rail:
        """Get-or-create a rail (the three defaults exist from birth).
        ``gbps`` overrides the LinkModel price; ``admit`` restricts
        which priority classes may be granted the rail."""
        with self._cond:
            r = self._rails.get(name)
            if r is None:
                r = Rail(name, direction)
                self._rails[name] = r
            if gbps is not None:
                r.gbps = float(gbps)
            if admit is not None:
                r.admit = frozenset(Priority(p) for p in admit)
            return r

    def rails(self) -> List[Rail]:
        with self._cond:
            return list(self._rails.values())

    def rails_for(
        self, direction: str, priority: Priority = Priority.BACKGROUND
    ) -> List[Rail]:
        """Rails a stripe of this direction/priority may ride: the
        direction-native rail(s) first, then every ``peer`` rail (the
        DCN path carries either direction), admission-filtered."""
        with self._cond:
            out = [
                r for r in self._rails.values()
                if (r.direction == direction or r.direction == "peer")
                and r.admits(priority)
            ]
        out.sort(key=lambda r: r.direction == "peer")
        return out

    def rail_gbps(self, name: str, model=None) -> float:
        """Bandwidth price of a rail: explicit override first, else the
        LinkModel leg matching the rail's direction (lazy import —
        constructing an arbiter never touches the backend)."""
        with self._cond:
            r = self._rails.get(name)
            explicit = None if r is None else r.gbps
            direction = "d2h" if r is None else r.direction
        if explicit is not None:
            return explicit
        try:
            from dlrover_tpu_torch.parallel import topology

            m = model if model is not None else topology.get_link_model()
            return topology.rail_link_gbps(m, direction)
        except Exception:
            return 64.0  # topology.FALLBACK_HOST_GBPS without a topology import

    # -- compute windows ----------------------------------------------
    def note_compute(self, active: bool) -> None:
        """Trainer hook: the device is (not) computing. While marks are
        fresh, BACKGROUND grants are deferred OUTSIDE compute windows —
        the inter-step host section belongs to the step's own host
        work (stager memcpy, metric sync)."""
        with self._cond:
            self._in_compute = bool(active)
            self._last_mark = time.perf_counter()
            self._cond.notify_all()

    def _window_gating(self, now: float) -> bool:
        return (
            self._last_mark > 0.0
            and now - self._last_mark < WINDOW_TTL_S
        )

    def in_compute_window(self) -> bool:
        """True while a FRESH mark says the trainer is inside a compute
        span. The co-located serving plane uses this as its idle-gap
        gate: stale or absent marks (no trainer, or a trainer wedged
        past WINDOW_TTL_S in host work — e.g. a resize drain) read as
        idle, so serving soaks exactly the windows BACKGROUND grants
        already treat as free."""
        with self._cond:
            return self._window_gating(time.perf_counter()) and (
                self._in_compute
            )

    # -- scheduling ----------------------------------------------------
    def _route(self, direction_or_rail: str) -> str:
        # lock held by callers
        if direction_or_rail in self._rails:
            return direction_or_rail
        if direction_or_rail == "h2d":
            return "host_h2d"
        return "host_d2h"

    def _effective(self, w: _Waiter, now: float) -> float:
        return float(w.priority) - (now - w.enq) / self.aging_s

    def _eligible(self, w: _Waiter, now: float) -> bool:
        if w.priority < Priority.BACKGROUND or w.ignore_window:
            return True
        if not self._window_gating(now) or self._in_compute:
            return True
        # aged past one class: window gating may no longer starve it
        return self._effective(w, now) <= float(Priority.BACKPRESSURE)

    def _best(self, rail: str, now: float) -> Optional[_Waiter]:
        cands = [
            w for w in self._waiters
            if w.rail == rail and self._eligible(w, now)
        ]
        if not cands:
            return None
        return min(cands, key=lambda w: (self._effective(w, now), w.enq))

    def acquire(
        self,
        stream: TransferStream,
        nbytes: int,
        priority: Priority = Priority.BACKGROUND,
        timeout: Optional[float] = None,
        ignore_window: bool = False,
        rail: Optional[str] = None,
    ) -> Grant:
        if not self.enabled or self._shutdown:
            return self._passthrough(stream, nbytes, priority)
        timeout = self.DEFAULT_TIMEOUT_S if timeout is None else timeout
        deadline = time.perf_counter() + timeout
        with self._cond:
            rail_name = self._route(
                rail if rail is not None else stream.direction
            )
            r = self._rails[rail_name]
            w = _Waiter(stream, Priority(priority), ignore_window,
                        rail_name)
            self._waiters.append(w)
            # cooperative preemption: flag a strictly lower-priority
            # holder of THIS rail so it yields at its next chunk
            # boundary
            if (
                r.holder is not None
                and not r.holder._preempt
                and w.priority < r.holder.priority
            ):
                r.holder._preempt = True
                r.holder.stream.yields += 1
                r.yields += 1
                self.preemptions += 1
                self._cond.notify_all()
            while True:
                now = time.perf_counter()
                if self._shutdown:
                    self._waiters.remove(w)
                    return self._passthrough(stream, nbytes, priority)
                if r.holder is None and self._best(rail_name, now) is w:
                    self._waiters.remove(w)
                    g = Grant(stream, nbytes, w.priority, rail=rail_name)
                    r.holder = g
                    r.grants += 1
                    r.bytes_total += int(nbytes)
                    stream.grants += 1
                    stream.bytes_total += int(nbytes)
                    stream.wait_s += now - w.enq
                    stream.waits.append(now - w.enq)
                    self._export()
                    return g
                if now >= deadline:
                    # backstop: never block a training thread on a
                    # wedged holder — degrade to pass-through
                    self._waiters.remove(w)
                    self.forced_grants += 1
                    logger.warning(
                        f"transfer arbiter: {stream.name} waited "
                        f"{timeout:.1f}s for rail {rail_name}; forcing "
                        f"a pass-through grant (holder wedged?)"
                    )
                    return self._passthrough(stream, nbytes, priority)
                # bounded wait: aging/window eligibility changes with
                # wall time, not only with notify
                self._cond.wait(timeout=min(0.05, deadline - now))

    def _passthrough(self, stream, nbytes, priority) -> Grant:
        stream.grants += 1
        stream.bytes_total += int(nbytes)
        return Grant(stream, nbytes, Priority(priority), passthrough=True)

    def release(self, grant: Grant) -> None:
        if grant._released:
            return
        grant._released = True
        if grant.passthrough:
            return
        with self._cond:
            r = self._rails.get(grant.rail) if grant.rail else None
            if r is not None and r.holder is grant:
                r.holder = None
                r.busy_s += max(0.0, time.perf_counter() - grant.t0)
            self._export()
            self._cond.notify_all()

    def shutdown(self) -> None:
        """Release every rail and never block again (idempotent). Safe
        mid-transfer (and mid-stripe): in-flight holders finish on
        their own, their release becomes a no-op, and every waiter
        wakes with a pass-through grant."""
        with self._cond:
            self._shutdown = True
            for r in self._rails.values():
                r.holder = None
            self._cond.notify_all()

    @property
    def scheduling_active(self) -> bool:
        return self.enabled and not self._shutdown

    # -- introspection / pricing hints ---------------------------------
    def set_demand(
        self,
        name: str,
        bytes_per_step: int,
        priority: Priority = Priority.BACKGROUND,
        direction: str = "d2h",
    ) -> TransferStream:
        """Register-or-update a stream's standing per-step demand (the
        dry-runner pricing hint)."""
        st = self.register(name, priority, direction)
        st.demand_bytes_per_step = int(bytes_per_step)
        return st

    def demand(self) -> Dict[str, TransferStream]:
        with self._cond:
            return {
                n: s
                for n, s in self._streams.items()
                if s.demand_bytes_per_step > 0
            }

    def stats(self) -> Dict[str, object]:
        """What the arbiter did, for a report: whether it schedules
        (an arbiter disabled by ``DLROVER_TPU_TRANSFER_ARBITER`` or shut
        down passes every transfer through), its preemptions and forced
        grants, and per stream its grants, bytes, yields and the median
        and worst wait of its scheduled grants (ms); per rail its
        grants, bytes and striped chunks."""
        with self._cond:
            streams = {}
            for name, st in self._streams.items():
                w = sorted(st.waits)
                streams[name] = {
                    "priority": st.priority.name,
                    "direction": st.direction,
                    "grants": st.grants,
                    "bytes": st.bytes_total,
                    "wait_ms_median": 1e3 * w[len(w) // 2] if w else 0.0,
                    "wait_ms_max": 1e3 * w[-1] if w else 0.0,
                    "yields": st.yields,
                }
            rails = {
                name: {
                    "grants": r.grants,
                    "bytes": r.bytes_total,
                    "stripe_chunks": r.stripe_chunks,
                }
                for name, r in self._rails.items()
            }
            return {
                "enabled": self.enabled,
                "scheduling": self.scheduling_active,
                "preemptions": self.preemptions,
                "forced_grants": self.forced_grants,
                "streams": streams,
                "rails": rails,
            }

    def note_stripe(self, report: "StripeReport") -> None:
        """Fold a finished stripe's per-rail chunk counts and balance
        into the rail gauges, and its realized per-rail throughput into
        the topology's observed-rate EWMA (``observe_rail_rate``) —
        every production stripe is a free bandwidth measurement, so the
        cost model tracks the link the job has instead of the one it
        probed at startup."""
        from dlrover_tpu_torch.parallel import topology

        folds: List[Tuple[str, float]] = []
        with self._cond:
            for name, n in report.rail_chunks.items():
                r = self._rails.get(name)
                if r is not None:
                    r.stripe_chunks += int(n)
            self._last_stripe_balance = float(report.balance)
            for name, nbytes in report.rail_bytes.items():
                r = self._rails.get(name)
                secs = report.rail_seconds.get(name, 0.0)
                if (
                    r is None
                    # an explicit gbps override marks an emulated/
                    # repriced rail (tests, bench) — its realized rate
                    # measures the emulation, not a physical link
                    or r.gbps is not None
                    or secs <= 0.0
                    # below this a chunk prices latency, not bandwidth
                    or nbytes < topology.RAIL_RATE_MIN_BYTES
                ):
                    continue
                folds.append((r.direction, nbytes / secs / 1e9))
            self._export()
        # fold outside the lock: observe_rail_rate persists to disk
        try:
            for direction, gbps in folds:
                topology.observe_rail_rate(direction, gbps)
        except Exception:  # pricing feedback must never break transfers
            pass

    def _export(self) -> None:
        """Registry gauges (lock held; cheap sets)."""
        try:
            from dlrover_tpu_torch.obs.metrics import default_registry

            reg = default_registry()
            now = time.perf_counter()
            busy_any = any(
                r.holder is not None for r in self._rails.values()
            )
            reg.gauge(
                "dlrover_transfer_link_busy",
                "1 while a stream holds any transfer rail",
            ).set(1.0 if busy_any else 0.0)
            reg.gauge(
                "dlrover_transfer_preemptions_total",
                "holders flagged to yield to a higher-priority stream",
            ).set(float(self.preemptions))
            g_rb = reg.gauge(
                "dlrover_transfer_rail_busy",
                "1 while a stream holds this rail",
                ("rail",),
            )
            g_rbytes = reg.gauge(
                "dlrover_transfer_rail_bytes_total",
                "bytes granted per transfer rail",
                ("rail",),
            )
            g_rutil = reg.gauge(
                "dlrover_transfer_rail_util_pct",
                "percent of wall time this rail was held",
                ("rail",),
            )
            g_ry = reg.gauge(
                "dlrover_transfer_rail_yields_total",
                "holders flagged to yield per rail",
                ("rail",),
            )
            g_rc = reg.gauge(
                "dlrover_transfer_rail_stripe_chunks_total",
                "striped chunks carried per rail",
                ("rail",),
            )
            wall = max(now - self._t0, 1e-9)
            for name, r in self._rails.items():
                busy = r.busy_s
                if r.holder is not None:
                    busy += max(0.0, now - r.holder.t0)
                g_rb.labels(name).set(
                    0.0 if r.holder is None else 1.0
                )
                g_rbytes.labels(name).set(float(r.bytes_total))
                g_rutil.labels(name).set(100.0 * busy / wall)
                g_ry.labels(name).set(float(r.yields))
                g_rc.labels(name).set(float(r.stripe_chunks))
            reg.gauge(
                "dlrover_transfer_rail_stripe_balance_pct",
                "completion-time balance of the last stripe "
                "(100 = every rail finished together)",
            ).set(100.0 * self._last_stripe_balance)
            g_b = reg.gauge(
                "dlrover_transfer_stream_bytes_total",
                "bytes moved per registered transfer stream",
                ("stream",),
            )
            g_w = reg.gauge(
                "dlrover_transfer_stream_wait_seconds_total",
                "seconds streams waited for a transfer rail",
                ("stream",),
            )
            for name, st in self._streams.items():
                g_b.labels(name).set(float(st.bytes_total))
                g_w.labels(name).set(st.wait_s)
        except Exception:  # metrics must never break a transfer
            pass


# -- striping ----------------------------------------------------------------


@dataclass
class StripeReport:
    """What one striped transfer did: per-rail byte/chunk split (the
    stripe-balance gauge input), the combined crc32 (bitwise equal to
    the single-rail digest of the same payload), requeue/failure
    accounting, and the effective rate."""

    nbytes: int = 0
    chunks: int = 0
    rail_bytes: Dict[str, int] = field(default_factory=dict)
    rail_chunks: Dict[str, int] = field(default_factory=dict)
    # wall seconds each rail spent actually executing its chunks
    # (excludes queue wait): rail_bytes / rail_seconds is the realized
    # throughput the arbiter folds into topology.observe_rail_rate
    rail_seconds: Dict[str, float] = field(default_factory=dict)
    crc32: Optional[int] = None
    elapsed_s: float = 0.0
    requeued_chunks: int = 0
    failed_rails: List[str] = field(default_factory=list)
    balance: float = 1.0

    def effective_gbps(self) -> float:
        if self.elapsed_s <= 0.0:
            return 0.0
        return self.nbytes / self.elapsed_s / 1e9


class StripedTransfer:
    """Split one large payload across every admitted rail.

    The plan is completion-time balanced: rail ``i`` gets a contiguous
    byte share proportional to its GB/s, split into chunks of at most
    ``chunk_bytes``; one worker per rail drains its chunk queue, each
    chunk under its own rail grant (so priority/preemption/shutdown
    semantics apply per chunk). Failure of a rail mid-stripe requeues
    its remaining chunks on the survivors; if every rail fails the
    first error is raised. ``run`` folds per-chunk crc32s through
    :func:`crc32_combine` into the exact whole-payload digest.
    """

    def __init__(
        self,
        arbiter: Optional[TransferArbiter] = None,
        name: str = "stripe",
        direction: str = "d2h",
        priority: Priority = Priority.BACKGROUND,
        chunk_bytes: int = 8 << 20,
        rails: Optional[Sequence[str]] = None,
        ignore_window: bool = False,
    ):
        self.arbiter = arbiter if arbiter is not None else get_arbiter()
        self.stream = self.arbiter.register(name, priority, direction)
        self.direction = direction
        self.priority = Priority(priority)
        self.chunk_bytes = max(int(chunk_bytes), 1)
        self.ignore_window = ignore_window
        self._rails = list(rails) if rails is not None else None

    def rails(self) -> List[str]:
        if self._rails is not None:
            return list(self._rails)
        return [
            r.name
            for r in self.arbiter.rails_for(self.direction, self.priority)
        ]

    def plan(self, nbytes: int) -> List[Tuple[str, int, int]]:
        """``[(rail, offset, length), ...]`` — contiguous shares
        ``∝ rail GB/s`` (every rail finishes at the same time), each
        chunked to ``chunk_bytes``."""
        nbytes = int(nbytes)
        rails = self.rails()
        if not rails:
            raise RuntimeError("striped transfer: no admitted rails")
        gbps = {r: max(self.arbiter.rail_gbps(r), 1e-9) for r in rails}
        total_w = sum(gbps.values())
        out: List[Tuple[str, int, int]] = []
        offset = 0
        for i, r in enumerate(rails):
            if i == len(rails) - 1:
                share = nbytes - offset
            else:
                share = int(nbytes * gbps[r] / total_w)
            lo = offset
            while lo < offset + share:
                ln = min(self.chunk_bytes, offset + share - lo)
                out.append((r, lo, ln))
                lo += ln
            offset += share
        return out

    def run(
        self,
        mover: Callable[[str, int, int], None],
        nbytes: Optional[int] = None,
        payload=None,
        priority: Optional[Priority] = None,
    ) -> StripeReport:
        """Stripe a byte range. ``mover(rail, offset, length)`` moves
        one chunk (it MUST address the destination by offset — chunks
        land out of order across rails). When ``payload`` (a buffer)
        is given, per-chunk crcs over its bytes are combined into
        ``report.crc32`` — bitwise the crc of the whole payload, folded
        BEFORE any downstream corruption site exactly like the
        single-rail staging path."""
        view = None
        if payload is not None:
            view = memoryview(payload).cast("B")
            if nbytes is None:
                nbytes = view.nbytes
        if nbytes is None:
            raise ValueError("run() needs nbytes or payload")
        prio = self.priority if priority is None else Priority(priority)
        report = StripeReport(nbytes=int(nbytes))
        assign: Dict[str, deque] = {}
        for r, off, ln in self.plan(nbytes):
            assign.setdefault(r, deque()).append((off, ln))
        crcs: Dict[int, Tuple[int, int]] = {}

        def exec_one(rail: str, item: Tuple[int, int]) -> None:
            off, ln = item
            mover(rail, off, ln)
            if view is not None:
                # distinct keys per chunk: plain dict set is safe
                crcs[off] = (zlib.crc32(view[off:off + ln]), ln)

        t0 = time.perf_counter()
        self._execute(
            assign, exec_one, lambda it: it[1], report, prio
        )
        report.elapsed_s = time.perf_counter() - t0
        if view is not None:
            total = 0
            for off in sorted(crcs):
                c, ln = crcs[off]
                total = crc32_combine(total, c, ln)
            report.crc32 = total
        report.balance = self._balance(report.rail_bytes)
        self.arbiter.note_stripe(report)
        return report

    def run_items(
        self,
        items: Sequence[Tuple[object, int]],
        mover: Callable[[str, object], None],
        priority: Optional[Priority] = None,
    ) -> StripeReport:
        """Stripe indivisible work items (``(key, nbytes)`` pairs —
        e.g. one reshard target shard, one spill row range) across
        rails by LPT: each item lands on the rail with the earliest
        projected finish time. ``mover(rail, key)`` moves one item."""
        prio = self.priority if priority is None else Priority(priority)
        rails = self.rails()
        if not rails:
            raise RuntimeError("striped transfer: no admitted rails")
        gbps = {r: max(self.arbiter.rail_gbps(r), 1e-9) for r in rails}
        loads = {r: 0.0 for r in rails}
        assign: Dict[str, deque] = {r: deque() for r in rails}
        report = StripeReport()
        for key, nb in sorted(items, key=lambda kv: -int(kv[1])):
            best = min(rails, key=lambda r: (loads[r] + nb) / gbps[r])
            loads[best] += int(nb)
            assign[best].append((key, int(nb)))
            report.nbytes += int(nb)

        def exec_one(rail: str, item: Tuple[object, int]) -> None:
            mover(rail, item[0])

        t0 = time.perf_counter()
        self._execute(
            assign, exec_one, lambda it: it[1], report, prio
        )
        report.elapsed_s = time.perf_counter() - t0
        report.balance = self._balance(report.rail_bytes)
        self.arbiter.note_stripe(report)
        return report

    # -- execution engine ---------------------------------------------
    def _execute(
        self,
        assign: Dict[str, deque],
        exec_one: Callable,
        nbytes_of: Callable,
        report: StripeReport,
        priority: Priority,
    ) -> None:
        lock = threading.Lock()
        errors: Dict[str, BaseException] = {}
        stranded: List[object] = []
        rails = [r for r in assign if assign[r]]

        def run_one(rail: str, item) -> None:
            faults.fire("transfer.stripe")
            with self.stream.transfer(
                nbytes_of(item), priority=priority,
                ignore_window=self.ignore_window, rail=rail,
            ):
                ct0 = time.perf_counter()
                exec_one(rail, item)
                cdt = time.perf_counter() - ct0
            with lock:
                report.rail_seconds[rail] = (
                    report.rail_seconds.get(rail, 0.0) + cdt
                )
                report.rail_bytes[rail] = (
                    report.rail_bytes.get(rail, 0) + nbytes_of(item)
                )
                report.rail_chunks[rail] = (
                    report.rail_chunks.get(rail, 0) + 1
                )
                report.chunks += 1

        def worker(rail: str) -> None:
            while True:
                with lock:
                    q = assign.get(rail)
                    item = q.popleft() if q else None
                if item is None:
                    return
                try:
                    run_one(rail, item)
                except BaseException as e:
                    # this rail is dead: requeue its remaining chunks
                    # (this one included — it did NOT land) on the
                    # survivors; the chunks are position-addressed, so
                    # a re-send on another rail is bitwise identical
                    with lock:
                        errors[rail] = e
                        leftover = [item] + list(assign.pop(rail, ()))
                        survivors = [
                            r for r in assign if r not in errors
                        ]
                        if survivors:
                            for i, it in enumerate(leftover):
                                assign[
                                    survivors[i % len(survivors)]
                                ].append(it)
                            report.requeued_chunks += len(leftover)
                        else:
                            stranded.extend(leftover)
                    return

        if len(rails) <= 1:
            if rails:
                worker(rails[0])
        else:
            threads = [
                threading.Thread(
                    target=worker, args=(r,), daemon=True,
                    name=f"stripe-{self.stream.name}-{r}",
                )
                for r in rails
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        # salvage pass: a worker that drained its queue may have
        # exited before a late failure redistributed chunks into it —
        # whatever is left moves serially on the first surviving rail
        with lock:
            leftovers = [
                it for q in assign.values() for it in q
            ] + list(stranded)
            for q in assign.values():
                q.clear()
            stranded.clear()
            survivors = [r for r in rails if r not in errors]
        if leftovers:
            if not survivors:
                report.failed_rails = sorted(errors)
                raise next(iter(errors.values()))
            report.requeued_chunks += len(leftovers)
            for it in leftovers:
                run_one(survivors[0], it)
        report.failed_rails = sorted(errors)

    def _balance(self, rail_bytes: Dict[str, int]) -> float:
        """min/max ratio of per-rail projected finish times (1.0 =
        every rail finishes together — the stripe goal)."""
        finish = [
            b / max(self.arbiter.rail_gbps(r), 1e-9)
            for r, b in rail_bytes.items()
            if b > 0
        ]
        if len(finish) <= 1:
            return 1.0
        return min(finish) / max(finish)


def local_rails(
    direction: str,
    priority: Priority = Priority.BACKGROUND,
    arbiter: Optional[TransferArbiter] = None,
) -> List[str]:
    """Rails a copy between this host and its own card may ride: the
    admitted rails of ``direction`` itself. ``rails_for`` adds the peer
    rail, which leads to another host, so a local card-to-host copy
    striped over it would move none of its bytes over that wire. With
    the default rails one host has one rail each way: a local copy
    stripes only where a second rail of its direction was registered."""
    a = arbiter if arbiter is not None else get_arbiter()
    return [
        r.name for r in a.rails_for(direction, priority)
        if r.direction == direction
    ]


# -- process-wide arbiter ----------------------------------------------------

_default: Optional[TransferArbiter] = None
_default_lock = threading.Lock()


def get_arbiter() -> TransferArbiter:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = TransferArbiter()
    return _default


def set_arbiter(arbiter: Optional[TransferArbiter]) -> None:
    """Install (tests) or reset (None → fresh lazy default) the
    process arbiter."""
    global _default
    with _default_lock:
        _default = arbiter


def note_compute(active: bool) -> None:
    """Module-level trainer hook (no-op cost when nothing contends)."""
    get_arbiter().note_compute(active)


# -- measured arbiter calibration --------------------------------------------


@dataclass
class ArbiterCalibration:
    """Measured per-rail hidden fractions, persisted in the
    topology cache under the device fingerprint (same invalidation
    rule as the link-model cache: a file whose fingerprint does not
    match the current world is stale and rejected)."""

    fingerprint: str
    hidden_fraction: Dict[str, float] = field(default_factory=dict)
    measured_at: float = 0.0
    source: str = "measured"

    def to_json(self) -> str:
        return json.dumps(
            {
                "fingerprint": self.fingerprint,
                "hidden_fraction": dict(self.hidden_fraction),
                "measured_at": self.measured_at,
                "source": self.source,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "ArbiterCalibration":
        d = json.loads(s)
        return ArbiterCalibration(
            fingerprint=str(d["fingerprint"]),
            hidden_fraction={
                str(k): float(v)
                for k, v in dict(d["hidden_fraction"]).items()
            },
            measured_at=float(d.get("measured_at", 0.0)),
            source=str(d.get("source", "measured")),
        )


_cal_current: Optional[ArbiterCalibration] = None
_cal_fallback_warned = False


def _current_fingerprint() -> str:
    try:
        from dlrover_tpu_torch.parallel import topology

        return topology.device_fingerprint()
    except Exception:  # no backend yet (early import paths)
        return ""


def calibration_path(
    fingerprint: str, dir_override: Optional[str] = None
) -> str:
    from dlrover_tpu_torch.parallel import topology

    return os.path.join(
        topology.cache_dir(dir_override), f"arbcal-{fingerprint}.json"
    )


def load_calibration(
    fingerprint: Optional[str] = None,
    dir_override: Optional[str] = None,
) -> Optional[ArbiterCalibration]:
    if fingerprint is None:
        fingerprint = _current_fingerprint()
    try:
        with open(calibration_path(fingerprint, dir_override)) as f:
            cal = ArbiterCalibration.from_json(f.read())
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if cal.fingerprint != fingerprint:
        return None  # stale file copied across worlds
    return cal


def save_calibration(
    cal: ArbiterCalibration, dir_override: Optional[str] = None
) -> Optional[str]:
    """Best-effort persist (atomic rename); a read-only cache dir must
    never take down calibration — pricing degrades to the documented
    constant instead."""
    path = calibration_path(cal.fingerprint, dir_override)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(cal.to_json())
        # best-effort cache: a torn file fails the json/fingerprint
        # check on load and the next A/B just re-measures
        os.replace(tmp, path)
        return path
    except OSError as e:
        logger.warning(f"arbiter calibration cache write failed: {e!r}")
        return None


def set_calibration(cal: Optional[ArbiterCalibration]) -> None:
    """Install a calibration as the process-current one (tests/bench;
    ``calibrate_hidden_fraction`` calls this with what it measured)."""
    global _cal_current
    _cal_current = cal


def reset_calibration() -> None:
    global _cal_current, _cal_fallback_warned
    _cal_current = None
    _cal_fallback_warned = False


def get_calibration(
    dir_override: Optional[str] = None,
) -> Optional[ArbiterCalibration]:
    """Process-current calibration, else the disk cache for the
    current device fingerprint, else None. Never measures."""
    global _cal_current
    if _cal_current is not None:
        return _cal_current
    cal = load_calibration(dir_override=dir_override)
    if cal is not None:
        _cal_current = cal
    return cal


def note_calibration_fallback() -> None:
    """Log ONCE per process when pricing uses the documented constant
    instead of a measured hidden fraction — the ``note_fallback_use``
    pattern: the old hardcoded assumption stays visible, never
    silent."""
    global _cal_fallback_warned
    if _cal_fallback_warned:
        return
    _cal_fallback_warned = True
    logger.info(
        f"transfer pricing: no arbiter calibration for this device "
        f"fingerprint — using the documented "
        f"HOST_HIDDEN_FRACTION={HOST_HIDDEN_FRACTION} constant until a "
        f"scheduled-vs-serialized A/B runs "
        f"(transfer_sched.calibrate_hidden_fraction)"
    )


def _clamped_hf(value: float) -> float:
    return min(max(float(value), 0.0), 0.95)


def hidden_fraction_for(
    rail: str,
    calibration: Optional[ArbiterCalibration] = None,
    dir_override: Optional[str] = None,
) -> float:
    """Measured hidden fraction for a rail, else the documented
    constant (logged once through :func:`note_calibration_fallback`)."""
    cal = (
        calibration
        if calibration is not None
        else get_calibration(dir_override)
    )
    if cal is not None and rail in cal.hidden_fraction:
        return _clamped_hf(cal.hidden_fraction[rail])
    note_calibration_fallback()
    return HOST_HIDDEN_FRACTION


def export_calibration_metrics(cal: ArbiterCalibration) -> None:
    try:
        from dlrover_tpu_torch.obs.metrics import default_registry

        g = default_registry().gauge(
            "dlrover_transfer_rail_hidden_fraction",
            "measured fraction of rail wire time hidden behind "
            "compute (scheduled-vs-serialized A/B)",
            ("rail",),
        )
        for rail, v in cal.hidden_fraction.items():
            g.labels(rail).set(_clamped_hf(v))
    except Exception:  # metrics must never break calibration
        pass


def _sleep_wire(seconds: float) -> None:
    """Default wire emulator for the calibration A/B: occupy the rail
    (and the emulated wire) for ``seconds``."""
    time.sleep(seconds)


def _ab_blocked_s(
    arbiter: TransferArbiter,
    rail: str,
    direction: str,
    steps: int,
    compute_s: float,
    chunks: int,
    chunk_s: float,
    wire: Callable[[float], None],
    scheduled: bool,
) -> float:
    """Step-blocking seconds of ``steps * chunks`` transfers on one
    rail: serialized (inline after each step's compute — the
    pre-arbiter world) vs scheduled (a worker thread rides compute
    windows). ``blocked = wall - compute`` either way."""
    stream = arbiter.register(f"calib:{rail}", Priority.BACKGROUND,
                              direction)
    if not scheduled:
        t0 = time.perf_counter()
        for _ in range(steps):
            wire(compute_s)
            for _ in range(chunks):
                wire(chunk_s)
        return time.perf_counter() - t0 - steps * compute_s

    done = threading.Event()

    def pump() -> None:
        for _ in range(steps * chunks):
            with stream.transfer(1 << 20, rail=rail):
                wire(chunk_s)
        done.set()

    t = threading.Thread(target=pump, daemon=True)
    t0 = time.perf_counter()
    t.start()
    for _ in range(steps):
        arbiter.note_compute(True)
        wire(compute_s)
        arbiter.note_compute(False)
    while not done.wait(timeout=0.05):
        pass
    t.join(timeout=5.0)
    return time.perf_counter() - t0 - steps * compute_s


def calibrate_hidden_fraction(
    rails: Sequence[str] = ("host_d2h", "host_h2d"),
    steps: int = 2,
    compute_s: float = 0.02,
    chunks: int = 3,
    chunk_s: float = 0.003,
    cache_dir: Optional[str] = None,
    force: bool = False,
    wire: Optional[Callable[[float], None]] = None,
    save: bool = True,
) -> ArbiterCalibration:
    """The measured replacement for ``HOST_HIDDEN_FRACTION``: per rail,
    run the same transfer demand scheduled (compute-window worker) and
    serialized (inline after compute — the pre-arbiter assumption) and
    record ``hidden = 1 - blocked_scheduled / blocked_serialized``.
    Results persist in the topology cache under the device
    fingerprint; a warm call returns the cached measurement without
    touching a rail (``force=True`` re-measures)."""
    fp = _current_fingerprint()
    if not force:
        cached = load_calibration(fp, cache_dir)
        if cached is not None:
            set_calibration(cached)
            export_calibration_metrics(cached)
            return cached
    wire_fn = wire if wire is not None else _sleep_wire
    hf: Dict[str, float] = {}
    for rail in rails:
        # a private arbiter per rail: the A/B must not contend with —
        # or leave marks on — the process arbiter's real streams
        a = TransferArbiter(aging_s=0.5, enabled=True)
        r = a.register_rail(rail)
        direction = "h2d" if r.direction == "h2d" else "d2h"
        serial = _ab_blocked_s(
            a, rail, direction, steps, compute_s, chunks, chunk_s,
            wire_fn, scheduled=False,
        )
        sched = _ab_blocked_s(
            a, rail, direction, steps, compute_s, chunks, chunk_s,
            wire_fn, scheduled=True,
        )
        a.shutdown()
        if serial <= 1e-6:
            continue
        hf[rail] = _clamped_hf(1.0 - sched / serial)
    cal = ArbiterCalibration(
        fingerprint=fp,
        hidden_fraction=hf,
        measured_at=time.time(),
        source="measured",
    )
    if save:
        save_calibration(cal, cache_dir)
    set_calibration(cal)
    export_calibration_metrics(cal)
    return cal


def ensure_calibrated(
    cache_dir: Optional[str] = None, **kwargs
) -> Optional[ArbiterCalibration]:
    """Startup hook (trainer link-probe path): load the cached
    calibration for this fingerprint, measuring once if absent.
    ``DLROVER_TPU_ARBITER_CALIBRATE=0`` disables — pricing then uses
    the documented constant (logged once)."""
    if os.getenv(ENV_CALIBRATE, "1").strip().lower() in (
        "0", "false", "no", "off"
    ):
        return None
    return calibrate_hidden_fraction(cache_dir=cache_dir, **kwargs)


# -- pricing -----------------------------------------------------------------


def aggregate_host_exposed_s(
    model=None,
    arbiter: Optional[TransferArbiter] = None,
    calibration: Optional[ArbiterCalibration] = None,
) -> float:
    """Exposed (step-blocking) seconds per train step of the AGGREGATE
    registered host-link demand, priced through the ``LinkModel``
    host leg — PER DIRECTION: D2H and H2D are independent physical
    wires, so each direction's streams serialize among themselves but
    the two directions overlap. Scheduled, each direction hides its
    measured ``hidden_fraction`` behind compute and the step pays only
    the busier wire's remainder (``max`` across directions). Disabled
    (or shut down) arbitration prices the full serialized sum: one
    queue draining every transfer single-file is exactly the
    pre-arbiter assumption this module replaced."""
    from dlrover_tpu_torch.parallel.topology import price_host_transfer

    a = arbiter or get_arbiter()
    per_dir = {"d2h": 0.0, "h2d": 0.0}
    for st in a.demand().values():
        d = "h2d" if st.direction == "h2d" else "d2h"
        per_dir[d] += price_host_transfer(
            st.demand_bytes_per_step,
            h2d=d == "h2d",
            model=model,
        )
    total = per_dir["d2h"] + per_dir["h2d"]
    if total <= 0.0:
        return 0.0
    if not a.scheduling_active:
        return total
    cal = (
        calibration if calibration is not None else get_calibration()
    )
    exposed = 0.0
    for d, rail in (("d2h", "host_d2h"), ("h2d", "host_h2d")):
        if per_dir[d] <= 0.0:
            continue
        exposed = max(
            exposed, per_dir[d] * (1.0 - hidden_fraction_for(rail, cal))
        )
    return exposed
