"""SparseTrainer: elastic sparse (embedding/recommender) training
(counterpart of ``dlrover_tpu/trainer/sparse.py``).

The reference's TF-PS path (EstimatorExecutor + PS failover over TFPlus
KvVariable embeddings) with the parameter-server fleet replaced by the
host-side ``ShardedKvEmbedding`` store (C++; ``ops/embedding``): the
DENSE model trains on the card, the SPARSE embedding rows live in host
memory with fused native optimizers or in the device hot tier, and
elasticity means

- checkpoint = dense params + embedding export (npz, crc-verified with
  rollback to the previous good file — a torn export must never
  restore silently);
- failover = watch the master's PS cluster version; on a bump (a
  reshard happened elsewhere, or we are a restarted worker) refresh
  the embedding state before continuing. With a reshard target the
  refresh is a WARM id-range redistribution (move only re-routed rows)
  instead of a full npz re-import.

Two train cycles:

- **host cycle** (``train_step``): host gather → dense step on the
  device → host fused sparse update — every row crosses the host link
  every step (the full fused-optimizer family is available);
- **device cycle** (``train_step_device`` / ``run(overlapped=True)``):
  the embedding is a :class:`DeviceSparseEmbedding` — gathers are the
  ``emb_gather`` kernel, the sparse update runs on the device, and with
  the :class:`SparseRowPipeline` the host link only carries fault-ins
  for step N+1 (overlapping step N's compute) and async spill-backs.

``dense_params`` is a tensor or a flat list, tuple or dict of tensors
(dict keys sorted, the JAX flatten order). The checkpoint legs carry the
``embedding.export`` / ``embedding.import`` fault sites, and a refresh
window is booked to the goodput ledger as ``restart_replay``.
"""

from __future__ import annotations

import io
import json
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.storage import fsync_dir
from dlrover_tpu_torch.ops.embedding.device_tier import (
    DeviceSparseEmbedding,
    _to_numpy,
)


def _book_replay(t0_ns: int):
    """Attribute a state-refresh window (re-import or warm reshard) to
    the goodput ledger so it cannot vanish from the wall-time closure."""
    try:
        from dlrover_tpu_torch.obs.goodput import default_ledger

        ledger = default_ledger()
        if ledger is not None:
            ledger.mark_interval(
                "restart_replay", t0_ns, time.monotonic_ns()
            )
    except Exception:  # accounting must never break the refresh itself
        pass


def _flatten_dense(params) -> Tuple[List[torch.Tensor], Callable]:
    """(leaves, rebuild) of a tensor or a flat list/tuple/dict of
    tensors; dict leaves in sorted key order."""
    if isinstance(params, torch.Tensor):
        return [params], lambda leaves: leaves[0]
    if isinstance(params, dict):
        keys = sorted(params)
        leaves = [params[k] for k in keys]
        rebuild = lambda ls: dict(zip(keys, ls))  # noqa: E731
    elif isinstance(params, (list, tuple)):
        leaves = list(params)
        rebuild = (tuple if isinstance(params, tuple) else list)
    else:
        raise TypeError(
            f"dense_params must be a tensor or a flat list/tuple/dict of "
            f"tensors, got {type(params).__name__}"
        )
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("every dense_params leaf must be a tensor")
    return leaves, rebuild


class SparseTrainer:
    """Embedding-store-backed training loop with elastic checkpointing.

    ``dense_step(dense_params, rows, batch) ->
    (dense_params, row_grads, metrics)`` is the user's dense
    computation on the device; the trainer owns the gather → step → sparse-update
    cycle, checkpoints, and cluster-version failover.

    ``embedding`` may be a host store (``ShardedKvEmbedding`` /
    tiered) for the classic host cycle, or a
    :class:`DeviceSparseEmbedding` to enable the device cycle.
    ``target_shards_fn`` (e.g. a master query) makes a cluster-version
    bump warm-reshard to that shard count instead of re-importing.
    """

    def __init__(
        self,
        embedding,
        dense_params: Any,
        dense_step: Callable,
        ckpt_dir: str = "",
        sparse_optimizer: str = "adagrad",
        sparse_lr: float = 0.05,
        master_client=None,
        target_shards_fn: Optional[Callable[[], int]] = None,
    ):
        self.embedding = embedding
        self.dense_params = dense_params
        self._dense_step = dense_step
        self._ckpt_dir = ckpt_dir
        self._opt = sparse_optimizer
        self._lr = sparse_lr
        self._client = master_client
        self._target_shards_fn = target_shards_fn
        self._cluster_version = (
            self._poll_cluster_version(initial=True)
            if master_client
            else 0
        )
        self.step = 0
        # counters of the last overlapped run's row pipeline
        self.pipeline_stats: Dict[str, float] = {}

    @property
    def device_mode(self) -> bool:
        return isinstance(self.embedding, DeviceSparseEmbedding)

    # -- sparse update dispatch (host cycle) ---------------------------
    def _apply_sparse(self, keys, grads):
        if self._opt == "adagrad":
            self.embedding.sparse_adagrad(keys, grads, lr=self._lr)
        elif self._opt == "adam":
            self.embedding.sparse_adam(
                keys, grads, lr=self._lr, step=self.step + 1
            )
        elif self._opt == "momentum":
            self.embedding.sparse_momentum(keys, grads, lr=self._lr)
        elif self._opt == "group_ftrl":
            self.embedding.sparse_group_ftrl(keys, grads, alpha=self._lr)
        elif self._opt == "group_adam":
            self.embedding.sparse_group_adam(
                keys, grads, lr=self._lr, step=self.step + 1
            )
        elif self._opt == "lamb":
            self.embedding.sparse_lamb(
                keys, grads, lr=self._lr, step=self.step + 1
            )
        elif self._opt == "adabelief":
            self.embedding.sparse_adabelief(
                keys, grads, lr=self._lr, step=self.step + 1
            )
        elif self._opt == "amsgrad":
            self.embedding.sparse_amsgrad(
                keys, grads, lr=self._lr, step=self.step + 1
            )
        else:
            raise ValueError(f"unknown sparse optimizer {self._opt!r}")

    # -- failover -------------------------------------------------------
    def _poll_cluster_version(self, initial: bool = False) -> int:
        """One cluster-version read over the client. A real
        ``MasterClient`` already retries with full jitter inside
        ``_call``; when the budget is exhausted anyway (master restart
        in flight) the poll degrades to "no change" instead of killing
        the train loop — the next poll sees the bump."""
        try:
            return self._client.get_cluster_version()
        except (ConnectionError, OSError) as e:
            if initial:
                raise
            logger.warning(
                f"cluster-version poll failed ({e!r}); keeping version "
                f"{self._cluster_version} until the master answers"
            )
            return self._cluster_version

    def check_failover(self) -> bool:
        """True if the PS cluster version moved and state was refreshed
        (parity: ps_addresses_changed → session refresh). The refresh
        is a WARM move-only reshard when a target shard count is known
        (``target_shards_fn``), else the npz re-import; both windows
        are booked to the goodput ledger as ``restart_replay``."""
        if self._client is None:
            return False
        version = self._poll_cluster_version()
        if version == self._cluster_version:
            return False
        logger.warning(
            f"embedding cluster version {self._cluster_version} -> "
            f"{version}: refreshing sparse state"
        )
        self._cluster_version = version
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        try:
            target = (
                self._target_shards_fn()
                if self._target_shards_fn is not None
                else None
            )
            if target and hasattr(self.embedding, "warm_reshard"):
                report = self.embedding.warm_reshard(int(target))
                logger.info(
                    f"warm embedding reshard on version bump: "
                    f"{report.describe()}"
                )
            else:
                self.restore_embedding()
        finally:
            _book_replay(t0_ns)
        logger.info(
            f"sparse state refreshed in {time.perf_counter() - t0:.3f} s"
        )
        return True

    # -- train loop -----------------------------------------------------
    def train_step(self, ids: np.ndarray, batch: Any) -> Dict:
        """One HOST cycle: gather rows → dense step on the device →
        fused sparse update on the host. The dense step gets the rows
        as a CPU tensor and places them itself."""
        rows = torch.from_numpy(self.embedding.gather(ids))
        self.dense_params, row_grads, metrics = self._dense_step(
            self.dense_params, rows, batch
        )
        self._apply_sparse(ids, _to_numpy(row_grads))
        self.step += 1
        return metrics

    def train_step_device(
        self, ids: np.ndarray, batch: Any, prep=None
    ) -> Dict:
        """One DEVICE cycle: HBM gather → dense step → on-device sparse
        update. ``prep`` usually comes from the row pipeline one step
        ahead; a stale prep (the tier was flushed/resharded in between)
        is transparently re-prepared."""
        emb = self.embedding
        if prep is None:
            prep = emb.prepare(ids)
        try:
            try:
                rows = emb.gather_for(prep)
            except RuntimeError:  # stale generation → re-prepare
                prep = emb.prepare(ids)
                rows = emb.gather_for(prep)
            self.dense_params, row_grads, metrics = self._dense_step(
                self.dense_params, rows, batch
            )
            emb.apply_grads(prep, row_grads, step=self.step + 1)
        finally:
            emb.release(prep)  # no-op when apply_grads got there
        self.step += 1
        return metrics

    def run(
        self,
        data_iter,
        num_steps: Optional[int] = None,
        overlapped: bool = True,
        pipeline_depth: int = 2,
    ) -> List[Dict]:
        """Drive ``data_iter`` of ``(ids, batch)`` pairs. In device
        mode with ``overlapped=True`` the row pipeline faults step
        N+1's rows in while step N computes; otherwise the synchronous
        cycle runs (host cycle for host stores, inline-prepare device
        cycle for a device embedding)."""
        metrics: List[Dict] = []
        if self.device_mode and overlapped:
            from dlrover_tpu_torch.data.sparse_prefetch import (
                SparseRowPipeline,
            )

            pipe = SparseRowPipeline(
                data_iter, self.embedding, depth=pipeline_depth
            )
            try:
                for ids, batch, prep in pipe:
                    metrics.append(
                        self.train_step_device(ids, batch, prep)
                    )
                    if num_steps and len(metrics) >= num_steps:
                        break
            finally:
                pipe.close()
                self.pipeline_stats = {
                    "prepared_steps": pipe.prepared_steps,
                    "prepare_waits": pipe.prepare_waits,
                    "prepare_wait_s": pipe.prepare_wait_s,
                }
            return metrics
        for ids, batch in data_iter:
            if self.device_mode:
                metrics.append(self.train_step_device(ids, batch))
            else:
                metrics.append(self.train_step(ids, batch))
            if num_steps and len(metrics) >= num_steps:
                break
        return metrics

    # -- telemetry ------------------------------------------------------
    def telemetry(self) -> Dict[str, float]:
        """Per-table hot-tier scalars (+ trainer step); with a master
        client they ride ``report_train_metrics`` to the master's
        collector alongside loss/lr."""
        scalars: Dict[str, float] = {"sparse_step": float(self.step)}
        if self.device_mode:
            scalars.update(self.embedding.export_metrics())
        return scalars

    def report_telemetry(self, extra: Optional[Dict] = None):
        scalars = self.telemetry()
        if extra:
            scalars.update(extra)
        if self._client is not None and hasattr(
            self._client, "report_train_metrics"
        ):
            try:
                self._client.report_train_metrics(self.step, scalars)
            except (ConnectionError, OSError) as e:
                logger.warning(f"telemetry report failed: {e!r}")
        return scalars

    # -- checkpoint -----------------------------------------------------
    def _emb_path(self) -> str:
        return os.path.join(self._ckpt_dir, "embedding_state.npz")

    @staticmethod
    def _prev_path(path: str) -> str:
        return path.replace(".npz", ".prev.npz")

    @staticmethod
    def _meta_path(path: str) -> str:
        return path + ".meta"

    def _dense_leaves(self) -> Dict[str, np.ndarray]:
        leaves, _ = _flatten_dense(self.dense_params)
        return {
            f"__dense_{i}": _to_numpy(leaf)
            for i, leaf in enumerate(leaves)
        }

    def _restore_dense(self, data: Dict[str, np.ndarray]):
        leaves, rebuild = _flatten_dense(self.dense_params)
        saved = [
            data.pop(k)
            for k in sorted(
                (k for k in data if k.startswith("__dense_")),
                key=lambda k: int(k.rsplit("_", 1)[1]),
            )
        ]
        if not saved:
            return
        if len(saved) != len(leaves):
            logger.warning(
                f"checkpoint dense leaf count {len(saved)} != current "
                f"{len(leaves)}; keeping in-memory dense params"
            )
            return
        self.dense_params = rebuild([
            torch.as_tensor(s, dtype=leaf.dtype).to(leaf.device)
            for s, leaf in zip(saved, leaves)
        ])

    def save_embedding(self):
        """crc-verified atomic save: the npz blob's whole-file crc32
        plus per-record crcs are written to a ``.meta`` sidecar BEFORE
        any byte can be corrupted in flight (the writer-side-crc
        rule), and the previous good file is kept for rollback. A
        device-tier embedding is flushed first so device-resident
        training is in the export."""
        if not self._ckpt_dir:
            return
        os.makedirs(self._ckpt_dir, exist_ok=True)
        state = dict(self.embedding.export_state())
        records = {**state, **self._dense_leaves()}
        buf = io.BytesIO()
        np.savez(buf, step=np.int64(self.step), **records)
        blob = buf.getvalue()
        meta = {
            "crc32": zlib.crc32(blob),
            "nbytes": len(blob),
            "records": {
                name: zlib.crc32(np.ascontiguousarray(arr).tobytes())
                for name, arr in records.items()
            },
            "step": int(self.step),
        }
        # fault site embedding.export: data kinds corrupt the payload
        # AFTER the crcs were computed — exactly a torn/bit-rotted
        # write, which restore must detect and roll back from
        blob = faults.corrupt("embedding.export", blob)
        path = self._emb_path()
        if os.path.exists(path):
            os.replace(path, self._prev_path(path))
            if os.path.exists(self._meta_path(path)):
                os.replace(
                    self._meta_path(path),
                    self._meta_path(self._prev_path(path)),
                )
        tmp = path.replace(".npz", f".tmp{os.getpid()}.npz")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())  # a "saved" checkpoint is durable
        with open(self._meta_path(path) + ".tmp", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(self._meta_path(path) + ".tmp", self._meta_path(path))
        os.replace(tmp, path)
        # both renames' directory entries must be durable before this
        # save is treated as the rollback target
        fsync_dir(os.path.dirname(path) or ".")
        logger.info(
            f"saved embedding state ({len(state['keys'])} rows, "
            f"crc {meta['crc32']:08x}) at step {self.step}"
        )

    def _load_verified(self, path: str) -> Optional[Dict]:
        """Load + verify one checkpoint file; None when absent, raises
        ``ValueError`` on corruption (caller quarantines)."""
        if not os.path.exists(path):
            return None
        faults.fire("embedding.import")
        with open(path, "rb") as f:
            blob = f.read()
        meta = None
        if os.path.exists(self._meta_path(path)):
            try:
                with open(self._meta_path(path)) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = None
        if meta is not None:
            if len(blob) != meta["nbytes"] or (
                zlib.crc32(blob) != meta["crc32"]
            ):
                raise ValueError(
                    f"embedding checkpoint {path} fails crc/length "
                    f"verification (torn or corrupted write)"
                )
        try:
            data = dict(np.load(io.BytesIO(blob)))
        except Exception as e:  # torn zip on legacy (meta-less) files
            raise ValueError(f"embedding checkpoint {path} unreadable: {e!r}")
        if meta is not None:
            for name, crc in meta["records"].items():
                if name not in data or (
                    zlib.crc32(
                        np.ascontiguousarray(data[name]).tobytes()
                    )
                    != crc
                ):
                    raise ValueError(
                        f"embedding checkpoint {path}: record "
                        f"{name!r} fails crc verification"
                    )
        return data

    def _quarantine(self, path: str):
        for p in (path, self._meta_path(path)):
            if os.path.exists(p):
                os.replace(p, p + ".corrupt")
        logger.error(
            f"embedding checkpoint {path} quarantined to "
            f"{path}.corrupt"
        )

    def restore_embedding(self) -> bool:
        """Restore the newest VERIFIED embedding checkpoint: the
        current file, else (after quarantining it) the kept previous
        one — a torn export rolls back instead of restoring silently."""
        path = self._emb_path()
        for candidate in (path, self._prev_path(path)):
            try:
                data = self._load_verified(candidate)
            except ValueError as e:
                logger.error(str(e))
                self._quarantine(candidate)
                continue
            if data is None:
                continue
            self.step = int(data.pop("step", 0))
            self._restore_dense(data)
            self.embedding.import_state(data)
            logger.info(
                f"restored embedding state ({len(data['keys'])} rows) "
                f"at step {self.step}"
                + (
                    " [rolled back to previous good file]"
                    if candidate != path
                    else ""
                )
            )
            return True
        return False
