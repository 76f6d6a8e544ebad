"""Training-process side of Flash Checkpoint (counterpart of
``dlrover_tpu/ckpt/engine.py``).

Parity: ``CheckpointEngine`` engine.py:131 — a save stages the state
into shm under a non-blocking shard lock (if the saver is still
persisting the previous step, this save is *skipped*, never blocked
on), then notifies the saver through the event queue; a restore reads
shm first and storage second, both crc-checked.

What changes on the card: torch updates state in place. The optimizer
writes params and its 8-bit moments into the same tensors every step,
so a copy that outlived one optimizer step would mix step N with step
N+1. Between step N's optimizer and step N+1's optimizer the state is
only read, and the stager is built on that:

- ``begin`` (at step boundary N) records an event on the compute
  stream; a side stream waits for it and copies every state tensor into
  the shm segment, which is pinned for the card (``cudaHostRegister``),
  so the copy lands in shm with no host copy after it;
- step N+1's forward and backward run beside that copy; before its
  optimizer writes anything, the compute stream waits for the copy's
  done event (``copy_fence``; the trainer's ``donation_aware`` step);
- a host thread then folds each record's crc32 over the bytes in shm
  (records on ``CRC_THREADS`` threads), off the loop thread and over as
  many steps as it takes; the loop
  thread only asks (``advance``) and publishes the metadata and
  notifies the saver (``commit``).

Host leaves (counts, the sampler) and CPU tensors are copied into shm at
``begin``. The link arbitration and multi-rail striping of the JAX
package's stager (``parallel/transfer_sched``) are not ported.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ckpt import saver as saver_mod
from dlrover_tpu_torch.ckpt.saver import SaveEvent
from dlrover_tpu_torch.ckpt.sharding import (
    ShardRecord,
    host_shard_index_set,
    host_shard_plan,
    host_shard_records,
    restore_state,
)
from dlrover_tpu_torch.ckpt.shm_handler import ShmHandler
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedLock,
    SharedQueue,
    server_exists,
)
from dlrover_tpu_torch.common.storage import CheckpointStorage, PosixDiskStorage
from dlrover_tpu_torch.obs.trace import span


# threads folding a stage's crc32s (the card's host has 8 cores; the
# train loop and the prefetcher keep two of them busy)
CRC_THREADS = 4


# what an idle rank proposes for the shm step: agreement ignores it
_IDLE_PROPOSAL = -2


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.getenv(name, default))
    except ValueError:
        return default


def _overlaps(a, b) -> bool:
    """Two index tuples ((lo,hi),...) intersect."""
    if len(a) != len(b):
        return False
    return all(max(alo, blo) < min(ahi, bhi) for (alo, ahi), (blo, bhi) in zip(a, b)) if a else True


def _no_link_arbitration(priority, stripe_min_bytes):
    if priority is not None or stripe_min_bytes is not None:
        raise NotImplementedError(
            "host-link priorities and multi-rail striping of checkpoint "
            "staging are not ported yet (ROADMAP A9b)"
        )


def _is_cuda(src) -> bool:
    return isinstance(src, torch.Tensor) and src.device.type == "cuda"


class ChunkedStager:
    """One checkpoint on its way into shm, spread over train steps.

    The contract is the JAX package's: the shm metadata stays invalid
    until ``commit``, so a concurrent restore never sees a half-staged
    step; ``advance(budget_s)`` spends at most about ``budget_s`` of the
    loop thread's time; ``commit`` is the barrier; ``abort`` gives the
    shard lock back. ``chunk_bytes`` is the unit of the crc fold (and of
    the ``ckpt.shm_stage`` fault point), so a cancel waits one chunk at
    most.

    Recovery window: ``begin`` invalidates the previous shm checkpoint
    before the first byte moves, so a crash before ``commit`` restores
    from storage instead.
    """

    def __init__(
        self,
        engine: "CheckpointEngine",
        step: int,
        state: Any,
        checkpoint_dir: str,
        sync: bool,
        chunk_bytes: int,
    ):
        t0 = time.perf_counter()
        self._engine = engine
        self.step = step
        self.checkpoint_dir = checkpoint_dir
        self._sync = sync
        self._chunk_bytes = max(int(chunk_bytes), 1 << 10)
        self._plan = host_shard_plan(state)
        self._metas = ShmHandler.layout_records([rec for rec, _ in self._plan])
        self.total_bytes = sum(m.nbytes for m in self._metas)
        self._staged_bytes = 0
        self.chunks_written = 0
        self._count_lock = threading.Lock()
        self._crcs: Dict[int, int] = {}
        self._finished = False
        self._failed = False
        self._error: Optional[BaseException] = None
        self._cancel = threading.Event()
        # the CUDA event the optimizer must wait for (None: nothing on a
        # card, every byte placed at begin)
        self.copy_done: Optional[torch.cuda.Event] = None
        self._copy_start: Optional[torch.cuda.Event] = None
        self._crc_t0 = 0.0  # when the host side began its crc fold
        # loop-thread seconds (begin + advance + commit), and the host
        # thread's own times, for the trainer's save records
        self.block_s = 0.0
        self.timings: Dict[str, float] = {}
        self._engine._shm.begin_save(max(self.total_bytes, 1))
        self._place()
        self._thread = threading.Thread(
            target=self._host_side, name=f"ckpt-stage-{step}", daemon=True
        )
        self._thread.start()
        self.block_s += time.perf_counter() - t0

    # -- placement (loop thread, at begin) ------------------------------
    def _place(self):
        """Every byte of the plan into the segment: CUDA tensors by
        copies on the engine's side stream that start when the compute
        stream reaches this point; host leaves and CPU tensors (the
        host-offloaded optimizer state among them: no card-to-host copy)
        by a memcpy now (nothing orders a CPU tensor's next update after
        a later copy)."""
        shm = self._engine._shm
        dst = shm.host_tensor()
        cuda = [(i, src) for i, (_, src) in enumerate(self._plan) if _is_cuda(src)]
        if cuda:
            device = cuda[0][1].device
            shm.register_for_device()
            stream = self._engine._side_stream(device)
            self._copy_start = torch.cuda.Event(enable_timing=True)
            self._copy_start.record(torch.cuda.current_stream(device))
            stream.wait_event(self._copy_start)
            with torch.cuda.stream(stream):
                for i, src in cuda:
                    m = self._metas[i]
                    dst[m.offset:m.offset + m.nbytes].copy_(
                        src.reshape(-1).view(torch.uint8), non_blocking=True
                    )
            self.copy_done = torch.cuda.Event(enable_timing=True)
            self.copy_done.record(stream)
        # host-offloaded optimizer state: no card-to-host copy, but the
        # last update's copies home must have landed
        from dlrover_tpu_torch.ops.host_offload import settle_host_sources

        settle_host_sources(src for _, src in self._plan)
        for i, (_, src) in enumerate(self._plan):
            m = self._metas[i]
            if _is_cuda(src) or m.nbytes == 0:
                continue
            if isinstance(src, torch.Tensor):
                dst[m.offset:m.offset + m.nbytes].copy_(src.reshape(-1).view(torch.uint8))
            else:
                dst[m.offset:m.offset + m.nbytes].numpy()[:] = (
                    np.ascontiguousarray(src).reshape(-1).view(np.uint8)
                )

    # -- host side (its own thread) --------------------------------------
    def _host_side(self):
        try:
            t0 = time.perf_counter()
            if self.copy_done is not None:
                self.copy_done.synchronize()
                self.timings["d2h_ms"] = self._copy_start.elapsed_time(self.copy_done)
            t1 = self._crc_t0 = time.perf_counter()
            self._plan = None  # the copies are done: drop the live tensors
            # one zlib.crc32 runs at ~3 GB/s and releases the GIL, so the
            # records are folded on several threads (each record's chunks
            # in order): a save then commits within a step or two
            with ThreadPoolExecutor(CRC_THREADS, thread_name_prefix="ckpt-crc") as pool:
                for _ in pool.map(self._fold_record, range(len(self._metas))):
                    pass
            if self._cancel.is_set():
                return
            self.timings["wait_copy_s"] = t1 - t0
            self.timings["crc_s"] = time.perf_counter() - t1
        except BaseException as e:  # surfaced by advance / commit
            self._error = e

    def _fold_record(self, i: int) -> None:
        m = self._metas[i]
        buf = self._engine._shm._shm.buf
        crc, off = 0, 0
        while off < m.nbytes:
            if self._cancel.is_set():
                return
            n = min(self._chunk_bytes, m.nbytes - off)
            view = np.ndarray((n,), dtype=np.uint8, buffer=buf, offset=m.offset + off)
            crc = zlib.crc32(view, crc)
            del view
            # the fault point corrupts after the checksum was taken, as
            # in-flight rot would
            self._engine._shm.fault_chunk(m.offset + off, n)
            off += n
            with self._count_lock:
                self._staged_bytes += n
                self.chunks_written += 1
        self._crcs[i] = crc

    # -- introspection -------------------------------------------------
    @property
    def backlog_bytes(self) -> int:
        return self.total_bytes - self._staged_bytes

    @property
    def done(self) -> bool:
        """Every byte staged and checksummed (commit may still be
        pending)."""
        return not self._thread.is_alive()

    @property
    def finished(self) -> bool:
        """Committed or aborted — the engine's lock is out of our hands."""
        return self._finished

    def advance(self, budget_s: Optional[float] = None, stats=None) -> int:
        """Give the host side at most ``budget_s`` of the loop's time
        (None: wait until it is done); returns the bytes it checksummed
        meanwhile. It runs on its own thread, so a budgeted call waits
        only when the backlog, at the rate seen so far, ends within the
        budget, and otherwise just looks. A failure of the host side
        aborts the stage and raises here."""
        if self._finished:
            return 0
        t0 = time.perf_counter()
        before, chunks0 = self._staged_bytes, self.chunks_written
        wait = budget_s
        if budget_s is not None:
            rate = self._staged_bytes / max(t0 - self._crc_t0, 1e-9) if self._crc_t0 else 0.0
            if rate <= 0.0 or self.backlog_bytes / rate > budget_s:
                wait = 0.0
        with span("ckpt_stage", step=self.step):
            self._thread.join(timeout=wait)
        if self._error is not None:
            err = self._error
            self.abort()
            raise err
        dt = time.perf_counter() - t0
        self.block_s += dt
        if stats is not None:
            stats.stage_chunks += self.chunks_written - chunks0
            stats.stage_bytes += self._staged_bytes - before
            stats.stage_backlog_bytes = self.backlog_bytes
            stats.stage_block_s += dt
        return self._staged_bytes - before

    # -- barrier -------------------------------------------------------
    def commit(self, stats=None) -> bool:
        """The commit barrier: wait for the host side, publish the
        metadata, notify the saver. After this the shm checkpoint is
        visible and the saver owns the shard lock."""
        if self._finished:
            return not self._failed
        try:
            with span("ckpt_commit", step=self.step):
                self.advance(budget_s=None, stats=stats)  # counts its own wait
                t0 = time.perf_counter()
                for i, m in enumerate(self._metas):
                    m.crc32 = self._crcs.get(i)
                self._engine._shm.commit_save(
                    self.step,
                    self._metas,
                    {
                        "checkpoint_dir": self.checkpoint_dir,
                        "global_shard_id": self._engine.global_shard_id,
                        "global_shard_num": self._engine.global_shard_num,
                        "step_meta": dict(self._engine.step_meta),
                    },
                )
        except BaseException as e:
            self.abort()
            logger.error(f"step {self.step}: staging commit failed: {e!r}")
            raise
        self._finished = True
        if stats is not None:
            stats.stage_commits += 1
        self._engine._queue.put(
            SaveEvent(
                step=self.step,
                checkpoint_dir=self.checkpoint_dir,
                local_rank=self._engine.local_rank,
                global_shard_id=self._engine.global_shard_id,
                global_shard_num=self._engine.global_shard_num,
                sync=self._sync,
            )
        )
        self.block_s += time.perf_counter() - t0
        return True

    def wait_copied(self) -> None:
        """Block the host until the device copies have landed."""
        if self.copy_done is not None:
            self.copy_done.synchronize()

    def abort(self):
        """Give up: metadata stays invalid (begin_save cleared it), the
        shard lock goes back so future saves are not starved. Waits for
        the device copies first, so no byte lands after the lock is
        free."""
        if self._finished:
            return
        self._finished = True
        self._failed = True
        self._cancel.set()
        self.wait_copied()
        self._thread.join()
        self._plan = None
        # force_release, not release: abort may run from a thread other
        # than the acquirer's
        self._engine._lock.force_release()


class _SyncFallbackStager:
    """No saver (plain ``python train.py``): there is no shm to stage
    into, so the state is copied to the host at begin (the next step
    updates it in place) and the commit barrier writes it to storage."""

    copy_done = None

    def __init__(self, engine, step, state, checkpoint_dir):
        t0 = time.perf_counter()
        self._engine = engine
        self.step = step
        self._records = host_shard_records(state)
        self.checkpoint_dir = checkpoint_dir
        self.total_bytes = sum(r.nbytes for r in self._records)
        self.chunks_written = 0
        self.backlog_bytes = 0
        self.done = True
        self.finished = False
        self.timings: Dict[str, float] = {}
        self.block_s = time.perf_counter() - t0

    def advance(self, budget_s=None, stats=None) -> int:
        return 0

    def commit(self, stats=None) -> bool:
        if self.finished:
            return True
        t0 = time.perf_counter()
        self.finished = True
        ok = self._engine._save_records_sync(
            self.step, self._records, self.checkpoint_dir
        )
        self._records = None
        if stats is not None:
            stats.stage_commits += 1
        self.block_s += time.perf_counter() - t0
        return ok

    def wait_copied(self) -> None:
        pass

    def abort(self):
        self.finished = True
        self._records = None


class CheckpointEngine:
    """One per training process. Talks to the saver when one is serving
    the IPC endpoints; otherwise writes to storage synchronously (plain
    ``python train.py`` without the launcher)."""

    def __init__(self, storage: Optional[CheckpointStorage] = None):
        self.local_rank = _env_int("DLROVER_TPU_LOCAL_RANK", 0)
        self.global_shard_id = _env_int("DLROVER_TPU_PROCESS_ID", 0)
        self.global_shard_num = _env_int("DLROVER_TPU_NUM_PROCESSES", 1)
        self.storage = storage or PosixDiskStorage()
        self._agent_mode = server_exists(saver_mod.CKPT_EVENT_QUEUE)
        self._shm: Optional[ShmHandler] = None
        self._queue: Optional[SharedQueue] = None
        self._lock: Optional[SharedLock] = None
        self._active_stager = None
        # the newest stager of any save (its timings, for the caller)
        self.last_stager = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        # "memory" or "storage": where the last load came from
        self.last_load_source: Optional[str] = None
        # what every save carries beside its records (the trainer's
        # strategy and world: ``step_meta`` of the saver's extras and of
        # the done files), and what the last load's step carried
        self.step_meta: Dict[str, Any] = {}
        self.last_load_meta: Dict[str, Any] = {}
        # bytes of records the last load read back
        self.last_load_bytes = 0
        if self._agent_mode:
            self._shm = ShmHandler(self.local_rank, create=False)
            self._queue = SharedQueue(saver_mod.CKPT_EVENT_QUEUE)
            self._lock = SharedLock(
                saver_mod.shard_lock_name(self.local_rank)
            )

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The stream staging copies run on, one per device."""
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def _try_lock(self, step: int) -> bool:
        # Lock-handoff protocol (parity: engine.py:284 + ckpt_saver.py:534):
        # we take the shard lock here and the *saver* force-releases it
        # once it has the step, so shm can never be overwritten before it
        # is safe — a save issued while the saver is busy is skipped,
        # never blocked on.
        if self._lock.acquire(blocking=False):
            return True
        logger.warning(
            f"step {step}: saver busy persisting a previous checkpoint; "
            f"skipping this save"
        )
        return False

    def _new_stager(self, step, state, checkpoint_dir, sync, chunk_bytes):
        try:
            self.last_stager = ChunkedStager(
                self, step, state, checkpoint_dir, sync, chunk_bytes
            )
        except BaseException:
            self._lock.force_release()
            raise
        return self.last_stager

    def save_to_memory(
        self,
        step: int,
        state: Any,
        checkpoint_dir: str,
        sync: bool = False,
    ) -> bool:
        """Stage ``state`` into shm and notify the saver, returning once
        it is committed. Returns False when skipped because the saver
        still holds the shard lock. (The JAX package's ``block=False``,
        a background drain, has no caller here: ``begin_chunked_save``
        is the overlapped form.)"""
        if not self._agent_mode:
            return self._save_sync(step, state, checkpoint_dir)
        if not self._try_lock(step):
            return False
        return self._new_stager(step, state, checkpoint_dir, sync, 64 << 20).commit()

    def begin_chunked_save(
        self,
        step: int,
        state: Any,
        checkpoint_dir: str,
        sync: bool = False,
        chunk_bytes: int = 64 << 20,
        priority=None,
        stripe_min_bytes: Optional[int] = None,
    ):
        """Start a save whose device copies run beside the next step and
        whose host side spreads over later steps: returns a stager whose
        ``advance(budget_s)`` the train loop calls between steps and
        whose ``commit()`` is the barrier, or None when the saver still
        holds the shard lock (skipped, never blocked on). Without a
        saver the stager copies to the host now and writes to storage at
        commit. ``priority`` / ``stripe_min_bytes`` (link arbitration)
        raise: not ported yet (ROADMAP A9b)."""
        _no_link_arbitration(priority, stripe_min_bytes)
        if self._agent_mode:
            if not self._try_lock(step):
                return None
            stager = self._new_stager(step, state, checkpoint_dir, sync, chunk_bytes)
        else:
            stager = self.last_stager = _SyncFallbackStager(
                self, step, state, checkpoint_dir
            )
        self._active_stager = stager
        return stager

    def wait_saver_idle(self, timeout_s: float) -> bool:
        """Wait, at most ``timeout_s``, until the saver has handed the
        shard lock back (it holds it while it persists a step); True at
        once without a saver. The eviction drain waits here instead of
        having its emergency save skipped."""
        if not self._agent_mode:
            return True
        deadline = time.monotonic() + timeout_s
        while self._lock.locked():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)
        return True

    def copy_fence(self) -> Optional[torch.cuda.Event]:
        """The event after which the active stage's device copies are
        done (None when none is pending): a step must make its stream
        wait for it before it updates the state in place."""
        st = self._active_stager
        if st is None or st.finished:
            return None
        return st.copy_done

    def staging_in_flight(self) -> bool:
        """True while a chunked stager is uncommitted."""
        st = self._active_stager
        if st is not None and st.finished:
            self._active_stager = st = None
        return st is not None

    def close(self):
        """Abort an uncommitted stage and drop the IPC clients."""
        if (
            self._active_stager is not None
            and not self._active_stager.finished
        ):
            # an uncommitted stage dies with the process — abort so the
            # shard lock is not leaked (metadata is already invalid, so
            # no reader can see the partial bytes)
            logger.warning(
                f"closing engine with an uncommitted stage at step "
                f"{self._active_stager.step}; aborting it"
            )
            self._active_stager.abort()
        self._active_stager = None
        for attr in ("_queue", "_lock"):
            obj = getattr(self, attr)
            if obj is not None:
                try:
                    obj.close()
                except OSError as e:
                    logger.warning(f"{attr} close failed: {e!r}")
        if self._shm is not None:
            try:
                self._shm.close(unlink=False)
            except (OSError, BufferError) as e:
                logger.warning(f"shm close failed: {e!r}")

    def save_to_storage(
        self,
        step: int,
        state: Any,
        checkpoint_dir: str,
        timeout: float = 600.0,
    ) -> bool:
        """Stage to shm, ask the saver to persist this step, and wait
        until the commit tracker names it (returning True means the
        checkpoint is on storage)."""
        if not self.save_to_memory(step, state, checkpoint_dir, sync=True):
            return False
        if not self._agent_mode:
            return True  # _save_sync already committed
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.latest_step(checkpoint_dir) >= step:
                return True
            time.sleep(0.05)
        logger.error(f"step {step}: storage persist not committed in time")
        return False

    def _save_sync(self, step: int, state: Any, checkpoint_dir: str) -> bool:
        return self._save_records_sync(
            step, host_shard_records(state), checkpoint_dir
        )

    def _save_records_sync(
        self, step: int, records: List[ShardRecord], checkpoint_dir: str
    ) -> bool:
        """No saver: write this process's shard straight to storage
        through the saver's payload/done/commit helpers, so files stay
        interchangeable. A storage failure (ENOSPC, a transient error)
        returns False instead of killing the train loop."""
        try:
            with span("ckpt_persist", step=step):
                faults.fire("ckpt.persist")
                self.storage.safe_makedirs(
                    os.path.join(
                        saver_mod.step_dir(checkpoint_dir, step),
                        saver_mod.DONE_DIR,
                    )
                )
                payload = saver_mod.build_shard_payload(
                    step, self.global_shard_id, self.global_shard_num,
                    records, {"step_meta": dict(self.step_meta)},
                )
                saver_mod.write_shard_and_done(
                    self.storage, checkpoint_dir, step, payload
                )
                if self.global_shard_id == 0:
                    return saver_mod.commit_checkpoint(
                        self.storage, checkpoint_dir, step,
                        self.global_shard_num,
                    )
                return True
        except OSError as e:
            logger.error(f"step {step}: sync persist failed: {e!r}")
            saver_mod._metric_counter(
                "dlrover_ckpt_persist_failures_total",
                "failed checkpoint persist attempts",
            ).inc()
            return False

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------
    def latest_step(self, checkpoint_dir: str) -> int:
        return saver_mod.read_tracker(self.storage, checkpoint_dir)

    def latest_verified_step(
        self, checkpoint_dir: str, repair: Optional[bool] = None
    ) -> int:
        """Newest committed step whose shards pass integrity
        verification. ``repair`` (default: only global shard 0)
        quarantines corrupt step dirs and rolls the tracker back; the
        repairing rank runs the deep read+crc pass, the others the cheap
        completeness/length check."""
        if repair is None:
            repair = self.global_shard_id == 0
        return saver_mod.resolve_verified_step(
            self.storage, checkpoint_dir, repair=repair, deep=repair
        )

    def peek_step_meta(self, checkpoint_dir: str) -> Tuple[int, Dict[str, Any]]:
        """``(step, step_meta)`` of the newest step this process can see
        without reading any record: its shm segment's (when it holds this
        directory's state) or the tracker's step on storage, by its done
        files; ``(-1, {})`` when there is neither. Reads no bytes of
        state and takes part in no collective."""
        best: Tuple[int, Dict[str, Any]] = (-1, {})
        if self._agent_mode and self._shm is not None:
            try:
                meta = self._shm.metadata()
                extra = meta.get("extra", {})
                if meta.get("valid") and extra.get("checkpoint_dir") == checkpoint_dir:
                    best = (int(meta["step"]), dict(extra.get("step_meta") or {}))
            except Exception as e:  # a dead segment is no checkpoint
                logger.info(f"shm metadata unreadable: {e!r}")
        step = self.latest_step(checkpoint_dir)
        if step > best[0]:
            best = (step, saver_mod.read_step_meta(self.storage, checkpoint_dir, step))
        return best

    def load(
        self, target: Any, checkpoint_dir: str, prefer_memory: bool = True,
        idle: bool = False,
    ) -> Tuple[int, Optional[Any]]:
        """Restore into ``target`` (its tensors are filled in place).
        Prefers shm when every process holds the same usable step of
        this ``checkpoint_dir`` at least as new as the newest verified
        one on storage, else reads that storage step; ``(-1, None)`` when
        neither exists.

        Both sources are integrity-checked: the shm proposal recomputes
        each record's crc32 against the writer's checksum (a corrupt
        segment downgrades to storage), and the storage step comes from
        ``latest_verified_step`` — a torn, bit-flipped or partial newest
        step is quarantined and the newest older step that verifies is
        restored. ``last_load_source`` says which was used.

        ``idle``: a rank of the process group outside the mesh (a
        resize that left it idle) takes part in the agreements and
        restores nothing: it proposes no shm step of its own, so the
        mesh's ranks choose as they would without it."""
        self.last_load_source = None
        self.last_load_meta = {}
        self.last_load_bytes = 0
        committed = self._agree_committed(
            self.latest_verified_step(checkpoint_dir)
        )
        if idle:
            self._all_processes_agree(_IDLE_PROPOSAL)
            return -1, None
        candidate = -1
        shm_meta: Dict[str, Any] = {}
        records = []
        got_lock = False
        if prefer_memory and self._agent_mode and self._shm is not None:
            try:
                got_lock = self._lock.acquire(blocking=True)
            except (TimeoutError, RuntimeError):
                got_lock = False
            if got_lock:
                try:
                    # zero-copy views, consumed by restore_state before
                    # the lock is released in the finally
                    shm_step, records, extra = self._shm.load_records(
                        copy=False, verify=True
                    )
                    # the segment is per job and rank, not per directory:
                    # a save of another directory (the best-eval one) is
                    # not this directory's newest state
                    if (
                        shm_step >= committed
                        and extra.get("checkpoint_dir") == checkpoint_dir
                        and self._shm_covers(records, target)
                    ):
                        candidate = shm_step
                        shm_meta = dict(extra.get("step_meta") or {})
                except (LookupError, ValueError) as e:
                    logger.warning(f"shm checkpoint unusable: {e!r}")
                    candidate = -1
        by_path: Dict[str, list] = {}
        try:
            agreed = self._all_processes_agree(candidate)
            if agreed and candidate >= 0:
                for r in records:
                    by_path.setdefault(r.path, []).append(r)
                try:
                    state = restore_state(
                        target, lambda p: by_path.get(p, [])
                    )
                    logger.info(f"restored step {candidate} from memory")
                    self.last_load_source = "memory"
                    self.last_load_meta = shm_meta
                    self.last_load_bytes = sum(r.nbytes for r in records)
                    return candidate, state
                except (LookupError, ValueError) as e:
                    logger.warning(
                        f"shm restore of step {candidate} failed ({e!r}); "
                        f"falling back to storage"
                    )
            elif candidate >= 0:
                logger.warning(
                    f"shm holds step {candidate} but processes disagree; "
                    f"falling back to committed step {committed}"
                )
        finally:
            # drop every view into the segment BEFORE releasing the lock
            records = []
            by_path.clear()
            if got_lock:
                self._lock.force_release()
        if committed < 0:
            return -1, None
        state = self._load_from_storage(target, checkpoint_dir, committed)
        logger.info(f"restored step {committed} from storage")
        self.last_load_source = "storage"
        self.last_load_meta = saver_mod.read_step_meta(self.storage, checkpoint_dir, committed)
        return committed, state

    @staticmethod
    def _gather_steps(step: int) -> Optional[List[int]]:
        """Every process's ``step`` when torch.distributed runs more
        than one process, else None."""
        # a process that never imported torch.distributed has no group
        # (and importing it costs seconds)
        dist = sys.modules.get("torch.distributed")
        if dist is None or not dist.is_initialized() or dist.get_world_size() <= 1:
            return None
        out: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(out, int(step))
        return [int(s) for s in out]

    def _agree_committed(self, committed: int) -> int:
        """Fleet minimum of per-rank verified storage steps (single
        process: the step itself)."""
        steps = self._gather_steps(committed)
        if steps is None:
            return committed
        agreed = min(steps)
        if agreed != committed:
            logger.warning(
                f"verified storage step disagreement: local {committed}, "
                f"fleet min {agreed}; using the min"
            )
        return agreed

    def _all_processes_agree(self, candidate: int) -> bool:
        """True iff every process proposes the same shm step (an idle
        rank's proposal counts for none)."""
        steps = self._gather_steps(candidate)
        return steps is None or len(set(steps) - {_IDLE_PROPOSAL}) == 1

    def _shm_covers(self, records, target) -> bool:
        """shm restore is only safe when the target's records match what
        this process staged."""
        have = {(r.path, r.index) for r in records}
        return host_shard_index_set(target) <= have

    def _load_from_storage(
        self, target: Any, checkpoint_dir: str, step: int
    ) -> Any:
        sdir = saver_mod.step_dir(checkpoint_dir, step)
        files = [
            f for f in self.storage.listdir(sdir) if f.endswith(".ckpt")
        ]
        needed = self._filter_needed_shards(sdir, files, target)
        by_path: Dict[str, list] = {}
        for fname in needed:
            payload = self.storage.read_state_dict(
                os.path.join(sdir, fname)
            )
            for m in payload["records"]:
                rec = ShardRecord(
                    path=m["path"],
                    global_shape=tuple(m["global_shape"]),
                    dtype=m["dtype"],
                    index=tuple(tuple(i) for i in m["index"]),
                    data=m["data"],
                )
                by_path.setdefault(rec.path, []).append(rec)
                self.last_load_bytes += rec.nbytes
        return restore_state(target, lambda p: by_path.get(p, []))

    def _filter_needed_shards(self, sdir, files, target):
        """Use the .idx sidecars to read only shard files overlapping
        this process's part of ``target``. Falls back to all files when
        any sidecar is missing."""
        wanted = host_shard_index_set(target)
        needed = []
        for fname in files:
            try:
                index = self.storage.read_state_dict(
                    os.path.join(sdir, fname + ".idx")
                )
            except Exception:
                index = None
            if index is None:
                return files
            for m in index:
                ridx = tuple(tuple(i) for i in m["index"])
                if any(
                    p == m["path"] and _overlaps(ridx, widx)
                    for p, widx in wanted
                ):
                    needed.append(fname)
                    break
        return needed
