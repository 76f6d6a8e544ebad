"""Agent-side async checkpoint saver (a copy of
``dlrover_tpu/ckpt/saver.py``: the same on-disk format, commit protocol,
verification, quarantine and rollback, so either package reads the
other's checkpoints).

Parity: ``AsyncCheckpointSaver`` ckpt_saver.py:341-1146 —

- ``start_async_saving_ckpt`` (ckpt_saver.py:405): the agent
  (``trainer/run.py``) starts a daemon thread *before spawning workers*
  that owns the IPC endpoints (event queue + per-shard meta dict/lock).
- event loop (``_sync_shm_to_storage`` ckpt_saver.py:505): drains per-shard
  SAVE events; when every local shard reported a step (or the straggler
  timeout fires) it persists shm → storage with one thread per shard
  (``save_step_checkpoint``/``_save_shard`` ckpt_saver.py:750,534).
  Every staged step is persisted, a memory save as well as a storage
  save, as in the JAX package: after a node loss the newest staged step
  is on disk. A persist holds the shard's lock, so a memory save the
  trainer tries meanwhile is skipped (the engine's non-blocking
  acquire), never queued behind it.
- commit protocol (``commit_checkpoint`` ckpt_saver.py:813): every shard
  writes a done file; node-0 waits for ``global_shard_num`` done files on
  the shared filesystem, then atomically publishes the tracker file
  ``latest_step`` — a checkpoint exists only once the tracker names it.
- ``save_shm_to_storage`` (ckpt_saver.py:623): called on SIGTERM and
  before an elastic restart ("save at breakpoint", training.py:614-623) to
  persist whatever newer state is still in memory.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import signal
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import SharedLock, SharedQueue
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    PosixDiskStorage,
)
from dlrover_tpu_torch.ckpt.shm_handler import ShmHandler, data_crc32
from dlrover_tpu_torch.obs.metrics import default_registry
from dlrover_tpu_torch.obs.trace import span

CKPT_EVENT_QUEUE = "ckpt_event_queue"
TRACKER_FILE = "latest_step"
# bounded history of committed steps (JSON list): the rollback set a
# load-time verification failure falls back through — one corrupt shard
# can no longer poison the only restorable checkpoint
HISTORY_FILE = "committed_steps"
DONE_DIR = "._done"
QUARANTINE_SUFFIX = ".corrupt"
COMMIT_HISTORY_KEEP = 8
QUARANTINE_KEEP = 2

# serializes the tracker's read-check-write so concurrent commit threads
# can never regress it
_tracker_mutex = threading.Lock()


def _metric_counter(name: str, help: str = ""):
    return default_registry().counter(name, help)


def _degraded_gauge():
    return default_registry().gauge(
        "dlrover_ckpt_degraded_mode",
        "1 while checkpoint persistence is shm-only (storage failing)",
    )


def read_tracker(storage, checkpoint_dir: str) -> int:
    """Committed step named by the tracker file; -1 when absent/garbled."""
    raw = storage.read(os.path.join(checkpoint_dir, TRACKER_FILE))
    if not raw:
        return -1
    try:
        return int(raw.decode() if isinstance(raw, bytes) else raw)
    except (AttributeError, ValueError):
        return -1


def read_history(storage, checkpoint_dir: str) -> List[int]:
    """The bounded committed-step history (ascending); [] when absent."""
    raw = storage.read(os.path.join(checkpoint_dir, HISTORY_FILE))
    if not raw:
        return []
    try:
        steps = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
        return sorted({int(s) for s in steps})
    except (AttributeError, ValueError, TypeError):
        return []


def _write_history(storage, checkpoint_dir: str, steps: List[int]):
    kept = sorted({int(s) for s in steps if s >= 0})[-COMMIT_HISTORY_KEEP:]
    storage.write(
        json.dumps(kept), os.path.join(checkpoint_dir, HISTORY_FILE)
    )


def known_committed_steps(storage, checkpoint_dir: str) -> List[int]:
    """The committed-step history, seeded from on-disk step dirs when the
    history file predates this code (first run after upgrading from the
    single-tracker protocol): dirs at or below the tracker were committed
    by the old protocol and must join the rollback set — without the
    seed, the first post-upgrade commit's GC would treat every
    pre-existing checkpoint as untracked and delete the only fallback."""
    hist = read_history(storage, checkpoint_dir)
    if hist:
        return hist
    tracker = read_tracker(storage, checkpoint_dir)
    if tracker < 0:
        return []
    steps = []
    for n in storage.listdir(checkpoint_dir):
        if not n.startswith("step_") or QUARANTINE_SUFFIX in n:
            continue
        try:
            s = int(n[len("step_"):])
        except ValueError:
            continue
        if s <= tracker:
            steps.append(s)
    return sorted(steps)


def shard_lock_name(local_rank: int) -> str:
    return f"ckpt_lock_{local_rank}"


def step_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir, f"step_{step}")


def shard_file(checkpoint_dir: str, step: int, global_shard_id: int) -> str:
    return os.path.join(
        step_dir(checkpoint_dir, step), f"shard_{global_shard_id}.ckpt"
    )


def build_shard_payload(
    step: int, global_shard_id: int, global_shard_num: int, records, extra,
    crcs: Optional[List[int]] = None,
) -> Dict:
    """Single source of truth for the on-disk shard format — the agent path
    and the launcher-less sync path must stay byte-compatible. Each record
    carries a crc32 of its raw bytes so corruption is attributable to a
    specific leaf slice, not just "the file". ``crcs``: the records'
    crc32s when the caller already verified them (the saver's shm read)."""
    return {
        "step": step,
        "global_shard_id": global_shard_id,
        "global_shard_num": global_shard_num,
        "records": [
            {
                "path": r.path,
                "global_shape": r.global_shape,
                "dtype": r.dtype,
                "index": r.index,
                "data": r.data,
                "crc32": data_crc32(r.data) if crcs is None else int(crcs[i]),
            }
            for i, r in enumerate(records)
        ],
        "extra": extra,
    }


def parse_done(raw) -> Dict:
    """Done-file contents: the integrity record for one shard. Current
    format is JSON ``{"global_shard_num", "crc32", "nbytes"}``; the
    legacy format (a bare shard-count int) still parses so pre-checksum
    checkpoints stay restorable."""
    if raw is None:
        return {}
    text = raw.decode() if isinstance(raw, bytes) else str(raw)
    text = text.strip()
    if not text:
        return {}
    try:
        if text.startswith("{"):
            out = json.loads(text)
            return out if isinstance(out, dict) else {}
        return {"global_shard_num": int(text)}
    except ValueError:
        return {}


def write_shard_and_done(
    storage, checkpoint_dir: str, step: int, payload: Dict
):
    gid = payload["global_shard_id"]
    path = shard_file(checkpoint_dir, step, gid)
    # fault point ckpt.shard_write: its control kinds fire before the
    # write
    faults.fire("ckpt.shard_write")
    # streamed where the storage can: a shard of a 7 B state is ~41 GB,
    # and its pickle in memory beside the shm segment would not fit the
    # host
    crc, nbytes = storage.write_pickle(payload, path)
    # its data kinds corrupt the written file AFTER the checksum was
    # taken — modelling bytes that rot past the journaled
    # tmp+fsync+rename (the done file still advertises the good crc, so
    # load-time verification catches the divergence)
    faults.corrupt_file("ckpt.shard_write", path)
    # index sidecar (record metas without data): lets a restarting host
    # read only the shard files that contain its slices instead of the
    # whole checkpoint
    index = [
        {k: m[k] for k in ("path", "global_shape", "dtype", "index")}
        for m in payload["records"]
    ]
    storage.write_state_dict(index, path + ".idx")
    faults.fire("ckpt.done_write")
    done = os.path.join(
        step_dir(checkpoint_dir, step), DONE_DIR, f"{gid}.done"
    )
    record = {
        "global_shard_num": payload["global_shard_num"],
        "crc32": crc,
        "nbytes": nbytes,
    }
    step_meta = (payload.get("extra") or {}).get("step_meta")
    if step_meta:
        # what the writer ran under (read_step_meta): small, and read
        # without the shard's bytes
        record["step_meta"] = step_meta
    storage.write(json.dumps(record), done)


def read_step_meta(storage, checkpoint_dir: str, step: int) -> Dict:
    """The ``step_meta`` a persisted step's writers recorded in their
    done files (the first that has one), ``{}`` when none did."""
    ddir = os.path.join(step_dir(checkpoint_dir, step), DONE_DIR)
    try:
        names = sorted(storage.listdir(ddir))
    except OSError:
        return {}
    for name in names:
        if name.endswith(".done"):
            meta = parse_done(storage.read(os.path.join(ddir, name))).get("step_meta")
            if meta:
                return dict(meta)
    return {}


def verify_step_dir(
    storage, checkpoint_dir: str, step: int, deep: bool = True
) -> Tuple[bool, str]:
    """Integrity check of one persisted step: every advertised shard's
    done file present, every shard file's bytes matching the crc32/length
    its done file recorded (torn writes and bit flips both fail here),
    legacy shards at least structurally loadable. Returns (ok, reason).

    ``deep=False`` checks completeness + file lengths only (metadata
    reads, no full-blob crc) — the cheap mode for the many restore
    ranks that do NOT own repair; the repairing rank (global shard 0)
    runs the deep pass once for the job, so a bit flip is still caught,
    quarantined and rolled back before anyone restores it."""
    sdir = step_dir(checkpoint_dir, step)
    done_dir = os.path.join(sdir, DONE_DIR)
    done_files = [
        f for f in storage.listdir(done_dir) if f.endswith(".done")
    ]
    if not done_files:
        return False, "no shard done files (commit never completed)"
    metas: Dict[int, Dict] = {}
    for fname in done_files:
        try:
            gid = int(fname[: -len(".done")])
        except ValueError:
            continue
        metas[gid] = parse_done(
            storage.read(os.path.join(done_dir, fname))
        )
    if not metas:
        return False, "unparseable done files"
    expected = max(
        int(m.get("global_shard_num", 1) or 1) for m in metas.values()
    )
    if len(metas) < expected:
        return (
            False,
            f"partial: {len(metas)}/{expected} shard done files",
        )
    for gid, m in sorted(metas.items()):
        path = shard_file(checkpoint_dir, step, gid)
        nbytes = m.get("nbytes")
        if not deep:
            have = storage.size(path)
            if have is None:
                return False, f"shard {gid} file missing"
            if nbytes is not None and have != int(nbytes):
                return (
                    False,
                    f"shard {gid} torn: {have} of {nbytes} bytes",
                )
            continue
        want_crc = m.get("crc32")
        if want_crc is not None:
            # read in chunks where the storage can: the shard need not
            # fit in memory
            got = storage.file_crc32(path)
            if got is None:
                return False, f"shard {gid} file missing"
            if nbytes is not None and got[1] != int(nbytes):
                return False, f"shard {gid} torn: {got[1]} of {nbytes} bytes"
            if got[0] != int(want_crc):
                return False, f"shard {gid} checksum mismatch"
            continue
        blob = storage.read(path)
        if blob is None:
            return False, f"shard {gid} file missing"
        if nbytes is not None and len(blob) != int(nbytes):
            return (
                False,
                f"shard {gid} torn: {len(blob)} of {nbytes} bytes",
            )
        want_crc = m.get("crc32")
        if want_crc is not None:
            if zlib.crc32(blob) != int(want_crc):
                return False, f"shard {gid} checksum mismatch"
            continue
        # legacy done file (no blob crc): structural + per-record checks
        try:
            payload = pickle.loads(blob)
            if int(payload.get("step", -1)) != step:
                return False, f"shard {gid} names step {payload.get('step')}"
            for rec in payload.get("records", []):
                rc = rec.get("crc32")
                if rc is not None and data_crc32(rec["data"]) != rc:
                    return (
                        False,
                        f"shard {gid} record {rec['path']!r} corrupt",
                    )
        except Exception as e:
            return False, f"shard {gid} unreadable: {e!r}"
    return True, "ok"


def quarantine_step_dir(
    storage, checkpoint_dir: str, step: int
) -> Optional[str]:
    """Move a corrupt/partial step dir out of the restore path (rename to
    ``step_N.corrupt[.i]``; forensic copy kept until GC). Falls back to
    deletion on storage without rename. Returns the new path or None."""
    src = step_dir(checkpoint_dir, step)
    if not storage.exists(src):
        return None
    for i in range(32):
        dst = src + QUARANTINE_SUFFIX + (f".{i}" if i else "")
        if storage.exists(dst):
            continue
        try:
            storage.rename(src, dst)
            return dst
        except NotImplementedError:
            storage.safe_rmtree(src)
            return None
        except OSError:
            continue  # concurrent quarantine won the rename
    storage.safe_rmtree(src)
    return None


def gc_checkpoints(
    storage,
    checkpoint_dir: str,
    keep_steps: int = COMMIT_HISTORY_KEEP,
    keep_quarantined: int = QUARANTINE_KEEP,
) -> int:
    """Retention GC: drop quarantined dirs beyond ``keep_quarantined``
    (newest kept for forensics) and committed step dirs beyond the newest
    ``keep_steps``. Steps newer than the tracker (in-flight persists) are
    never touched. Returns the number of dirs removed.

    The whole pass runs under ``_tracker_mutex``: the history rewrite at
    the end is a read-modify-write racing concurrent commit threads'
    append-under-mutex — without the lock, a step committed between this
    function's read and its rewrite would silently drop out of the
    rollback set (and its dir be GC'd on a later pass)."""
    with _tracker_mutex:
        hist = known_committed_steps(storage, checkpoint_dir)
        tracker = read_tracker(storage, checkpoint_dir)
        keep = set(hist[-max(1, keep_steps):])
        if tracker >= 0:
            keep.add(tracker)
        removed = 0
        names = storage.listdir(checkpoint_dir)
        quarantined = sorted(n for n in names if QUARANTINE_SUFFIX in n)
        drop_q = max(0, len(quarantined) - max(0, keep_quarantined))
        for n in quarantined[:drop_q]:
            storage.safe_rmtree(os.path.join(checkpoint_dir, n))
            removed += 1
        for n in names:
            if not n.startswith("step_") or QUARANTINE_SUFFIX in n:
                continue
            try:
                s = int(n[len("step_"):])
            except ValueError:
                continue
            if s in keep or s > tracker:
                continue
            storage.safe_rmtree(os.path.join(checkpoint_dir, n))
            removed += 1
        if hist and set(hist) - keep:
            _write_history(
                storage, checkpoint_dir, [s for s in hist if s in keep]
            )
        return removed


def resolve_verified_step(
    storage, checkpoint_dir: str, repair: bool = True,
    deep: Optional[bool] = None,
) -> int:
    """Newest committed step that passes :func:`verify_step_dir`.

    Walks the tracker + history newest-first. A corrupt newest step is
    never silently restored: with ``repair=True`` (exactly one process
    per job should repair — callers gate on shard id 0) the bad dirs are
    quarantined, the tracker is rolled back to the newest verified step,
    and the history drops the quarantined entries. Returns -1 when no
    verifiable checkpoint exists.

    ``deep`` defaults to ``repair``: the repairing rank pays the full
    read+crc pass once per job; the other restore ranks only check
    completeness and file lengths (a checkpoint is many GB and there
    may be many hosts — N× full-checkpoint reads just to pick the
    restore step would swamp restart I/O)."""
    if deep is None:
        deep = repair
    tracker = read_tracker(storage, checkpoint_dir)
    hist = known_committed_steps(storage, checkpoint_dir)
    candidates = sorted(
        {s for s in hist + [tracker] if s >= 0}, reverse=True
    )
    good = -1
    bad: List[int] = []
    for s in candidates:
        ok, reason = verify_step_dir(
            storage, checkpoint_dir, s, deep=deep
        )
        if ok:
            good = s
            break
        bad.append(s)
        logger.error(
            f"checkpoint step {s} failed verification: {reason}"
        )
        _metric_counter(
            "dlrover_ckpt_corrupt_steps_total",
            "committed steps that failed load-time verification",
        ).inc()
    if repair and bad:
        for s in bad:
            q = quarantine_step_dir(storage, checkpoint_dir, s)
            if q:
                logger.warning(
                    f"quarantined corrupt checkpoint step {s} -> {q}"
                )
        with _tracker_mutex:
            if read_tracker(storage, checkpoint_dir) > good:
                _metric_counter(
                    "dlrover_ckpt_rollback_total",
                    "tracker rollbacks to an older verified step",
                ).inc()
                if good >= 0:
                    storage.write(
                        str(good),
                        os.path.join(checkpoint_dir, TRACKER_FILE),
                    )
                    logger.warning(
                        f"checkpoint tracker rolled back to verified "
                        f"step {good}"
                    )
                else:
                    storage.safe_remove(
                        os.path.join(checkpoint_dir, TRACKER_FILE)
                    )
                    logger.warning(
                        "no verifiable checkpoint remains; tracker "
                        "cleared"
                    )
            _write_history(
                storage,
                checkpoint_dir,
                [s for s in hist if s not in bad],
            )
    return good


def commit_checkpoint(
    storage,
    checkpoint_dir: str,
    step: int,
    global_shard_num: int,
    timeout: float = 600.0,
    stop_event: Optional[threading.Event] = None,
) -> bool:
    """Wait for all global done files, then atomically publish the tracker.
    Parity: commit_checkpoint ckpt_saver.py:813."""
    done_dir = os.path.join(step_dir(checkpoint_dir, step), DONE_DIR)
    deadline = time.time() + timeout
    done: List[str] = []
    while time.time() < deadline:
        try:
            done = [
                f for f in storage.listdir(done_dir) if f.endswith(".done")
            ]
        except FileNotFoundError:
            done = []
        if len(done) >= global_shard_num:
            # monotonic: concurrent commit threads for different steps must
            # never regress the tracker (read-check-write under a mutex)
            try:
                with _tracker_mutex:
                    faults.fire("ckpt.tracker_write")
                    if step > read_tracker(storage, checkpoint_dir):
                        storage.write(
                            str(step),
                            os.path.join(checkpoint_dir, TRACKER_FILE),
                        )
                    # the rollback set: remember this step as committed
                    # (bounded history; GC keeps dirs and list in sync;
                    # seeded from pre-history step dirs on upgrade)
                    hist = known_committed_steps(storage, checkpoint_dir)
                    if step not in hist:
                        hist.append(step)
                    _write_history(storage, checkpoint_dir, hist)
            except OSError as e:
                # crash-before-tracker scenario: shards + done files are
                # on disk but the step was never published — restore
                # ignores it (not in tracker/history), which is the
                # documented recovery behavior, so fail the commit
                # rather than the saver thread
                logger.error(f"tracker publish for step {step} failed: {e!r}")
                storage.commit(step, False)
                return False
            try:
                gc_checkpoints(storage, checkpoint_dir)
            except Exception as e:
                logger.warning(f"checkpoint GC failed: {e!r}")
            storage.commit(step, True)
            logger.info(f"checkpoint step {step} committed")
            return True
        if stop_event is not None and stop_event.is_set():
            return False
        time.sleep(0.2)
    logger.error(
        f"commit of step {step} timed out: "
        f"{len(done)}/{global_shard_num} shards done"
    )
    storage.commit(step, False)
    return False


@dataclass
class SaveEvent:
    """One training process finished staging one shard into shm."""

    step: int
    checkpoint_dir: str
    local_rank: int
    global_shard_id: int
    global_shard_num: int
    sync: bool = False  # True => also wait for storage persist (storage API)


@dataclass
class _StepState:
    checkpoint_dir: str = ""
    global_shard_num: int = 1
    ranks: Set[int] = field(default_factory=set)
    first_seen: float = 0.0


class AsyncCheckpointSaver:
    """Singleton per agent process; owns shm/IPC servers for all local
    shards and persists them to storage off the training's critical path."""

    _singleton: Optional["AsyncCheckpointSaver"] = None
    _lock = threading.Lock()

    def __init__(
        self,
        local_shard_num: int,
        node_rank: int = 0,
        storage: Optional[CheckpointStorage] = None,
        straggler_timeout: float = 120.0,
    ):
        self.local_shard_num = local_shard_num
        self.node_rank = node_rank
        self.storage = storage or PosixDiskStorage()
        self.straggler_timeout = straggler_timeout
        # -- persist-failure policy (ENOSPC / transient FS errors) -----
        # attempts per persist; between attempts: retention pruning
        # (quarantined + stale step dirs) and full-jitter backoff
        self.persist_retries = 3
        self.persist_backoff_base = 0.5
        self.persist_backoff_cap = 4.0
        # step dirs kept when pruning FOR SPACE (tighter than the
        # steady-state COMMIT_HISTORY_KEEP retention)
        self.retention_steps = 2
        # shm-only "degraded checkpoint mode": entered after a fully
        # retried persist still fails; every later persist is a single
        # cheap probe, and the first success exits the mode
        self._degraded = False
        # reporter(event, message) → the agent wires a master node event
        self._event_reporter: Optional[Callable[[str, str], None]] = None
        self._event_queue = SharedQueue(CKPT_EVENT_QUEUE, create=True)
        self._shm_handlers = [
            ShmHandler(r, create=True) for r in range(local_shard_num)
        ]
        self._shard_locks = [
            SharedLock(shard_lock_name(r), create=True)
            for r in range(local_shard_num)
        ]
        self._steps: Dict[int, _StepState] = {}
        self._persisted_step = -1
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        # event loop and save-at-breakpoint/SIGTERM can race; persists are
        # idempotent but serializing them keeps the logs and locks sane
        self._persist_mutex = threading.Lock()
        # live async commit threads by step (joined bounded on close so a
        # fully-persisted final step doesn't die uncommitted)
        self._commit_threads: Dict[int, threading.Thread] = {}
        # (step, seconds, outcome) of every persist pass, in order
        self.persist_log: List[Tuple[int, float, str]] = []

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @classmethod
    def start_async_saving_ckpt(
        cls,
        local_shard_num: int,
        node_rank: int = 0,
        storage: Optional[CheckpointStorage] = None,
    ) -> "AsyncCheckpointSaver":
        with cls._lock:
            if cls._singleton is None:
                saver = cls(
                    local_shard_num, node_rank=node_rank, storage=storage
                )
                saver._loop_thread = threading.Thread(
                    target=saver._event_loop,
                    name="checkpoint-saver",
                    daemon=True,
                )
                saver._loop_thread.start()
                saver.register_signal_handlers()
                cls._singleton = saver
            return cls._singleton

    @classmethod
    def get_saver(cls) -> Optional["AsyncCheckpointSaver"]:
        return cls._singleton

    @classmethod
    def reset(cls):
        with cls._lock:
            if cls._singleton is not None:
                cls._singleton.close()
                cls._singleton = None

    def close(self, drain_timeout: float = 30.0):
        # drain: anything staged but not yet persisted (queued events the
        # 2s-poll loop has not consumed) must land on storage before the
        # shm segments are unlinked. Commits during drain are bounded — a
        # dead peer node must not stall shutdown for the full 600s.
        try:
            self.save_shm_to_storage(commit_timeout=drain_timeout)
        except Exception as e:
            logger.error(f"drain-on-close persist failed: {e!r}")
        # a persisted final step whose async commit thread is still polling
        # must get its chance to publish the tracker
        deadline = time.time() + drain_timeout
        for step, t in list(self._commit_threads.items()):
            t.join(timeout=max(0.0, deadline - time.time()))
            if t.is_alive():
                logger.warning(
                    f"commit of step {step} still pending at shutdown"
                )
        self._stop.set()
        # the event loop checks _stop only at its poll top: it may have
        # dequeued one last event just before and still be inside
        # _persist_step reading the segments. Closing the handlers
        # unmaps those pages under its shm views (a segfault, not an
        # exception) — hold _persist_mutex so teardown waits the
        # in-flight persist out; a persist starting after this block
        # finds the handlers empty and degrades to a logged skip.
        with self._persist_mutex:
            for h in self._shm_handlers:
                h.close(unlink=True)
            for lk in self._shard_locks:
                lk.close()
        self._event_queue.close()

    def register_signal_handlers(self):
        """SIGTERM (preemption) → persist shm, then previous handler.
        Parity: register_signal_handler ckpt_saver.py:467."""
        if threading.current_thread() is not threading.main_thread():
            return

        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            logger.info("saver got SIGTERM: persisting in-memory checkpoint")
            try:
                self.save_shm_to_storage()
            except Exception as e:
                logger.error(f"SIGTERM persist failed: {e!r}")
            if callable(prev_term):
                prev_term(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------
    def _event_loop(self):
        while not self._stop.is_set():
            try:
                ev = self._event_queue.get(timeout=2.0)
            except TimeoutError:
                ev = None
            except Exception:
                if self._stop.is_set():
                    return
                ev = None
            now = time.time()
            if isinstance(ev, SaveEvent):
                if ev.step <= self._persisted_step:
                    # stale event (e.g. a straggler shard arriving after a
                    # timeout-triggered partial persist) — the trainer
                    # staged under the shard lock and left it held;
                    # discarding without releasing would mark that rank
                    # "saver busy" forever. Only release when the rank's
                    # shm still holds exactly this step: a newer shm step
                    # means the lock was already recycled and may be held
                    # by a *live* staging we must not break.
                    self._release_if_shm_step(ev.local_rank, ev.step)
                    continue
                st = self._steps.setdefault(ev.step, _StepState())
                st.checkpoint_dir = ev.checkpoint_dir
                st.global_shard_num = ev.global_shard_num
                st.first_seen = st.first_seen or now
                st.ranks.add(ev.local_rank)
                for older, ost in self._steps.items():
                    if older < ev.step and ev.local_rank not in ost.ranks:
                        # this rank moved on (its stage of the older step
                        # was aborted): that step cannot complete, and
                        # waiting out the straggler window would hold the
                        # other ranks' shard locks, and their next saves
                        ost.first_seen = now - self.straggler_timeout - 1.0
            # persist any step that is complete (or timed out waiting)
            for step in sorted(list(self._steps)):
                st = self._steps[step]
                # a world smaller than the node (a resize's, or one that
                # left ranks idle) stages fewer shards than it hosts
                complete = len(st.ranks) >= min(
                    self.local_shard_num, st.global_shard_num or self.local_shard_num
                )
                expired = now - st.first_seen > self.straggler_timeout
                if complete or expired:
                    if expired and not complete:
                        logger.warning(
                            f"step {step}: only shards {sorted(st.ranks)} "
                            f"reported; persisting partial node shards"
                        )
                    del self._steps[step]
                    self._persist_step(step, st)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _persist_step(
        self,
        step: int,
        st: _StepState,
        sync_commit: bool = False,
        commit_timeout: float = 600.0,
    ):
        t0 = time.time()
        outcome = "fail"
        failures: Dict[int, str] = {}  # storage errors (retryable)
        corrupt_failures: Dict[int, str] = {}  # shm checksum mismatches
        try:
            with self._persist_mutex:
                if step <= self._persisted_step:
                    # the event loop and a breakpoint (or close) persist
                    # can both take the same shm step; the second finds
                    # it persisted once it has the mutex. Writing it
                    # again would cost a whole persist on the restart
                    # path, so it only hands the shard locks back
                    for r in sorted(st.ranks):
                        self._release_if_shm_step(r, step)
                    logger.info(f"step {step} already persisted")
                    return
                ckpt_dir = st.checkpoint_dir
                # in degraded mode every persist is one cheap probe —
                # the retry/prune dance already ran and failed, and the
                # event loop must keep draining newer shm steps
                attempts = (
                    1 if self._degraded else max(1, self.persist_retries)
                )
                with span("ckpt_persist", step=step):
                    for attempt in range(attempts):
                        failures.clear()
                        corrupt_failures.clear()
                        statuses: Dict[int, Tuple[str, str]] = {}
                        try:
                            faults.fire("ckpt.persist")
                            self.storage.safe_makedirs(
                                step_dir(ckpt_dir, step)
                            )
                            self.storage.safe_makedirs(
                                os.path.join(
                                    step_dir(ckpt_dir, step), DONE_DIR
                                )
                            )
                            with ThreadPoolExecutor(
                                max_workers=max(1, self.local_shard_num),
                                thread_name_prefix="ckpt-shard",
                            ) as pool:
                                futures = {
                                    r: pool.submit(
                                        self._save_shard, step, r, st
                                    )
                                    for r in sorted(st.ranks)
                                }
                                statuses = {
                                    r: f.result()
                                    for r, f in futures.items()
                                }
                        except OSError as e:
                            failures[-1] = repr(e)
                        for r, (status, detail) in statuses.items():
                            if status == "fail":
                                failures[r] = detail
                            elif status == "corrupt":
                                corrupt_failures[r] = detail
                        if not failures and not corrupt_failures:
                            outcome = (
                                "ok"
                                if statuses
                                and all(
                                    s == "ok"
                                    for s, _ in statuses.values()
                                )
                                else "skip"
                            )
                            break
                        if failures:
                            _metric_counter(
                                "dlrover_ckpt_persist_failures_total",
                                "failed checkpoint persist attempts",
                            ).inc()
                        for r, msg in sorted(
                            {**failures, **corrupt_failures}.items()
                        ):
                            logger.error(
                                f"step {step}: shard {r} persist "
                                f"failed: {msg}"
                            )
                        if corrupt_failures or attempt >= attempts - 1:
                            # corruption never heals by retrying; the
                            # last attempt has no follow-up either
                            break
                        # the disk may simply be full: reclaim
                        # quarantined + stale step dirs, back off with
                        # full jitter, try again
                        self._free_space(ckpt_dir)
                        time.sleep(
                            random.uniform(
                                0.0,
                                min(
                                    self.persist_backoff_base
                                    * (2.0 ** attempt),
                                    self.persist_backoff_cap,
                                ),
                            )
                        )
                if outcome == "ok":
                    self._persisted_step = max(self._persisted_step, step)
                    self._exit_degraded(step)
                self.persist_log.append((step, time.time() - t0, outcome))
                logger.info(
                    f"persisted step {step} ({len(st.ranks)} local shards) "
                    f"in {time.time() - t0:.2f}s [{outcome}]"
                )
            if outcome != "ok":
                # fast-fail: a shard whose done file will never arrive
                # must not make commit_checkpoint wait out its full
                # timeout — skip the commit entirely and surface the
                # failure (node event + degraded-mode entry) now.
                # The handoff locks MUST come back too: a failure before
                # _save_shard even ran (ENOSPC at makedirs) would leave
                # the trainer's locks held and turn "degraded shm-only
                # mode" into "no saves ever again". Guarded release: a
                # rank whose shm moved on belongs to a newer staging.
                for r in sorted(st.ranks):
                    self._release_if_shm_step(r, step)
                if corrupt_failures:
                    # shm corruption is NOT a storage failure: entering
                    # shm-only "degraded mode" here would declare the
                    # known-bad copy the job's only checkpoint and point
                    # the operator at the wrong subsystem — report it
                    # as its own incident instead
                    detail = "; ".join(
                        f"shard {r}: {m}"
                        for r, m in sorted(corrupt_failures.items())
                    )
                    _metric_counter(
                        "dlrover_ckpt_shm_corrupt_total",
                        "persists refused because the shared-memory "
                        "checkpoint failed its checksum",
                    ).inc()
                    logger.error(
                        f"step {step}: shm checkpoint corrupt, persist "
                        f"refused: {detail}"
                    )
                    self._report_event(
                        "ckpt_shm_corrupt", f"step {step}: {detail}"
                    )
                if failures:
                    self._note_persist_failure(step, failures)
                return
            # shard locks are free again, and the commit wait normally runs
            # on its own thread: a straggling node must not stall the event
            # loop (newer steps would be skipped for up to the commit
            # timeout). Breakpoint/SIGTERM persists commit synchronously —
            # the process may be about to die.
            if self.node_rank == 0:
                if sync_commit:
                    self._commit_checkpoint(step, st, commit_timeout)
                else:
                    t = threading.Thread(
                        target=self._commit_checkpoint,
                        args=(step, st, commit_timeout),
                        name=f"ckpt-commit-{step}",
                        daemon=True,
                    )
                    # started before close() can see it: joining a
                    # thread not yet started raises
                    t.start()
                    self._commit_threads[step] = t
        except Exception as e:
            # one bad step (disk full, transient FS error) must not kill the
            # saver thread or leave the handoff locks held — that would
            # silently end checkpointing for the rest of the job
            logger.error(f"persist of step {step} failed: {e!r}")
            for r in st.ranks:
                try:
                    self._shard_locks[r].force_release()
                except Exception:
                    pass

    def _save_shard(
        self, step: int, local_rank: int, st: _StepState
    ) -> Tuple[str, str]:
        """shm → one shard file + its done file. The trainer staged under
        the shard lock and left it held; we persist and then force-release
        it, completing the handoff (a trainer save meanwhile is skipped).

        Returns ``(status, detail)``: ``ok``; ``skip`` (no/stale shm —
        nothing to do); ``corrupt`` (shm checksum mismatch — retrying
        cannot help, and the bytes must NOT reach storage); ``fail``
        (storage error — retryable). When shm already holds a NEWER step
        the lock is left alone: it belongs to that step's live handoff,
        and force-releasing it here would break a staging in flight."""
        lock = self._shard_locks[local_rank]
        release = True
        try:
            handler = self._shm_handlers[local_rank]
            try:
                # zero-copy views, verified: the shard lock is ours until
                # the finally, and the views are dropped before it
                shm_step, records, extra = handler.load_records(
                    copy=False, verify=True
                )
            except LookupError:
                logger.warning(f"shard {local_rank}: no shm checkpoint")
                return "skip", "no shm checkpoint"
            except ValueError as e:
                logger.error(f"shard {local_rank}: {e}")
                return "corrupt", str(e)
            if shm_step != step:
                logger.warning(
                    f"shard {local_rank}: shm holds step {shm_step}, "
                    f"wanted {step}; skipping"
                )
                release = shm_step < step
                return "skip", f"shm holds step {shm_step}"
            gid = extra.get("global_shard_id", local_rank)
            crcs = [m.get("crc32") for m in handler.metadata()["records"]]
            payload = build_shard_payload(
                step, gid, st.global_shard_num, records, extra,
                crcs=crcs if None not in crcs else None,
            )
            write_shard_and_done(
                self.storage, st.checkpoint_dir, step, payload
            )
            return "ok", ""
        except Exception as e:
            logger.error(f"shard {local_rank} persist failed: {e!r}")
            return "fail", repr(e)
        finally:
            # no view into the segment outlives the lock
            records = payload = None
            if release:
                lock.force_release()

    # ------------------------------------------------------------------
    # degraded checkpoint mode (shm-only persistence)
    # ------------------------------------------------------------------
    def _free_space(self, ckpt_dir: str):
        try:
            n = gc_checkpoints(
                self.storage,
                ckpt_dir,
                keep_steps=self.retention_steps,
                keep_quarantined=0,
            )
            if n:
                logger.info(
                    f"retention pruning freed {n} checkpoint dirs"
                )
        except Exception as e:
            logger.warning(f"retention pruning failed: {e!r}")

    @property
    def degraded(self) -> bool:
        """True while storage persists are failing and checkpoints live
        only in shm (training continues; a crash in this mode loses
        everything since the last verified storage step)."""
        return self._degraded

    def set_event_reporter(self, reporter: Callable[[str, str], None]):
        """``reporter(event, message)`` — the agent wires this to a
        master node event (``MasterClient.report_failure`` at WARNING
        level) so degraded mode is visible off-host."""
        self._event_reporter = reporter

    def _report_event(self, event: str, message: str):
        reporter = self._event_reporter
        if reporter is None:
            return
        try:
            reporter(event, message)
        except Exception as e:
            logger.warning(f"checkpoint event report failed: {e!r}")

    def _note_persist_failure(self, step: int, failures: Dict[int, str]):
        detail = "; ".join(
            f"shard {r}: {m}" for r, m in sorted(failures.items())
        )
        if not self._degraded:
            self._degraded = True
            _degraded_gauge().set(1.0)
            logger.error(
                f"entering DEGRADED checkpoint mode (shm-only) after "
                f"step {step} persist failure: {detail}"
            )
            self._report_event(
                "ckpt_degraded", f"step {step}: {detail}"
            )
        else:
            # already degraded: one node event per episode is enough —
            # repeats would spam the master at the save cadence
            logger.warning(
                f"still in degraded checkpoint mode: step {step} "
                f"persist probe failed: {detail}"
            )

    def _exit_degraded(self, step: int):
        if not self._degraded:
            return
        self._degraded = False
        _degraded_gauge().set(0.0)
        logger.info(
            f"leaving degraded checkpoint mode: step {step} persisted"
        )
        self._report_event(
            "ckpt_degraded_recovered", f"step {step} persisted"
        )

    def _commit_checkpoint(
        self, step: int, st: _StepState, timeout: float = 600.0
    ):
        try:
            commit_checkpoint(
                self.storage,
                st.checkpoint_dir,
                step,
                st.global_shard_num,
                timeout=timeout,
                stop_event=self._stop,
            )
        finally:
            self._commit_threads.pop(step, None)

    # ------------------------------------------------------------------
    # breakpoint / SIGTERM persistence
    # ------------------------------------------------------------------
    def save_shm_to_storage(
        self, commit_timeout: float = 600.0, sync_commit: bool = True
    ):
        """Persist in-memory checkpoints newer than the last persisted step
        (the workers may be dead already — shm outlives them).

        ``sync_commit``: wait for the global commit before returning. Only
        correct when THIS PROCESS is about to die (SIGTERM, close) — the
        commit needs done files from every node, and after a hard node
        death those never come, so a synchronous wait burns the whole
        timeout. Membership-change restarts keep the agent alive: pass
        False there and the commit completes (or times out) on its own
        thread while the node re-rendezvouses (found by the chaos soak:
        survivors stalled 600s on every peer death)."""
        steps: Dict[int, _StepState] = {}
        for r, handler in enumerate(self._shm_handlers):
            if handler.no_checkpoint():
                continue
            meta = handler.metadata()
            step = int(meta.get("step", -1))
            extra = meta.get("extra", {})
            if step <= self._persisted_step or not extra.get(
                "checkpoint_dir"
            ):
                continue
            st = steps.setdefault(step, _StepState())
            st.checkpoint_dir = extra["checkpoint_dir"]
            st.global_shard_num = int(extra.get("global_shard_num", 1))
            st.ranks.add(r)
        for step, st in sorted(steps.items()):
            logger.info(f"save-at-breakpoint: persisting shm step {step}")
            self._persist_step(
                step, st,
                sync_commit=sync_commit,
                commit_timeout=commit_timeout,
            )

    def _release_if_shm_step(self, local_rank: int, step: int):
        """Free ``local_rank``'s shard lock iff its shm still holds exactly
        ``step`` (i.e. the lock belongs to that completed, now-obsolete
        staging and nothing newer has recycled it)."""
        try:
            handler = self._shm_handlers[local_rank]
            if handler.no_checkpoint():
                return
            shm_step = int(handler.metadata().get("step", -1))
            if shm_step == step:
                self._shard_locks[local_rank].force_release()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # worker-restart reset
    # ------------------------------------------------------------------
    def reset_shared_memory(self):
        """Release shard locks orphaned by dead workers.

        Parity: ckpt_saver.py:527 ``reset_shared_memory``. A trainer
        killed mid-staging leaves its shard lock held; without this, every
        save after the restart returns False ('saver busy') forever. The
        agent calls this on its worker-restart path, after the workers are
        stopped and ``save_shm_to_storage`` has persisted anything staged.

        Holding ``_persist_mutex`` (not just probing it) makes this safe
        against an in-flight persist: we wait for it to finish rather than
        yanking locks from under ``_save_shard``'s shm reads, and ranks it
        didn't cover still get their orphaned locks released afterwards.
        The old generation's queued SaveEvents are purged first so the
        event loop cannot later force-release a lock the *new* generation
        holds."""
        purged = 0
        try:
            while True:
                self._event_queue.get(timeout=0.01)
                purged += 1
        except Exception:
            pass
        if purged:
            logger.info(f"purged {purged} stale checkpoint events")
        with self._persist_mutex:
            for lk in self._shard_locks:
                try:
                    lk.force_release()
                except Exception:
                    pass

    @classmethod
    def reset_shared_memory_if_any(cls):
        saver = cls.get_saver()
        if saver is not None:
            saver.reset_shared_memory()
