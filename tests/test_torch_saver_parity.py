"""The port's checkpoint saver against the JAX package's, on the CPU:

- the same sequence of ``SaveEvent``s (memory and storage saves
  interleaved), each staged into a saver's own shm, makes both savers
  commit the same steps: every staged step, as the JAX package's saver
  persists it;
- after a node loss (the saver reset, its shm unlinked) a memory save
  that was committed comes back from disk, bit for bit;
- a memory save the trainer tries while the saver holds the shard lock
  is skipped, never queued;
- the event reporter the launcher wires to the master hears degraded
  mode, its recovery and a corrupt shm copy (the JAX package's
  ``tests/test_faults.py`` cases, on torch state).
"""

import os
import shutil
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
from dlrover_tpu_torch.ckpt.saver import (
    AsyncCheckpointSaver,
    SaveEvent,
    known_committed_steps,
    read_tracker,
    shard_file,
)
from dlrover_tpu_torch.ckpt.sharding import host_shard_records
from dlrover_tpu_torch.ckpt.shm_handler import ShmHandler
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.storage import PosixDiskStorage

# memory (False) and storage (True) saves, interleaved
EVENTS = [(2, False), (3, True), (4, False), (5, False), (6, True), (8, False)]


@pytest.fixture
def job(monkeypatch):
    """A job name and socket dir of its own, and no saver yet."""
    sock = tempfile.mkdtemp(prefix="dlr")  # unix socket paths stay short
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    AsyncCheckpointSaver.reset()
    yield monkeypatch
    AsyncCheckpointSaver.reset()
    faults.reset()
    shutil.rmtree(sock, ignore_errors=True)


@pytest.fixture
def saver(job):
    yield AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)


def _wait(pred, timeout=30.0, what="timed out"):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.05)


def _drive(pkg, ckpt_dir):
    """Stage each of ``EVENTS`` into a fresh saver of package ``pkg``
    (``dlrover_tpu`` or ``dlrover_tpu_torch``) as a trainer does: take
    the shard lock, write shm, send the event; wait until the saver
    hands the lock back. Each step's commit runs on a thread of its own
    and publishes to the history in the order the threads get there, so
    the next step is staged only once this one is committed: the
    history's order is then the staging order in both packages. A step
    counts as committed once the history holds it: a commit writes the
    tracker first and the history after it, so a tracker that names the
    step may still come with a history that lacks it. Returns the steps
    committed on disk."""
    import importlib

    saver_mod = importlib.import_module(f"{pkg}.ckpt.saver")
    shm_mod = importlib.import_module(f"{pkg}.ckpt.shm_handler")
    mp = importlib.import_module(f"{pkg}.common.multi_process")
    sharding = importlib.import_module(f"{pkg}.ckpt.sharding")
    storage = importlib.import_module(f"{pkg}.common.storage")
    saver_mod.AsyncCheckpointSaver.reset()
    saver = saver_mod.AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    writer = shm_mod.ShmHandler(0, create=False)
    lock = mp.SharedLock(saver_mod.shard_lock_name(0), create=False)
    queue = mp.SharedQueue(saver_mod.CKPT_EVENT_QUEUE, create=False)
    try:
        for step, sync in EVENTS:
            _wait(lambda: lock.acquire(blocking=False))
            writer.save_records(
                step, sharding.host_shard_records({"w": np.arange(8.0) * step}),
                {"checkpoint_dir": ckpt_dir, "global_shard_id": 0,
                 "global_shard_num": 1},
            )
            queue.put(saver_mod.SaveEvent(
                step=step, checkpoint_dir=ckpt_dir, local_rank=0,
                global_shard_id=0, global_shard_num=1, sync=sync))
            _wait(lambda: step in saver_mod.known_committed_steps(
                storage.PosixDiskStorage(), ckpt_dir),
                what=f"{pkg}: step {step} never committed")
        last = EVENTS[-1][0]
        _wait(lambda: saver_mod.read_tracker(storage.PosixDiskStorage(), ckpt_dir) == last)
        return saver_mod.known_committed_steps(storage.PosixDiskStorage(), ckpt_dir)
    finally:
        writer.close()
        saver_mod.AsyncCheckpointSaver.reset()


def test_port_commits_the_same_steps_as_the_jax_package(job, tmp_path):
    got = {}
    for pkg in ("dlrover_tpu", "dlrover_tpu_torch"):
        job.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
        got[pkg] = _drive(pkg, str(tmp_path / pkg))
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    # every staged step, memory saves included
    assert sorted(got["dlrover_tpu"]) == [s for s, _ in EVENTS]


def test_a_commit_slow_to_write_its_history_is_waited_for(job, tmp_path, monkeypatch):
    """Between a commit's tracker write and its history write a loaded
    host can stall; the drive must still see every staged step (it once
    read the history in that window and missed the last step)."""
    from dlrover_tpu_torch.ckpt import saver as saver_mod

    write = saver_mod._write_history

    def slow(*args, **kw):
        time.sleep(0.3)
        return write(*args, **kw)

    monkeypatch.setattr(saver_mod, "_write_history", slow)
    assert _drive("dlrover_tpu_torch", str(tmp_path / "ck")) == [s for s, _ in EVENTS]


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(16, 8, generator=g),
            "codes": torch.randint(-127, 128, (4, 128), generator=g, dtype=torch.int8),
            "step": np.int32(seed)}


def _zeros_like(state):
    return {"w": torch.zeros(16, 8), "codes": torch.zeros(4, 128, dtype=torch.int8),
            "step": np.int32(0)}


def test_memory_save_restores_from_disk_after_node_loss(saver, tmp_path):
    d = str(tmp_path / "ck")
    engine = CheckpointEngine()
    assert engine._agent_mode
    assert engine.save_to_storage(3, _state(3), d, timeout=30)
    state = _state(7)
    assert engine.save_to_memory(7, state, d)
    _wait(lambda: read_tracker(PosixDiskStorage(), d) == 7)
    engine.close()
    # node loss: the agent dies with its shm, a new agent starts
    AsyncCheckpointSaver.reset()
    AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    fresh = CheckpointEngine()
    step, got = fresh.load(_zeros_like(state), d)
    assert (step, fresh.last_load_source) == (7, "storage")
    assert torch.equal(got["w"], state["w"]) and torch.equal(got["codes"], state["codes"])
    assert int(got["step"]) == 7
    fresh.close()


def test_memory_save_is_skipped_while_the_saver_holds_the_lock(saver, tmp_path):
    d = str(tmp_path / "ck")
    engine = CheckpointEngine()
    # the saver's persist holds the shard lock: a save meanwhile is
    # skipped, not queued behind it
    assert saver._shard_locks[0].acquire(blocking=False)
    assert not engine.save_to_memory(4, _state(4), d)
    saver._shard_locks[0].force_release()
    assert engine.save_to_memory(5, _state(5), d)
    _wait(lambda: read_tracker(PosixDiskStorage(), d) == 5)
    assert known_committed_steps(PosixDiskStorage(), d) == [5]
    engine.close()


def test_a_step_is_persisted_once_when_two_paths_take_it(saver, tmp_path):
    """The event loop and a breakpoint persist waiting for the same step:
    the second finds it persisted and writes nothing."""
    import threading

    d = str(tmp_path / "ck")
    writer = ShmHandler(0, create=False)
    with saver._persist_mutex:  # a persist in flight
        assert saver._shard_locks[0].acquire(blocking=False)
        writer.save_records(
            5, host_shard_records({"w": np.arange(16.0)}),
            {"checkpoint_dir": d, "global_shard_id": 0, "global_shard_num": 1},
        )
        saver._event_queue.put(SaveEvent(step=5, checkpoint_dir=d, local_rank=0,
                                         global_shard_id=0, global_shard_num=1))
        time.sleep(0.5)  # the event loop now waits for the mutex
        hook = threading.Thread(target=saver.save_shm_to_storage,
                                kwargs={"sync_commit": False})
        hook.start()
        time.sleep(0.2)
    hook.join(timeout=30)
    _wait(lambda: read_tracker(PosixDiskStorage(), d) == 5)
    _wait(lambda: saver._shard_locks[0].acquire(blocking=False))
    saver._shard_locks[0].force_release()
    assert [oc for st, _, oc in saver.persist_log if st == 5] == ["ok"]
    writer.close()


class TestEventReporter:
    def test_degraded_mode_and_recovery_are_reported(self, saver, tmp_path):
        events = []
        saver.set_event_reporter(lambda ev, msg: events.append((ev, msg)))
        saver.persist_backoff_base = saver.persist_backoff_cap = 0.01
        d = str(tmp_path / "ck")
        engine = CheckpointEngine()
        faults.configure("ckpt.persist:enospc:1.0")
        assert engine.save_to_memory(1, _state(1), d)
        _wait(lambda: saver.degraded)
        assert events and events[0][0] == "ckpt_degraded"
        assert read_tracker(PosixDiskStorage(), d) == -1
        faults.reset()
        # shm-only saves go on while degraded; the first healthy
        # persist leaves the mode and reports it
        _wait(lambda: engine.save_to_memory(2, _state(2), d))
        _wait(lambda: not saver.degraded)
        assert "ckpt_degraded_recovered" in {e for e, _ in events}
        _wait(lambda: read_tracker(PosixDiskStorage(), d) == 2)
        engine.close()

    def test_corrupt_shm_is_reported_and_not_persisted(self, saver, tmp_path):
        events = []
        saver.set_event_reporter(lambda ev, msg: events.append((ev, msg)))
        d = str(tmp_path / "ck")
        writer = ShmHandler(0, create=False)
        assert saver._shard_locks[0].acquire(blocking=False)
        faults.configure("ckpt.shm_stage:bit_flip:1.0:21")
        writer.save_records(
            2, host_shard_records({"w": np.arange(16.0)}),
            {"checkpoint_dir": d, "global_shard_id": 0, "global_shard_num": 1},
        )
        faults.reset()
        saver._event_queue.put(SaveEvent(step=2, checkpoint_dir=d, local_rank=0,
                                         global_shard_id=0, global_shard_num=1))
        _wait(lambda: events)
        assert events[0][0] == "ckpt_shm_corrupt" and not saver.degraded
        assert not os.path.exists(shard_file(d, 2, 0))
        writer.close()

    def test_a_failing_reporter_does_not_stop_the_saver(self, saver, tmp_path):
        def boom(ev, msg):
            raise ConnectionError("master unreachable")

        saver.set_event_reporter(boom)
        saver.persist_backoff_base = saver.persist_backoff_cap = 0.01
        d = str(tmp_path / "ck")
        engine = CheckpointEngine()
        faults.configure("ckpt.persist:enospc:1.0")
        assert engine.save_to_memory(1, _state(1), d)
        _wait(lambda: saver.degraded)
        faults.reset()
        _wait(lambda: engine.save_to_memory(2, _state(2), d))
        _wait(lambda: read_tracker(PosixDiskStorage(), d) == 2)
        engine.close()
