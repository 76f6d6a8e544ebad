"""The port's Flash Checkpoint on the CPU: real shm, real unix-socket
IPC, real saver threads (the JAX package's tests/test_flash_checkpoint.py
classes, on torch state), quarantine and rollback after a corrupted
byte, and two checks against the JAX package: a step directory the port
writes passes the JAX package's own verification, and a checkpoint the
JAX package writes reads back through the port's reader byte for byte.
"""

import os
import shutil
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ckpt.checkpointer import FlashCheckpointer, StorageType
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
from dlrover_tpu_torch.ckpt.saver import (
    TRACKER_FILE,
    AsyncCheckpointSaver,
    SaveEvent,
    shard_file,
    step_dir,
)
from dlrover_tpu_torch.ckpt.sharding import (
    ShardRecord,
    assemble_leaf,
    host_shard_records,
    restore_state,
)
from dlrover_tpu_torch.ckpt.shm_handler import ShmCrcError, ShmHandler
from dlrover_tpu_torch.common import faults


@pytest.fixture
def job(monkeypatch):
    """A job name and socket dir of its own (no saver)."""
    sock = tempfile.mkdtemp(prefix="dlr")  # unix socket paths stay short
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    AsyncCheckpointSaver.reset()
    yield
    AsyncCheckpointSaver.reset()
    faults.reset()
    shutil.rmtree(sock, ignore_errors=True)


@pytest.fixture
def saver(job):
    yield AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 8, generator=g),
        "codes": torch.randint(-127, 128, (4, 128), generator=g, dtype=torch.int8),
        "step": np.int32(7),
        "sampler": {"epoch": 1, "completed_num": 24},
    }


def _zeros_like(state):
    return {
        "w": torch.zeros(16, 8),
        "codes": torch.zeros(4, 128, dtype=torch.int8),
        "step": np.int32(0),
        "sampler": {"epoch": 0, "completed_num": 0},
    }


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "timed out"
        time.sleep(0.05)


def _assert_state_equal(got, want):
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["codes"], want["codes"])
    assert int(got["step"]) == int(want["step"])
    assert {k: int(v) for k, v in got["sampler"].items()} == want["sampler"]


class TestShardRecords:
    def test_paths_are_the_sorted_key_paths(self):
        recs = host_shard_records(_state())
        assert [r.path for r in recs] == [
            "codes", "sampler/completed_num", "sampler/epoch", "step", "w"
        ]
        w = next(r for r in recs if r.path == "w")
        assert w.index == ((0, 16), (0, 8)) and w.dtype == "float32"

    def test_bfloat16_raises_naming_the_record(self):
        with pytest.raises(ValueError, match="'params/w'.*bfloat16"):
            host_shard_records({"params": {"w": torch.zeros(2, dtype=torch.bfloat16)}})

    def test_assemble_roundtrip_any_resharding(self):
        recs = [
            ShardRecord("w", (16,), "float32", ((i * 2, i * 2 + 2),),
                        np.arange(i * 2, i * 2 + 2, dtype=np.float32))
            for i in range(8)
        ]
        out = assemble_leaf((16,), "float32", ((4, 12),), recs)
        np.testing.assert_array_equal(out, np.arange(4, 12, dtype=np.float32))

    def test_assemble_detects_holes(self):
        recs = [ShardRecord("w", (4,), "float32", ((0, 2),), np.zeros(2, np.float32))]
        with pytest.raises(ValueError):
            assemble_leaf((4,), "float32", ((0, 4),), recs)

    def test_restore_copies_into_the_existing_tensors(self):
        state = _state()
        by_path = {r.path: [r] for r in host_shard_records(state)}
        target = _zeros_like(state)
        w = target["w"]
        out = restore_state(target, lambda p: by_path[p])
        assert out["w"] is w  # the same tensor, filled in place
        _assert_state_equal(out, {**state, "sampler": state["sampler"]})

    def test_restore_refuses_a_shape_mismatch(self):
        by_path = {r.path: [r] for r in host_shard_records(_state())}
        target = {**_zeros_like(None), "w": torch.zeros(8, 16)}
        with pytest.raises(ValueError, match="'w'"):
            restore_state(target, lambda p: by_path[p])


class TestShmHandler:
    def test_write_read_roundtrip(self, saver):
        writer = ShmHandler(0, create=False)
        writer.save_records(3, host_shard_records({"a": np.arange(10.0)}), {"checkpoint_dir": "/x"})
        step, out, extra = writer.load_records()
        assert step == 3
        np.testing.assert_array_equal(out[0].data, np.arange(10.0))
        assert extra["checkpoint_dir"] == "/x"
        writer.close()

    def test_crc_error_names_the_record(self, saver):
        writer = ShmHandler(0, create=False)
        faults.configure("ckpt.shm_stage:bit_flip:1.0:3")
        writer.save_records(3, host_shard_records({"a": np.arange(10.0)}), {})
        faults.reset()
        with pytest.raises(ShmCrcError) as e:
            writer.load_records(verify=True)
        assert e.value.record == "a"
        writer.close()


class TestEngineWithSaver:
    def test_memory_save_stays_in_shm(self, saver, tmp_path):
        """A memory save stays in shm for a restart to find, and the
        saver persists it to disk as well (lock released after), as the
        JAX package's saver persists every staged step."""
        d = str(tmp_path / "ck")
        engine = CheckpointEngine()
        assert engine._agent_mode
        assert engine.save_to_memory(10, _state(), d)
        _wait(lambda: engine._lock.acquire(blocking=False))
        engine._lock.force_release()
        assert engine._shm.metadata()["step"] == 10
        _wait(lambda: os.path.exists(os.path.join(d, TRACKER_FILE)))
        assert open(os.path.join(d, TRACKER_FILE)).read().strip() == "10"
        assert saver.persist_log[-1][0] == 10 and saver.persist_log[-1][2] == "ok"
        engine.close()

    def test_storage_save_persists_and_commits(self, saver, tmp_path):
        d = str(tmp_path / "ck")
        engine = CheckpointEngine()
        assert engine.save_to_storage(10, _state(), d, timeout=30)
        assert open(os.path.join(d, TRACKER_FILE)).read().strip() == "10"
        assert os.path.exists(shard_file(d, 10, 0))
        assert saver.persist_log[-1][0] == 10 and saver.persist_log[-1][2] == "ok"
        engine.close()

    def test_load_prefers_memory_then_storage(self, saver, tmp_path):
        d = str(tmp_path / "ck")
        engine = CheckpointEngine()
        state = _state()
        assert engine.save_to_storage(5, state, d, timeout=30)
        newer = _state(seed=1)
        newer["step"] = np.int32(9)
        assert engine.save_to_memory(9, newer, d)
        _wait(lambda: engine._lock.acquire(blocking=False))
        engine._lock.force_release()
        step, got = engine.load(_zeros_like(state), d)
        assert (step, engine.last_load_source) == (9, "memory")
        _assert_state_equal(got, newer)
        # a fresh process after node loss: no valid shm. The saver
        # persisted the memory save too, so the disk holds step 9
        _wait(lambda: os.path.exists(os.path.join(d, TRACKER_FILE))
              and open(os.path.join(d, TRACKER_FILE)).read().strip() == "9")
        saver._shm_handlers[0]._meta.set("valid", False)
        step, got = engine.load(_zeros_like(state), d)
        assert (step, engine.last_load_source) == (9, "storage")
        _assert_state_equal(got, newer)
        engine.close()

    def test_shm_of_another_directory_is_not_restored(self, saver, tmp_path):
        engine = CheckpointEngine()
        assert engine.save_to_memory(9, _state(), str(tmp_path / "other"))
        _wait(lambda: engine._lock.acquire(blocking=False))
        engine._lock.force_release()
        assert engine.load(_zeros_like(None), str(tmp_path / "ck")) == (-1, None)
        engine.close()

    def test_save_at_breakpoint_persists_unsaved_shm(self, saver, tmp_path):
        d = str(tmp_path / "ck")
        writer = ShmHandler(0, create=False)
        writer.save_records(
            9, host_shard_records({"a": np.arange(4.0)}),
            {"checkpoint_dir": d, "global_shard_id": 0, "global_shard_num": 1},
        )
        saver.save_shm_to_storage()
        assert os.path.exists(shard_file(d, 9, 0))
        assert open(os.path.join(d, TRACKER_FILE)).read() == "9"
        writer.close()

    def test_stale_event_releases_shard_lock(self, saver, tmp_path):
        saver._persisted_step = 50
        eng = CheckpointEngine()
        assert eng._lock.acquire(blocking=False)
        eng._shm.save_records(50, host_shard_records({"w": np.arange(4.0)}), {"checkpoint_dir": str(tmp_path)})
        eng._queue.put(SaveEvent(step=50, checkpoint_dir=str(tmp_path), local_rank=0,
                                 global_shard_id=0, global_shard_num=1, sync=True))
        _wait(lambda: eng._lock.acquire(blocking=False), timeout=10)
        eng._lock.force_release()
        eng.close()

    def test_a_rank_that_moved_on_frees_the_older_step(self, job, tmp_path, monkeypatch):
        """Two local ranks: rank 0 staged step 2, rank 1 aborted its stage
        of step 2 and staged step 4. Step 2 cannot complete, so the saver
        gives it up at once (well inside its 120 s straggler window) and
        hands rank 0's shard lock back for its next save."""
        AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=2)
        d = str(tmp_path)
        engines = []
        for r in (0, 1):
            monkeypatch.setenv("DLROVER_TPU_LOCAL_RANK", str(r))
            engines.append(CheckpointEngine())
        for eng, step, r in ((engines[0], 2, 0), (engines[1], 4, 1)):
            assert eng._lock.acquire(blocking=False)
            eng._shm.save_records(step, host_shard_records({"w": np.arange(4.0)}),
                                  {"checkpoint_dir": d, "global_shard_id": r,
                                   "global_shard_num": 2})
            eng._queue.put(SaveEvent(step=step, checkpoint_dir=d, local_rank=r,
                                     global_shard_id=r, global_shard_num=2))
        _wait(lambda: engines[0]._lock.acquire(blocking=False), timeout=20)
        engines[0]._lock.force_release()
        for eng in engines:
            eng.close()

    def test_reset_shared_memory_frees_orphaned_locks(self, saver):
        eng = CheckpointEngine()
        assert eng._lock.acquire(blocking=False)
        saver.reset_shared_memory()
        assert eng._lock.acquire(blocking=False)
        eng._lock.force_release()
        eng.close()


class TestCheckpointerNoAgent:
    def test_sync_fallback_without_agent(self, job, tmp_path):
        ckptr = FlashCheckpointer(str(tmp_path / "ck"))
        assert not ckptr.engine._agent_mode
        state = _state()
        assert ckptr.save_checkpoint(4, state, StorageType.DISK)
        step, got = ckptr.load_checkpoint(_zeros_like(state))
        assert step == 4
        _assert_state_equal(got, state)


class TestChunkedStaging:
    def _big(self):
        state = _state()
        state["big"] = torch.from_numpy(np.random.default_rng(3).standard_normal(16384).astype(np.float32))
        return state

    def test_chunked_commit_bitwise_identical_to_sync(self, saver, tmp_path):
        engine = CheckpointEngine()
        state = self._big()
        assert engine.save_to_memory(1, state, str(tmp_path / "sync"))
        _, recs, _ = engine._shm.load_records(copy=True)
        sync_bytes = {r.path: r.data.tobytes() for r in recs}
        _wait(lambda: engine._lock.acquire(blocking=False))
        engine._lock.force_release()
        stager = engine.begin_chunked_save(2, state, str(tmp_path / "chunk"), chunk_bytes=4096)
        assert stager is not None and engine.staging_in_flight()
        # until commit the metadata stays invalid
        assert not engine._shm.metadata().get("valid")
        while not stager.done:
            stager.advance(budget_s=0.001)
        assert stager.backlog_bytes == 0
        assert stager.chunks_written > len(sync_bytes)  # really chunked
        assert stager.commit()
        assert not engine.staging_in_flight()
        step, recs2, extra = engine._shm.load_records(copy=True, verify=True)
        assert step == 2 and extra["checkpoint_dir"] == str(tmp_path / "chunk")
        assert {r.path: r.data.tobytes() for r in recs2} == sync_bytes
        engine.close()

    def test_snapshot_is_of_begin_time(self, saver, tmp_path):
        """The optimizer updates tensors in place: what begin saw is what
        commits, whatever happens to the state afterwards."""
        engine = CheckpointEngine()
        state = self._big()
        want = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
        stager = engine.begin_chunked_save(3, state, str(tmp_path / "ck"), chunk_bytes=4096)
        state["w"].add_(1.0)
        state["big"].zero_()
        state["sampler"]["completed_num"] = 999
        assert stager.commit()
        _, recs, _ = engine._shm.load_records(copy=True)
        got = {r.path: r.data for r in recs}
        np.testing.assert_array_equal(got["w"], want["w"].numpy())
        np.testing.assert_array_equal(got["big"], want["big"].numpy())
        assert int(got["sampler/completed_num"]) == 24
        engine.close()

    def test_lock_busy_skips(self, saver, tmp_path):
        engine = CheckpointEngine()
        d = str(tmp_path / "ck")
        s1 = engine.begin_chunked_save(1, {"w": torch.arange(32.0)}, d)
        assert s1 is not None
        assert engine.begin_chunked_save(2, {"w": torch.arange(32.0)}, d) is None
        assert s1.commit()
        engine.close()

    def test_abort_releases_lock_and_invalidates(self, saver, tmp_path):
        engine = CheckpointEngine()
        d = str(tmp_path / "ck")
        s1 = engine.begin_chunked_save(1, {"w": torch.arange(64.0)}, d)
        s1.abort()
        assert not engine.staging_in_flight()
        assert engine._shm.no_checkpoint()
        s2 = engine.begin_chunked_save(2, {"w": torch.arange(64.0)}, d)
        assert s2 is not None and s2.commit()
        engine.close()

    def test_link_arbitration_raises(self, saver, tmp_path):
        """The stage takes a host-link class and a stripe floor (the
        arbiter is ported); a class the arbiter does not know raises,
        and gives the shard lock back."""
        engine = CheckpointEngine()
        with pytest.raises(ValueError):
            engine.begin_chunked_save(1, {"w": torch.zeros(2)}, str(tmp_path), priority=7)
        st = engine.begin_chunked_save(
            1, {"w": torch.zeros(2)}, str(tmp_path), priority=0, stripe_min_bytes=1
        )
        assert st is not None and st.commit()
        engine.close()


class TestTrainerStaging:
    def test_a_stage_open_at_a_disk_step_yields_to_the_disk_save(self, saver, tmp_path):
        """A memory save begun one step before a disk save is aborted
        there, not committed: a commit would hand the shard lock to the
        saver just as the disk save asks for it, and the disk save would
        be skipped."""
        from dlrover_tpu_torch.models.config import tiny
        from dlrover_tpu_torch.trainer.elastic.trainer import (
            ElasticTrainer, TrainerConfig, build_optimizer,
        )

        class Tokens:
            data = np.random.default_rng(0).integers(0, 256, (32, 33), dtype=np.int32)

            def __len__(self):
                return len(self.data)

            def __getitem__(self, i):
                return {"x": self.data[i, :-1], "y": self.data[i, 1:]}

        tc = TrainerConfig(batch_size=4, seq_len=32, ckpt_dir=str(tmp_path / "ck"),
                           save_memory_interval=5, save_storage_interval=6)
        tr = ElasticTrainer(tiny(), build_optimizer("adamw"), Tokens(), tc, devices="cpu")
        tr.train(6)
        tr.close()
        assert [(s["step"], s["kind"], s["ok"], s.get("end_step")) for s in tr.save_log] == [
            (5, "memory", False, 6), (6, "storage", True, None)]


class TestQuarantineAndRollback:
    def test_bit_flip_on_disk_rolls_back_to_the_older_step(self, job, tmp_path):
        d = str(tmp_path / "ck")
        ckptr = FlashCheckpointer(d)
        old, new = _state(0), _state(1)
        assert ckptr.save_checkpoint(4, old, StorageType.DISK)
        faults.configure("ckpt.shard_write:bit_flip:1.0")
        assert ckptr.save_checkpoint(8, new, StorageType.DISK)
        faults.reset()
        assert open(os.path.join(d, TRACKER_FILE)).read() == "8"
        step, got = ckptr.load_checkpoint(_zeros_like(old))
        assert step == 4
        _assert_state_equal(got, old)
        assert open(os.path.join(d, TRACKER_FILE)).read() == "4"
        assert not os.path.exists(step_dir(d, 8))
        assert os.path.exists(step_dir(d, 8) + ".corrupt")

    def test_corrupt_shm_falls_back_to_storage(self, saver, tmp_path):
        d = str(tmp_path / "ck")
        engine = CheckpointEngine()
        state = _state()
        assert engine.save_to_storage(5, state, d, timeout=30)
        faults.configure("ckpt.shm_stage:bit_flip:1.0")
        stager = engine.begin_chunked_save(9, _state(1), d)
        assert stager.commit()
        faults.reset()
        _wait(lambda: engine._lock.acquire(blocking=False))
        engine._lock.force_release()
        step, got = engine.load(_zeros_like(state), d)
        assert (step, engine.last_load_source) == (5, "storage")
        _assert_state_equal(got, state)
        engine.close()


class TestStreamedPersist:
    def test_streamed_shard_is_the_pickled_one_and_verifies_in_chunks(self, saver, tmp_path):
        """The saver writes a shard from zero-copy views into shm,
        pickled straight into the file: the bytes (and the done file's
        crc and length) are ``pickle.dumps``'s of the copied records,
        the chunked verification passes, and one flipped byte fails it."""
        import pickle
        import zlib

        from dlrover_tpu_torch.ckpt.saver import build_shard_payload, verify_step_dir
        from dlrover_tpu_torch.common.storage import PosixDiskStorage

        engine = CheckpointEngine()
        d = str(tmp_path / "ck")
        assert engine.save_to_storage(2, _state(), d)
        _, recs, extra = engine._shm.load_records(copy=True)
        want = pickle.dumps(build_shard_payload(2, 0, 1, recs, extra), protocol=pickle.HIGHEST_PROTOCOL)
        with open(shard_file(d, 2, 0), "rb") as f:
            got = f.read()
        assert got == want
        storage = PosixDiskStorage()
        assert storage.file_crc32(shard_file(d, 2, 0), chunk_bytes=1000) == (zlib.crc32(want), len(want))
        assert verify_step_dir(storage, d, 2) == (True, "ok")
        with open(shard_file(d, 2, 0), "r+b") as f:
            f.seek(len(want) // 2)
            b = f.read(1)
            f.seek(len(want) // 2)
            f.write(bytes([b[0] ^ 1]))
        assert verify_step_dir(storage, d, 2) == (False, "shard 0 checksum mismatch")
        engine.close()


    @pytest.mark.parametrize("kind,reason", [("bit_flip", "checksum mismatch"), ("torn_write", "torn")])
    def test_shard_write_faults_corrupt_the_streamed_file(self, job, tmp_path, monkeypatch, kind, reason):
        """``ckpt.shard_write``'s data kinds act on the file the streamed
        writer wrote (no in-memory pickle while a fault is armed), after
        its crc was taken, at the positions ``corrupt`` picks for the
        same bytes; verification then refuses the step."""
        import pickle

        from dlrover_tpu_torch.ckpt.saver import verify_step_dir
        from dlrover_tpu_torch.common.storage import PosixDiskStorage

        streamed = []
        real = PosixDiskStorage.write_pickle

        def spy(self, obj, path):
            streamed.append(path)
            return real(self, obj, path)

        monkeypatch.setattr(PosixDiskStorage, "write_pickle", spy)
        d = str(tmp_path / "ck")
        faults.configure(f"ckpt.shard_write:{kind}:1.0:7")
        assert FlashCheckpointer(d).save_checkpoint(3, _state(), StorageType.DISK)
        faults.reset()
        assert streamed == [shard_file(d, 3, 0)]
        ok, why = verify_step_dir(PosixDiskStorage(), d, 3)
        assert not ok and reason in why
        # the same bytes through ``corrupt`` with the same seeded spec
        faults.configure(f"ckpt.shard_write:{kind}:1.0:7")
        clean = str(tmp_path / "clean")
        faults.reset()
        assert FlashCheckpointer(clean).save_checkpoint(3, _state(), StorageType.DISK)
        with open(shard_file(clean, 3, 0), "rb") as f:
            good = f.read()
        faults.configure(f"ckpt.shard_write:{kind}:1.0:7")
        want = faults.corrupt("ckpt.shard_write", good)
        faults.reset()
        with open(shard_file(d, 3, 0), "rb") as f:
            assert f.read() == want

    def test_a_shard_write_fault_armed_only_by_the_environment_fires(self, job, tmp_path, monkeypatch):
        """A spec in ``DLROVER_TPU_FAULTS`` that nothing loaded yet still
        reaches the shard write, and a spec armed at another site leaves
        the shard intact."""
        from dlrover_tpu_torch.ckpt.saver import verify_step_dir
        from dlrover_tpu_torch.common.storage import PosixDiskStorage

        d = str(tmp_path / "ck")
        faults.reset()
        monkeypatch.setattr(faults, "_env_loaded", False)
        monkeypatch.setenv(faults.ENV_VAR, "ckpt.shard_write:bit_flip:1.0")
        assert FlashCheckpointer(d).save_checkpoint(4, _state(), StorageType.DISK)
        assert verify_step_dir(PosixDiskStorage(), d, 4) == (False, "shard 0 checksum mismatch")
        faults.configure("prefetch.pull:delay:1.0")
        assert FlashCheckpointer(d).save_checkpoint(5, _state(), StorageType.DISK)
        faults.reset()
        assert verify_step_dir(PosixDiskStorage(), d, 5) == (True, "ok")


class TestAgainstTheJaxPackage:
    def test_port_step_dir_passes_the_jax_verification(self, job, tmp_path):
        from dlrover_tpu.ckpt import saver as jsaver
        from dlrover_tpu.common.storage import PosixDiskStorage as JaxStorage

        d = str(tmp_path / "ck")
        assert FlashCheckpointer(d).save_checkpoint(3, _state(), StorageType.DISK)
        assert jsaver.verify_step_dir(JaxStorage(), d, 3) == (True, "ok")
        assert jsaver.resolve_verified_step(JaxStorage(), d, repair=False) == 3

    def test_jax_checkpoint_reads_back_byte_for_byte(self, tmp_path, monkeypatch):
        import jax.numpy as jnp

        from dlrover_tpu.ckpt.checkpointer import FlashCheckpointer as JaxCheckpointer
        from dlrover_tpu.ckpt.checkpointer import StorageType as JaxStorageType
        from dlrover_tpu.ckpt.saver import AsyncCheckpointSaver as JaxSaver

        monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
        monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", tempfile.mkdtemp(prefix="dlr"))
        JaxSaver.reset()  # no agent: the JAX package writes synchronously
        rng = np.random.default_rng(5)
        w = rng.standard_normal((16, 8)).astype(np.float32)
        codes = rng.integers(-127, 128, (4, 128)).astype(np.int8)
        d = str(tmp_path / "jax")
        jstate = {"w": jnp.asarray(w), "codes": jnp.asarray(codes), "step": np.int32(7),
                  "sampler": {"epoch": 1, "completed_num": 24}}
        assert JaxCheckpointer(d).save_checkpoint(2, jstate, JaxStorageType.DISK)
        step, got = FlashCheckpointer(d).load_checkpoint(_zeros_like(None))
        assert step == 2
        assert got["w"].numpy().tobytes() == w.tobytes()
        assert got["codes"].numpy().tobytes() == codes.tobytes()
        assert int(got["step"]) == 7 and int(got["sampler"]["completed_num"]) == 24
