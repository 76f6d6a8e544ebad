"""The checkpoint stager on the card: its host-link grants, and the
compute stream left free beside its copies. Marked ``cuda``; on a host
without a card the tests skip (the stager's CPU-side grants are tested
in ``tests/test_torch_link_arbitration.py``).

A state with a device leg and host leaves: the device leg takes one
``ckpt_stage`` grant and holds it until its copies' fence has passed,
and the host leaves ride that grant. Asking for a second grant while the
first is held would wait for itself until the arbiter's forced grant
(30 s): the stage must take exactly one grant, wait for none and force
none."""

import contextlib
import shutil
import tempfile
import time
import uuid

import pytest
import torch

from dlrover_tpu_torch.parallel import transfer_sched as ts

pytestmark = pytest.mark.cuda


@contextlib.contextmanager
def _saver(monkeypatch):
    """A saver in this process (its own socket dir and job name) and a
    fresh arbiter; yields the arbiter."""
    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

    sock = tempfile.mkdtemp(prefix="dlr")
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"l{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    arb = ts.TransferArbiter(aging_s=0.2, enabled=True)
    ts.set_arbiter(arb)
    AsyncCheckpointSaver.reset()
    AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    try:
        yield arb
    finally:
        AsyncCheckpointSaver.reset()
        ts.set_arbiter(None)
        shutil.rmtree(sock, ignore_errors=True)


def test_device_leg_and_host_leaves_take_one_grant(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device leg's copies and their fence")
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine

    with _saver(monkeypatch) as arb:
        engine = CheckpointEngine()
        w = torch.randn(1 << 20, device="cuda")
        st = engine.begin_chunked_save(1, {"w": w, "host": torch.arange(64.0), "step": 3},
                                       str(tmp_path))
        assert st.commit()
        assert st.grant_wait_s < 1.0 and arb.forced_grants == 0
        assert arb.register("ckpt_stage").grants == 1
        assert arb.rails()[0].holder is None  # given back once the fence passed
        engine.close()


def test_a_stage_after_an_item_leaves_the_compute_stream_free(monkeypatch, tmp_path):
    """A loop reads its loss with ``item()`` (a card-to-host copy on the
    compute stream) and then stages: the compute stream must pass the
    point after ``begin`` while the stage's copies still run, not after
    the last of them (it waited for all of them before the stager's
    tick)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy engine's queue")
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine

    with _saver(monkeypatch):
        engine = CheckpointEngine()
        state = {f"w{i}": torch.randn(16 << 20, device="cuda") for i in range(32)}  # 2 GiB
        for _ in range(2):  # the first stage pins the segment
            deadline = time.monotonic() + 30.0  # the saver gives the lock back
            while not engine._lock.acquire(blocking=False):
                assert time.monotonic() < deadline, "the shard lock stayed held"
                time.sleep(0.01)
            engine._lock.force_release()
            loss = torch.randn((), device="cuda")
            loss.item()
            st = engine.begin_chunked_save(1, state, str(tmp_path))
            after = torch.cuda.Event(enable_timing=True)
            after.record()
            assert st.commit()
            torch.cuda.synchronize()
            copies_ms = st._copy_start.elapsed_time(st.copy_done)
            past_ms = st._copy_start.elapsed_time(after)
            assert past_ms < 0.5 * copies_ms, (past_ms, copies_ms)
        engine.close()
