"""The port's Flash Checkpoint under ElasticTrainer, end to end on the
CPU: the resume drill of ``chip_smoke.py``'s ``flash_ckpt`` phase at a
small size (``tiny()``, batch 4 x 32, a 36-row corpus so the run crosses
an epoch at step 9, ``prefetch=2``, shm saves every 4 steps and disk
saves every 6).

The test process hosts the port's saver, as the agent would; each run
is a fresh training process (``examples/train_gpt2_torch.py``, one torch
thread, so the CPU's matmuls round the same way in every run):

- U: 12 uninterrupted steps;
- A: killed with SIGKILL after step 9's loss (its step-8 save committed);
- B: a fresh process restores step 8 from shm; its losses 9-12 must
  equal U's bit for bit;
- C: after the saver is reset (shm unlinked, as on node loss), a fresh
  process restores the newest verified step on disk of a copy of A's
  directory, taken once the saver has persisted and committed A's newest
  staged step (step 8; the saver persists memory saves too), and its
  losses from there must equal U's bit for bit.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid

import pytest

from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver, read_tracker
from dlrover_tpu_torch.common.storage import PosixDiskStorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "train_gpt2_torch.py")
RUN = [
    "--model", "tiny", "--devices", "cpu", "--threads", "1", "--steps", "12",
    "--batch", "4", "--seq", "32", "--rows", "36", "--prefetch", "2",
    "--save-memory-interval", "4", "--save-storage-interval", "6",
]


@pytest.fixture
def job(monkeypatch):
    """A job of its own (name and socket dir) with the saver hosted in
    this process."""
    sock = tempfile.mkdtemp(prefix="dlr")  # unix socket paths stay short
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    _restart_saver()
    yield
    AsyncCheckpointSaver.reset()
    shutil.rmtree(sock, ignore_errors=True)


def _restart_saver():
    AsyncCheckpointSaver.reset()
    return AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)


def _run(ckpt_dir, events, *extra):
    p = subprocess.run(
        [sys.executable, EXAMPLE, *RUN, "--ckpt-dir", ckpt_dir, "--events", events, *extra],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    with open(events) as f:
        evs = [json.loads(line) for line in f]
    losses = {e["step"]: e["loss"] for e in evs if e["event"] == "loss"}
    restored = next(e for e in evs if e["event"] == "restored")
    saves = next((e["log"] for e in evs if e["event"] == "saves"), [])
    return p, losses, restored, saves


def test_resume_from_shm_and_from_disk_is_bitwise(job, tmp_path):
    p, u, r, saves = _run(str(tmp_path / "u"), str(tmp_path / "u.jsonl"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert sorted(u) == list(range(1, 13)) and r["step"] == -1
    # shm at 4 and 8 (the step-4 stage may be superseded by the disk
    # save at 6 while still in flight), disk at 6 and 12
    ok = {(s["step"], s["kind"]) for s in saves if s["ok"]}
    assert {(6, "storage"), (8, "memory"), (12, "storage")} <= ok, saves

    saver = _restart_saver()  # a new job: the saver's persisted step starts over
    a_dir = str(tmp_path / "a")
    p, a, _, a_saves = _run(a_dir, str(tmp_path / "a.jsonl"), "--kill-after-step", "9")
    assert p.returncode == -signal.SIGKILL, p.stderr[-3000:]
    assert sorted(a) == list(range(1, 10))
    assert all(a[s] == u[s] for s in a)
    # C later reads A's disk state; B goes on writing A's directory. The
    # saver persists and commits A's newest staged step after A's death:
    # copy once that commit has landed, not while its tracker is written
    newest = max(s["step"] for s in a_saves if s["ok"])
    deadline = time.time() + 60
    while time.time() < deadline and (
        read_tracker(PosixDiskStorage(), a_dir) < newest
        or any(t.is_alive() for t in list(saver._commit_threads.values()))
    ):
        time.sleep(0.05)
    c_dir = str(tmp_path / "c")
    shutil.copytree(a_dir, c_dir)
    on_disk = read_tracker(PosixDiskStorage(), c_dir)
    # the newest step A committed to disk is one the saver persisted
    assert (on_disk, "ok") in {(st, oc) for st, _, oc in saver.persist_log}

    p, b, r, _ = _run(a_dir, str(tmp_path / "b.jsonl"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert (r["step"], r["source"]) == (8, "memory")
    assert b == {s: u[s] for s in range(9, 13)}

    _restart_saver()  # node loss: the shm segment is gone
    p, c, r, _ = _run(c_dir, str(tmp_path / "c.jsonl"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert on_disk >= 6 and (r["step"], r["source"]) == (on_disk, "storage")
    assert c == {s: u[s] for s in range(on_disk + 1, 13)}



def test_disk_save_waits_for_a_busy_saver(job, tmp_path):
    """A disk save that finds the saver still persisting an older step
    (it holds the shard lock; the port's saver persists every staged
    step) waits for it instead of being skipped: on several ranks one
    rank's skipped save would leave the others waiting for the step's
    commit."""
    import threading

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    import torch_dist_worker as tdw

    tr = tt.ElasticTrainer(
        tcfg.tiny(), tt.build_optimizer("adamw", lr=1e-2), tdw.Tokens(),
        tt.TrainerConfig(batch_size=4, seq_len=16, report_metrics=False, prefetch=0,
                         ckpt_dir=str(tmp_path / "ck"), save_memory_interval=1000,
                         save_storage_interval=2),
        strategy=Strategy(mesh=MeshConfig(dp=1)), devices="cpu",
    )
    lock = tr._ckptr.engine._lock
    assert lock.acquire(blocking=False)  # the saver's hold while it persists
    release = threading.Timer(0.5, lock.force_release)
    release.start()
    tr.train(2)
    release.join()
    assert [(s["step"], s["kind"], s["ok"]) for s in tr.save_log] == [(2, "storage", True)]
    assert read_tracker(PosixDiskStorage(), str(tmp_path / "ck")) == 2
    tr.close()
