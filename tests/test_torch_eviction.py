"""The eviction drain of the port's ``ElasticTrainer`` against the JAX
package's, on the CPU, and the drain's state machine.

Both trainers train ``tiny(num_layers=1)`` from the same weights (the
JAX trainer's initial params, converted) with the 8-bit AdamW of
``tests/test_torch_train.py``; each is given ``request_eviction`` after
step 3. Both drain at the step boundary, save step 3, set ``evicted``
and write the same eviction keys to the runtime-metrics file; a fresh
trainer of each resumes from step 3 and their next losses agree within
``tests/test_torch_train.py``'s tolerance. Without a saver (plain
``python train.py``) the emergency save's commit writes storage itself.

Then the drain's state machine on the port alone (the cases of
``tests/test_eviction.py``'s ``TestDrainStateMachine``): a deadline that
closes mid-stage aborts the stage and commits nothing; the persist floor
decides whether the drain waits for the agent's saver; a SIGTERM handler
is installed only on the main thread; ``node.preempt`` fires at the step
boundary.
"""

import json
import os
import shutil
import signal
import tempfile
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.accel.strategy import Strategy
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.parallel.mesh import MeshConfig
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import train as ttrain
from dlrover_tpu_torch.models.convert import params_from_jax
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

LOSS_RTOL = 1e-5  # tests/test_torch_train.py
OPT_KW = dict(min_quantized_size=512, group_elems=8192)
EVICT_AT = 3
STEPS = 6


class _Tokens:
    def __init__(self, n=64, seq=32, vocab=256, seed=3):
        self.data = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1), dtype=np.int32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return {"x": self.data[i, :-1], "y": self.data[i, 1:]}


def _tcfg(ckpt_dir, **kw):
    return dict(
        batch_size=4, seq_len=32, ckpt_dir=ckpt_dir, save_memory_interval=2,
        save_storage_interval=10_000, log_interval=2, prefetch=2, eviction_grace_s=20.0, **kw,
    )


def _jax_trainer(ckpt_dir, losses, evict=True):
    tr = None

    def hook(step, m):
        if "loss" in m:
            losses[step] = float(m["loss"])
        if evict and step == EVICT_AT:
            tr.request_eviction(20.0, reason="test")

    tr = jtrainer.ElasticTrainer(
        model_cfg=jcfg.tiny(num_layers=1),
        tx=jtrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW),
        dataset=_Tokens(),
        trainer_cfg=jtrainer.TrainerConfig(**_tcfg(ckpt_dir, speculative_compile=False,
                                                   donation_aware=False)),
        strategy=Strategy(mesh=MeshConfig(dp=1), dtype="float32"),
        devices=list(jax.devices())[:1],
        metrics_hook=hook,
    )
    return tr


def _port_trainer(ckpt_dir, losses, evict=True, jax_params=None, **kw):
    tr = None

    def hook(step, m):
        if "loss" in m:
            losses[step] = float(m["loss"])
        if evict and step == EVICT_AT:
            tr.request_eviction(20.0, reason="test")

    tx = ttrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    cfg = tcfg.tiny(num_layers=1)
    tr = ttrainer.ElasticTrainer(
        cfg, tx, _Tokens(), ttrainer.TrainerConfig(**_tcfg(ckpt_dir, **kw)),
        devices="cpu", metrics_hook=hook,
    )
    if jax_params is not None:
        tr.state = ttrain.state_from_params(params_from_jax(jax_params, cfg), tx)
    return tr


@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """One evicted run and one resumed run of each trainer; every
    parity assertion reads this."""
    tmp = tmp_path_factory.mktemp("evict_parity")
    keys = ("DLROVER_TPU_RUNTIME_METRICS_PATH", "DLROVER_TPU_FLIGHT_DIR",
            "DLROVER_TPU_WORKER_COMMANDS_PATH", "DLROVER_TPU_JOB_NAME")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["DLROVER_TPU_JOB_NAME"] = f"nosaver{uuid.uuid4().hex[:8]}"
    os.environ["DLROVER_TPU_WORKER_COMMANDS_PATH"] = str(tmp / "commands.json")
    out = {}
    try:
        for pkg in ("jax", "port"):
            os.environ["DLROVER_TPU_RUNTIME_METRICS_PATH"] = str(tmp / f"{pkg}_metrics.json")
            os.environ["DLROVER_TPU_FLIGHT_DIR"] = str(tmp / f"{pkg}_flight")
            ck = str(tmp / f"{pkg}_ckpt")
            first, resumed = {}, {}
            if pkg == "jax":
                t = _jax_trainer(ck, first)
                out["jax_params"] = jax.device_get(t.state.params)
            else:
                t = _port_trainer(ck, first, jax_params=out["jax_params"])
            t.train(STEPS)
            with open(os.environ["DLROVER_TPU_RUNTIME_METRICS_PATH"]) as f:
                metrics = json.load(f)
            rec = dict(trainer=t, losses=first, metrics=metrics, step=t.global_step,
                       evicted=t.evicted, flight=os.listdir(os.environ["DLROVER_TPU_FLIGHT_DIR"]),
                       goodput=t._goodput.snapshot().as_dict())
            t._flight.clear_suppression()
            t.close()
            r = (_jax_trainer(ck, resumed, evict=False) if pkg == "jax"
                 else _port_trainer(ck, resumed, evict=False))
            rec["resumed_from"] = r.global_step
            r.train(STEPS)
            r.close()
            rec["resumed"] = resumed
            out[pkg] = rec
        yield out
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_both_drain_at_the_step_boundary(drained):
    for pkg in ("jax", "port"):
        rec = drained[pkg]
        assert rec["evicted"] is True and rec["step"] == EVICT_AT, pkg
        assert rec["metrics"]["global_step"] == EVICT_AT
        assert any("eviction" in name for name in rec["flight"]), pkg
    assert drained["port"]["trainer"].eviction_report["committed"] is True
    assert drained["port"]["trainer"].eviction_report["persisted"] is True
    assert drained["port"]["goodput"]["eviction"] > 0


def test_same_eviction_keys_in_the_metrics_file(drained):
    j, t = drained["jax"]["metrics"], drained["port"]["metrics"]
    jk = {k for k in j if "evict" in k}
    tk = {k for k in t if "evict" in k}
    assert tk == jk
    assert {"eviction_pending", "eviction_grace_s", "eviction_drain_ms"} <= tk
    for k in ("eviction_pending", "eviction_grace_s"):
        assert t[k] == j[k]
    assert t["eviction_drain_ms"] > 0


def test_losses_agree_before_and_after_the_resume(drained):
    j, t = drained["jax"], drained["port"]
    assert sorted(t["losses"]) == sorted(j["losses"]) == list(range(1, EVICT_AT + 1))
    for s in j["losses"]:
        np.testing.assert_allclose(t["losses"][s], j["losses"][s], rtol=LOSS_RTOL)
    assert t["resumed_from"] == j["resumed_from"] == EVICT_AT
    assert sorted(t["resumed"]) == sorted(j["resumed"]) == list(range(EVICT_AT + 1, STEPS + 1))
    for s in j["resumed"]:
        np.testing.assert_allclose(t["resumed"][s], j["resumed"][s], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the drain's state machine (port)
# ---------------------------------------------------------------------------
@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """Metrics, commands and flight files of this test's own."""
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(tmp_path / "m.json"))
    monkeypatch.setenv("DLROVER_TPU_WORKER_COMMANDS_PATH", str(tmp_path / "c.json"))
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"nosaver{uuid.uuid4().hex[:8]}")
    return tmp_path


class _StuckStager:
    """A stage whose host side never finishes."""

    def __init__(self):
        self.aborted = self.committed = False
        self.done = False
        self.total_bytes, self.block_s, self.timings = 0, 0.0, {}

    def advance(self, budget_s=None, stats=None):
        time.sleep(budget_s or 0)
        return 0

    def commit(self, stats=None):
        self.committed = True
        return True

    def abort(self):
        self.aborted = True


def test_deadline_mid_stage_aborts_and_commits_nothing(isolated):
    t = _port_trainer(str(isolated / "ck"), {}, evict=False)
    stuck = _StuckStager()
    t._ckptr.begin_chunked_save = lambda *a, **k: stuck
    t.request_eviction(0.8, reason="test")
    t.train(STEPS)  # the notice is pending: the loop drains at once
    assert stuck.aborted and not stuck.committed
    rep = t.eviction_report
    assert (rep["committed"], rep["persisted"], rep["step"]) == (False, False, 0)
    assert rep["drain_ms"] < 2000
    assert t._ckptr.latest_verified_step() == -1  # nothing on storage
    assert t.save_log[-1]["kind"] == "eviction" and t.save_log[-1]["ok"] is False
    t._flight.clear_suppression()
    t.close()


@pytest.fixture
def saver_job(isolated, monkeypatch):
    """The agent's saver hosted in this process (a job of its own)."""
    sock = tempfile.mkdtemp(prefix="dlr")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    AsyncCheckpointSaver.reset()
    AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    yield isolated
    AsyncCheckpointSaver.reset()
    shutil.rmtree(sock, ignore_errors=True)


@pytest.mark.parametrize("floor,persisted", [(0.0, True), (1e9, False)],
                         ids=["waits_for_the_saver", "floor_skips_the_persist"])
def test_persist_floor_is_honored(saver_job, floor, persisted):
    t = _port_trainer(str(saver_job / "ck"), {}, eviction_persist_floor_s=floor)
    assert t._ckptr.engine._agent_mode
    t.train(STEPS)
    rep = t.eviction_report
    assert (rep["step"], rep["committed"], rep["persisted"]) == (EVICT_AT, True, persisted)
    assert ("persist_s" in rep) == persisted
    if persisted:
        assert t._ckptr.engine.latest_step(t._ckptr.checkpoint_dir) == EVICT_AT
    t._flight.clear_suppression()
    t.close()


def test_sigterm_handler_only_on_the_main_thread(isolated, monkeypatch):
    # the handler chains to the one before it: start from the default
    # (a saver hosted by an earlier test leaves its own, which re-raises)
    saved = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    before = signal.getsignal(signal.SIGTERM)
    t = _port_trainer("", {}, evict=False)
    box = {}
    th = threading.Thread(target=lambda: box.setdefault("r", t.install_eviction_handler(5.0)))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and "r" in box
    assert signal.getsignal(signal.SIGTERM) is before  # nothing installed
    # on the main thread, the env's deadline installs it and a SIGTERM
    # only sets the flags
    monkeypatch.setenv("DLROVER_TPU_EVICTION_DEADLINE_S", "7")
    t2 = _port_trainer("", {}, evict=False)
    try:
        assert t2.tcfg.eviction_grace_s == 7.0
        assert signal.getsignal(signal.SIGTERM) is not before
        os.kill(os.getpid(), signal.SIGTERM)
        assert t2.eviction_pending and t2._evict_grace_s == 7.0
    finally:
        signal.signal(signal.SIGTERM, saved)
        t.close()
        t2.close()


def test_node_preempt_fires_at_the_step_boundary(isolated):
    # the chaos harness's scripted hard death parses (it would end this
    # process, so it is not armed here)
    assert faults.FaultSpec.parse("node.preempt:kill:@7").nth == 7
    t = _port_trainer("", {}, evict=False)
    faults.configure("node.preempt:io_error:@3")
    try:
        with pytest.raises(OSError, match="node.preempt"):
            t.train(STEPS)
    finally:
        faults.reset()
    assert t.global_step == 2  # two steps done; the third boundary raised
    bundles = os.listdir(isolated / "flight")
    assert any("_crash_" in b for b in bundles)
    t.close()


def test_evict_command_arms_the_drain(isolated):
    from dlrover_tpu_torch.agent.monitor import atomic_write_json

    t = _port_trainer("", {}, evict=False)
    atomic_write_json(str(isolated / "c.json"), {"commands": [
        {"id": t._last_command_id + 1, "kind": "evict", "arg": 7, "reason": "operator"}]})
    t._poll_worker_commands()
    assert t.eviction_pending and t._evict_grace_s == 7.0
    assert t._evict_reason == "master_operator"
    t.close()
    _ = torch  # the port's tensors live on the CPU here
