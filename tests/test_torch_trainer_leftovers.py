"""The trainer loop's leftovers against the JAX package, on the CPU:
early stopping (the port's ``ElasticTrainer`` and the JAX one stop at
the same eval for the same eval losses), and the sparse trainer's
``embedding.export`` / ``embedding.import`` fault sites, its refresh
window booked to the goodput ledger, and the device tier's
``export_metrics(registry=...)`` gauges."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.accel.strategy import Strategy
from dlrover_tpu.common import faults as jfaults
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from dlrover_tpu.ops.embedding import ShardedKvEmbedding as JaxHost
from dlrover_tpu.ops.embedding.device_tier import DeviceSparseEmbedding as JaxEmb
from dlrover_tpu.parallel.mesh import MeshConfig
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu.trainer.sparse import SparseTrainer as JaxSparse
from dlrover_tpu_torch.common import faults as tfaults
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.obs import goodput as tgoodput
from dlrover_tpu_torch.obs.metrics import MetricsRegistry
from dlrover_tpu_torch.obs.trace import SpanTracer
from dlrover_tpu_torch.ops.embedding import DeviceSparseEmbedding, ShardedKvEmbedding
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer
from dlrover_tpu_torch.trainer.sparse import SparseTrainer

DIM = 8


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------
def _stopper(patience):
    return SimpleNamespace(
        _last_eval={}, _run_best_eval_loss=float("inf"), _evals_since_best=0,
        _best_ckptr=None, _best_eval_loss=float("inf"), _last_best_save=0.0,
        tcfg=SimpleNamespace(early_stopping_patience=patience, save_best_min_interval_s=60.0),
    )


@pytest.mark.parametrize("patience", [0, 1, 2, 3])
@pytest.mark.parametrize("losses", [
    [3.0, 2.5, 2.6, 2.7, 2.4, 2.45, 2.5, 2.55],
    [3.0, 3.0, 3.0, 3.0],
    [5.0, 4.0, 3.0, 2.0, 1.0],
])
def test_stop_at_the_same_eval_as_jax(patience, losses):
    stops = {}
    for key, cls in (("j", jtrainer.ElasticTrainer), ("t", ttrainer.ElasticTrainer)):
        me = _stopper(patience)
        stops[key] = None
        for i, loss in enumerate(losses):
            me._last_eval = {"eval_loss": loss}
            if cls._after_eval(me, i + 1):
                stops[key] = i + 1
                break
    assert stops["t"] == stops["j"]
    if patience == 0:
        assert stops["t"] is None


class _Tokens:
    def __init__(self, n=32, seq=32, vocab=256, seed=0):
        self.data = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1), dtype=np.int32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return {"x": self.data[i, :-1], "y": self.data[i, 1:]}


def test_trainers_stop_early_at_the_same_step(tmp_path, monkeypatch):
    """lr 0: every eval gives the same loss, so with patience 2 both stop
    at the third eval."""
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(tmp_path / "m.json"))
    monkeypatch.setenv("DLROVER_TPU_WORKER_COMMANDS_PATH", str(tmp_path / "c.json"))
    kw = dict(batch_size=4, seq_len=32, eval_interval=1, eval_steps=1,
              early_stopping_patience=2, log_interval=100)
    jt = jtrainer.ElasticTrainer(
        model_cfg=jcfg.tiny(num_layers=1), tx=jtrainer.build_optimizer("sgd", lr=0.0),
        dataset=_Tokens(), trainer_cfg=jtrainer.TrainerConfig(speculative_compile=False, **kw),
        strategy=Strategy(mesh=MeshConfig(dp=1), dtype="float32"),
        devices=list(jax.devices())[:1], eval_dataset=_Tokens(n=8, seed=1))
    jt.train(10)
    tt = ttrainer.ElasticTrainer(
        tcfg.tiny(num_layers=1), ttrainer.build_optimizer("sgd", lr=0.0), _Tokens(),
        ttrainer.TrainerConfig(**kw), devices="cpu", eval_dataset=_Tokens(n=8, seed=1))
    tt.train(10)
    assert tt.global_step == jt.global_step == 3
    jt.close()
    tt.close()


# ---------------------------------------------------------------------------
# the sparse trainer's fault sites and refresh booking
# ---------------------------------------------------------------------------
def _jax_dense_step(w, rows, y):
    return w, jnp.zeros_like(jnp.asarray(rows)), {"loss": 0.0}


def _torch_dense_step(w, rows, y):
    return w, torch.zeros_like(rows), {"loss": 0.0}


def _stream(n, start=0, bs=16, vocab=40):
    for s in range(start, n):
        ids = np.random.default_rng(s).integers(0, vocab, bs).astype(np.int64)
        yield ids, (ids % 2).astype(np.float32)


def _sparse(pkg, ckpt_dir):
    if pkg == "jax":
        emb = JaxEmb(JaxHost(2, DIM, seed=0), capacity=64, sparse_optimizer="adagrad", lr=0.5,
                     kernel_mode="jnp")
        return JaxSparse(emb, jnp.zeros((DIM,)), _jax_dense_step, ckpt_dir=ckpt_dir), emb
    emb = DeviceSparseEmbedding(ShardedKvEmbedding(2, DIM, seed=0), capacity=64,
                                sparse_optimizer="adagrad", lr=0.5, devices="cpu")
    return SparseTrainer(emb, torch.zeros(DIM), _torch_dense_step, ckpt_dir=ckpt_dir), emb


@pytest.mark.parametrize("kind", ["torn_write", "bit_flip"])
def test_export_fault_quarantines_the_same_checkpoint(tmp_path, kind):
    out = {}
    for pkg, fmod in (("jax", jfaults), ("port", tfaults)):
        d = tmp_path / pkg
        t, emb = _sparse(pkg, str(d))
        t.run(_stream(2), overlapped=False)
        t.save_embedding()
        t.run(_stream(4, start=2), overlapped=False)
        fmod.configure(f"embedding.export:{kind}:1.0:7")
        try:
            t.save_embedding()  # its crcs are taken first: the bytes rot after
        finally:
            fmod.reset()
        t2, emb2 = _sparse(pkg, str(d))
        assert t2.restore_embedding()
        out[pkg] = (t2.step, sorted(os.listdir(d)))
        emb.close()
        emb2.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 2  # rolled back to the previous good file
    assert "embedding_state.npz.corrupt" in out["port"][1]


def test_import_fault_fires_on_the_read_leg(tmp_path):
    for pkg, fmod in (("jax", jfaults), ("port", tfaults)):
        t, emb = _sparse(pkg, str(tmp_path / pkg))
        t.run(_stream(1), overlapped=False)
        t.save_embedding()
        fmod.configure("embedding.import:io_error:1.0")
        try:
            with pytest.raises(OSError, match="embedding.import"):
                t.restore_embedding()
        finally:
            fmod.reset()
        assert t.restore_embedding()
        emb.close()


class _Client:
    def __init__(self):
        self.version = 0

    def get_cluster_version(self):
        return self.version


def test_refresh_window_is_booked_as_restart_replay(tmp_path, monkeypatch):
    ledger = tgoodput.GoodputLedger(tracer=SpanTracer(enabled=True))
    monkeypatch.setattr(tgoodput, "_default", ledger)
    t, emb = _sparse("port", str(tmp_path))
    t.run(_stream(2), overlapped=False)
    t.save_embedding()
    client = _Client()
    t._client, t._cluster_version = client, 0
    assert not t.check_failover()
    client.version = 1
    assert t.check_failover()
    assert ledger.snapshot().seconds["restart_replay"] > 0
    emb.close()


# ---------------------------------------------------------------------------
# export_metrics(registry=...)
# ---------------------------------------------------------------------------
def test_export_metrics_publishes_the_jax_gauges(monkeypatch, tmp_path):
    from dlrover_tpu.parallel import topology as jtop
    from dlrover_tpu_torch.parallel import topology as ttop

    # one link model in both packages: the host leg's price reads it
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path))
    link = dict(host_d2h_gbps=20.0, host_h2d_gbps=25.0, host_lat_s=1e-5, source="measured")
    jtop.set_link_model(jtop.LinkModel(**link))
    ttop.set_link_model(ttop.LinkModel(**link))
    monkeypatch.setattr(jtop, "_observed_for", lambda *a, **k: None)
    monkeypatch.setattr(ttop, "_observed_for", lambda *a, **k: None)
    j = JaxEmb(JaxHost(2, DIM, seed=0), capacity=32, sparse_optimizer="adagrad", lr=0.5,
               kernel_mode="jnp")
    t = DeviceSparseEmbedding(ShardedKvEmbedding(2, DIM, seed=0), capacity=32,
                              sparse_optimizer="adagrad", lr=0.5, devices="cpu")
    rng = np.random.default_rng(5)
    for step in range(1, 11):
        # tests/test_torch_device_tier.py's sliding window: 16 ids, 8 new
        # a step; the 32-row tier spills from step 5 on
        ids = (8 * (step - 1) + rng.integers(0, 16, 48)).astype(np.int64)
        grads = rng.normal(size=(48, DIM)).astype(np.float32)
        for emb in (j, t):
            p = emb.prepare(ids)
            emb.gather_for(p)
            emb.apply_grads(p, grads, step=step)
    for emb in (j, t):
        emb.join_spills()  # the drains count a spill once it has landed
    jr, tr = JaxRegistry(), MetricsRegistry()
    js, ts = j.export_metrics(registry=jr), t.export_metrics(registry=tr)
    jtop.reset_link_model()
    ttop.reset_link_model()
    # the host leg is priced through the one link model (the arbiter is
    # ported); the scatter lag is wall time
    skip = {"emb_scatter_lag_ms"}
    assert {k: v for k, v in ts.items() if k not in skip} == {
        k: v for k, v in js.items() if k not in skip}
    assert ts["emb_host_leg_ms"] > 0
    assert set(tr.scalars()) == set(jr.scalars())
    assert tr.scalars()['dlrover_embedding_spill_rows{table="t0"}'] > 0
    j.close()
    t.close()
