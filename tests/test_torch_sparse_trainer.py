"""Port parity for the sparse slice as a whole, on the CPU:
``SparseTrainer`` over the port's ``DeviceSparseEmbedding`` (and over
the host store) against the JAX package's trainer, per-step losses
within 1e-5 relative (f32 dense steps in two frameworks: the logistic
head's reductions may round differently). Then the trainer's own
contracts: crc-verified save / restore with quarantine and rollback,
and cluster-version failover against a duck-typed client."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.embedding import ShardedKvEmbedding as JaxHost
from dlrover_tpu.ops.embedding.device_tier import (
    DeviceSparseEmbedding as JaxEmb,
)
from dlrover_tpu.trainer.sparse import SparseTrainer as JaxTrainer
from dlrover_tpu_torch.ops.embedding import (
    DeviceSparseEmbedding,
    ShardedKvEmbedding,
)
from dlrover_tpu_torch.trainer.sparse import SparseTrainer

DIM = 16
LOSS_RTOL = 1e-5


def _jax_dense_step(lr=0.3):
    @jax.jit
    def loss_fn(w, rows, y):
        p = jax.nn.sigmoid(rows @ w)
        return -jnp.mean(y * jnp.log(p + 1e-7) + (1 - y) * jnp.log(1 - p + 1e-7))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))

    def dense_step(w, rows, batch):
        loss, (gw, grows) = grad_fn(w, jnp.asarray(rows), jnp.asarray(batch))
        return w - lr * gw, grows, {"loss": float(loss)}

    return dense_step


def _torch_dense_step(lr=0.3):
    """The logistic head of examples/train_sparse_torch.py."""

    def dense_step(w, rows, batch):
        rows = rows.to(w.device).detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        y = torch.as_tensor(batch, device=w.device)
        p = torch.sigmoid(rows @ wg)
        loss = -torch.mean(y * torch.log(p + 1e-7) + (1 - y) * torch.log(1 - p + 1e-7))
        gw, grows = torch.autograd.grad(loss, (wg, rows))
        return (w - lr * gw).detach(), grows, {"loss": loss.item()}

    return dense_step


def _stream(n, bs=64, vocab=40, seed=7, start=0):
    for s in range(start, n):
        r = np.random.default_rng(seed * 1000 + s)
        ids = r.integers(0, vocab, bs).astype(np.int64)
        yield ids, (ids % 2).astype(np.float32)


def _window_stream(n, bs=64, seed=3):
    """16 ids a step, 8 of them new: a 48-row tier spills from step 6
    on, and its victims are never ids of a batch in flight."""
    rng = np.random.default_rng(seed)
    for s in range(n):
        ids = (8 * s + rng.integers(0, 16, bs)).astype(np.int64)
        yield ids, (ids % 2).astype(np.float32)


def _device_trainer(ckpt_dir="", capacity=128, lr=0.5, client=None, opt="adagrad", **kw):
    host = ShardedKvEmbedding(2, DIM, num_slots=2 if opt == "adam" else 1, seed=0)
    emb = DeviceSparseEmbedding(
        host, capacity=capacity, sparse_optimizer=opt, lr=lr, devices="cpu"
    )
    t = SparseTrainer(
        emb, torch.zeros(DIM), _torch_dense_step(), ckpt_dir=str(ckpt_dir),
        master_client=client, **kw,
    )
    return t, host, emb


def _jax_device_trainer(capacity=128, lr=0.5, opt="adagrad"):
    host = JaxHost(2, DIM, num_slots=2 if opt == "adam" else 1, seed=0)
    emb = JaxEmb(host, capacity=capacity, sparse_optimizer=opt, lr=lr, kernel_mode="jnp")
    return JaxTrainer(emb, jnp.zeros((DIM,)), _jax_dense_step()), emb


@pytest.mark.parametrize("overlapped", [True, False])
@pytest.mark.parametrize("opt,capacity", [("adagrad", 128), ("adam", 48)])
def test_device_cycle_matches_jax(overlapped, opt, capacity):
    """The adam case runs the sliding window through a 48-row tier,
    which spills; the adagrad case keeps every row resident."""
    stream = _stream if opt == "adagrad" else _window_stream
    jt, jemb = _jax_device_trainer(capacity=capacity, opt=opt)
    tt, thost, temb = _device_trainer(capacity=capacity, opt=opt)
    jl = [m["loss"] for m in jt.run(stream(10), overlapped=overlapped)]
    tl = [m["loss"] for m in tt.run(stream(10), overlapped=overlapped)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert (temb.stats.spill_rows > 0) == (opt == "adam")
    assert tt.step == jt.step == 10
    assert bool(tt.pipeline_stats) == overlapped
    np.testing.assert_allclose(tt.dense_params.numpy(), np.asarray(jt.dense_params), rtol=1e-5, atol=1e-7)
    jemb.close()
    temb.close()


def test_host_cycle_matches_jax():
    jt = JaxTrainer(JaxHost(2, DIM, seed=0), jnp.zeros((DIM,)), _jax_dense_step(), sparse_lr=0.5)
    tt = SparseTrainer(ShardedKvEmbedding(2, DIM, seed=0), torch.zeros(DIM), _torch_dense_step(), sparse_lr=0.5)
    jl = [m["loss"] for m in jt.run(_stream(8), overlapped=True)]  # host store: sync
    tl = [m["loss"] for m in tt.run(_stream(8), overlapped=True)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_overlapped_and_inline_runs_are_bitwise():
    ta, _, ea = _device_trainer()
    la = [m["loss"] for m in ta.run(_stream(12), overlapped=False)]
    tb, _, eb = _device_trainer()
    lb = [m["loss"] for m in tb.run(_stream(12), overlapped=True)]
    assert la == lb
    ea.close()
    eb.close()


def test_dense_params_may_be_a_dict(tmp_path):
    t, _, emb = _device_trainer(ckpt_dir=tmp_path)
    t.dense_params = {"w": torch.zeros(DIM), "b": torch.ones(2)}
    t._dense_step = lambda p, rows, y: (p, torch.zeros_like(rows), {"loss": 0.0})
    t.run(_stream(1), overlapped=False)
    t.save_embedding()
    t.dense_params = {"w": torch.full((DIM,), 5.0), "b": torch.zeros(2)}
    assert t.restore_embedding()
    assert torch.equal(t.dense_params["b"], torch.ones(2))
    assert torch.equal(t.dense_params["w"], torch.zeros(DIM))
    with pytest.raises(TypeError):
        SparseTrainer(emb, object(), t._dense_step)._dense_leaves()
    emb.close()


def test_save_restore_round_trip(tmp_path):
    t, _, emb = _device_trainer(ckpt_dir=tmp_path)
    t.run(_stream(5), overlapped=True)
    t.save_embedding()
    vals = t.embedding.gather(np.arange(10)).numpy().copy()
    dense = t.dense_params.clone()
    t2, host2, emb2 = _device_trainer(ckpt_dir=tmp_path)
    assert t2.restore_embedding()
    assert t2.step == 5
    np.testing.assert_array_equal(emb2.gather(np.arange(10)).numpy(), vals)
    assert torch.equal(t2.dense_params, dense)
    assert len(host2) == len(t.embedding.host)
    emb.close()
    emb2.close()


def test_corrupt_newest_is_quarantined_and_rolled_back(tmp_path):
    t, _, emb = _device_trainer(ckpt_dir=tmp_path)
    t.run(_stream(5), overlapped=False)
    t.save_embedding()
    vals = emb.gather(np.arange(10)).numpy().copy()
    dense5 = t.dense_params.clone()
    t.run(_stream(8, start=5), overlapped=False)
    t.save_embedding()  # rotates the first save to .prev
    p = str(tmp_path / "embedding_state.npz")
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[: len(blob) // 2])  # torn write
    t2, _, emb2 = _device_trainer(ckpt_dir=tmp_path)
    assert t2.restore_embedding()
    assert t2.step == 5  # the previous good save
    np.testing.assert_array_equal(emb2.gather(np.arange(10)).numpy(), vals)
    assert torch.equal(t2.dense_params, dense5)
    assert os.path.exists(p + ".corrupt")
    emb.close()
    emb2.close()


def test_bit_flip_fails_crc_and_both_corrupt_restores_nothing(tmp_path):
    t, _, emb = _device_trainer(ckpt_dir=tmp_path)
    t.run(_stream(2), overlapped=False)
    t.save_embedding()
    t.save_embedding()
    p = str(tmp_path / "embedding_state.npz")
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    open(p, "wb").write(bytes(blob))
    open(str(tmp_path / "embedding_state.prev.npz"), "wb").write(b"garbage")
    t2, _, emb2 = _device_trainer(ckpt_dir=tmp_path)
    assert t2.restore_embedding() is False
    assert os.path.exists(p + ".corrupt")
    emb.close()
    emb2.close()


class _Client:
    def __init__(self):
        self.version, self.fail, self.reports = 0, False, []

    def get_cluster_version(self, version_type="global"):
        if self.fail:
            raise ConnectionError("master unreachable")
        return self.version

    def report_train_metrics(self, step, metrics):
        self.reports.append((step, metrics))


def test_failover_reimports_on_version_bump(tmp_path):
    c = _Client()
    t, _, emb = _device_trainer(ckpt_dir=tmp_path, client=c)
    t.run(_stream(4), overlapped=False)
    t.save_embedding()
    saved = emb.gather(np.arange(10)).numpy().copy()
    assert t.check_failover() is False
    t.run(_stream(6, start=4), overlapped=False)
    c.version = 1
    assert t.check_failover() is True
    assert t.step == 4
    np.testing.assert_array_equal(emb.gather(np.arange(10)).numpy(), saved)
    emb.close()


def test_failover_warm_reshards_and_polls_degrade(tmp_path):
    c = _Client()
    t, host, emb = _device_trainer(ckpt_dir=tmp_path, client=c, target_shards_fn=lambda: 3)
    t.run(_stream(3), overlapped=False)
    c.fail = True
    assert t.check_failover() is False  # a failed poll is "no change"
    c.fail, c.version = False, 1
    assert t.check_failover() is True
    assert host.num_shards == 3
    scalars = t.report_telemetry()
    assert scalars["sparse_step"] == 3.0 and "emb_gather_hit_pct" in scalars
    assert c.reports and c.reports[-1][0] == 3
    emb.close()
    c.fail = True
    with pytest.raises(ConnectionError):
        _device_trainer(client=c)
