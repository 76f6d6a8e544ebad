"""Port parity for the micro-batch rebalance (``Strategy.batch_pad``):
the row-weight and padding helpers against the JAX package's, the padded
train step against the JAX step built with the same ``batch_pad``, the
padded step against the unpadded one on the real rows, its refusals,
and the trainer padding each global batch before the rank split, on one
process and at dp=2 over gloo (``tests/torch_dist_worker.py``).

Tolerances: the JAX step as ``tests/test_torch_train.py``; the padded
run against the real rows alone 1e-6 relative (the same mean, summed
with other weights); dp=2 against one process as
``tests/test_torch_dp_trainer.py`` (1e-6 of the largest loss)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import train as ttrain
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

import torch_dist_worker as tdw
from test_torch_train import (  # noqa: E402  (the slice's tolerances)
    LOSS_RTOL,
    OPT_KW,
    PARAM_ATOL,
    PARAM_CLOSE_ATOL,
    PARAM_FLIP_SHARE,
)

PAD = 2
REAL_RTOL = 1e-6
LOSS_TOL = 1e-6
STEPS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("real,padded", [(3, 4), (6, 8), (5, 5), (1, 7)])
def test_pad_helpers_match_jax(real, padded):
    np.testing.assert_array_equal(ttrain.pad_row_weights(real, padded),
                                  jtrain.pad_row_weights(real, padded))
    x = np.arange(real * 3, dtype=np.int32).reshape(real, 3)
    np.testing.assert_array_equal(ttrain.pad_batch_rows(x, padded), jtrain.pad_batch_rows(x, padded))
    for bad in ((0, 4), (5, 4)):
        with pytest.raises(ValueError):
            ttrain.pad_row_weights(*bad)


def _padded_batches(cfg, n, real=6, T=32, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, cfg.vocab_size, (n, real, T + 1)).astype(np.int32)
    return [(d[:, :-1], d[:, 1:]) for d in data]


def test_padded_step_matches_jax():
    jc, tc = jcfg.tiny(), tcfg.tiny()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False, batch_pad=PAD)
    ttx = ttrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    tstate = ttrain.state_from_params(params_from_jax(jax.device_get(jstate.params), tc), ttx)
    tstep = ttrain.build_train_step(tc, ttx, batch_pad=PAD)
    for x, y in _padded_batches(jc, 3):
        x, y = jtrain.pad_batch_rows(x, 8), jtrain.pad_batch_rows(y, 8)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, _t(x), _t(y))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tstate.params)),
                    jax.tree.leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        assert np.mean(np.abs(a - b) > PARAM_CLOSE_ATOL) <= PARAM_FLIP_SHARE


def test_padded_step_trains_on_the_real_rows():
    """The pads weigh 0: loss, grad norm and the SGD update equal the
    unpadded step's on the real rows alone."""
    tc = tcfg.tiny()
    runs = []
    for pad in (0, PAD):
        tx = ttrainer.build_optimizer("sgd", lr=0.1)
        state = ttrain.init_state(tc, tx, seed=3, devices="cpu")
        step = ttrain.build_train_step(tc, tx, batch_pad=pad)
        metrics = []
        for x, y in _padded_batches(tc, 2, seed=3):
            if pad:
                x, y = ttrain.pad_batch_rows(x, 6 + pad), ttrain.pad_batch_rows(y, 6 + pad)
            state, m = step(state, _t(x), _t(y))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [p.detach().clone() for p in state.params.jax_ordered_parameters()]))
    (m0, p0), (m1, p1) = runs
    np.testing.assert_allclose(m1, m0, rtol=REAL_RTOL)
    for a, b in zip(p1, p0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=REAL_RTOL, atol=1e-7)


def test_batch_pad_refuses_grad_accum_and_moe():
    with pytest.raises(ValueError, match="grad_accum"):
        ttrain.build_train_step(tcfg.tiny(), batch_pad=1, grad_accum=2)
    with pytest.raises(ValueError, match="MoE"):
        ttrain.build_train_step(tcfg.tiny(num_experts=4), batch_pad=1)


def test_trainer_pads_the_global_batch_on_one_process():
    """``Strategy(batch_pad=2)`` on one process: 6 real rows of each
    batch plus 2 zero rows, losses those of the unpadded trainer; the
    eval batch is not padded."""
    out = []
    for strategy in (None, Strategy(batch_pad=PAD)):
        losses, seen = [], []
        tr = ttrainer.ElasticTrainer(
            tcfg.tiny(), ttrainer.build_optimizer("sgd", lr=0.1), tdw.Tokens(),
            ttrainer.TrainerConfig(batch_size=6, seq_len=16, report_metrics=False, prefetch=0),
            strategy=strategy, devices="cpu",
            metrics_hook=lambda s, m, losses=losses: losses.append(float(m["loss"])),
            eval_dataset=tdw.Tokens(n=12, seed=5),
        )
        step = tr._step_fn

        def spy(state, x, y, step=step, seen=seen):
            seen.append(tuple(x.shape))
            return step(state, x, y)

        tr._step_fn = spy
        tr.train(STEPS)
        out.append((losses, seen, tr.evaluate(2)["eval_loss"]))
        tr.close()
    (l0, s0, e0), (l1, s1, e1) = out
    assert s0 == [(6, 16)] * STEPS and s1 == [(6 + PAD, 16)] * STEPS
    np.testing.assert_allclose(l1, l0, rtol=REAL_RTOL)
    np.testing.assert_allclose(e1, e0, rtol=REAL_RTOL)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pad")
    run = dict(steps=STEPS, batch=6, mesh={}, strategy=dict(batch_pad=PAD))
    one = tdw.run_ranks("train", 1, {"pad": run}, str(d / "w1"))[0]
    two = tdw.run_ranks("train", 2, {"pad": dict(run, mesh=dict(dp=2))}, str(d / "w2"))
    return one, two


def test_dp2_padded_batches_match_one_process(dp_runs):
    """dp=2 splits 6 + 2 padded rows as 4 and 4 (the second rank's last
    two are the pads, weighing 0): its losses equal one process's."""
    one, two = dp_runs
    ref = one["pad"]["losses"]
    assert len(ref) == STEPS
    for r in two:
        np.testing.assert_allclose(r["pad"]["losses"], ref, rtol=0, atol=LOSS_TOL * max(ref))
    leaves = [jax.tree.leaves(r["pad"]["params"]) for r in two]
    for a, b in zip(*leaves):
        np.testing.assert_array_equal(a, b)
