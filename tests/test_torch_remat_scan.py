"""Port parity for the model's layer layouts and remat: the port's
``remat`` / ``scan_layers`` forward, loss and grads against the JAX
package's with the same switches, on converted weights in f32; the
port's remat against no remat, bitwise; the stacked <-> list
conversions; ``logical_axes``; the stacked train state's tree against
the JAX ``TrainState``'s; and three steps of the stacked model under
the flat 8-bit AdamW against the JAX step.

Tolerances as ``tests/test_torch_transformer.py``: 1e-5 on logits and
loss, 1e-4 on gradients; the train steps as ``tests/test_torch_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ckpt.sharding import _flatten_with_path, _keystr
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.models import transformer as jtr
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.ckpt.sharding import flatten_state
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import train as ttrain
from dlrover_tpu_torch.models import transformer as ttr
from dlrover_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
    train_state_tree,
)
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

from test_torch_train import (  # noqa: E402  (the slice's tolerances)
    LOSS_RTOL,
    OPT_KW,
    PARAM_ATOL,
    PARAM_CLOSE_ATOL,
    PARAM_FLIP_SHARE,
    _batches,
)

TOL = 1e-5
GRAD_TOL = 1e-4

MODELS = {
    "llama": {},
    "gpt2": dict(rope=False, rmsnorm=False, swiglu=False,
                 tie_embeddings=True, num_kv_heads=None),
}
SWITCHES = {
    "remat": dict(remat=True),
    "scan": dict(scan_layers=True),
    "remat_scan": dict(remat=True, scan_layers=True),
}


def _data(cfg, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    return d[:, :-1], d[:, 1:]


def _t(a):
    return torch.from_numpy(a).long()


def _lookup(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_grads_match_jax(name, switch):
    kw = {**MODELS[name], **SWITCHES[switch]}
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    params = jax.device_get(jtr.init_params(jax.random.PRNGKey(3), jc))
    assert isinstance(params["layers"], dict) == tc.scan_layers
    x, y = _data(jc, 3)
    model = params_from_jax(params, tc)
    logits_j, _ = jtr.forward(params, x, jc)
    loss_j, g_j = jax.value_and_grad(jtr.loss_fn)(params, x, y, jc)
    logits_t, _ = ttr.forward(model, _t(x), tc)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), atol=TOL, rtol=TOL)
    loss_t = ttr.loss_fn(model, _t(x), _t(y), tc)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=TOL, rtol=TOL)
    loss_t.backward()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(_lookup(g_j, n)),
                                   atol=GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_is_bitwise_no_remat(name, scan):
    """The recompute runs the same operations on the same inputs: the
    loss and every grad equal the run without remat to the bit."""
    out = []
    for remat in (False, True):
        cfg = tcfg.tiny(**MODELS[name], remat=remat, scan_layers=scan)
        model = ttr.init_params(torch.Generator().manual_seed(5), cfg)
        x, y = _data(cfg, 5)
        loss = ttr.loss_fn(model, _t(x), _t(y), cfg)
        grads = torch.autograd.grad(loss, model.jax_ordered_parameters())
        out.append((loss.detach(), grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stacked_and_list_layouts_convert_both_ways(name):
    jc_list = jcfg.tiny(**MODELS[name])
    tc_scan = tcfg.tiny(**MODELS[name], scan_layers=True)
    listed = jax.device_get(jtr.init_params(jax.random.PRNGKey(1), jc_list))
    # the port's stack of the list equals the JAX package's
    j_stacked = jax.device_get(jtr.stack_layer_params(listed["layers"]))
    t_stacked = ttr.stack_layer_params(listed["layers"])
    assert jax.tree.structure(j_stacked) == jax.tree.structure(t_stacked)
    for a, b in zip(jax.tree.leaves(j_stacked), jax.tree.leaves(t_stacked)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a stacked JAX tree into the port and back, leaf for leaf
    tree = {**listed, "layers": t_stacked}
    model = params_from_jax(tree, tc_scan)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the port's params in the JAX flatten order of the stacked tree
    for a, b in zip(jax.tree.leaves(tree), model.jax_ordered_parameters()):
        np.testing.assert_array_equal(a, b.detach().numpy())
    # and unstacked again: the list layout's leaves
    for a, b in zip(jax.tree.leaves(listed["layers"]),
                    jax.tree.leaves(ttr.unstack_layer_params(back["layers"]))):
        np.testing.assert_array_equal(a, b)
    # torch leaves stack as numpy ones do
    st = ttr.stack_layer_params(
        [{k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in layer.items()}
         for layer in listed["layers"]])
    for a, b in zip(jax.tree.leaves(t_stacked), jax.tree.leaves(st)):
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(ValueError, match="stacked"):
        params_from_jax(tree, tcfg.tiny(**MODELS[name]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stacked_model_holds_the_list_models_weights(name):
    """Both layouts draw layer by layer from the generator: the stacked
    model of a seed is the list model of that seed, stacked."""
    listed = ttr.init_params(torch.Generator().manual_seed(2), tcfg.tiny(**MODELS[name]))
    stacked = ttr.init_params(torch.Generator().manual_seed(2),
                              tcfg.tiny(**MODELS[name], scan_layers=True))
    a, b = params_to_numpy(listed), params_to_numpy(stacked)
    a["layers"] = ttr.stack_layer_params(a["layers"])
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logical_axes_match_jax(name, scan):
    kw = dict(MODELS[name], scan_layers=scan)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    j = jtr.logical_axes(jcfg.tiny(**kw))
    t = ttr.logical_axes(tcfg.tiny(**kw))
    assert jax.tree.structure(j, is_leaf=is_axes) == jax.tree.structure(t, is_leaf=is_axes)
    assert jax.tree.leaves(j, is_leaf=is_axes) == jax.tree.leaves(t, is_leaf=is_axes)


@pytest.mark.parametrize("opt", ["adamw_8bit_flat", "adamw_8bit", "adamw"])
def test_stacked_train_state_tree_is_the_jax_trees(opt):
    """Paths, shapes and dtypes of the stacked model's whole train
    state, leaf for leaf, against the JAX ``TrainState`` of the same
    optimizer."""
    kw = OPT_KW if opt == "adamw_8bit_flat" else (dict(min_quantized_size=512) if opt == "adamw_8bit" else {})
    jc, tc = jcfg.tiny(scan_layers=True), tcfg.tiny(scan_layers=True)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer(opt, lr=1e-3, **kw)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    want = {_keystr(kp): (tuple(np.shape(v)), np.asarray(v).dtype.name)
            for kp, v in _flatten_with_path(jax.device_get(jstate))}
    ttx = ttrainer.build_optimizer(opt, lr=1e-3, **kw)
    tstate = ttrain.init_state(tc, ttx, devices="cpu")
    got = {}
    for path, v in flatten_state(train_state_tree(tstate)):
        dt = str(v.dtype).replace("torch.", "") if isinstance(v, torch.Tensor) else np.asarray(v).dtype.name
        got[path] = (tuple(np.shape(v)), dt)
    assert got == want


def test_three_stacked_steps_match_jax():
    """The stacked model under the flat 8-bit AdamW against the JAX step
    with ``scan_layers`` (and remat), as ``test_three_steps_match_jax``."""
    jc, tc = jcfg.tiny(scan_layers=True, remat=True), tcfg.tiny(scan_layers=True, remat=True)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False)
    model = params_from_jax(jax.device_get(jstate.params), tc)
    ttx = ttrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    tstate = ttrain.state_from_params(model, ttx)
    assert len(tstate.opt_state.opt.layout.groups) == len(jstate.opt_state.inner_state[0].mu)
    tstep = ttrain.build_train_step(tc, ttx)
    for x, y in _batches(jc, 3):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, _t(x), _t(y))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tstate.params)),
                    jax.tree.leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        assert np.mean(np.abs(a - b) > PARAM_CLOSE_ATOL) <= PARAM_FLIP_SHARE


def test_trainer_takes_remat_from_the_strategy():
    """``Strategy.remat`` (or its ``remat`` opt) reaches the model's
    config, as the JAX accel pins it; without a strategy the config's
    own switch stands."""
    from dlrover_tpu_torch.accel.strategy import Strategy

    data = np.random.default_rng(0).integers(0, 256, (16, 17)).astype(np.int64)
    ds = [(r[:-1], r[1:]) for r in data]
    seen = []
    for cfg, strategy in (
        (tcfg.tiny(remat=True), None),
        (tcfg.tiny(), Strategy(remat=True)),
        (tcfg.tiny(), Strategy(opts=("remat",))),
        (tcfg.tiny(remat=True), Strategy()),
    ):
        tr = ttrainer.ElasticTrainer(
            cfg, ttrainer.build_optimizer("sgd", lr=1e-2), ds,
            ttrainer.TrainerConfig(batch_size=4, seq_len=16, report_metrics=False),
            strategy=strategy, devices="cpu",
        )
        seen.append(tr.cfg.remat)
        tr.close()
    assert seen == [True, True, True, False]
