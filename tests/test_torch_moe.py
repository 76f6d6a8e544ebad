"""The port's MoE layer (``dlrover_tpu_torch/parallel/moe.py``) and MoE
model against the JAX package's, one process on the CPU, inputs from a
numpy seed:

- ``topk_gating`` at k = 1 and 2, with and without per-expert cutoffs
  (``expert_caps``), on logits with a planted tie: ``dispatch``,
  ``combine``, the balance and z losses and the routing stats within
  ``GATE_TOL`` of the JAX function's (the one-hots exactly); the
  rank-0 priority case of ``tests/test_models_parallel.py``; ties go to
  the lower expert index, as ``lax.top_k`` orders them;
- ``moe_layer_local`` at ep = 1 (the JAX ``axis_name=None``), with and
  without capacity drops, top-1 and top-2: the output and the aux within
  ``LAYER_TOL``, the gradients of the params and the tokens within
  ``LAYER_TOL`` of each tensor's largest entry;
- ``CapacityRebalancer``: the same splits as the JAX class for the same
  load sequence;
- the model (``tiny(num_experts=4, moe_every=2)``, remat off and on,
  with capacity splits): ``loss_fn``'s loss (NLL plus the weighted
  balance and z losses) and aux summed over the blocks within
  ``MODEL_TOL`` of the JAX ``loss_fn``, every leaf's gradient within
  ``GRAD_TOL``; the leaves in the JAX flatten order (``MoEParams`` in
  its field order); ``logical_axes`` the JAX tree's;
- the meshes that compose MoE with the other axes build (ep with fsdp,
  tp or sp, MoE at ep = 1 with tp or sp; ROADMAP A19, checked step for
  step in ``tests/test_torch_ep_compose.py``): each rank's expert leaves
  are its ep x tp boxes; what still raises: ep on a dense model or one
  that does not divide the experts (``ValueError``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import transformer as jtr
from dlrover_tpu.parallel import moe as jmoe
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import transformer as ttr
from dlrover_tpu_torch.models.convert import params_from_jax
from dlrover_tpu_torch.parallel import moe as tmoe
from dlrover_tpu_torch.parallel.mesh import MeshConfig

GATE_TOL = 1e-6  # the gating's f32 outputs (the one-hots are exact)
LAYER_TOL = 2e-6  # the layer's output and aux, f32; its gradients relative to their largest entry
MODEL_TOL = 2e-6  # the model's loss and aux, f32, relative
GRAD_TOL = 2e-6  # the model's gradients, f32, absolute
E = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(M, H, seed=1):
    """A MoE layer's params at the JAX init's scales, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return jmoe.MoEParams(
        gate=(rng.standard_normal((M, E)) * M**-0.5).astype(np.float32),
        w_up=(rng.standard_normal((E, M, H)) * M**-0.5).astype(np.float32),
        w_down=(rng.standard_normal((E, H, M)) * H**-0.5).astype(np.float32))


def _logits(T=24, seed=0, tie=True):
    logits = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    if tie:
        # token 3's two best experts tie exactly, and token 5's best two
        logits[3, 1] = logits[3, 2] = 4.0
        logits[5, 0] = logits[5, 3] = 3.0
    return logits


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("caps", [None, (7, 2, 9, 4)])
def test_topk_gating_matches_the_jax_function(k, caps):
    logits = _logits()
    C = 6 if caps is None else max(caps)
    jcaps = None if caps is None else jnp.asarray(caps, jnp.float32)
    jd, jc, jb, jz, js = jmoe.topk_gating(jnp.asarray(logits), E, C, k=k, expert_caps=jcaps,
                                          return_stats=True)
    td, tc, tb, tz, ts = tmoe.topk_gating(_t(logits), E, C, k=k, expert_caps=caps,
                                          return_stats=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=GATE_TOL)
    for t, j in ((tb, jb), (tz, jz), (ts["load"], js["load"]), (ts["drop"], js["drop"])):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=GATE_TOL)
    assert float(ts["drop"]) > 0  # the capacity drops assignments here


def test_top2_capacity_priority_rank0_first():
    """A token's secondary expert must not evict another token's
    primary (the JAX test's case): capacity 1, both primaries kept."""
    logits = np.asarray([[4.0, 2.0], [2.0, 4.0]], np.float32)
    d, _, _, _ = tmoe.topk_gating(_t(logits), 2, capacity=1, k=2)
    jd, _, _, _ = jmoe.topk_gating(jnp.asarray(logits), 2, capacity=1, k=2)
    d = d.numpy()
    assert d[0, 0, 0] == 1 and d[1, 1, 0] == 1 and d.sum() == 2
    np.testing.assert_array_equal(d, np.asarray(jd))


def test_ties_go_to_the_lower_expert_as_lax_top_k():
    probs = np.asarray([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]], np.float32)
    for k in (1, 2, 3):
        tv, ti = tmoe._top_k(_t(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_top1_gating_is_topk_at_one():
    logits = _logits(tie=False)
    jd, jc, jb = jmoe.top1_gating(jnp.asarray(logits), E, 5)
    td, tc, tb = tmoe.top1_gating(_t(logits), E, 5)
    for t, j in ((td, jd), (tc, jc), (tb, jb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=GATE_TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no_drops", "drops"])
def test_moe_layer_local_matches_the_jax_function(k, cf):
    M, H = 16, 32
    p = _moe_params(M, H)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, M)).astype(np.float32)
    w = rng.standard_normal((24, M)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_layer_local(p, x, axis_name=None, capacity_factor=cf, top_k=k)
        return jnp.sum(out * w) + aux["balance"] + aux["z"], (out, aux)

    (_, (jo, ja)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        p, jnp.asarray(x))
    tp = {f: _t(getattr(p, f)).requires_grad_() for f in tmoe.MOE_FIELDS}
    tx = _t(x).requires_grad_()
    to, ta = tmoe.moe_layer_local(tp, tx, capacity_factor=cf, top_k=k)
    ((to * _t(w)).sum() + ta["balance"] + ta["z"]).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=LAYER_TOL)
    for n in ("balance", "z", "load", "drop"):
        np.testing.assert_allclose(np.asarray(ta[n].detach()), np.asarray(ja[n]), atol=LAYER_TOL)
    assert (float(ta["drop"]) > 0) == (cf < 1)
    # a gradient to LAYER_TOL of its tensor's largest entry (the gate's
    # entries are sums over every token that cancel)
    for name, g, j in [("x", tx.grad, jgx)] + [(f, tp[f].grad, getattr(jgp, f))
                                               for f in tmoe.MOE_FIELDS]:
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, atol=LAYER_TOL * np.abs(j).max(), err_msg=name)


def test_expert_caps_of_the_wrong_length_raise_as_in_the_jax_package():
    p = _moe_params(8, 16)
    x = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError) as je:  # raised while tracing
        jax.jit(lambda p, x: jmoe.moe_layer_local(p, x, axis_name=None, expert_caps=(1, 2)))(
            p, jnp.asarray(x))
    with pytest.raises(ValueError) as te:
        tmoe.moe_layer_local({f: _t(getattr(p, f)) for f in tmoe.MOE_FIELDS}, _t(x),
                             expert_caps=(1, 2))
    assert str(te.value) == str(je.value)


def test_init_moe_params_draws_the_jax_scales():
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 8, 64, 256)
    j = jax.jit(jmoe.init_moe_params, static_argnums=(1, 2, 3))(jax.random.PRNGKey(0), 8, 64, 256)
    for f in tmoe.MOE_FIELDS:
        assert tuple(p[f].shape) == tuple(getattr(j, f).shape)
        np.testing.assert_allclose(float(p[f].std()), float(jnp.std(getattr(j, f))), rtol=0.05)


def test_capacity_rebalancer_splits_as_the_jax_class():
    rng = np.random.default_rng(0)
    tr, jr = tmoe.CapacityRebalancer(E, top_k=2), jmoe.CapacityRebalancer(E, top_k=2)
    for i in range(12):
        load = rng.dirichlet(np.ones(E) * (0.3 if i % 3 else 3.0))
        if i == 5:
            load = np.zeros(E)  # skipped by both
        tr.observe(load)
        jr.observe(load)
        for tokens in (64, 1000, 4096):
            assert tr.splits(tokens) == jr.splits(tokens)
        np.testing.assert_array_equal(tr.load, jr.load)
    assert tr.observations == jr.observations == 11
    with pytest.raises(ValueError):
        tmoe.CapacityRebalancer(1)


MODEL = dict(num_layers=4, num_experts=E, moe_every=2, moe_top_k=2, capacity_factor=1.0)


@functools.lru_cache(maxsize=None)
def _jax_model_params():
    """The JAX draw of ``MODEL``'s params, once (``remat`` and
    ``capacity_splits`` leave the params as they are)."""
    return jax.device_get(jax.jit(functools.partial(jtr.init_params, cfg=jcfg.tiny(**MODEL)))(
        jax.random.PRNGKey(0)))


def _model_pair(**kw):
    jc, tc = jcfg.tiny(**dict(MODEL, **kw)), tcfg.tiny(**dict(MODEL, **kw))
    jp = _jax_model_params()
    return jc, tc, jp, params_from_jax(jp, tc)


def _path(kp):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in kp)


@pytest.mark.parametrize("kw", [{}, dict(remat=True), dict(capacity_splits=(20, 40, 12, 30))],
                         ids=["plain", "remat", "capacity_splits"])
def test_the_model_loss_aux_and_grads_match_the_jax_loss_fn(kw):
    jc, tc, jp, model = _model_pair(**kw)
    rng = np.random.default_rng(1)
    x, y = (rng.integers(0, jc.vocab_size, (4, 16)).astype(np.int32) for _ in range(2))
    (jl, ja), jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jnp.asarray(x), jnp.asarray(y), jc, return_aux=True),
        has_aux=True))(jp)
    tl, ta = ttr.loss_fn(model, _t(x).long(), _t(y).long(), tc, return_aux=True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=MODEL_TOL)
    assert ta.keys() == ja.keys()
    for n in ja:
        np.testing.assert_allclose(ta[n].detach().numpy(), np.asarray(ja[n]), rtol=MODEL_TOL,
                                   atol=1e-7, err_msg=n)
    named = dict(model.named_parameters())
    for kp, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        np.testing.assert_allclose(named[_path(kp)].grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                   err_msg=_path(kp))


def test_leaf_order_and_logical_axes_are_the_jax_package_s():
    jc, tc, jp, model = _model_pair()
    names = {id(p): n for n, p in model.named_parameters()}
    want = [_path(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [names[id(p)] for p in model.jax_ordered_parameters()] == want
    assert [n for n in want if ".moe." in n] == [
        f"layers.{i}.moe.{f}" for i in (1, 3) for f in ("gate", "w_up", "w_down")]
    jaxes = jtr.logical_axes(jc)
    taxes = ttr.logical_axes(tc)
    for i, layer in enumerate(jaxes["layers"]):
        if "moe" in layer:
            assert taxes["layers"][i]["moe"] == layer["moe"]._asdict()
            assert "mlp" not in taxes["layers"][i]
        else:
            assert taxes["layers"][i]["mlp"] == layer["mlp"]


def test_an_ep_mesh_splits_the_expert_leaves_on_dim_0():
    """Each ep rank's box of an expert leaf is its ``E/ep`` experts; the
    weights are ep = 1's of the same seed."""
    cfg = tcfg.tiny(**MODEL)
    whole = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    local = ttr.init_params(torch.Generator().manual_seed(0), cfg, mesh=MeshConfig(ep=2))
    for (n, w), (m, p) in zip(whole.named_parameters(), local.named_parameters()):
        assert n == m
        if ".moe.w_" in n:
            assert p.shape[0] == E // 2 and p.leaf_numel == w.numel()
            torch.testing.assert_close(p, w[:E // 2], rtol=0, atol=0)
        else:
            torch.testing.assert_close(p, w, rtol=0, atol=0)


# The ids are those of the cases when these meshes raised, naming
# ROADMAP A19, which now runs them: each of them builds (err None).
@pytest.mark.parametrize("mesh,err,match", [
    (dict(ep=2, fsdp=2), None, None), (dict(ep=2, tp=2), None, None),
    (dict(ep=2, sp=2), None, None), (dict(tp=2), None, None),
    (dict(sp=2), None, None), (dict(ep=3), ValueError, "divide"),
], ids=[f"mesh{i}-NotImplementedError-A19" for i in range(5)] + ["mesh5-ValueError-divide"])
def test_what_still_raises(mesh, err, match):
    cfg = tcfg.tiny(**MODEL)
    if err is not None:
        with pytest.raises(err, match=match):
            ttr.check_supported(cfg, MeshConfig(**mesh))
        return
    ttr.check_supported(cfg, MeshConfig(**mesh))
    # the model builds on the mesh (coordinate 0's boxes): an expert
    # leaf is cut along the experts by ep and along "expert_mlp" by tp
    E, F = cfg.num_experts, cfg.ffn_dim
    ep, tp = mesh.get("ep", 1), mesh.get("tp", 1)
    model = ttr.init_params(torch.Generator().manual_seed(0), cfg, mesh=MeshConfig(**mesh))
    for n, p in model.named_parameters():
        if n.endswith(".moe.w_up"):
            assert tuple(p.shape) == (E // ep, cfg.model_dim, F // tp)
        elif n.endswith(".moe.w_down"):
            assert tuple(p.shape) == (E // ep, F // tp, cfg.model_dim)
        elif n.endswith(".moe.gate"):
            assert tuple(p.shape) == (cfg.model_dim, E)


def test_ep_on_a_dense_model_raises():
    with pytest.raises(ValueError, match="MoE config"):
        ttr.check_supported(tcfg.tiny(), MeshConfig(ep=2))
