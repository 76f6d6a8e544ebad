"""Port parity: the dlrover_tpu_torch transformer against the JAX
package's ``forward`` / ``loss_fn`` on converted weights, in f32.

Tolerances: 1e-5 on logits and loss, 1e-4 on gradients (f32 sums in a
different order over a few layers)."""

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import transformer as jtr
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import transformer as ttr
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy

TOL = 1e-5
GRAD_TOL = 1e-4

# tiny Llama (RoPE, RMSNorm, SwiGLU, GQA, untied) and tiny GPT-2
# (learned positions, LayerNorm, tanh-GELU, MHA, tied)
CONFIGS = {
    "llama": {},
    "gpt2": dict(rope=False, rmsnorm=False, swiglu=False,
                 tie_embeddings=True, num_kv_heads=None),
    "gpt2_mup": dict(rope=False, rmsnorm=False, swiglu=False,
                     tie_embeddings=True, num_kv_heads=None,
                     mup_attn_scale=1 / 8.0, mup_output_mult=0.5),
}


def _setup(name, seed=0):
    jc, tc = jcfg.tiny(**CONFIGS[name]), tcfg.tiny(**CONFIGS[name])
    params = jax.device_get(jtr.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    data = rng.integers(0, jc.vocab_size, (2, 33)).astype(np.int32)
    return jc, tc, params, data[:, :-1], data[:, 1:]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_and_loss_match_jax(name):
    jc, tc, params, x, y = _setup(name)
    model = params_from_jax(params, tc)
    logits_j, _ = jtr.forward(params, x, jc)
    loss_j = jtr.loss_fn(params, x, y, jc)
    with torch.no_grad():
        logits_t, aux = ttr.forward(model, torch.from_numpy(x).long(), tc)
        loss_t = ttr.loss_fn(model, torch.from_numpy(x).long(), torch.from_numpy(y).long(), tc)
    assert logits_t.dtype == torch.float32 and set(aux) == {"balance", "z"}
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_grads_match_jax(name):
    jc, tc, params, x, y = _setup(name, seed=1)
    model = params_from_jax(params, tc)
    g_j = jax.grad(jtr.loss_fn)(params, x, y, jc)
    loss = ttr.loss_fn(model, torch.from_numpy(x).long(), torch.from_numpy(y).long(), tc)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads.items():
        ref = g_j
        for part in n.split("."):
            ref = ref[int(part)] if part.isdigit() else ref[part]
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=GRAD_TOL, err_msg=n)


def test_conversion_round_trips_and_orders_leaves_like_jax():
    jc, tc, params, _, _ = _setup("gpt2")
    model = params_from_jax(params, tc)
    back = params_to_numpy(model)
    j_leaves, j_def = jax.tree.flatten(params)
    b_leaves, b_def = jax.tree.flatten(back)
    assert j_def == b_def
    for a, b in zip(j_leaves, b_leaves):
        np.testing.assert_array_equal(a, b)
    ordered = [p.detach().numpy() for p in model.jax_ordered_parameters()]
    for a, b in zip(j_leaves, ordered):
        np.testing.assert_array_equal(a, b)


def test_init_params_shapes_match_jax():
    jc, tc = jcfg.tiny(), tcfg.tiny()
    j = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), jc))
    model = ttr.init_params(torch.Generator().manual_seed(0), tc)
    shapes = jax.tree.map(lambda s: tuple(s.shape), params_to_numpy(model))
    assert shapes == jax.tree.map(lambda s: tuple(s.shape), j)


@pytest.mark.parametrize(
    "override,item",
    [
        # MoE with tp raised naming A19 until that item landed: it builds
        (dict(num_experts=4), "A19"),
        (dict(int8_mlp=True), "A12"),
    ],
)
def test_unported_switches_raise_naming_roadmap_item(override, item):
    from dlrover_tpu_torch.parallel.mesh import MeshConfig

    if override.get("num_experts"):
        cfg = tcfg.tiny(**override)
        model = ttr.init_params(torch.Generator().manual_seed(0), cfg, mesh=MeshConfig(tp=2))
        w_up = dict(model.named_parameters())["layers.1.moe.w_up"]
        assert tuple(w_up.shape) == (4, cfg.model_dim, cfg.ffn_dim // 2)
        return
    with pytest.raises(NotImplementedError, match=item):
        ttr.init_params(torch.Generator().manual_seed(0), tcfg.tiny(**override), mesh=None)
