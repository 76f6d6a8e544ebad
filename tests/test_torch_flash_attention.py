"""Port parity: dlrover_tpu_torch flash attention (its plain CPU path)
against the JAX package's Pallas kernels in interpret mode.

Tolerances are the JAX package's own (tests/test_ops.py): 2e-5 on the
forward in f32, 5e-4 on gradients."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import flash_attention as tfa

# the module, not the function ``dlrover_tpu.ops`` re-exports under its name
jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")

FWD_TOL = 2e-5
BWD_TOL = 5e-4


def _inputs(B=2, H=4, Hkv=4, T=128, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T, D)).astype(np.float32)
    do = rng.normal(size=(B, H, T, D)).astype(np.float32)
    return q, k, v, do


# (name, H, Hkv, causal, q_offset, k_offset, allow_fused): the fused
# short-sequence contract, the streaming contract with GQA, and offsets
# that leave the first 64 query rows without any visible key
CASES = [
    ("fused", 4, 4, True, 0, 0, True),
    ("fused_noncausal", 4, 4, False, 0, 0, True),
    ("streaming_gqa", 4, 2, True, 0, 0, False),
    ("fused_masked_rows", 4, 4, True, 0, 64, True),
    ("streaming_masked_rows", 4, 2, True, 0, 64, False),
]


def _jax_fwd(q, k, v, causal, qo, ko, fused):
    o, lse = jfa.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=qo, k_offset=ko, block_q=64, block_k=64, interpret=True,
        layout="bhtd", allow_fused=fused,
    )
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("name,H,Hkv,causal,qo,ko,fused", CASES)
def test_forward_matches_jax(name, H, Hkv, causal, qo, ko, fused):
    q, k, v, _ = _inputs(H=H, Hkv=Hkv)
    o_j, lse_j = _jax_fwd(q, k, v, causal, qo, ko, fused)
    o_t, lse_t = tfa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        q_offset=qo, k_offset=ko, layout="bhtd",
    )
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=FWD_TOL, rtol=0)
    if ko:
        assert float(np.abs(o_t.numpy()[:, :, :ko]).max()) == 0.0
        assert np.all(lse_t.numpy()[:, :, :ko] == np.float32(tfa.NEG_INF))


@pytest.mark.parametrize("name,H,Hkv,causal,qo,ko,fused", CASES)
def test_backward_matches_jax(name, H, Hkv, causal, qo, ko, fused):
    q, k, v, do = _inputs(H=H, Hkv=Hkv, seed=1)
    o, lse = _jax_fwd(q, k, v, causal, qo, ko, fused)
    g_j = jfa.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do)), causal=causal,
        q_offset=qo, k_offset=ko, block_q=64, block_k=64, interpret=True,
        layout="bhtd", allow_fused=fused,
    )
    g_t = tfa.flash_attention_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)),
        causal=causal, q_offset=qo, k_offset=ko, layout="bhtd",
    )
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL)


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("Hkv,ko", [(4, 0), (2, 0), (2, 64)])
def test_autograd_function_matches_plain_autograd(layout, Hkv, ko):
    """The differentiable op (plain forward + plain backward kernels'
    math) against autograd through the materialized reference."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(Hkv=Hkv, seed=2))
    if layout == "bthd":
        q, k, v, do = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True, k_offset=ko, layout=layout)
    g_fn = torch.autograd.grad(out, leaves, do)
    ref_in = [x.clone().requires_grad_() for x in (q, k, v)]
    args = ref_in if layout == "bthd" else [x.transpose(1, 2) for x in ref_in]
    ref = tfa.flash_attention_reference(*args, causal=True, k_offset=ko)
    if layout == "bhtd":
        ref = ref.transpose(1, 2)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=FWD_TOL)
    g_ref = torch.autograd.grad(ref, ref_in, do)
    for a, b in zip(g_fn, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=BWD_TOL)


def test_custom_mask_runs_reference_on_cpu():
    win = lambda qp, kp: (qp >= kp) & (qp - kp < 32)  # noqa: E731
    q, k, v, _ = _inputs()
    o_j = jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), mask_fn=win, force="pallas",
        block_q=64, block_k=64, layout="bhtd",
    )
    o_t = tfa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), mask_fn=win, layout="bhtd"
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=FWD_TOL)


@pytest.mark.parametrize(
    "dtype,D,T,mask_fn",
    [
        (torch.float32, 64, 128, None),  # kernels take bf16 only
        (torch.bfloat16, 32, 128, None),  # head_dim 64 / 128 only
        (torch.bfloat16, 64, 100, None),  # lengths in 64-row tiles
        (torch.bfloat16, 64, 128, lambda a, b: a >= b),  # no mask_fn
    ],
)
def test_cuda_wrapper_refuses_what_the_kernels_cannot_take(dtype, D, T, mask_fn):
    x = torch.zeros((1, 2, T, D), dtype=dtype)
    with pytest.raises(NotImplementedError):
        tfa._check_cuda(x, x, x, mask_fn, 0, 0)
