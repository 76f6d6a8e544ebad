"""The port's hand-written kernels against their plain PyTorch versions
on the card. Marked ``cuda``; on a host without a card every test skips
(decided inside a fixture, so every worker collects the same tests).

Run on the card:  python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: attention outputs and gradients within 0.2 of the plain f32
result's rms in every 64-row tile (the kernels' tile; bf16 inputs and
outputs, p and ds rounded to bf16 before their products), lse within
1e-3; the 8-bit update's codes may
differ by 1 on at most 0.1 % of elements, scales and deltas within 1e-6
of their largest value. The plain versions run with TF32 off."""

import math

import pytest
import torch

from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import quantized_optim as qo

pytestmark = pytest.mark.cuda

ATTN_TOL = 0.2  # per 64-row tile, over the tile's rms (see _tile_err)
LSE_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _tile_err(got, ref, rows=64):
    """Largest over 64-row tiles of max |got - ref| / rms(ref tile); empty
    tiles are floored at 1e-3 of the tensor's rms."""
    ref = ref.float()
    shape = ref.shape[:-2] + (ref.shape[-2] // rows, rows * ref.shape[-1])
    err = (got.float() - ref).abs().reshape(shape).amax(-1)
    rms = ref.reshape(shape).square().mean(-1).sqrt()
    return (err / rms.clamp_min(1e-3 * ref.square().mean().sqrt())).max().item()


@pytest.mark.parametrize(
    "B,H,Hkv,T,D,q_off,k_off",
    [
        (2, 4, 4, 256, 64, 0, 0),
        (1, 4, 4, 256, 128, 0, 0),
        (1, 8, 2, 192, 128, 0, 0),
        (2, 4, 4, 256, 64, 0, 128),  # whole tiles skipped, empty rows
        (1, 4, 2, 128, 64, 256, 0),  # every key visible
    ],
)
def test_attention_kernels_match_plain(dev, B, H, Hkv, T, D, q_off, k_off):
    g = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn((B, H, T, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    fa.reset_launch_counts()
    kw = dict(causal=True, q_offset=q_off, k_offset=k_off, layout="bhtd")
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts == {"fa_fwd": 1, "fa_bwd_dkdv": 1, "fa_bwd_dq": 1}
    leaves = [x.float().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    o_ref, lse_ref = fa.flash_attention_reference(
        *leaves, causal=True, q_offset=q_off, k_offset=k_off, return_residuals=True
    )
    refs = torch.autograd.grad(o_ref, leaves, do.float().transpose(1, 2))
    assert _tile_err(o, o_ref.detach().transpose(1, 2)) <= ATTN_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.bfloat16
        assert _tile_err(got, ref.transpose(1, 2)) <= ATTN_TOL


def test_autograd_op_counts_one_launch_each(dev):
    q, k, v = (torch.randn((1, 2, 128, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v, layout="bhtd").square().sum().backward()
    assert fa.launch_counts == {"fa_fwd": 1, "fa_bwd_dkdv": 1, "fa_bwd_dq": 1}
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_cuda_refuses_mask_fn(dev):
    x = torch.zeros((1, 2, 128, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(x, x, x, mask_fn=lambda a, b: a >= b, layout="bhtd")


@pytest.mark.parametrize("classic", [True, False])
def test_adam8_kernel_matches_plain(dev, classic):
    R = 4096
    g = torch.Generator(device=dev).manual_seed(1)
    grad = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    m0 = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    v0 = torch.rand((R, 128), generator=g, device=dev) * 1e-6

    def state():
        return [qo.Quantized8(*qo._quant_block_math_wide(x, s), (R * 128,), s)
                for x, s in ((m0, True), (v0, False))]

    scalars = (3e-4 / (1 - 0.9**2), 1 / (1 - 0.999**2), 1e-8)
    scalars = tuple(float(torch.tensor(x, dtype=torch.float32)) for x in scalars)
    (mk, vk), (mp, vp) = state(), state()
    qo.reset_launch_counts()
    dk = qo.adam8_update_flat(grad, mk, vk, scalars, 0.9, 0.999, classic)
    dp = qo._adam8_update_plain(grad, mp, vp, scalars, 0.9, 0.999, classic)
    torch.cuda.synchronize()
    assert qo.launch_counts["adam8_flat"] == 1
    for a, b in ((mk, mp), (vk, vp)):
        diff = (a.codes.int() - b.codes.int()).abs()
        assert diff.max().item() <= 1 and diff.float().mean().item() <= 1e-3
        assert _rel(a.scales, b.scales) <= 1e-6
    assert _rel(dk, dp) <= 1e-6


def test_small_train_step_on_the_card(dev):
    from dataclasses import replace

    from dlrover_tpu_torch.models import gpt2_small, train
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    cfg = replace(gpt2_small(), num_layers=2, model_dim=128, num_heads=2, vocab_size=512, max_seq_len=128)
    tx = build_optimizer("adamw_8bit_flat", lr=1e-3, min_quantized_size=4096)
    state = train.init_state(cfg, tx, seed=0)
    step = train.build_train_step(cfg, tx)
    x = torch.randint(0, 512, (4, 128), device=dev)
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    losses = []
    for _ in range(3):
        state, m = step(state, x, x.roll(-1, 1))
        losses.append(float(m["loss"]))
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert fa.launch_counts == {"fa_fwd": 6, "fa_bwd_dkdv": 6, "fa_bwd_dq": 6}
    assert qo.launch_counts["adam8_flat"] == 3 * len(state.opt_state.opt.layout.groups)
