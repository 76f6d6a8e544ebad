"""Port parity: dlrover_tpu_torch flash attention (its plain CPU path)
against the JAX package's Pallas kernels in interpret mode.

Tolerances are the JAX package's own (tests/test_ops.py): 2e-5 on the
forward in f32, 5e-4 on gradients.

The CUDA kernels cannot run without a card, so their tile schedule is
rehearsed here in PyTorch (``_emulate_fwd``, ``_emulate_dq``,
``_emulate_dkdv``): the same blocks, warpgroup rows, key / query tiles,
full / crossed / skipped classification and exp2-domain arithmetic as
``csrc/flash_attention.cu``, held to the plain versions and to the JAX
package."""

import importlib
import math

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


# ---------------------------------------------------------------------------
# rehearsal of the CUDA kernels' tile schedule
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = tfa.NEG_INF
WGR = tfa._TILE  # rows of a consumer warpgroup


def _emulate_fwd(q, k, v, causal, q_off, k_off):
    """``fa_fwd`` tile by tile on ``[B,H,T,D]`` tensors: 128-row blocks of
    two 64-row warpgroups, 64-key tiles, tiles wholly in the future never
    loaded, the mask only on tiles the diagonal crosses, online softmax in
    the exp2 domain, p rounded to the input dtype before its product.
    Returns o, lse and, for head (0, 0), which (warpgroup row, key tile)
    pairs were computed and how, and how many tiles each block loaded."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    BM, BN = tfa.FWD_BLOCK_Q, tfa.FWD_BLOCK_K
    scale_log2 = D**-0.5 * LOG2E
    o = torch.zeros_like(q)
    lse = torch.full((B, H, Tq), NEG)
    classes, loaded = {}, {}
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for q0 in range(0, Tq, BM):
                rows_here = min(BM, Tq - q0)
                nk = Tk // BN
                if causal:
                    lim = q_off + q0 + rows_here - 1 - k_off
                    nk = 0 if lim < 0 else min(nk, lim // BN + 1)
                loaded[q0] = nk
                for qw0 in range(q0, q0 + rows_here, WGR):
                    qpos = q_off + qw0 - k_off
                    nk_wg = n_full = nk
                    if causal and nk:
                        nk_wg = 0 if qpos + 63 < 0 else min(nk, (qpos + 63) // BN + 1)
                        n_full = min(nk_wg, max(0, (qpos - BN + 1) // BN + 1))
                    m = torch.full((WGR,), NEG)
                    l = torch.zeros(WGR)
                    acc = torch.zeros(WGR, D)
                    qw = q[b, h, qw0:qw0 + WGR].float()
                    for j in range(nk_wg):
                        kj = k[b, hk, j * BN:(j + 1) * BN].float()
                        s = qw @ kj.T * scale_log2
                        if j >= n_full:
                            qp = q_off + qw0 + torch.arange(WGR)[:, None]
                            kp = k_off + j * BN + torch.arange(BN)[None, :]
                            s = torch.where(qp >= kp, s, NEG)
                        if (b, h) == (0, 0):
                            classes[(qw0, j)] = "full" if j < n_full else "crossed"
                        mn = torch.maximum(m, s.amax(1))
                        ms = torch.where(mn > NEG * 0.5, mn, 0.0)
                        a = torch.exp2(m - ms)
                        p = torch.exp2(s - ms[:, None])
                        l = l * a + p.sum(1)
                        pv = p.to(q.dtype).float() @ v[b, hk, j * BN:(j + 1) * BN].float()
                        acc = acc * a[:, None] + pv
                        m = mn
                    seen = l > 0
                    o[b, h, qw0:qw0 + WGR] = (acc / torch.where(seen, l, 1.0)[:, None]).to(q.dtype)
                    lse[b, h, qw0:qw0 + WGR] = torch.where(
                        seen, m * LN2 + torch.log(l.clamp_min(1e-30)), NEG)
    return o, lse, classes, loaded


def _emulate_dkdv(q, k, v, do, lse, delta, causal, q_off, k_off):
    """``fa_bwd_dkdv`` tile by tile: 128-key blocks of two 64-key
    warpgroups, 64-query steps from the causal diagonal on, p recomputed
    from lse in the exp2 domain, p and ds rounded to the input dtype
    before their products. Returns per-query-head f32 dk, dv and the
    computed (warpgroup key row, query tile) pairs of head (0, 0)."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    BN, BM = tfa.DKV_BLOCK_K, tfa.DKV_BLOCK_Q
    scale = D**-0.5
    dk = torch.zeros((B, H, Tk, D))
    dv = torch.zeros((B, H, Tk, D))
    classes = {}
    nq = Tq // BM
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for k0 in range(0, Tk, BN):
                i_start = min(nq, max(0, (k_off + k0 - q_off) // BM)) if causal else 0
                for kw0 in range(k0, min(k0 + BN, Tk), WGR):
                    kpos = k_off + kw0 - q_off
                    i_first, i_full = i_start, 0
                    if causal:
                        i_first = max(i_start, kpos // BM)
                        i_full = (kpos + 63 + BM - 1) // BM
                    kw = k[b, hk, kw0:kw0 + WGR].float()
                    vw = v[b, hk, kw0:kw0 + WGR].float()
                    for qi in range(i_start, nq):
                        if qi < i_first:
                            continue
                        rows = slice(qi * BM, (qi + 1) * BM)
                        qt, dot = q[b, h, rows].float(), do[b, h, rows].float()
                        lq, dl = lse[b, h, rows][None, :], delta[b, h, rows][None, :]
                        st = kw @ qt.T
                        dpt = vw @ dot.T
                        vis = (lq > NEG * 0.5).expand(WGR, BM)
                        if qi < i_full:
                            qp = q_off + qi * BM + torch.arange(BM)[None, :]
                            kp = k_off + kw0 + torch.arange(WGR)[:, None]
                            vis = vis & (qp >= kp)
                        if (b, h) == (0, 0):
                            classes[(kw0, qi)] = "full" if qi >= i_full else "crossed"
                        p = torch.where(vis, torch.exp2(st * (scale * LOG2E) - lq * LOG2E), 0.0)
                        dv[b, h, kw0:kw0 + WGR] += p.to(q.dtype).float() @ dot
                        ds = p * (dpt - dl) * scale
                        dk[b, h, kw0:kw0 + WGR] += ds.to(q.dtype).float() @ qt
    return dk, dv, classes


def _emulate_dq(q, k, v, do, lse, delta, causal, q_off, k_off):
    """``fa_bwd_dq`` tile by tile: the forward's blocks (128 query rows,
    two 64-row warpgroups) against 64-key tiles up to each block's last
    visible one, the mask only on tiles the diagonal crosses, p recomputed
    from lse in the exp2 domain (a row whose lse is NEG_INF takes +1e30,
    so its p is 0), ds rounded to the input dtype before dS K. Returns f32
    dq, which (warpgroup row, key tile) pairs of head (0, 0) were computed
    and how, and how many tiles each block loaded."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    BM, BN = tfa.DQ_BLOCK_Q, tfa.DQ_BLOCK_K
    scale = D**-0.5
    dq = torch.zeros((B, H, Tq, D))
    classes, loaded = {}, {}
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for q0 in range(0, Tq, BM):
                rows_here = min(BM, Tq - q0)
                nk = Tk // BN
                if causal:
                    lim = q_off + q0 + rows_here - 1 - k_off
                    nk = 0 if lim < 0 else min(nk, lim // BN + 1)
                loaded[q0] = nk
                for qw0 in range(q0, q0 + rows_here, WGR):
                    qpos = q_off + qw0 - k_off
                    nk_wg = n_full = nk
                    if causal and nk:
                        nk_wg = 0 if qpos + 63 < 0 else min(nk, (qpos + 63) // BN + 1)
                        n_full = min(nk_wg, max(0, (qpos - BN + 1) // BN + 1))
                    rows = slice(qw0, qw0 + WGR)
                    lq = lse[b, h, rows]
                    lq = torch.where(lq > NEG * 0.5, lq * LOG2E, -NEG)[:, None]
                    dl = delta[b, h, rows][:, None]
                    qw, dow = q[b, h, rows].float(), do[b, h, rows].float()
                    acc = torch.zeros(WGR, D)
                    for j in range(nk_wg):
                        kj = k[b, hk, j * BN:(j + 1) * BN].float()
                        vj = v[b, hk, j * BN:(j + 1) * BN].float()
                        x = qw @ kj.T * (scale * LOG2E) - lq
                        if j >= n_full:
                            qp = q_off + qw0 + torch.arange(WGR)[:, None]
                            kp = k_off + j * BN + torch.arange(BN)[None, :]
                            x = torch.where(qp >= kp, x, NEG)
                        if (b, h) == (0, 0):
                            classes[(qw0, j)] = "full" if j < n_full else "crossed"
                        ds = torch.exp2(x) * (dow @ vj.T - dl) * scale
                        acc += ds.to(q.dtype).float() @ kj
                    dq[b, h, rows] = acc
    return dq, classes, loaded


def _tile_classes(Tq, Tk, causal, q_off, k_off, by_key=False):
    """What a 64 x 64 tile is, from the mask itself: every (64-row
    warpgroup, 64-wide tile) pair with a visible entry, 'full' if all of
    its entries are visible."""
    qp = q_off + torch.arange(Tq)[:, None]
    kp = k_off + torch.arange(Tk)[None, :]
    vis = (qp >= kp) if causal else torch.ones(Tq, Tk, dtype=torch.bool)
    out = {}
    for r in range(0, Tq, 64):
        for c in range(0, Tk, 64):
            blk = vis[r:r + 64, c:c + 64]
            if blk.any():
                key = (c, r // 64) if by_key else (r, c // 64)
                out[key] = "full" if blk.all() else "crossed"
    return out


SCHEDULE_CASES = [
    (T, qo, ko, causal, Hkv)
    for T in (64, 192, 256)
    for qo, ko in ((0, 0), (0, 128), (256, 0), (0, 32), (40, 0))
    for causal in (True, False)
    for Hkv in (4, 2)
]


@pytest.mark.parametrize("T,qo,ko,causal,Hkv", SCHEDULE_CASES)
def test_forward_tile_schedule_matches_plain(T, qo, ko, causal, Hkv):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(B=1, Hkv=Hkv, T=T, D=16, seed=3))
    o_e, lse_e, classes, loaded = _emulate_fwd(q, k, v, causal, qo, ko)
    o_r, lse_r = tfa.flash_attention_reference(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=causal, q_offset=qo,
        k_offset=ko, return_residuals=True)
    np.testing.assert_allclose(o_e.numpy(), o_r.transpose(1, 2).numpy(), atol=FWD_TOL)
    np.testing.assert_allclose(lse_e.numpy(), lse_r.numpy(), atol=FWD_TOL, rtol=0)
    # exactly the tiles with a visible entry are computed, the mask is
    # applied on exactly those the diagonal crosses, and a block loads no
    # tile past the last one any of its rows sees
    want = _tile_classes(T, T, causal, qo, ko)
    assert classes == want
    for q0, n in loaded.items():
        seen = [j for (r, j) in want if q0 <= r < q0 + tfa.FWD_BLOCK_Q]
        assert n == (max(seen) + 1 if seen else 0)


@pytest.mark.parametrize("T,qo,ko,causal,Hkv", SCHEDULE_CASES)
def test_dkdv_tile_schedule_matches_plain(T, qo, ko, causal, Hkv):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B=1, Hkv=Hkv, T=T, D=16, seed=4))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, q_offset=qo,
                                     k_offset=ko, layout="bhtd")
    delta = (do * o).sum(-1)
    dk_e, dv_e, classes = _emulate_dkdv(q, k, v, do, lse, delta, causal, qo, ko)
    _, dk_r, dv_r = tfa._bwd_plain(q, k, v, do, lse, delta, 16**-0.5, causal, None, qo, ko)
    np.testing.assert_allclose(dk_e.numpy(), dk_r.numpy(), atol=BWD_TOL)
    np.testing.assert_allclose(dv_e.numpy(), dv_r.numpy(), atol=BWD_TOL)
    assert classes == _tile_classes(T, T, causal, qo, ko, by_key=True)


@pytest.mark.parametrize("T,qo,ko,causal,Hkv", SCHEDULE_CASES)
def test_dq_tile_schedule_matches_plain(T, qo, ko, causal, Hkv):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B=1, Hkv=Hkv, T=T, D=16, seed=5))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, q_offset=qo,
                                     k_offset=ko, layout="bhtd")
    delta = (do * o).sum(-1)
    dq_e, classes, loaded = _emulate_dq(q, k, v, do, lse, delta, causal, qo, ko)
    dq_r, _, _ = tfa._bwd_plain(q, k, v, do, lse, delta, 16**-0.5, causal, None, qo, ko)
    np.testing.assert_allclose(dq_e.numpy(), dq_r.numpy(), atol=BWD_TOL)
    # the forward's tiles: exactly those with a visible entry, masked
    # exactly where the diagonal crosses, none loaded past a block's last
    want = _tile_classes(T, T, causal, qo, ko)
    assert classes == want
    for q0, n in loaded.items():
        seen = [j for (r, j) in want if q0 <= r < q0 + tfa.DQ_BLOCK_Q]
        assert n == (max(seen) + 1 if seen else 0)


@pytest.mark.parametrize("name,H,Hkv,causal,qo,ko,fused", CASES)
def test_forward_tile_schedule_matches_jax(name, H, Hkv, causal, qo, ko, fused):
    q, k, v, _ = _inputs(H=H, Hkv=Hkv)
    o_j, lse_j = _jax_fwd(q, k, v, causal, qo, ko, fused)
    o_e, lse_e, _, _ = _emulate_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal, qo, ko)
    np.testing.assert_allclose(o_e.numpy(), o_j, atol=FWD_TOL)
    np.testing.assert_allclose(lse_e.numpy(), lse_j, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("name,H,Hkv,causal,qo,ko,fused", CASES)
def test_dkdv_tile_schedule_matches_jax(name, H, Hkv, causal, qo, ko, fused):
    q, k, v, do = _inputs(H=H, Hkv=Hkv, seed=1)
    o, lse = _jax_fwd(q, k, v, causal, qo, ko, fused)
    _, dk_j, dv_j = jfa.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do)), causal=causal,
        q_offset=qo, k_offset=ko, block_q=64, block_k=64, interpret=True,
        layout="bhtd", allow_fused=fused,
    )
    tq, tk, tv, tdo, to, tlse = (torch.from_numpy(np.array(x)) for x in (q, k, v, do, o, lse))
    dk_e, dv_e, _ = _emulate_dkdv(tq, tk, tv, tdo, tlse, (tdo * to).sum(-1), causal, qo, ko)
    B, _, T, D = dk_e.shape
    fold = lambda g: g.view(B, Hkv, H // Hkv, T, D).sum(2)  # noqa: E731
    np.testing.assert_allclose(fold(dk_e).numpy(), np.asarray(dk_j), atol=BWD_TOL)
    np.testing.assert_allclose(fold(dv_e).numpy(), np.asarray(dv_j), atol=BWD_TOL)


@pytest.mark.parametrize("name,H,Hkv,causal,qo,ko,fused", CASES)
def test_dq_tile_schedule_matches_jax(name, H, Hkv, causal, qo, ko, fused):
    q, k, v, do = _inputs(H=H, Hkv=Hkv, seed=1)
    o, lse = _jax_fwd(q, k, v, causal, qo, ko, fused)
    dq_j, _, _ = jfa.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do)), causal=causal,
        q_offset=qo, k_offset=ko, block_q=64, block_k=64, interpret=True,
        layout="bhtd", allow_fused=fused,
    )
    tq, tk, tv, tdo, to, tlse = (torch.from_numpy(np.array(x)) for x in (q, k, v, do, o, lse))
    dq_e, _, _ = _emulate_dq(tq, tk, tv, tdo, tlse, (tdo * to).sum(-1), causal, qo, ko)
    np.testing.assert_allclose(dq_e.numpy(), np.asarray(dq_j), atol=BWD_TOL)


def test_schedule_constants_tile_the_lengths_the_wrapper_admits():
    """Lengths come in multiples of 64; a block's last warpgroup may be
    empty (T an odd multiple of 64), never part of one."""
    assert WGR == tfa.FWD_BLOCK_K == tfa.DQ_BLOCK_K == tfa.DKV_BLOCK_Q == 64
    assert tfa.FWD_BLOCK_Q == tfa.DQ_BLOCK_Q == tfa.DKV_BLOCK_K == 2 * WGR
    assert math.isclose(LOG2E * LN2, 1.0, rel_tol=1e-12)
