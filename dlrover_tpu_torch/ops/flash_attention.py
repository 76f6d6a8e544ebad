"""Flash attention on Hopper (counterpart of
``dlrover_tpu/ops/flash_attention.py``).

Three hand-written CUDA kernels (``csrc/flash_attention.cu``) stand in
for the JAX package's six Pallas attention kernels:

- ``fa_fwd`` for ``_fused_fwd_kernel`` and the streaming ``_fwd_kernel``;
- ``fa_bwd_dkdv`` for the dk/dv half of ``_fused_bwd_kernel`` and for
  ``_bwd_dkv_kernel``;
- ``fa_bwd_dq`` for the dq half of ``_fused_bwd_kernel`` and for
  ``_bwd_dq_kernel``.

A Hopper block cannot keep the fused kernels' ``[T, T]`` f32 score tile,
so every kernel tiles with the streaming algebra; the fused and
streaming contracts compute the same function and each keeps its own
check. ``fa_fwd`` and ``fa_bwd_dq`` (128 query rows a block, 64-key
tiles) and ``fa_bwd_dkdv`` (128 keys a block, 64-query steps) are built
on TMA loads, ``wgmma`` and a producer warpgroup, with scores,
probabilities and accumulators in registers (the source's header has
the design). ``delta = rowsum(do * o)`` stays a plain
reduction outside the kernels, as in the JAX code. The backward
kernels write bf16 gradients, except dk/dv under GQA: those are written
in f32 per query head and each group is summed outside the kernel.

Dispatch is by device: a tensor on the CPU takes the plain PyTorch
version (``flash_attention_reference`` forward, ``_bwd_plain``
backward); a CUDA tensor takes the kernels or raises
``NotImplementedError`` for what they do not take (a ``mask_fn``, a
dtype other than bf16, head_dim other than 64/128, a length not a
multiple of 64). Nothing falls back from the card to the plain path.

Layouts are the JAX entry's: ``bthd`` (``[B, T, H, D]``, the default)
or the kernel-native ``bhtd``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

NEG_INF = -1e30  # finite stand-in for -inf, as in the JAX package
_TILE = 64  # lengths come in 64-row tiles: a consumer warpgroup's rows
# the tile schedule of csrc/flash_attention.cu (FWD_BM, FWD_BN, DKV_BN,
# DKV_BM there): the forward and dq take 128 query rows a block, 64 each
# of two consumer warpgroups, against 64-key tiles; dk/dv takes 128 keys
# a block, 64 each, against 64-query steps
FWD_BLOCK_Q, FWD_BLOCK_K = 128, 64
DQ_BLOCK_Q, DQ_BLOCK_K = FWD_BLOCK_Q, FWD_BLOCK_K
DKV_BLOCK_K, DKV_BLOCK_Q = 128, 64
_HEAD_DIMS = (64, 128)

MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# launches per kernel, counted where the wrapper launches it
launch_counts: Dict[str, int] = {"fa_fwd": 0, "fa_bwd_dkdv": 0, "fa_bwd_dq": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fa_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "fa_bwd_dkdv": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _I, _P],
    "fa_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lib():
    from dlrover_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _mask_for_block(q_pos, k_pos, causal, mask_fn):
    """[Tq,1] x [1,Tk] positions -> bool mask or None (= all visible)."""
    if mask_fn is not None:
        return mask_fn(q_pos, k_pos)
    if causal:
        return q_pos >= k_pos
    return None


def _swap(x, layout):
    """The caller's layout <-> the kernels' [B,H,T,D] (for ``bthd`` a
    transpose, its own inverse)."""
    return x if layout == "bhtd" else x.transpose(1, 2)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------
def flash_attention_reference(
    q,
    k,
    v,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    mask_fn: Optional[MaskFn] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    return_residuals: bool = False,
):
    """Same semantics as the kernels, materialized scores, ``[B,T,H,D]``.
    Differentiable through autograd. Returns ``o`` (and ``lse [B,H,Tq]``
    f32 with ``return_residuals``)."""
    D = q.shape[-1]
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = sm_scale if sm_scale is not None else D**-0.5
    # f32 products of the input values: exact for bf16 inputs, as the
    # JAX reference's preferred_element_type=f32
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    Tq, Tk = q.shape[1], k.shape[1]
    q_pos = (q_offset + torch.arange(Tq, device=q.device))[:, None]
    k_pos = (k_offset + torch.arange(Tk, device=q.device))[None, :]
    mask = _mask_for_block(q_pos, k_pos, causal, mask_fn)
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = m.clamp_min(NEG_INF)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    visible = m > NEG_INF / 2
    o = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), v.float())
    o = torch.where(visible.transpose(1, 2), o, 0.0).to(q.dtype)
    if not return_residuals:
        return o
    lse = torch.where(
        visible, m_safe + torch.log(l.clamp_min(1e-30)), NEG_INF
    ).squeeze(-1)
    return o, lse


def _bwd_plain(qt, kt, vt, dot, lse, delta, scale, causal, mask_fn,
               q_offset, k_offset):
    """The backward kernels' math on ``[B,H,T,D]`` tensors: p recomputed
    from ``lse`` (0 on rows whose lse is NEG_INF), ``ds = p (dp - delta)
    scale``; returns f32 ``dq`` and per-q-head f32 ``dk``, ``dv``."""
    H, Hkv = qt.shape[1], kt.shape[1]
    kf = kt.float().repeat_interleave(H // Hkv, dim=1)
    vf = vt.float().repeat_interleave(H // Hkv, dim=1)
    qf, dof = qt.float(), dot.float()
    Tq, Tk = qt.shape[2], kt.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    q_pos = (q_offset + torch.arange(Tq, device=qt.device))[:, None]
    k_pos = (k_offset + torch.arange(Tk, device=qt.device))[None, :]
    mask = _mask_for_block(q_pos, k_pos, causal, mask_fn)
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    lse4 = lse[..., None]
    p = torch.where(lse4 > NEG_INF * 0.5, torch.exp(s - lse4), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    # products consume p and ds rounded to the input dtype, as the kernels
    lo = qt.dtype
    p_lo, ds_lo = p.to(lo).float(), ds.to(lo).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_lo, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_lo, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_lo, dof)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers ([B,H,T,D] contiguous bf16 on one CUDA device)
# ---------------------------------------------------------------------------
def _check_cuda(q, k, v, mask_fn, q_offset, k_offset):
    if mask_fn is not None:
        raise NotImplementedError(
            "mask_fn on CUDA: the kernels take causal or no mask only "
            "(ROADMAP A3); run a custom mask on the CPU reference"
        )
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must lie on one device")
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"flash attention kernels take bf16, got {t.dtype}"
            )
    if D not in _HEAD_DIMS or k.shape[-1] != D or v.shape != k.shape:
        raise NotImplementedError(
            f"head_dim {D} (k {tuple(k.shape)}, v {tuple(v.shape)}): the "
            f"kernels take head_dim in {_HEAD_DIMS} and v shaped as k"
        )
    if Tq % _TILE or Tk % _TILE:
        raise NotImplementedError(
            f"sequence lengths {Tq}/{Tk} must be multiples of {_TILE}"
        )
    if H % Hkv or k.shape[0] != B:
        raise ValueError(f"{Hkv} kv heads do not divide {H} heads")
    if not (isinstance(q_offset, int) and isinstance(k_offset, int)):
        raise NotImplementedError("the kernels take int offsets only")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' bulk loads need (a
    view into the middle of a buffer may be neither)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_cuda(qt, kt, vt, scale, causal, q_offset, k_offset):
    qt, kt, vt = (_dense(x) for x in (qt, kt, vt))
    B, H, Tq, D = qt.shape
    Hkv, Tk = kt.shape[1], kt.shape[2]
    o = torch.empty_like(qt)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=qt.device)
    lib = _lib()
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_fwd(
            _ptr(qt), _ptr(kt), _ptr(vt), _ptr(o), _ptr(lse),
            B, H, Hkv, Tq, Tk, D, float(scale), int(causal),
            q_offset, k_offset, stream,
        )
    if err:
        raise RuntimeError(f"fa_fwd launch failed: CUDA error {err}")
    launch_counts["fa_fwd"] += 1
    return o, lse


def _bwd_launch(name, outs, qt, kt, vt, dot, lse, delta, scale, causal,
                q_offset, k_offset):
    """One backward kernel (``fa_bwd_dkdv`` writes ``outs = (dk, dv)``
    per q head, bf16 or f32; ``fa_bwd_dq`` writes ``outs = (dq,)``, bf16)
    on contiguous, 16-byte aligned ``[B,H,T,D]`` inputs, f32
    ``lse``/``delta [B,H,Tq]``."""
    B, H, Tq, D = qt.shape
    Hkv, Tk = kt.shape[1], kt.shape[2]
    out_bf16 = outs[0].dtype == torch.bfloat16
    if name == "fa_bwd_dq" and not out_bf16:
        raise ValueError("fa_bwd_dq writes bf16")
    flag = (int(out_bf16),) if name == "fa_bwd_dkdv" else ()
    fn = getattr(_lib(), name)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            _ptr(qt), _ptr(kt), _ptr(vt), _ptr(dot), _ptr(lse), _ptr(delta),
            *(_ptr(o) for o in outs),
            B, H, Hkv, Tq, Tk, D, float(scale), int(causal),
            q_offset, k_offset, *flag, stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _bwd_cuda(qt, kt, vt, ot, lse, dot, scale, causal, q_offset, k_offset):
    qt, kt, vt, dot = (_dense(x) for x in (qt, kt, vt, dot))
    lse = _dense(lse.float())
    B, H, Tq, D = qt.shape
    Hkv, Tk = kt.shape[1], kt.shape[2]
    # bandwidth-bound rowsum, left to PyTorch as the JAX code leaves it
    # to XLA
    delta = (dot.float() * ot.float()).sum(-1)
    # per-q-head dk/dv in f32 under GQA, summed per group by the caller
    gdt = qt.dtype if Hkv == H else torch.float32
    dk = torch.empty((B, H, Tk, D), dtype=gdt, device=qt.device)
    dv = torch.empty_like(dk)
    dq = torch.empty_like(qt)
    args = (qt, kt, vt, dot, lse, delta, scale, causal, q_offset, k_offset)
    _bwd_launch("fa_bwd_dkdv", (dk, dv), *args)
    _bwd_launch("fa_bwd_dq", (dq,), *args)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# raw entries (non-differentiable), dispatching on the tensors' device
# ---------------------------------------------------------------------------
def flash_attention_fwd(
    q,
    k,
    v,
    *,
    causal=True,
    sm_scale=None,
    mask_fn=None,
    q_offset=0,
    k_offset=0,
    layout="bthd",
):
    """Forward; returns ``(o, lse)`` with lse ``[B,H,Tq]`` f32."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    qt, kt, vt = (_swap(x, layout) for x in (q, k, v))
    if q.device.type == "cuda":
        _check_cuda(qt, kt, vt, mask_fn, q_offset, k_offset)
        ot, lse = _fwd_cuda(qt, kt, vt, scale, causal, q_offset, k_offset)
        return _swap(ot, layout), lse
    o, lse = flash_attention_reference(
        *(x.transpose(1, 2) for x in (qt, kt, vt)),
        causal=causal, sm_scale=scale, mask_fn=mask_fn,
        q_offset=q_offset, k_offset=k_offset, return_residuals=True,
    )
    return _swap(o.transpose(1, 2), layout), lse


def flash_attention_bwd(
    q,
    k,
    v,
    o,
    lse,
    do,
    *,
    causal=True,
    sm_scale=None,
    mask_fn=None,
    q_offset=0,
    k_offset=0,
    layout="bthd",
):
    """Backward from the saved residuals; returns ``(dq, dk, dv)`` in
    the inputs' dtypes."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    qt, kt, vt, ot, dot = (_swap(x, layout) for x in (q, k, v, o, do))
    if q.device.type == "cuda":
        _check_cuda(qt, kt, vt, mask_fn, q_offset, k_offset)
        dq, dk, dv = _bwd_cuda(
            qt, kt, vt, ot, lse, dot, scale, causal, q_offset, k_offset
        )
    else:
        delta = (dot.float() * ot.float()).sum(-1)
        dq, dk, dv = _bwd_plain(
            qt, kt, vt, dot, lse.float(), delta, scale, causal, mask_fn,
            q_offset, k_offset,
        )
    B, H, Tk, D = dk.shape
    Hkv = kt.shape[1]
    if Hkv != H:  # per-q-head grads fold onto their kv head
        dk = dk.view(B, Hkv, H // Hkv, Tk, D).sum(2)
        dv = dv.view(B, Hkv, H // Hkv, Tk, D).sum(2)
    return (
        _swap(dq.to(q.dtype), layout),
        _swap(dk.to(k.dtype), layout),
        _swap(dv.to(v.dtype), layout),
    )


class _FlashAttention(torch.autograd.Function):
    """The kernels' forward and backward as one differentiable op (the
    port of the JAX ``custom_vjp``); on the CPU the same composition
    runs the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, k_offset, layout):
        o, lse = flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=sm_scale,
            q_offset=q_offset, k_offset=k_offset, layout=layout,
        )
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, q_offset, k_offset, layout)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, q_offset, k_offset, layout = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
            q_offset=q_offset, k_offset=k_offset, layout=layout,
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    mask_fn: Optional[MaskFn] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    return_residuals: bool = False,
    layout: str = "bthd",
):
    """Flash attention over ``q:[B,Tq,H,D] k,v:[B,Tk,Hkv,D]`` (or
    ``[B,H,T,D]`` with ``layout="bhtd"``), differentiable.

    ``return_residuals`` returns the raw forward ``(o, lse)`` (callers
    own the gradient, as the JAX entry). A ``mask_fn`` runs the
    materialized reference on the CPU and raises on CUDA."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"unknown layout {layout!r}")
    if return_residuals:
        return flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=sm_scale, mask_fn=mask_fn,
            q_offset=q_offset, k_offset=k_offset, layout=layout,
        )
    if mask_fn is not None:
        if q.device.type == "cuda":
            _check_cuda(q, k, v, mask_fn, q_offset, k_offset)  # raises
        if layout == "bhtd":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        o = flash_attention_reference(
            q, k, v,
            causal=causal, sm_scale=sm_scale, mask_fn=mask_fn,
            q_offset=q_offset, k_offset=k_offset,
        )
        return o if layout == "bthd" else o.transpose(1, 2)
    return _FlashAttention.apply(
        q, k, v, causal, sm_scale, q_offset, k_offset, layout
    )
