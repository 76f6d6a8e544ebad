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

Masks: the JAX package's kernels take any ``mask_fn(q_pos, k_pos)``. A
Python callable cannot enter a CUDA kernel, so the kernels take one
declared family, ``KeyIntervals``: per query row the visible keys are
``[lo, hi)`` at global positions (causal, a GLM prefix, a sliding
window, packed documents, rows that see nothing). It is also callable as
``(q_pos, k_pos) -> bool``, so the plain version, and the JAX package in
the tests, run the same mask as a function.

Dispatch is by device: a tensor on the CPU takes the plain PyTorch
version (``flash_attention_reference`` forward, ``_bwd_plain``
backward), with any ``mask_fn``; a CUDA tensor takes the kernels or
raises ``NotImplementedError`` for what they do not take (a ``mask_fn``
that is not a ``KeyIntervals``, a dtype other than bf16, head_dim other
than 64/128). Nothing falls back from the card to the plain path.

Lengths: any ``Tq, Tk >= 1``. The kernels mask the last tile past the
length and store nothing past it; the per-row tables the backward reads
(lse, delta, an interval's lo / hi) go in padded to whole 64-row tiles
(``_pad_rows``): lse with NEG_INF (so a padded row's p is 0), delta with
0, lo / hi as rows that see nothing.

``merge_partials`` and ``flash_attention_fwd_chunked`` are the JAX
module's online-softmax merge and its tiled long-sequence forward (each
tile one ``fa_fwd`` launch on the card, the merges plain f32 algebra).

Layouts are the JAX entry's: ``bthd`` (``[B, T, H, D]``, the default)
or the kernel-native ``bhtd``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30  # finite stand-in for -inf, as in the JAX package
_TILE = 64  # a consumer warpgroup's rows; the row tables come in whole tiles
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
# each entry ends with the interval tables (null pointers without
# intervals), whether they hold one row a batch row, and the stream
_SIGNATURES = {
    "fa_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _I] + [_P] * 3 + [_I, _P],
    "fa_bwd_dkdv": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _I] + [_P] * 4 + [_I, _P],
    "fa_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _I] + [_P] * 3 + [_I, _P],
}
# an empty row's lo and hi in the tile tables (IV_FAR of the source)
_IV_FAR = 0x3FFFFFFF


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


# ---------------------------------------------------------------------------
# the declared mask family
# ---------------------------------------------------------------------------
class KeyIntervals:
    """Per query row ``q``, the visible keys are ``[lo(q), hi(q))`` at
    global positions: ``lo`` and ``hi`` int32 ``[B or 1, T]`` over the
    rows ``0 .. T-1`` (one row for the whole batch, or one a batch row;
    every head shares them). Rows with ``hi <= lo`` see nothing (their
    output is 0 and their lse NEG_INF). The constructors give the masks
    of the family; ``without_rows`` empties rows of any of them.

    Callable as ``(q_pos, k_pos) -> bool`` (1-D position vectors, as the
    ring and Ulysses hand a mask, or ``[Tq,1]`` / ``[1,Tk]``, as the
    kernels do): on torch tensors by looking up ``lo`` / ``hi``
    (``[B, Tq, Tk]`` for per-batch intervals), on other arrays (numpy,
    JAX) by the constructor's own expression in the positions, so the
    JAX package can run the same mask."""

    def __init__(self, lo, hi, expr: Optional[Callable] = None, name: str = "intervals"):
        lo = torch.as_tensor(np.asarray(lo), dtype=torch.int32)
        hi = torch.as_tensor(np.asarray(hi), dtype=torch.int32)
        lo, hi = (x[None] if x.dim() == 1 else x for x in (lo, hi))
        if lo.shape != hi.shape or lo.dim() != 2:
            raise ValueError(f"lo {tuple(lo.shape)} and hi {tuple(hi.shape)} must be [B, T]")
        self.lo, self.hi = lo.contiguous(), hi.contiguous()
        self._expr, self.name = expr, name
        self._cache: Dict = {}

    @property
    def T(self) -> int:
        return self.lo.shape[1]

    @property
    def batch(self) -> int:
        return self.lo.shape[0]

    # -- the family --------------------------------------------------------
    @classmethod
    def causal(cls, T: int) -> "KeyIntervals":
        q = np.arange(T)
        return cls(np.zeros(T), q + 1, lambda q, k: k <= q, "causal")

    @classmethod
    def prefix(cls, T: int, P: int) -> "KeyIntervals":
        """The GLM mask: causal, and every row sees the first ``P`` keys
        (``hi = max(q + 1, P)``)."""
        q = np.arange(T)
        return cls(np.zeros(T), np.maximum(q + 1, P),
                   lambda q, k: (k <= q) | (k < P), f"prefix{P}")

    @classmethod
    def window(cls, T: int, w: int) -> "KeyIntervals":
        """Causal sliding window of ``w`` keys (``lo = q - w + 1``)."""
        q = np.arange(T)
        return cls(np.maximum(q - w + 1, 0), q + 1,
                   lambda q, k: (k <= q) & (k > q - w), f"window{w}")

    @classmethod
    def documents(cls, doc_ids) -> "KeyIntervals":
        """Packed documents, causal within each: ``doc_ids`` ``[B or 1,
        T]`` (or ``[T]``) labels each position's document, documents
        contiguous; ``lo`` is the first position of the row's
        document."""
        ids = np.asarray(doc_ids)
        ids = ids[None] if ids.ndim == 1 else ids
        T = ids.shape[1]
        lo = np.zeros(ids.shape, np.int64)
        starts_of = []
        for b in range(ids.shape[0]):
            starts = np.concatenate([[0], np.flatnonzero(np.diff(ids[b])) + 1])
            lo[b] = starts[np.searchsorted(starts, np.arange(T), side="right") - 1]
            starts_of.append([int(x) for x in starts])
        expr = None
        if ids.shape[0] == 1:
            st = starts_of[0]

            def expr(q, k):
                # the row's document start, from comparisons alone
                first = 0
                for a, b in zip(st[:-1], st[1:]):
                    first = first + (q >= b) * (b - a)
                return (k >= first) & (k <= q)

        return cls(lo, np.arange(T)[None] + 1 + 0 * lo, expr, "documents")

    def without_rows(self, rows: Sequence[int]) -> "KeyIntervals":
        """The same mask with the query ``rows`` seeing no key."""
        rows = [int(r) for r in rows]
        lo, hi = self.lo.clone(), self.hi.clone()
        hi[:, rows] = lo[:, rows]
        expr = None
        if self._expr is not None:
            base = self._expr

            def expr(q, k):
                keep = base(q, k)
                for r in rows:
                    keep = keep & (q != r)
                return keep

        return KeyIntervals(lo, hi, expr, f"{self.name}-empty{len(rows)}")

    # -- as a mask function ------------------------------------------------
    def __call__(self, q_pos, k_pos):
        if getattr(q_pos, "ndim", 2) == 1:
            q_pos, k_pos = q_pos[:, None], k_pos[None, :]
        if isinstance(q_pos, torch.Tensor):
            idx = q_pos.reshape(-1).long().cpu()
            lo = self.lo[:, idx].to(q_pos.device)[..., None]
            hi = self.hi[:, idx].to(q_pos.device)[..., None]
            m = (k_pos.reshape(1, 1, -1) >= lo) & (k_pos.reshape(1, 1, -1) < hi)
            return m[0] if self.batch == 1 else m
        if self._expr is not None:
            return self._expr(q_pos, k_pos)
        qi = np.asarray(q_pos).reshape(-1)
        k = np.asarray(k_pos).reshape(1, 1, -1)
        m = (k >= self.lo.numpy()[:, qi, None]) & (k < self.hi.numpy()[:, qi, None])
        return m[0] if self.batch == 1 else m

    # -- what the kernels and the drivers read ------------------------------
    def check_rows(self, B: int, q_offset: int, Tq: int) -> None:
        if self.batch not in (1, B):
            raise ValueError(f"intervals of batch {self.batch} for a batch of {B}")
        if q_offset < 0 or q_offset + Tq > self.T:
            raise ValueError(
                f"query rows [{q_offset}, {q_offset + Tq}) outside the intervals' "
                f"{self.T} rows"
            )

    def visible(self, q_offset: int, Tq: int, k_offset: int, Tk: int) -> np.ndarray:
        """Visible keys of each row ``[batch, Tq]``, counted on the host."""
        lo = self.lo[:, q_offset:q_offset + Tq].numpy().astype(np.int64)
        hi = self.hi[:, q_offset:q_offset + Tq].numpy().astype(np.int64)
        return np.clip(np.minimum(hi, k_offset + Tk) - np.maximum(lo, k_offset), 0, None)

    def any_visible(self, q_offset: int, Tq: int, k_offset: int, Tk: int) -> bool:
        return bool(self.visible(q_offset, Tq, k_offset, Tk).any())

    def tables(self, device, q_offset: int, Tq: int, k_offset: int, Tk: int):
        """(lo, hi, qstat, kblk) of the call's rows on ``device`` (cached):
        ``lo`` / ``hi`` ``[Bi, Tqp]`` (``Tqp``: Tq rounded up to whole
        64-row tiles, the rows past Tq seeing nothing); ``qstat [Bi,
        Tqp/64, 4]`` each 64-row tile's (min lo, max lo, min hi, max hi),
        empty rows counted as ``lo = +IV_FAR``, ``hi = -IV_FAR``; ``kblk
        [Bi, ceil(Tk/128), 2]`` each 128-key block's first and
        past-the-last query tile with a visible pair (both 0 if none)."""
        key = (str(device), q_offset, Tq, k_offset, Tk)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        lo = _pad_rows(self.lo[:, q_offset:q_offset + Tq], 0)
        hi = _pad_rows(self.hi[:, q_offset:q_offset + Tq], 0)
        empty = hi <= lo
        los = torch.where(empty, _IV_FAR, lo).view(self.batch, -1, _TILE)
        his = torch.where(empty, -_IV_FAR, hi).view(self.batch, -1, _TILE)
        qstat = torch.stack(
            [los.amin(-1), los.amax(-1), his.amin(-1), his.amax(-1)], -1
        ).int()
        kstart = k_offset + DKV_BLOCK_K * torch.arange(-(-Tk // DKV_BLOCK_K))
        kend = torch.clamp(kstart + DKV_BLOCK_K, max=k_offset + Tk)
        vis = (qstat[..., 0:1] < kend) & (qstat[..., 3:4] > kstart)  # [Bi, nQ, nKB]
        nq = vis.shape[1]
        seen = vis.any(1)
        first = vis.int().argmax(1)
        last = nq - vis.flip(1).int().argmax(1)
        kblk = torch.stack(
            [torch.where(seen, first, 0), torch.where(seen, last, 0)], -1
        ).int()
        out = tuple(
            t.contiguous().to(device) for t in (lo, hi, qstat, kblk)
        )
        self._cache[key] = out
        return out

    def __repr__(self) -> str:
        return f"KeyIntervals({self.name}, batch={self.batch}, T={self.T})"


def _pad_rows(t: torch.Tensor, value) -> torch.Tensor:
    """``t [..., T]`` padded along its last dim to whole 64-row tiles
    with ``value`` (itself when T is a multiple of 64)."""
    pad = -t.shape[-1] % _TILE
    if not pad:
        return t
    return torch.cat([t, t.new_full(t.shape[:-1] + (pad,), value)], -1)


def _mask_for_block(q_pos, k_pos, causal, mask_fn):
    """[Tq,1] x [1,Tk] positions -> bool mask ([Tq,Tk], or [B,Tq,Tk] for
    per-batch intervals) or None (= all visible)."""
    if mask_fn is not None:
        return mask_fn(q_pos, k_pos)
    if causal:
        return q_pos >= k_pos
    return None


def _apply_mask(s, mask):
    """Scores ``[B,H,Tq,Tk]`` with the masked pairs at NEG_INF."""
    if mask is None:
        return s
    m = mask[:, None] if mask.dim() == 3 else mask[None, None]
    return torch.where(m, s, NEG_INF)


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
    s = _apply_mask(s, _mask_for_block(q_pos, k_pos, causal, mask_fn))
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
    s = _apply_mask(s, _mask_for_block(q_pos, k_pos, causal, mask_fn))
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
    if mask_fn is not None and not isinstance(mask_fn, KeyIntervals):
        raise NotImplementedError(
            "mask_fn on CUDA must be a KeyIntervals: the kernels take one "
            "declared mask family, per query row the visible keys [lo, hi) "
            "at global positions (causal, prefix, sliding window, packed "
            f"documents, rows that see nothing); got {mask_fn!r}. Run any "
            "other mask on the CPU reference"
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
    if Tq < 1 or Tk < 1:
        raise ValueError(f"sequence lengths {Tq}/{Tk} must be at least 1")
    if H % Hkv or k.shape[0] != B:
        raise ValueError(f"{Hkv} kv heads do not divide {H} heads")
    if not (isinstance(q_offset, int) and isinstance(k_offset, int)):
        raise NotImplementedError("the kernels take int offsets only")
    if mask_fn is not None:
        mask_fn.check_rows(B, q_offset, Tq)


def _iv_args(iv, device, q_offset, Tq, k_offset, Tk, dkv=False):
    """The C entries' interval arguments: pointers to the tables (null
    without intervals) and whether they hold a row a batch row."""
    if iv is None:
        return (None,) * (4 if dkv else 3) + (0,)
    lo, hi, qstat, kblk = iv.tables(device, q_offset, Tq, k_offset, Tk)
    ptrs = (lo, hi, qstat, kblk) if dkv else (lo, hi, qstat)
    return tuple(_ptr(t) for t in ptrs) + (int(iv.batch > 1),)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' bulk loads need (a
    view into the middle of a buffer may be neither)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_cuda(qt, kt, vt, scale, causal, q_offset, k_offset, iv=None):
    qt, kt, vt = (_dense(x) for x in (qt, kt, vt))
    B, H, Tq, D = qt.shape
    Hkv, Tk = kt.shape[1], kt.shape[2]
    o = torch.empty_like(qt)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=qt.device)
    lib = _lib()
    ivargs = _iv_args(iv, qt.device, q_offset, Tq, k_offset, Tk)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_fwd(
            _ptr(qt), _ptr(kt), _ptr(vt), _ptr(o), _ptr(lse),
            B, H, Hkv, Tq, Tk, D, float(scale), int(causal),
            q_offset, k_offset, *ivargs, stream,
        )
    if err:
        raise RuntimeError(f"fa_fwd launch failed: CUDA error {err}")
    launch_counts["fa_fwd"] += 1
    return o, lse


def _bwd_launch(name, outs, qt, kt, vt, dot, lse, delta, scale, causal,
                q_offset, k_offset, iv=None):
    """One backward kernel (``fa_bwd_dkdv`` writes ``outs = (dk, dv)``
    per q head, bf16 or f32; ``fa_bwd_dq`` writes ``outs = (dq,)``, bf16)
    on contiguous, 16-byte aligned ``[B,H,T,D]`` inputs, f32
    ``lse``/``delta [B,H,Tqp]`` (padded to whole 64-row tiles,
    ``_pad_rows``); ``iv`` a ``KeyIntervals`` or None."""
    B, H, Tq, D = qt.shape
    Hkv, Tk = kt.shape[1], kt.shape[2]
    out_bf16 = outs[0].dtype == torch.bfloat16
    if name == "fa_bwd_dq" and not out_bf16:
        raise ValueError("fa_bwd_dq writes bf16")
    flag = (int(out_bf16),) if name == "fa_bwd_dkdv" else ()
    fn = getattr(_lib(), name)
    ivargs = _iv_args(iv, qt.device, q_offset, Tq, k_offset, Tk, name == "fa_bwd_dkdv")
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            _ptr(qt), _ptr(kt), _ptr(vt), _ptr(dot), _ptr(lse), _ptr(delta),
            *(_ptr(o) for o in outs),
            B, H, Hkv, Tq, Tk, D, float(scale), int(causal),
            q_offset, k_offset, *flag, *ivargs, stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _bwd_cuda(qt, kt, vt, ot, lse, dot, scale, causal, q_offset, k_offset, iv=None):
    qt, kt, vt, dot = (_dense(x) for x in (qt, kt, vt, dot))
    # the row tables in whole 64-row tiles: a padded row's lse is NEG_INF
    # (its p is 0), its delta 0
    lse = _dense(_pad_rows(lse.float(), NEG_INF))
    B, H, Tq, D = qt.shape
    Hkv, Tk = kt.shape[1], kt.shape[2]
    # bandwidth-bound rowsum, left to PyTorch as the JAX code leaves it
    # to XLA
    delta = _dense(_pad_rows((dot.float() * ot.float()).sum(-1), 0.0))
    # per-q-head dk/dv in f32 under GQA, summed per group by the caller
    gdt = qt.dtype if Hkv == H else torch.float32
    dk = torch.empty((B, H, Tk, D), dtype=gdt, device=qt.device)
    dv = torch.empty_like(dk)
    dq = torch.empty_like(qt)
    args = (qt, kt, vt, dot, lse, delta, scale, causal, q_offset, k_offset, iv)
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
        ot, lse = _fwd_cuda(qt, kt, vt, scale, causal, q_offset, k_offset, mask_fn)
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
            qt, kt, vt, ot, lse, dot, scale, causal, q_offset, k_offset, mask_fn
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
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, k_offset, layout, mask_fn=None):
        o, lse = flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=sm_scale, mask_fn=mask_fn,
            q_offset=q_offset, k_offset=k_offset, layout=layout,
        )
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, q_offset, k_offset, layout, mask_fn)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, q_offset, k_offset, layout, mask_fn = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale, mask_fn=mask_fn,
            q_offset=q_offset, k_offset=k_offset, layout=layout,
        )
        return dq, dk, dv, None, None, None, None, None, None


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
    own the gradient, as the JAX entry). A ``KeyIntervals`` mask runs the
    kernels on CUDA (the plain versions on the CPU); any other
    ``mask_fn`` runs the materialized reference on the CPU and raises on
    CUDA."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"unknown layout {layout!r}")
    if return_residuals:
        return flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=sm_scale, mask_fn=mask_fn,
            q_offset=q_offset, k_offset=k_offset, layout=layout,
        )
    if mask_fn is not None and not isinstance(mask_fn, KeyIntervals):
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
        q, k, v, causal, sm_scale, q_offset, k_offset, layout, mask_fn
    )


# ---------------------------------------------------------------------------
# partial results: the merge and the tiled long-sequence forward
# ---------------------------------------------------------------------------
# the JAX module's fused-kernel limit, its chunked driver's default tile
_CHUNK = 1024


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Online-softmax merge of two partial attention results over the
    same queries and different keys (the JAX ``merge_partials``): ``o``
    ``[B,T,H,D]`` f32 normalized, ``lse`` ``[B,H,T]`` f32. Plain tensor
    algebra, shared by the ring's hops and the chunked forward."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse_new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o_a * w_a + o_b * w_b, lse_new


def _tile_visible(causal, mask_fn, q_offset, Tq, k_offset, Tk) -> bool:
    """Whether a (query, key) tile has a visible pair, decided on the
    host: the causal diagonal, or the intervals' counts."""
    if isinstance(mask_fn, KeyIntervals):
        return mask_fn.any_visible(q_offset, Tq, k_offset, Tk)
    if mask_fn is None and causal:
        return q_offset + Tq - 1 >= k_offset
    return True


def flash_attention_fwd_chunked(
    q,
    k,
    v,
    *,
    causal: bool = True,
    sm_scale=None,
    mask_fn: Optional[MaskFn] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    chunk: int = _CHUNK,
):
    """Long-sequence forward as ``[chunk x chunk]`` tile calls of
    ``flash_attention_fwd`` (on the card, one ``fa_fwd`` launch each)
    merged by ``merge_partials`` (the JAX ``flash_attention_fwd_chunked``,
    ``[B,T,H,D]``). Tiles with no visible pair are skipped: above the
    causal diagonal, as the JAX driver skips them, and under
    ``KeyIntervals`` wherever no row sees the tile's keys. Returns
    ``(o, lse [B,H,Tq])``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if Tq % chunk or Tk % chunk or chunk % 8:
        raise ValueError(f"Tq={Tq}/Tk={Tk} must divide into 8-aligned chunk={chunk}")
    if not isinstance(q_offset, int) or not isinstance(k_offset, int):
        raise ValueError("the chunked driver needs int offsets (tile skipping is decided on the host)")
    o_parts, lse_parts = [], []
    for i in range(Tq // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk]
        o_acc = lse_acc = None
        for j in range(Tk // chunk):
            qo, ko = q_offset + i * chunk, k_offset + j * chunk
            if not _tile_visible(causal, mask_fn, qo, chunk, ko, chunk):
                continue
            o_j, lse_j = flash_attention_fwd(
                qi, k[:, j * chunk:(j + 1) * chunk], v[:, j * chunk:(j + 1) * chunk],
                causal=causal, sm_scale=sm_scale, mask_fn=mask_fn,
                q_offset=qo, k_offset=ko,
            )
            o_j = o_j.float()
            if o_acc is None:
                o_acc, lse_acc = o_j, lse_j
            else:
                o_acc, lse_acc = merge_partials(o_acc, lse_acc, o_j, lse_j)
        if o_acc is None:  # no key visible to any row of the tile
            o_acc = torch.zeros((B, chunk, H, D), dtype=torch.float32, device=q.device)
            lse_acc = torch.full((B, H, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        o_parts.append(o_acc)
        lse_parts.append(lse_acc)
    return torch.cat(o_parts, 1).to(q.dtype), torch.cat(lse_parts, 2)
