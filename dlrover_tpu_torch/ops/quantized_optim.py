"""8-bit (blockwise-quantized state) AdamW on Hopper (counterpart of
``dlrover_tpu/ops/quantized_optim.py``).

Optimizer moments are int8 codes plus one f32 scale per 128-element
block, on the sqrt map (code = round(sign(y) sqrt|y| 127) of the
block-max-normalized value). The hot path (dequantize -> Adam moment
update -> requantize -> parameter delta) is one Triton kernel,
``adam8_flat``, launched once per packed group by ``adamw_8bit_flat``
(replacing the Pallas ``_adam8_kernel_wide``) and once per big leaf by
the per-leaf ``adamw_8bit`` (replacing the Pallas ``_adam8_kernel``;
its launches count under ``adam8_leaf``). The scale of codes row r
lies at flat offset r in both layouts (the flat form's wide
``[R//128, 128]`` and the per-leaf ``[R]``), so one kernel serves
both; rows past R in the last tile are masked. It reads g, the codes
and the scales once and writes them once, in place.
What bounds it on the card is memory bandwidth (~12 bytes a parameter
against a few dozen f32 operations, far below the H100's ridge), so the
design spends few instructions and few registers an element: one
program per 8 x 128 tile (eight elements a thread), one block max per
row, no intermediate in device memory; the dequantize takes no division
(an fma-corrected product by rn(1/127), the same bits as ``code / 127``
for every code), the requantize one IEEE division and square root a
row (``k = 127 / sqrt(scale)``) and an approximate square root an
element. The delta keeps its IEEE square root and division. Triton is
imported only inside its launcher.

The plain PyTorch version (``_adam8_update_plain``) is the CPU path and
the kernel's oracle; both round half to even and give sign(0) = 0; the
plain version divides truly, as the JAX math does. The kernel's moments
and delta equal it to the rounding of one operation; its requantize may
move a code by 1 where ``sqrt(|x| / scale) 127`` lies within a few ulp
of a half (about 2 in a million codes on an H100, in chip_smoke.py's
check).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch

BLOCK = 128  # quantization block
_FLAT_ROWS = 2048  # group sizes are multiples of _FLAT_ROWS * BLOCK
# rows per Triton program and its warps: 8 x 128 elements over 128
# threads keeps 8 a thread and ~56 registers, so enough programs share an
# SM to keep loads in flight (on an H100, 32 rows took 157 registers and
# reached 42 % of the byte bound; tools/torch_adam8_variants.py times the
# choices)
_TILE_ROWS = 8
_WARPS = 4

# launches of the Triton kernel, counted where the wrapper launches it:
# under "adam8_flat" for a packed group, "adam8_leaf" for one leaf
launch_counts: Dict[str, int] = {"adam8_flat": 0, "adam8_leaf": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclass
class Quantized8:
    """Blockwise sqrt-map quantized tensor: ``x ~ sign(c) c^2 scale``
    with ``c = codes / 127``. ``quantize_8bit``: ``scales [nblocks, 1]``;
    the per-leaf optimizer's state: ``scales [nblocks]``; the flat
    optimizer's wide form: ``scales [nblocks // 128, 128]``."""

    codes: torch.Tensor  # int8 [nblocks, BLOCK]
    scales: torch.Tensor  # f32
    shape: Tuple[int, ...]
    signed: bool


def _to_blocks(x):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.view(-1, BLOCK)


def _from_blocks(blocks, shape):
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].view(shape)


def _sqrt_map_quant(x, signed, qmax):
    """x [rows, N] f32 -> (float codes, scales [rows, 1])."""
    scale = (x.abs() if signed else x).amax(-1, keepdim=True)
    y = x / scale.clamp_min(1e-30)
    codes = torch.round(torch.sign(y) * torch.sqrt(y.abs()) * qmax)
    lo = -float(qmax) if signed else 0.0
    return codes.clamp(lo, float(qmax)), scale


def _sqrt_map_dequant(codes_f, scales, qmax):
    c = codes_f / qmax
    return torch.sign(c) * c * c * scales


def quantize_8bit(x, signed: bool = True) -> Quantized8:
    codes, scales = _sqrt_map_quant(_to_blocks(x.float()), signed, 127.0)
    return Quantized8(codes.to(torch.int8), scales, tuple(x.shape), signed)


def dequantize_8bit(q: Quantized8):
    return _from_blocks(
        _sqrt_map_dequant(q.codes.float(), q.scales, 127.0), q.shape
    )


# -- "wide" scale layout (the flat path): the scale of codes row r lives
# at [r // 128, r % 128]
def _quant_block_math_wide(x, signed):
    R = x.shape[0]
    x3 = x.view(R // 128, 128, 128)
    s = (x3.abs() if signed else x3).amax(-1)  # [R//128, 128]
    y = x3 / s.clamp_min(1e-30)[:, :, None]
    codes = torch.round(torch.sign(y) * torch.sqrt(y.abs()) * 127.0)
    lo = -127.0 if signed else 0.0
    codes = codes.clamp(lo, 127.0).view(R, BLOCK)
    return codes.to(torch.int8), s


def _adam8_block_math(g, m, v, lrA, invbc2, eps, b1, b2, classic_eps=True):
    """Shared f32 Adam math; the operation order is the JAX package's,
    so results agree to the bit where the primitives do."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    if classic_eps:
        delta = -lrA * m_new / (torch.sqrt(v_new * invbc2) + eps)
    else:
        delta = -lrA * m_new * torch.rsqrt(v_new * invbc2 + eps)
    return m_new, v_new, delta


def _adam8_update_plain(g_blocks, mq, vq, scalars, b1, b2, classic_eps=True):
    """Plain version of the kernel: updates the codes and scales of
    ``mq``/``vq`` in place and returns the delta in g's dtype. Scales
    of either layout hold row r's scale at flat offset r (the wide
    math is the per-row math). ``scalars = (lrA, invbc2, eps)`` as
    f32-exact floats."""
    lrA, invbc2, eps = scalars
    R = g_blocks.shape[0]
    m = _sqrt_map_dequant(mq.codes.float(), mq.scales.view(R, 1), 127.0)
    v = _sqrt_map_dequant(vq.codes.float(), vq.scales.view(R, 1), 127.0)
    m_new, v_new, delta = _adam8_block_math(
        g_blocks.float(), m, v, lrA, invbc2, eps, b1, b2, classic_eps
    )
    for q, x, signed in ((mq, m_new, True), (vq, v_new, False)):
        codes, s = _sqrt_map_quant(x, signed, 127.0)
        q.codes.copy_(codes.to(torch.int8))
        q.scales.view(R, 1).copy_(s)
    return delta.to(g_blocks.dtype)


_TRITON_KERNEL = None
_compiled: Dict[str, object] = {}  # the last launch's compiled kernel, by counter


def _triton_kernel():
    """Compile-once handle of the Triton kernel; Triton is imported here,
    never at module import (the CPU has none)."""
    global _TRITON_KERNEL, tl, libdevice
    if _TRITON_KERNEL is not None:
        return _TRITON_KERNEL
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def adam8_flat(
        g_ptr, mc_ptr, ms_ptr, vc_ptr, vs_ptr, d_ptr, R,
        lrA, invbc2, eps, b1, omb1, b2, omb2,
        TILE_ROWS: tl.constexpr, CLASSIC: tl.constexpr,
    ):
        rows = tl.program_id(0) * TILE_ROWS + tl.arange(0, TILE_ROWS)
        live = rows < R  # the last tile of a leaf may run past its rows
        offs = rows[:, None] * 128 + tl.arange(0, 128)[None, :]
        mask = live[:, None]
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        # sqrt-map dequantize, x = sign(c) c c scale with c = code / 127,
        # without a division: c0 = code rn(1/127) is off by at most an ulp,
        # and one fma-corrected step gives rn(code / 127) for every code;
        # c |c| is then sign(c) rn(c c), the same bits as the plain version
        cm = tl.load(mc_ptr + offs, mask=mask, other=0).to(tl.float32)
        cv = tl.load(vc_ptr + offs, mask=mask, other=0).to(tl.float32)
        cm0 = cm * 0.007874015718698502  # rn(1/127) in f32
        cv0 = cv * 0.007874015718698502
        cm = tl.fma(tl.fma(-cm0, 127.0, cm), 0.007874015718698502, cm0)
        cv = tl.fma(tl.fma(-cv0, 127.0, cv), 0.007874015718698502, cv0)
        m = cm * tl.abs(cm) * tl.load(ms_ptr + rows, mask=live, other=0.0)[:, None]
        v = cv * cv * tl.load(vs_ptr + rows, mask=live, other=0.0)[:, None]
        # moments and delta, in the JAX math's operation order, each
        # operation rounded as IEEE rounds it
        m_new = b1 * m + omb1 * g
        v_new = b2 * v + omb2 * g * g
        if CLASSIC:
            den = libdevice.sqrt_rn(v_new * invbc2) + eps
            delta = libdevice.div_rn(-lrA * m_new, den)
        else:
            r = libdevice.div_rn(1.0, libdevice.sqrt_rn(v_new * invbc2 + eps))
            delta = -lrA * m_new * r
        tl.store(d_ptr + offs, delta.to(d_ptr.dtype.element_ty), mask=mask)
        # requantize: one max per 128-element row; code = rint(sign(x)
        # sqrt(|x| / s) 127) as sqrt(|x|) k with k = 127 / sqrt(s) once a
        # row and the approximate square root (a code may move by 1 where
        # sqrt(|x| / s) 127 lies within a few ulp of a half)
        s_m = tl.max(tl.abs(m_new), axis=1)
        k_m = libdevice.div_rn(127.0, libdevice.sqrt_rn(tl.maximum(s_m, 1e-30)))
        qm = libdevice.rint(tl.sqrt(tl.abs(m_new)) * k_m[:, None])
        qm = tl.minimum(tl.maximum(tl.where(m_new < 0, -qm, qm), -127.0), 127.0)
        s_v = tl.max(v_new, axis=1)
        k_v = libdevice.div_rn(127.0, libdevice.sqrt_rn(tl.maximum(s_v, 1e-30)))
        qv = libdevice.rint(tl.sqrt(v_new) * k_v[:, None])
        qv = tl.minimum(qv, 127.0)
        tl.store(mc_ptr + offs, qm.to(tl.int8), mask=mask)
        tl.store(vc_ptr + offs, qv.to(tl.int8), mask=mask)
        tl.store(ms_ptr + rows, s_m, mask=live)
        tl.store(vs_ptr + rows, s_v, mask=live)

    _TRITON_KERNEL = adam8_flat
    return _TRITON_KERNEL


def _adam8_update_triton(g_blocks, mq, vq, scalars, b1, b2, classic_eps=True,
                         counter="adam8_flat"):
    """One launch over ``[R, 128]`` rows, any R (the last tile is
    masked), counted under ``counter``."""
    R = g_blocks.shape[0]
    dev = g_blocks.device
    ok = (
        g_blocks.is_contiguous()
        and g_blocks.shape[1] == BLOCK
        and R > 0
        and all(
            t.device == dev and t.is_contiguous()
            for t in (mq.codes, mq.scales, vq.codes, vq.scales)
        )
        and mq.codes.dtype == vq.codes.dtype == torch.int8
        and mq.codes.shape == vq.codes.shape == g_blocks.shape
        and mq.scales.dtype == vq.scales.dtype == torch.float32
        and mq.scales.numel() == vq.scales.numel() == R
    )
    if not ok:
        raise NotImplementedError(
            "adam8_flat takes contiguous [R, 128] rows with int8 codes and "
            "R f32 scales (one a row) on the same device"
        )
    kernel = _triton_kernel()
    delta = torch.empty_like(g_blocks)
    lrA, invbc2, eps = scalars
    with torch.cuda.device(dev):
        compiled = kernel[(-(-R // _TILE_ROWS),)](
            g_blocks, mq.codes, mq.scales, vq.codes, vq.scales, delta, R,
            lrA, invbc2, eps, b1, 1.0 - b1, b2, 1.0 - b2,
            TILE_ROWS=_TILE_ROWS, CLASSIC=bool(classic_eps),
            num_warps=_WARPS,
            # no fused multiply-add but the dequantize's own: each product
            # and sum rounds on its own, as in the JAX math and the plain
            # version
            enable_fp_fusion=False,
        )
    launch_counts[counter] += 1
    _compiled[counter] = compiled
    return delta


def triton_kernel_info(counter: str = "adam8_flat") -> Dict[str, int]:
    """Registers a thread and spill bytes of the kernel that the last
    launch under ``counter`` ran, as Triton compiled it."""
    c = _compiled[counter]
    return {"n_regs": c.n_regs, "n_spills": c.n_spills}


def adam8_update_flat(g_blocks, mq, vq, scalars, b1, b2, classic_eps=True):
    """One fused update of a packed group: the Triton kernel on CUDA,
    the plain version on the CPU. Moments update in place."""
    if g_blocks.device.type == "cuda":
        return _adam8_update_triton(g_blocks, mq, vq, scalars, b1, b2, classic_eps)
    return _adam8_update_plain(g_blocks, mq, vq, scalars, b1, b2, classic_eps)


def adam8_update_leaf(g_blocks, mq, vq, scalars, b1, b2, classic_eps=True):
    """One fused update of one leaf's ``[R, 128]`` blocks (any R) with
    ``[R]`` scales: the Triton kernel on CUDA (counted as
    ``adam8_leaf``), the plain version on the CPU."""
    if g_blocks.device.type == "cuda":
        return _adam8_update_triton(
            g_blocks, mq, vq, scalars, b1, b2, classic_eps, counter="adam8_leaf"
        )
    return _adam8_update_plain(g_blocks, mq, vq, scalars, b1, b2, classic_eps)


# ---------------------------------------------------------------------------
# flat-buffer layout (leaf order = the JAX package's flatten order)
# ---------------------------------------------------------------------------
class _FlatGroup(NamedTuple):
    idx: tuple  # leaf positions in this group
    offsets: tuple  # start offset of each leaf (BLOCK-aligned)
    total: int  # padded group size (multiple of BLOCK * _FLAT_ROWS)


class _FlatLayout(NamedTuple):
    groups: tuple
    small_idx: tuple
    small_offsets: tuple
    small_total: int


def _flat_layout(
    leaves: Sequence[torch.Tensor], min_quantized_size: int, group_elems: int
) -> _FlatLayout:
    """Pack big leaves into dtype-homogeneous groups of ~``group_elems``
    elements, each leaf padded to a BLOCK boundary so quantization
    blocks never straddle leaves (the JAX package's layout)."""
    chunk = BLOCK * _FLAT_ROWS
    groups, g_idx, g_off, off = [], [], [], 0
    g_dtype = None
    small_idx, small_off, soff = [], [], 0

    def _close_group():
        nonlocal g_idx, g_off, off, g_dtype
        if g_idx:
            groups.append(
                _FlatGroup(tuple(g_idx), tuple(g_off), -(-off // chunk) * chunk)
            )
            g_idx, g_off, off, g_dtype = [], [], 0, None

    for i, leaf in enumerate(leaves):
        n = leaf.numel()
        if n >= min_quantized_size:
            if off and (off + n > group_elems or leaf.dtype != g_dtype):
                _close_group()
            g_idx.append(i)
            g_off.append(off)
            g_dtype = leaf.dtype
            off += -(-n // BLOCK) * BLOCK
        else:
            small_idx.append(i)
            small_off.append(soff)
            soff += n
    _close_group()
    return _FlatLayout(tuple(groups), tuple(small_idx), tuple(small_off), soff)


def _pack_group(leaves, group: _FlatGroup, dtype):
    """One group's leaves, each zero-padded to its BLOCK-aligned slot,
    in one flat ``[group.total]`` buffer."""
    dev = leaves[group.idx[0]].device
    flat = torch.zeros((group.total,), dtype=dtype, device=dev)
    for i, off in zip(group.idx, group.offsets):
        n = leaves[i].numel()
        flat[off:off + n].copy_(leaves[i].reshape(-1))
    return flat


class _Adam8Base(torch.optim.Optimizer):
    """What the two 8-bit AdamW forms share: one param group whose
    ``retune_scale`` multiplies the whole update, the eps / eps_root
    choice, the f32 bias-correction scalars, and decoupled weight decay
    ``- lr * wd * p`` applied after the kernel, as the JAX transform
    chain does."""

    def __init__(self, params, lr, b1, b2, eps, weight_decay, eps_root):
        if eps_root and eps:
            raise ValueError(
                "pass either eps (classic, outside the sqrt) or eps_root "
                "(inside), not both"
            )
        super().__init__(params, dict(lr=lr, retune_scale=1.0))
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} takes one param group")
        self.b1, self.b2 = b1, b2
        self.classic = eps_root == 0.0
        self.eps_val = eps if self.classic else eps_root
        self.weight_decay = weight_decay

    def _scalars(self, lr: float, count: int):
        """(lrA = lr / bc1, invbc2 = 1 / bc2, eps) in f32, as the JAX
        update computes them, returned as floats exact in f32."""
        cf = torch.tensor(float(count), dtype=torch.float32)
        lrA = torch.tensor(lr, dtype=torch.float32) / (1.0 - self.b1**cf)
        invbc2 = 1.0 / (1.0 - self.b2**cf)
        eps32 = torch.tensor(self.eps_val, dtype=torch.float32)
        return float(lrA), float(invbc2), float(eps32)

    def _grads(self, leaves):
        grads = [p.grad for p in leaves]
        if any(g is None for g in grads):
            raise ValueError("every parameter needs a gradient")
        return grads

    def _apply(self, leaves, out, lr, group):
        if self.weight_decay:
            wd = float(torch.tensor(lr, dtype=torch.float32) * self.weight_decay)
            out = torch._foreach_add(out, leaves, alpha=-wd)
        if group["retune_scale"] != 1.0:
            out = torch._foreach_mul(out, float(group["retune_scale"]))
        torch._foreach_add_(leaves, out)


class adamw_8bit_flat(_Adam8Base):
    """AdamW with flat-buffer 8-bit state (the JAX ``adamw_8bit_flat``):
    big leaves' moments live in group-packed ``Quantized8`` pairs with
    wide scales, updated by one ``adam8_flat`` launch per group; leaves
    under ``min_quantized_size`` keep f32 moments in one flat pair.

    ``params`` are taken in the order given, which should be the JAX
    flatten order (``Transformer.jax_ordered_parameters``) for the
    layout to match the JAX package's. ``eps`` (outside the sqrt) and
    ``eps_root`` (inside) are mutually exclusive."""

    def __init__(
        self,
        params,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        min_quantized_size: int = 4096,
        group_elems: int = 1 << 27,
        eps_root: float = 0.0,
    ):
        super().__init__(params, lr, b1, b2, eps, weight_decay, eps_root)
        leaves: List[torch.Tensor] = self.param_groups[0]["params"]
        self.layout = _flat_layout(leaves, min_quantized_size, group_elems)
        self.count = 0
        self.mu, self.nu = [], []
        for g in self.layout.groups:
            dev = leaves[g.idx[0]].device
            nblocks = g.total // BLOCK
            for moments, signed in ((self.mu, True), (self.nu, False)):
                moments.append(
                    Quantized8(
                        torch.zeros((nblocks, BLOCK), dtype=torch.int8, device=dev),
                        torch.zeros((nblocks // 128, 128), dtype=torch.float32, device=dev),
                        (g.total,),
                        signed,
                    )
                )
        dev = leaves[0].device if leaves else torch.device("cpu")
        self.mu_small = torch.zeros(self.layout.small_total, device=dev)
        self.nu_small = torch.zeros(self.layout.small_total, device=dev)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("adamw_8bit_flat takes no closure")
        group = self.param_groups[0]
        leaves = group["params"]
        grads = self._grads(leaves)
        lr = group["lr"]
        self.count += 1
        scalars = self._scalars(lr, self.count)
        lrA, invbc2, _ = scalars
        out: List[torch.Tensor] = [None] * len(leaves)
        for gi, g in enumerate(self.layout.groups):
            gflat = _pack_group(grads, g, grads[g.idx[0]].dtype)
            delta = adam8_update_flat(
                gflat.view(-1, BLOCK), self.mu[gi], self.nu[gi], scalars,
                self.b1, self.b2, self.classic,
            ).view(-1)
            for i, off in zip(g.idx, g.offsets):
                n = leaves[i].numel()
                out[i] = delta[off:off + n].view(leaves[i].shape)
        if self.layout.small_idx:
            gs = torch.cat(
                [grads[i].reshape(-1).float() for i in self.layout.small_idx]
            )
            m_new, v_new, ds = _adam8_block_math(
                gs, self.mu_small, self.nu_small, lrA, invbc2,
                self.eps_val, self.b1, self.b2, self.classic,
            )
            self.mu_small, self.nu_small = m_new, v_new
            for i, off in zip(self.layout.small_idx, self.layout.small_offsets):
                n = leaves[i].numel()
                out[i] = ds[off:off + n].view(leaves[i].shape).to(leaves[i].dtype)
        self._apply(leaves, out, lr, group)
        return None


@dataclass
class Adam8State:
    """The per-leaf form's state (the JAX ``Adam8State``): the update
    count and, per leaf, a ``Quantized8`` moment pair (``[R]`` scales)
    or, under ``min_quantized_size``, an f32 pair."""

    count: int
    mu: List[Union[Quantized8, torch.Tensor]]
    nu: List[Union[Quantized8, torch.Tensor]]


class adamw_8bit(_Adam8Base):
    """AdamW with per-leaf 8-bit state (the JAX ``adamw_8bit``, its
    ``bits=8`` form): each leaf of at least ``min_quantized_size``
    elements keeps its moments as int8 codes with one f32 scale per
    128-element block and is updated by one launch of the Triton kernel
    (``adam8_leaf``); smaller leaves keep f32 moments. Numerically the
    same as ``adamw_8bit_flat``: blocks never straddle leaves in either
    form. ``bits=4`` (``adamw_4bit``) is not ported yet (ROADMAP A4)."""

    def __init__(
        self,
        params,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        min_quantized_size: int = 4096,
        bits: int = 8,
        eps_root: float = 0.0,
    ):
        if bits == 4:
            raise NotImplementedError(
                "adamw_8bit(bits=4): the nibble-packed 4-bit state is not "
                "ported yet (ROADMAP A4)"
            )
        if bits != 8:
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        super().__init__(params, lr, b1, b2, eps, weight_decay, eps_root)
        mu, nu = [], []
        for p in self.param_groups[0]["params"]:
            if p.numel() < min_quantized_size:
                mu.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                nu.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                continue
            nblocks = -(-p.numel() // BLOCK)
            for moments, signed in ((mu, True), (nu, False)):
                moments.append(
                    Quantized8(
                        torch.zeros((nblocks, BLOCK), dtype=torch.int8, device=p.device),
                        torch.zeros((nblocks,), dtype=torch.float32, device=p.device),
                        tuple(p.shape),
                        signed,
                    )
                )
        self.adam_state = Adam8State(0, mu, nu)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("adamw_8bit takes no closure")
        group = self.param_groups[0]
        leaves = group["params"]
        grads = self._grads(leaves)
        lr = group["lr"]
        st = self.adam_state
        st.count += 1
        scalars = self._scalars(lr, st.count)
        lrA, invbc2, _ = scalars
        out: List[torch.Tensor] = []
        for i, g in enumerate(grads):
            m, v = st.mu[i], st.nu[i]
            if isinstance(m, Quantized8):
                delta = adam8_update_leaf(
                    _to_blocks(g.float()), m, v, scalars, self.b1, self.b2,
                    self.classic,
                )
                out.append(_from_blocks(delta, g.shape).to(g.dtype))
            else:
                # small leaf: plain f32 Adam with the kernel's eps form
                st.mu[i], st.nu[i], d = _adam8_block_math(
                    g.float(), m, v, lrA, invbc2, self.eps_val, self.b1,
                    self.b2, self.classic,
                )
                out.append(d.to(g.dtype))
        self._apply(leaves, out, lr, group)
        return None
