"""Ring attention: context parallelism over the ``sp`` axis (the port of
``dlrover_tpu/parallel/ring_attention.py``).

Every rank keeps its own query block and passes its key/value block one
hop around the ``sp`` group at a time, merging each hop's partial result
into an f32 online softmax, so the result is single-device attention
over the whole sequence. The JAX package runs the ring inside
``shard_map`` with ``lax.ppermute``; here each rank holds its own
sequence block already (``parallel/mesh.sequence_sharding``), the rank
index is a host int, and the hops are ``batch_isend_irecv`` on the
``sp`` group (``_Ring``).

- ``ring_attention_local``: the plain ``_block_attn`` algebra (the JAX
  ``ring_attention_local``), differentiable through its hops; the tests'
  second opinion.
- ``ring_flash_attention_local``: a ``torch.autograd.Function`` ported
  from ``_make_ring_flash``. Forward: one ``flash_attention_fwd`` a hop at
  the int offsets ``my_idx * T`` / ``blk_idx * T``, partials merged in f32
  by ``merge_partials``. Backward: a second ring pass; ``dq`` accumulates
  here, ``dk`` / ``dv`` travel with their key/value block, and ``p`` is
  recomputed from the merged global ``lse``. A hop whose keys all follow
  all of its queries (or that a ``KeyIntervals`` mask leaves empty)
  skips its kernel; its block still travels.
- ``ring_self_attention``: the entry the model calls with its local
  block: the kernel ring (on CPU tensors its kernels run their plain
  versions).

Masks: causal by positions, or a ``mask_fn`` over global positions (on
the card a ``KeyIntervals``, which the ring hands the kernels for this
rank's own rows: the intervals belong to the queries, the keys travel).

Transport: on NCCL the hops go device to device. Gloo's send and recv do
not take CUDA tensors (its writes fault on a device pointer: the H100
probe of ``chip_smoke.py``'s sp phase), so over gloo each hop of CUDA
tensors is staged through pinned host buffers: the copies out, the host
send / receive, the copies back. Each hop is posted before the hop's
kernel runs, so transfer and compute overlap where the backend allows.
The compute never leaves the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from dlrover_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _tile_visible,
    flash_attention_bwd,
    flash_attention_fwd,
    merge_partials,
)

MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# the transport's host time (ms) in posting and waiting for hops, the
# hops, and how many were staged through host buffers (read by the sp
# phase of chip_smoke.py: the exposed sp communication a step)
comm = {"ms": 0.0, "calls": 0, "staged": 0}


def reset_comm() -> None:
    comm.update(ms=0.0, calls=0, staged=0)


@dataclass
class _Ring:
    """This rank's place on the ``sp`` ring: the group, its size, this
    rank's sp index and the global ranks of the next and previous
    member (in sp order)."""

    group: object
    n: int
    idx: int
    nxt: int
    prv: int

    @staticmethod
    def of(mesh) -> "_Ring":
        ranks = mesh.ranks.get("sp") or [mesh.rank]
        i = ranks.index(mesh.rank) if mesh.rank in ranks else 0
        n = len(ranks)
        return _Ring(mesh.groups.get("sp"), n, i, ranks[(i + 1) % n], ranks[(i - 1) % n])

    def staged(self, t: torch.Tensor) -> bool:
        """Whether a hop of ``t`` goes through pinned host buffers (gloo
        with a CUDA tensor)."""
        import torch.distributed as dist

        return t.device.type == "cuda" and dist.get_backend(self.group) == "gloo"

    def post(self, tensors: Sequence[torch.Tensor]) -> "_Hop":
        """Send ``tensors`` to the next rank and receive the previous
        rank's of the same shapes; ``wait()`` on the result returns
        them."""
        import time

        import torch.distributed as dist

        staged = self.staged(tensors[0])
        if staged:
            # the card finishes what was queued before the copies (not
            # booked as transport time)
            torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        if staged:
            out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for o, t in zip(out, tensors):
                o.copy_(t, non_blocking=True)
            torch.cuda.current_stream().synchronize()  # the copies are in the buffers
            inb = [torch.empty_like(o) for o in out]
            comm["staged"] += 1
        else:
            out = [t.contiguous() for t in tensors]
            inb = [torch.empty_like(t) for t in out]
        ops = []
        for o, i in zip(out, inb):
            ops.append(dist.P2POp(dist.isend, o, self.nxt, self.group))
            ops.append(dist.P2POp(dist.irecv, i, self.prv, self.group))
        hop = _Hop(dist.batch_isend_irecv(ops), inb, tensors[0].device if staged else None)
        comm["ms"] += (time.perf_counter() - t0) * 1e3
        comm["calls"] += 1
        return hop


@dataclass
class _Hop:
    reqs: list
    inb: List[torch.Tensor]
    device: Optional[torch.device]  # set when staged: where the block goes back

    def wait(self) -> List[torch.Tensor]:
        import time

        t0 = time.perf_counter()
        for r in self.reqs:
            r.wait()
        out = self.inb
        if self.device is not None:
            out = [t.to(self.device, non_blocking=True) for t in self.inb]
        comm["ms"] += (time.perf_counter() - t0) * 1e3
        return out


class _Rotate(torch.autograd.Function):
    """One ring hop as an op: forward sends to the next rank and returns
    the previous rank's tensor; backward sends the gradient the other
    way (the plain ring's only communication)."""

    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return ring.post([x]).wait()[0]

    @staticmethod
    def backward(ctx, g):
        r = ctx.ring
        back = _Ring(r.group, r.n, r.idx, r.prv, r.nxt)
        return None, back.post([g.contiguous()]).wait()[0]


def _block_attn(q, k, v, mask, scale):
    """One (q block, kv block) step in f32 (the JAX ``_block_attn``):
    ``(p @ v, row max, row sum, any visible)``; ``mask`` ``[Tq, Tk]`` or
    ``[B, Tq, Tk]`` bool."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m4 = mask[:, None] if mask.dim() == 3 else mask[None, None]
    s = torch.where(m4, s, float("-inf"))
    m = s.amax(-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()), m_safe, p.sum(-1), finite


def _positions_mask(q_pos, k_pos, causal, mask_fn, device):
    if mask_fn is not None:
        return mask_fn(q_pos, k_pos)
    if causal:
        return q_pos[:, None] >= k_pos[None, :]
    return torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool, device=device)


def ring_attention_local(q, k, v, ring: _Ring, *, causal: bool = True,
                         sm_scale: Optional[float] = None, mask_fn: Optional[MaskFn] = None):
    """The plain ring on this rank's block ``q/k/v [B, T_local, H(kv), D]``
    (GQA: the kv heads are repeated first, as the JAX body does):
    ``mask_fn`` takes 1-D global positions. Differentiable."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = sm_scale if sm_scale is not None else D**-0.5
    q_pos = ring.idx * T + torch.arange(T, device=q.device)
    o_acc = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, H, T), torch.finfo(torch.float32).min, device=q.device)
    l_acc = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    for j in range(ring.n):
        blk = (ring.idx - j) % ring.n
        k_pos = blk * T + torch.arange(T, device=q.device)
        mask = _positions_mask(q_pos, k_pos, causal, mask_fn, q.device)
        o, m, l, vis = _block_attn(q, k, v, mask, scale)
        m_new = torch.maximum(m_acc, torch.where(vis, m, m_acc))
        alpha = torch.exp(m_acc - m_new)
        beta = torch.where(vis, torch.exp(m - m_new), 0.0)
        l_acc = l_acc * alpha + l * beta
        o_acc = o_acc * alpha.transpose(1, 2)[..., None] + o * beta.transpose(1, 2)[..., None]
        m_acc = m_new
        if j < ring.n - 1:
            k, v = _Rotate.apply(ring, k), _Rotate.apply(ring, v)
    out = o_acc / l_acc.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _ring_fwd(q, k, v, ring: _Ring, causal, scale, mask_fn):
    """(o in q's dtype, lse [B,H,T] f32) of the kernel ring."""
    B, T, H, D = q.shape
    o_acc = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    kv = [k, v]
    for j in range(ring.n):
        blk = (ring.idx - j) % ring.n
        hop = ring.post(kv) if j < ring.n - 1 else None
        if _tile_visible(causal, mask_fn, ring.idx * T, T, blk * T, T):
            o_j, lse_j = flash_attention_fwd(
                q, kv[0], kv[1], causal=causal, sm_scale=scale, mask_fn=mask_fn,
                q_offset=ring.idx * T, k_offset=blk * T,
            )
            o_acc, lse_acc = merge_partials(o_acc, lse_acc, o_j.float(), lse_j)
        if hop is not None:
            kv = hop.wait()
    return o_acc.to(q.dtype), lse_acc


class _RingFlash(torch.autograd.Function):
    """The kernel ring (``_make_ring_flash``): forward ``_ring_fwd``;
    backward a second pass in which dk / dv ride with their block."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, mask_fn):
        o, lse = _ring_fwd(q, k, v, ring, causal, scale, mask_fn)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (ring, causal, scale, mask_fn)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring, causal, scale, mask_fn = ctx.args
        T = q.shape[1]
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kv = [k, v]
        for j in range(ring.n):
            blk = (ring.idx - j) % ring.n
            hop = ring.post(kv) if j < ring.n - 1 else None
            if _tile_visible(causal, mask_fn, ring.idx * T, T, blk * T, T):
                dq_j, dk_j, dv_j = flash_attention_bwd(
                    q, kv[0], kv[1], o, lse, do, causal=causal, sm_scale=scale,
                    mask_fn=mask_fn, q_offset=ring.idx * T, k_offset=blk * T,
                )
                dq += dq_j.float()
                dk += dk_j.float()
                dv += dv_j.float()
            # dk / dv ride with their block: after n hops each is home
            back = ring.post([dk, dv]) if ring.n > 1 else None
            if hop is not None:
                kv = hop.wait()
            if back is not None:
                dk, dv = back.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_flash_attention_local(q, k, v, ring: _Ring, *, causal: bool = True,
                               sm_scale: Optional[float] = None,
                               mask_fn: Optional[MaskFn] = None):
    """The kernel ring on this rank's block (``[B, T_local, H, D]``; GQA
    kv heads stay unexpanded on the wire)."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, ring, causal, scale, mask_fn)


def ring_self_attention(q, k, v, mesh, *, causal: bool = True,
                        mask_fn: Optional[MaskFn] = None):
    """Ring attention over the mesh's ``sp`` group on this rank's
    sequence block ``[B, T/sp, H, D]`` (the model hands it the local
    shard; there is no ``shard_map``): the kernel ring, whose kernels
    run their plain versions on CPU tensors."""
    return ring_flash_attention_local(q, k, v, _Ring.of(mesh), causal=causal, mask_fn=mask_fn)
