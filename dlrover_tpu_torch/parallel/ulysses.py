"""Ulysses all-to-all sequence parallelism (the port of
``dlrover_tpu/parallel/ulysses.py``).

Activations arrive sequence-sharded ``[B, S/sp, H, D]``. One all-to-all
on the ``sp`` group re-shards them head-wise ``[B, S, H/sp, D]``: every
rank then holds the whole sequence for its heads, and the port's
``flash_attention`` runs over it with no communication inside (the
kernels on the card, with a ``KeyIntervals`` mask over the whole
sequence: after the all-to-all a rank holds every query row). A second
all-to-all brings the output home to ``[B, S/sp, H, D]``. sp must divide
the local head count (the JAX check and message). GQA kv heads ride
unexpanded when sp divides them, else they are repeated first.

The all-to-alls are ``all_to_all_single`` on the sp group (the helper
``parallel/collectives.all_to_all`` it shares with the MoE layer,
counted in this module's ``comm``), each an autograd op whose backward
is the other all-to-all. Gloo takes them on
CUDA tensors (the H100 probe of ``chip_smoke.py``'s sp phase); on NCCL
they go device to device.
"""

from __future__ import annotations

from typing import Optional

import torch

from dlrover_tpu_torch.ops.flash_attention import KeyIntervals, flash_attention
from dlrover_tpu_torch.parallel.collectives import all_to_all, new_counter, reset_counter
from dlrover_tpu_torch.parallel.ring_attention import MaskFn


# the all-to-alls' host time (ms; on the card after the queued kernels
# finished), their number, and how many moved CUDA tensors over gloo
# (read by the sp phase of chip_smoke.py)
comm = new_counter()


def reset_comm() -> None:
    reset_counter(comm)


def _sp_group(mesh):
    """The sp group, its size, and a check that its group rank order is
    the mesh's sp order (chunk j of an all-to-all goes to group rank j)."""
    ranks = mesh.ranks.get("sp") or [mesh.rank]
    if ranks != sorted(ranks):
        raise NotImplementedError(
            f"the sp group's ranks {ranks} are not in rank order (a DCN layout "
            "of sp): the all-to-all's chunk order would not be the sequence order"
        )
    return mesh.groups.get("sp"), len(ranks)


def _seq_to_heads(x, group, sp):
    """``[B, S/sp, h, D]`` -> ``[B, S, h/sp, D]``: head chunk j to rank j,
    the sequence blocks concatenated in rank order."""
    B, Tl, h, D = x.shape
    send = x.reshape(B, Tl, sp, h // sp, D).permute(2, 0, 1, 3, 4).contiguous()
    got = all_to_all(send, group, comm)  # [sp (source = sequence block), B, Tl, h/sp, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, sp * Tl, h // sp, D)


def _heads_to_seq(x, group, sp):
    """The inverse: ``[B, S, h/sp, D]`` -> ``[B, S/sp, h, D]``."""
    B, S, hl, D = x.shape
    send = x.reshape(B, sp, S // sp, hl, D).permute(1, 0, 2, 3, 4).contiguous()
    got = all_to_all(send, group, comm)  # [sp (source = head chunk), B, S/sp, h/sp, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // sp, sp * hl, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _seq_to_heads(x, group, sp)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group, ctx.sp), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _heads_to_seq(x, group, sp)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group, ctx.sp), None, None


def ulysses_self_attention(q, k, v, mesh, *, causal: bool = True,
                           mask_fn: Optional[MaskFn] = None):
    """This rank's sequence block ``q/k/v [B, S/sp, H(kv), D]`` in, its
    block of the output out (layout-compatible with
    ``ring_self_attention``). ``mask_fn``: a ``KeyIntervals`` over the
    whole sequence, or (on the CPU) a callable of 1-D global positions,
    as the ring takes."""
    group, sp = _sp_group(mesh)
    H, Hkv = q.shape[2], k.shape[2]
    if H % sp:
        raise ValueError(
            f"ulysses needs sp={sp} to divide the local head count "
            f"{H}; use the ring scheme for this config"
        )
    if Hkv % sp:
        # sp does not divide the kv heads: expand them before the wire
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    kernel_mask = mask_fn
    if mask_fn is not None and not isinstance(mask_fn, KeyIntervals):
        # the kernels' contract hands [Tq,1] / [1,Tk]; this module's, 1-D
        kernel_mask = lambda qp, kp: mask_fn(qp.reshape(-1), kp.reshape(-1))  # noqa: E731
    if sp == 1:
        return flash_attention(q, k, v, causal=causal, mask_fn=kernel_mask)
    out = flash_attention(
        _SeqToHeads.apply(q, group, sp),
        _SeqToHeads.apply(k, group, sp),
        _SeqToHeads.apply(v, group, sp),
        causal=causal, mask_fn=kernel_mask,
    )
    return _HeadsToSeq.apply(out, group, sp)
