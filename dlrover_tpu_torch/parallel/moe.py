"""Mixture-of-Experts with expert parallelism over the mesh's ``ep``
group (the port of ``dlrover_tpu/parallel/moe.py``).

The math is the JAX package's, kept op for op:

- ``topk_gating``: softmax router, each token's ``k`` best experts
  (ties go to the lower expert index, as ``lax.top_k`` orders them),
  per-expert capacity slots counted rank-major (every token's first
  choice before any token's second), per-expert cutoffs
  (``expert_caps``), the one-hot ``dispatch`` / ``combine`` tensors
  ``[T, E, C]``, the Switch balance loss, the router z-loss and the
  routing stats (primary load, drop rate);
- ``moe_layer_local``: one rank's tokens in, gating on all of them,
  the dispatch einsum into ``[E, C, d]`` buckets, the dispatch
  all-to-all over the ep group (``ep`` > 1), the local experts' FFN as
  one batched einsum pair, the return all-to-all and the combine einsum.
  Where JAX promotes (``x @ gate`` of bf16 activations and f32 weights)
  the operands are cast to the promoted dtype here, so the gating,
  ``dispatch``, ``combine`` and the expert FFN run in the params' f32
  and the result is cast back to the activations' dtype.

The global ``moe_layer`` wrapper (``shard_map`` over the JAX mesh) has
no counterpart: the port's model hands ``moe_layer_local`` its local
tokens (under sp its block of each row, gated with the capacity of its
own tokens, as the JAX shard_map gates each block), the ep group and
the tp group.

Under tp the expert FFN is Megatron's split, as the dense MLP's: each tp
rank holds its ``F/tp`` columns of every local expert (``w_up [E/ep, D,
F/tp]``, ``w_down [E/ep, F/tp, D]``), the tokens and the gate enter
through ``copy_to_tp`` (identity forward, the tp sum backward), the
gating, the buckets and both ep exchanges are full width on every tp
rank, and the combined ``[T, D]`` output leaves through one
``reduce_from_tp``. The activation is elementwise, so the split is
exact: the same function the JAX layer computes after gathering the
expert weights over tp, at ``1/tp`` of the weights and the expert
FLOPs. The gradients of the tokens and the gate are then tp sums of each
rank's part, and the balance and z losses, computed whole on every tp
rank, must enter that sum once: they carry their gradient on tp
coordinate 0 alone (``_tp_once``).

Each all-to-all is ``_EpAllToAll``, an autograd op whose backward is
the same exchange of the gradient (an all-to-all that splits and joins
on one dim is its own transpose). Every ep rank must therefore run the
forward and the backward of every MoE layer in the same order. The
exchanges go through ``parallel/collectives.all_to_all`` and are
counted in this module's ``comm`` (apart from Ulysses').

``CapacityRebalancer`` is the JAX class, host-side numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.parallel.collectives import all_to_all, new_counter, reset_counter

# the JAX ``MoEParams`` fields, in its NamedTuple (flatten) order
MOE_FIELDS = ("gate", "w_up", "w_down")

# the ep all-to-alls' host ms, number and CUDA tensors staged over gloo
# (the ``ep_train`` line of chip_smoke.py)
comm = new_counter()


def reset_comm() -> None:
    reset_counter(comm)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def init_moe_params(
    generator: torch.Generator, num_experts: int, model_dim: int, hidden_dim: int,
    dtype=torch.float32, device=None,
) -> Dict[str, torch.Tensor]:
    """``{"gate" [d, E], "w_up" [E, d, f], "w_down" [E, f, d]}`` drawn
    from ``generator`` in that order: ``N(0, 1/d)``, ``N(0, 1/d)``,
    ``N(0, 1/f)`` (the JAX draw's scales; its values come across through
    ``models/convert.py``)."""
    d, f, E = model_dim, hidden_dim, num_experts

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=generator.device) * fan_in**-0.5
        return w.to(device=device, dtype=dtype)

    return {
        "gate": draw((d, E), d),
        "w_up": draw((E, d, f), d),
        "w_down": draw((E, f, d), f),
    }


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the ``k`` largest along the last dim, largest
    first, ties to the lower index (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_gating(
    logits: torch.Tensor,
    num_experts: int,
    capacity: int,
    k: int = 2,
    normalize: bool = True,
    expert_caps: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """GShard top-k gating (the JAX ``topk_gating``): ``(dispatch [T,E,C],
    combine [T,E,C], balance, z)``, and with ``return_stats`` a dict of
    ``load`` (``[E]``, the primary-routing fraction) and ``drop`` (the
    fraction of (token, slot) assignments capacity dropped).
    ``expert_caps`` (``[E]``, at most ``capacity``): expert ``e`` keeps
    its first ``expert_caps[e]`` assignments."""
    T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    vals, idx = _top_k(probs, k)  # [T, k]
    if normalize and k > 1:
        gates = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    else:
        gates = vals
    onehots = F.one_hot(idx, num_experts).to(logits.dtype)  # [T, k, E]
    # capacity accounting rank-major: every rank-0 choice first, then
    # the rank-1 choices continue the same per-expert counters
    flat = onehots.transpose(0, 1).reshape(k * T, num_experts)
    pos_flat = (torch.cumsum(flat, dim=0) * flat).sum(-1) - 1.0
    pos = pos_flat.reshape(k, T).t()  # [T, k]
    if expert_caps is not None:
        caps = torch.as_tensor(expert_caps, dtype=torch.float32, device=logits.device)
        keep = pos < caps[idx]
    else:
        keep = pos < capacity
    gate_val = gates * keep
    # one_hot of an out-of-range slot is all zeros in JAX: one class more
    # here, then cut
    slot = torch.where(keep, pos, torch.full_like(pos, capacity)).long()
    pos_oh = F.one_hot(slot, capacity + 1)[..., :capacity].to(logits.dtype)  # [T, k, C]
    routed = onehots[..., None] * pos_oh[:, :, None, :]  # [T, k, E, C]
    dispatch = routed.sum(1)  # a token's k experts are distinct
    combine = (routed * gate_val[..., None, None]).sum(1)

    density = onehots[:, 0, :].mean(0)  # the primary assignment
    density_proxy = probs.mean(0)
    balance = (density * density_proxy).sum() * num_experts
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    if return_stats:
        stats = {"load": density, "drop": 1.0 - keep.float().sum() / float(k * T)}
        return dispatch, combine, balance, z, stats
    return dispatch, combine, balance, z


def top1_gating(logits: torch.Tensor, num_experts: int, capacity: int):
    """Switch top-1 gating: ``topk_gating`` at k = 1 without the z-loss."""
    dispatch, combine, balance, _ = topk_gating(logits, num_experts, capacity, k=1)
    return dispatch, combine, balance


class _EpAllToAll(torch.autograd.Function):
    """``[ep, ...]`` exchanged over the ep group (row ``j`` to ep rank
    ``j``); the backward exchanges the gradient the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x.contiguous(), group, comm)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group, comm), None


def ep_group_of(mesh) -> Tuple[object, int]:
    """(the mesh's ep group, ep) with a check that the group's rank
    order is the mesh's ep order (row ``j`` of an all-to-all goes to
    group rank ``j``, which must hold experts ``j x E/ep`` on)."""
    if mesh is None:
        return None, 1
    ep = int(getattr(getattr(mesh, "config", mesh), "ep", 1))
    if ep == 1:
        return None, 1
    ranks = mesh.ranks.get("ep") or [mesh.rank]
    if ranks != sorted(ranks):
        raise NotImplementedError(
            f"the ep group's ranks {ranks} are not in rank order (a DCN layout "
            "of ep): the all-to-all's row order would not be the expert order"
        )
    return mesh.groups.get("ep"), ep


def _promoted(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _tp_once(t: torch.Tensor, tp_coord: int) -> torch.Tensor:
    """An aux loss every tp rank computes whole, with its gradient on tp
    coordinate 0 alone: its cotangent reaches the tokens and the gate,
    whose tp sums (``copy_to_tp``'s backward) would otherwise take it tp
    times."""
    return t if tp_coord == 0 else t.detach()


def moe_layer_local(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    group=None,
    ep: int = 1,
    capacity_factor: float = 1.25,
    activation=_gelu,
    top_k: int = 1,
    expert_caps: Optional[Sequence[int]] = None,
    tp_group=None,
    tp_coord: int = 0,
):
    """One rank's MoE FFN: ``x [T, d]`` (this rank's tokens) -> ``(out
    [T, d] in x's dtype, aux)``, aux ``{"balance", "z", "load", "drop"}``.
    ``params``: ``gate [d, E]`` whole, ``w_up [E/ep, d, f]`` and ``w_down
    [E/ep, f, d]`` this ep rank's experts (rank ``i`` holds experts ``i x
    E/ep`` on; under tp ``f`` is this tp rank's ``F/tp`` columns of
    them). ``group`` / ``ep``: the ep group and its size (None / 1:
    every expert local, no exchange). ``tp_group`` / ``tp_coord``: the tp
    group (None: no tp) and this rank's coordinate on it. ``expert_caps``
    (static ``[E]`` ints, ``CapacityRebalancer.splits``): the bucket dim
    becomes ``max(expert_caps)`` and expert ``e`` keeps its first
    ``expert_caps[e]`` assignments."""
    gate, w_up, w_down = params["gate"], params["w_up"], params["w_down"]
    if tp_group is not None:
        from dlrover_tpu_torch.models.transformer import copy_to_tp

        x, gate = copy_to_tp(x, tp_group), copy_to_tp(gate, tp_group)
    e_local = w_up.shape[0]
    e_global = e_local * ep
    T, model = x.shape
    caps = None
    if expert_caps:
        if len(expert_caps) != e_global:
            raise ValueError(
                f"expert_caps has {len(expert_caps)} entries for {e_global} experts"
            )
        capacity = max(1, int(max(expert_caps)))
        caps = torch.as_tensor(list(expert_caps), dtype=torch.float32, device=x.device)
    else:
        # top-k routes k slots a token: the capacity scales with k
        capacity = max(1, int(capacity_factor * top_k * T / e_global))

    xg, gate = _promoted(x, gate)
    logits = xg @ gate  # [T, E]
    dispatch, combine, balance, z, stats = topk_gating(
        logits, e_global, capacity, k=top_k, expert_caps=caps, return_stats=True
    )
    if tp_group is not None:
        balance, z = _tp_once(balance, tp_coord), _tp_once(z, tp_coord)
    aux = {"balance": balance, "z": z, "load": stats["load"], "drop": stats["drop"]}

    # bucket the tokens [E, C, d]; global expert id (owner rank, local
    # expert) row-major
    d_, xe = _promoted(dispatch, x)
    expert_in = torch.einsum("tec,tm->ecm", d_, xe)
    expert_in = expert_in.reshape(ep, e_local, capacity, model)
    if ep > 1:
        # [ep (source), E/ep, C, d]
        expert_in = _EpAllToAll.apply(expert_in, group)
    expert_in = expert_in.transpose(0, 1).reshape(e_local, ep * capacity, model)

    # the local experts' FFN: one batched einsum pair
    a, wu = _promoted(expert_in, w_up)
    h = activation(torch.einsum("ecm,emh->ech", a, wu))
    h, wd = _promoted(h, w_down)
    expert_out = torch.einsum("ech,ehm->ecm", h, wd)

    # the return exchange: each source rank's rows home, then [E, C, d]
    expert_out = expert_out.reshape(e_local, ep, capacity, model).transpose(0, 1)
    if ep > 1:
        expert_out = _EpAllToAll.apply(expert_out, group)  # [ep (owner), E/ep, C, d]
    expert_out = expert_out.reshape(e_global, capacity, model)

    c_, eo = _promoted(combine, expert_out)
    out = torch.einsum("tec,ecm->tm", c_, eo)
    if tp_group is not None:
        from dlrover_tpu_torch.models.transformer import reduce_from_tp

        # the tp ranks' partial sums over their F/tp columns
        out = reduce_from_tp(out, tp_group)
    return out.to(x.dtype), aux


# -- capacity rebalancing ----------------------------------------------------


class CapacityRebalancer:
    """Per-expert capacity re-split from the measured routing load (the
    JAX class): an EMA of the per-expert primary-routing fraction
    (``observe``, fed the ``moe_expert_load`` metric) and, on request,
    the same total slot budget re-split in proportion to it
    (``splits``), each expert clamped to ``[floor, boost] x`` the
    uniform capacity. The trainer consults it every
    ``moe_rebalance_interval`` steps and sets ``capacity_splits``."""

    def __init__(
        self,
        num_experts: int,
        capacity_factor: float = 1.25,
        top_k: int = 1,
        ema: float = 0.8,
        boost: float = 2.0,
        floor: float = 0.25,
    ):
        if num_experts < 2:
            raise ValueError("rebalancing needs >= 2 experts")
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        self.top_k = int(top_k)
        self.ema = float(ema)
        self.boost = float(boost)
        self.floor = float(floor)
        self.load = np.full(num_experts, 1.0 / num_experts)
        self.observations = 0

    def observe(self, load) -> None:
        """Fold one per-expert primary-routing fraction vector into the
        EMA (a vector summing to 0 is skipped)."""
        load = np.asarray(load, dtype=np.float64).reshape(-1)
        if load.shape[0] != self.num_experts:
            raise ValueError(
                f"load has {load.shape[0]} entries for {self.num_experts} experts"
            )
        total = float(load.sum())
        if total <= 0:
            return
        load = load / total
        self.load = self.ema * self.load + (1.0 - self.ema) * load
        self.load = self.load / self.load.sum()
        self.observations += 1

    def splits(self, tokens_per_shard: int) -> Tuple[int, ...]:
        """Static per-expert capacities for a shard of
        ``tokens_per_shard`` routed tokens."""
        base = max(
            1, int(self.capacity_factor * self.top_k * tokens_per_shard / self.num_experts)
        )
        total = base * self.num_experts
        raw = self.load * total
        lo = max(1, int(round(self.floor * base)))
        hi = max(lo + 1, int(np.ceil(self.boost * base)))
        caps = np.clip(np.round(raw), lo, hi).astype(int)
        return tuple(int(c) for c in caps)
