"""The training step (counterpart of ``dlrover_tpu/models/train.py``:
``TrainState``, state init and ``build_train_step``).

One process drives one device and computes the gradients of its own
rows of the global batch (``parallel/mesh.batch_sharding``). The step
has the JAX package's two paths:

- **explicit** (a ``grad_sync`` plan, ``comm_overlap`` on a mesh with a
  data axis): local gradients, accumulated in f32 across the
  ``grad_accum`` microbatches with no collective, then ONE bucketed
  ``sync_grads`` per optimizer step (the JAX package's
  ``synced_grads``). The error-feedback residual is used only when the
  plan's resolved mode compresses. With the SDC switch on
  (``parallel/sdc.py``) the ``device.sdc`` fault's lane scales its
  local gradient before the sync and the metrics carry the per-lane
  pre-sync norms (``sdc_device_norms``);
- **default** (no plan; the JAX package's ``gspmd_grads``): the mean
  over the data axes per microbatch, one all-reduce of the whole
  gradient tree each, the un-overlapped baseline the explicit path is
  measured against. At world size 1 it is the single-device step.

The loss and every metric are global means over the data axes.

Sequence parallelism (a mesh with ``sp > 1``): the step takes this
rank's rows at their full length and keeps its block of each row
(``mesh.sequence_sharding``, tokens and targets alike); the model runs
the ring or Ulysses over the ``sp`` group. The loss is the global token
mean: each rank's mean over its block, over ``sp``, summed over the sp
group, so the logged loss is the same number on every rank. sp shards
no parameter, so the gradients are summed over the sp group: on the
explicit path by the plan (kind ``tp`` with ``auto_axes=("sp",)``, the
sp sum before the dp legs), on the default path by the data mean's own
all-reduce, run over the ``replica`` group (dp x fsdp x sp) and divided
by dp x fsdp: one collective a microbatch sums over sp and averages over
the data axes at once. The loss is reduced the same way.

Tensor parallelism (a mesh with ``tp > 1``; ``models/transformer``'s
Megatron layout): each tp rank holds its box of every split leaf and
runs the same rows; the loss is the same number on every tp rank, so it
is reduced over each tp coordinate's own data (or replica) group alone.
The grads of a split leaf are the rank's box of the global gradient and
those of a whole leaf are equal on every tp rank, so the sync runs per
tp coordinate: the default path's all-reduce over that coordinate's
data (or replica) group, the explicit plans of kind ``tp`` (dp x tp:
the dp legs on the rank's tp-local buckets) and ``3d`` (dp x fsdp x tp:
ZeRO on the tp-local leaves). ``grad_norm`` is the global norm of the
whole tree, as in the JAX package: the squares of the split leaves
summed over tp, the whole leaves counted once. Under the per-leaf 8-bit
AdamW each tp-local leaf is quantized in its own 128-element blocks
where the JAX package quantizes the whole leaf in its blocks (the
codes of a split leaf's box differ from the JAX codes of those
elements: a block can straddle two boxes there), as ZeRO's per-leaf
block padding departs.

Micro-batch rebalance (``batch_pad``): the trainer appends
``batch_pad`` zero rows to each global batch (``pad_batch_rows``) and
the step weighs the rows of the loss (``pad_row_weights``: the pads 0,
the real rows ``padded / real``), so the mean over the padded batch, and
the mean of the ranks' means, is the mean over the real rows. It needs
``grad_accum=1`` and a dense model, as in the JAX package.

ZeRO (a plan of kind ``zero``, dp x fsdp; and ep x fsdp, which no plan
syncs: ``zero_layout_of``): between steps the optimizer
and its state hold only this rank's block rows of each leaf
(``TrainState.shards``, ``BucketPlan.leaf_shard`` elements each, whole
128-element blocks of the row-major flatten), so the per-leaf 8-bit
AdamW quantizes the same blocks as on the whole leaf. The module's
params (``TrainState.params``) hold no storage: the step gathers them
over fsdp a unit at a time (``ZeroUnits``; a unit is the embedding, one
block, or the head, and under ``scan_layers`` all the stacked blocks,
since a stacked leaf's shard runs across layers) just before the unit
runs and frees them right after, in the forward and again in the
backward (a remat block is recomputed there; otherwise the backward
gathers only the params whose own storage the unit's graph saved: all
of them in the f32 compute of the CPU, the f32 norm scales alone under
the card's bf16 casts). So at any point a rank holds its shards and at
most one unit's full params. The gradients stay whole and are
reduce-scattered by the bucketed sync after the backward (which
consumes them bucket by bucket). ``evaluate`` runs the same units;
``gather_params`` fills the whole module for code that reads it.

``tx`` is an optimizer factory: a callable that takes the parameters in
the JAX flatten order (or, under ZeRO, their shards) and returns an
optimizer with ``step()`` (``trainer.elastic.trainer.build_optimizer``
makes one, and so does ``functools.partial`` over any ``torch.optim``
class).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import (
    Transformer,
    check_supported,
    init_params,
    loss_fn,
)
from dlrover_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    step: int
    params: Transformer
    opt_state: Any  # the optimizer bound to ``params`` (or ``shards``)
    # error-feedback residual of the int8-compressed gradient sync
    # (parallel/grad_sync.py): this rank's per-bucket (shard_elems,)
    # f32 rows, carried across steps so quantization noise cancels
    # instead of biasing the trajectory. None unless attached by
    # ``grad_sync.ensure_residual``; never checkpointed.
    grad_residual: Any = None
    # ZeRO: this rank's block rows of each leaf (1-D, whole blocks), the
    # tensors the optimizer updates; None off the zero kind
    shards: Optional[List[torch.Tensor]] = None
    # ZeRO: the per-unit gather the forward runs under (``ZeroUnits``)
    units: Any = None


def init_state(
    cfg: TransformerConfig, tx: Callable, seed: int = 0, devices=None,
    mesh=None, plan=None, offload_opt_state: bool = False,
    generator: Optional[torch.Generator] = None,
) -> TrainState:
    """Params from ``torch.Generator().manual_seed(seed)`` (or the given
    ``generator``, which draws on its own device) on the device (the card
    unless ``devices="cpu"``) and the optimizer over them (or, on a zero
    ``plan``, over this rank's shards of them). ``offload_opt_state``:
    the optimizer state in pinned host memory between steps
    (``ops/host_offload.py``; a numeric no-op on the CPU)."""
    device = resolve_device(devices)
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    params = init_params(gen, cfg, device, mesh)
    return state_from_params(params, tx, mesh, plan, offload_opt_state)


def _zero(plan) -> bool:
    """ZeRO's layout: the zero kind, and the 3d kind on tp-local leaves."""
    return plan is not None and plan.kind in ("zero", "3d")


def leaf_shards(leaves, mesh, plan) -> List[torch.Tensor]:
    """This rank's block rows of each leaf (its fsdp index's run of
    ``plan.leaf_shard(i)`` elements of the padded row-major flatten).
    Each shard carries its whole leaf's size in ``leaf_numel`` (the
    8-bit AdamW decides quantization on it, as on the whole leaf; under
    3d the global leaf's, which a tp-local param carries)."""
    f = mesh.group_index("fsdp")
    out = []
    for i, p in enumerate(leaves):
        flat = F.pad(p.detach().reshape(-1), (0, plan.leaf_padded(i) - p.numel()))
        sh = plan.leaf_shard(i)
        s = flat[f * sh:(f + 1) * sh].clone()
        s.leaf_numel = getattr(p, "leaf_numel", p.numel())
        out.append(s)
    return out


def zero_layout_of(leaves, mesh, plan):
    """The ZeRO layout a rank's ``leaves`` take, or None off ZeRO: the
    plan's (the zero and 3d kinds), and on an ep x fsdp mesh, which no
    plan syncs, the port's block layout of the rank's ep-local (under
    ep x tp, ep x tp-local) boxes over its fsdp group
    (``zero_layout``, as pp x fsdp lays its stage boxes out)."""
    if _zero(plan):
        return plan
    m = getattr(mesh, "config", None)
    if m is not None and m.ep > 1 and m.fsdp > 1:
        return zero_layout(leaves, m.fsdp)
    return None


def state_from_params(
    params: Transformer, tx: Callable, mesh=None, plan=None, offload_opt_state: bool = False,
) -> TrainState:
    leaves = params.jax_ordered_parameters()
    layout = zero_layout_of(leaves, mesh, plan)
    if layout is not None:
        shards = leaf_shards(leaves, mesh, layout)
        state = TrainState(step=0, params=params, opt_state=tx(shards), shards=shards)
        state.units = ZeroUnits(state, mesh, layout)
        free_params(state)
    else:
        state = TrainState(step=0, params=params, opt_state=tx(leaves))
    if offload_opt_state:
        from dlrover_tpu_torch.ops.host_offload import offload_optimizer

        offload_optimizer(state.opt_state, leaves[0].device if leaves else None)
    return state


def free_params(state: TrainState) -> None:
    """ZeRO: release the full params' storage; their shapes stay, and
    ``gather_params`` fills them again."""
    for p in state.params.jax_ordered_parameters():
        p.untyped_storage().resize_(0)


def _gather_leaves(state: TrainState, group, plan, idx: List[int]) -> None:
    """Leaves ``idx`` (in order) of the module, allocated where
    ``free_params`` released them and filled from every fsdp rank's
    shards by one all-gather over fsdp. The copies go through ``.data``:
    a saved tensor of the autograd graph that shares a param's storage
    sees the same bytes again, at the version it saved."""
    from dlrover_tpu_torch.parallel.grad_sync import _all_gather

    leaves = state.params.jax_ordered_parameters()
    for i in idx:
        p = leaves[i]
        if p.untyped_storage().nbytes() == 0:
            p.untyped_storage().resize_(p.numel() * p.element_size())
    chunk = torch.cat([state.shards[i].reshape(-1).float() for i in idx])
    full, h = _all_gather(chunk, group)
    h.wait()
    rows = full.view(plan.fsdp, -1)
    off = 0
    for i in idx:
        sh, p = plan.leaf_shard(i), leaves[i]
        p.data.copy_(rows[:, off:off + sh].reshape(-1)[:p.numel()].view(p.shape))
        off += sh


def gather_params(state: TrainState, mesh, plan) -> None:
    """ZeRO: the whole module from every fsdp rank's shards (one
    all-gather a bucket over fsdp), for code that reads it between
    steps; ``free_params`` releases it again."""
    group = mesh.groups["fsdp"]
    for b in plan.buckets:
        _gather_leaves(state, group, plan, list(range(b.start, b.stop)))


class ZeroUnits:
    """ZeRO's per-unit gather, the ``gather`` of ``transformer.forward``:
    a unit's params (``transformer.unit_parameters``) are gathered over
    fsdp just before it runs and freed right after. With autograd on
    (``_GatheredUnit``) the unit's own graph is kept aside and the
    backward gathers the unit again only if that graph saved its params'
    storage (those params only), or, for a remat block
    (``recompute``), to rebuild it. ``units``: the parameters of each
    unit by key (default ``transformer.unit_parameters``; a pipeline
    stage's are ``parallel/pipeline.stage_units``)."""

    def __init__(self, state: TrainState, mesh, plan, units=None):
        self.state, self.plan = state, plan
        self.group = mesh.groups["fsdp"]
        leaves = state.params.jax_ordered_parameters()
        index = {id(p): i for i, p in enumerate(leaves)}
        if units is None:
            from dlrover_tpu_torch.models.transformer import unit_parameters

            units = unit_parameters(state.params)
        # key -> (leaf indices, their params), in leaf order
        self.units = {}
        for key, ps in units.items():
            pairs = sorted((index[id(p)], p) for p in ps)
            self.units[key] = ([i for i, _ in pairs], [p for _, p in pairs])

    def gather(self, key, only=None) -> None:
        """Gather unit ``key`` (``only``: just those of its leaf
        indices)."""
        idx = self.units[key][0] if only is None else sorted(only)
        if idx:
            _gather_leaves(self.state, self.group, self.plan, idx)

    def free(self, key) -> None:
        for p in self.units[key][1]:
            p.untyped_storage().resize_(0)

    def largest_unit_bytes(self) -> int:
        return max(sum(p.numel() * p.element_size() for p in ps) for _, ps in self.units.values())

    def __call__(self, key, fn, x, recompute=False):
        if not torch.is_grad_enabled():
            self.gather(key)
            try:
                return fn(x)
            finally:
                self.free(key)
        return _GatheredUnit.apply(self, key, fn, recompute, x, *self.units[key][1])


def zero_layout(leaves, fsdp: int):
    """The port's ZeRO layout of a rank's leaves (its boxes) over fsdp
    when no plan lays them out (pp x fsdp, ep x fsdp): each leaf padded
    to fsdp x whole 128-element blocks, a rank's shard its run of block
    rows (``grad_sync.BucketPlan.leaf_shard``), as one bucket the ZeRO
    helpers here walk."""
    from dlrover_tpu_torch.parallel.grad_sync import ZERO_LEAF_BLOCK, plan_buckets

    return plan_buckets(list(leaves), dp=1, fsdp=fsdp, bucket_bytes=1 << 62, kind="zero",
                        leaf_block=ZERO_LEAF_BLOCK)


def zero_scatter(grads, idx, units: "ZeroUnits", mesh, n_data: int,
                 over=("dp",)) -> List[torch.Tensor]:
    """The whole grads of leaves ``idx`` (this rank's, of one sync unit)
    -> this rank's ZeRO shards of their mean over the data axes: each
    leaf padded to its ``leaf_padded`` length and laid out rank-major
    (every fsdp rank's block rows of the unit's leaves in turn), one
    reduce-scatter over fsdp, one all-reduce over each group of
    ``over`` (dp; under ep x fsdp x sp also sp), divided by ``n_data``.
    ``grads`` is consumed."""
    from dlrover_tpu_torch.parallel.grad_sync import _all_reduce, _reduce_scatter

    plan = units.plan
    sizes = [plan.leaf_shard(i) for i in idx]
    flat = torch.zeros((plan.fsdp, sum(sizes)), dtype=torch.float32, device=grads[0].device)
    off = 0
    for k, g in enumerate(grads):
        # the leaf's padded flatten as fsdp rows of its shard's length
        sh, gf = sizes[k], g.reshape(-1)
        full, rest = divmod(gf.numel(), sh)
        flat[:full, off:off + sh] = gf[:full * sh].view(full, sh)
        if rest:
            flat[full, off:off + rest] = gf[full * sh:]
        off += sh
        grads[k] = gf = g = None
    flat = flat.reshape(-1)
    out, h = _reduce_scatter(flat, units.group)
    h.wait()
    del flat
    for name in over:
        group = mesh.groups.get(name)
        if group is not None:
            _all_reduce(out, group).wait()
    out.div_(n_data)
    return list(out.split(sizes))


class _GatheredUnit(torch.autograd.Function):
    """One unit of the forward under ``ZeroUnits``: its params in the
    outer graph only as inputs (their grads come from the unit's own
    graph, or its recompute), so the outer graph holds none of them. A
    unit returns a tensor, or a tuple of them (a MoE model's block: the
    residual stream and its packed aux)."""

    @staticmethod
    def forward(ctx, units, key, fn, recompute, x, *params):
        ctx.units, ctx.key, ctx.fn, ctx.recompute = units, key, fn, recompute
        units.gather(key)
        try:
            if recompute:
                ctx.save_for_backward(x)
                return fn(x)  # autograd is off in here
            leaf = dict(zip(units.units[key][0], params))
            ptrs = {p.untyped_storage().data_ptr(): i for i, p in leaf.items()}
            ctx.saved_leaves = set()

            def pack(t):
                i = ptrs.get(t.untyped_storage().data_ptr())
                if i is not None:
                    ctx.saved_leaves.add(i)
                return t

            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                xi = x.detach().requires_grad_(x.requires_grad)
                out = fn(xi)
            ctx.inner = (xi, out)
            if isinstance(out, tuple):
                return tuple(o.detach() for o in out)
            return out.detach()
        finally:
            units.free(key)

    @staticmethod
    def backward(ctx, *g):
        units, key = ctx.units, ctx.key
        params = units.units[key][1]
        if ctx.recompute:
            (x,) = ctx.saved_tensors
            units.gather(key)
            with torch.enable_grad():
                xi = x.detach().requires_grad_(x.requires_grad)
                out = ctx.fn(xi)
        else:
            (xi, out), ctx.inner = ctx.inner, None
            # only the params whose own storage the graph saved (on the
            # card the weights are saved as their bf16 casts)
            units.gather(key, ctx.saved_leaves)
        # the outputs autograd reaches (a dense block's zero aux does not)
        pairs = [(o, go) for o, go in zip(out if isinstance(out, tuple) else (out,), g)
                 if o.requires_grad]
        try:
            wrt = ([xi] if xi.requires_grad else []) + list(params)
            grads = list(torch.autograd.grad([o for o, _ in pairs], wrt, [go for _, go in pairs],
                                             allow_unused=True))
        finally:
            units.free(key)
        gx = grads.pop(0) if xi.requires_grad else None
        return (None, None, None, None, gx, *grads)


def pad_row_weights(n_real: int, n_padded: int) -> np.ndarray:
    """Loss row-weights for a zero-padded batch (micro-batch rebalance):
    real rows weigh ``n_padded / n_real`` and pad rows 0, so the plain
    mean over the padded batch equals the mean over the real rows, and so
    does the mean of the data ranks' means (the scale is uniform)."""
    if not 0 < n_real <= n_padded:
        raise ValueError(f"need 0 < n_real <= n_padded, got {n_real}/{n_padded}")
    w = np.zeros((n_padded,), np.float32)
    w[:n_real] = n_padded / float(n_real)
    return w


def pad_batch_rows(x, n_padded: int) -> np.ndarray:
    """Zero-pad a ``[B, ...]`` host batch to ``n_padded`` rows (the
    trainer's collate step under ``batch_pad``; ``pad_row_weights`` zero
    the pads out of the loss)."""
    x = np.asarray(x)
    if x.shape[0] >= n_padded:
        return x
    pad = np.zeros((n_padded - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _flat_all_reduce_mean(grads: List[torch.Tensor], group, n: int) -> List[torch.Tensor]:
    """The mean over the data axes of a whole gradient list: one
    all-reduce of its concatenation."""
    from dlrover_tpu_torch.parallel.grad_sync import _all_reduce

    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _all_reduce(flat, group).wait()
    flat /= n
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out


def build_train_step(
    cfg: TransformerConfig, tx: Callable = None, grad_accum: int = 1,
    before_update: Optional[Callable[[], None]] = None,
    mesh=None, plan=None, batch_pad: int = 0,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, Dict]]:
    """``(state, tokens, targets) -> (state, {"loss", "grad_norm"})``,
    updating ``state`` in place (params, optimizer, step count).
    ``tokens`` / ``targets`` are this rank's rows of the global batch
    (all of it at world size 1).

    ``grad_accum=K`` splits the rows into K microbatches in order and
    accumulates their grads in f32 whatever the param dtype before ONE
    optimizer step. ``mesh`` (``parallel/mesh.build_mesh``) gives the
    data axes' groups; ``plan`` (``grad_sync.resolve_plan``) picks the
    explicit path. ``tx`` is accepted for the JAX signature; the step
    uses the optimizer bound in ``state.opt_state``. ``before_update()``
    runs after the gradients are final and before the optimizer writes
    anything (the trainer makes its stream wait there for a
    checkpoint's copies of the state). ``batch_pad``: the last
    ``batch_pad`` rows of the global batch are padding and weigh 0 in
    the loss (``pad_row_weights``).

    A MoE model's loss carries its aux losses (``loss_fn``'s), and the
    metrics add ``moe_balance_loss``,
    ``moe_z_loss``, ``moe_expert_load`` (an ``[E]`` vector: consumers
    that report scalars pop it) and ``moe_drop_rate``, the last two per
    MoE layer, all means over the data axes and the microbatches.

    Expert parallelism (a mesh with ``ep > 1``; the JAX
    ``ep_synced_grads``): every ep rank of a data (and sp, tp)
    coordinate runs the same rows, with its ``E/ep`` experts, through
    the MoE layers' all-to-alls. The loss is seeded on ep rank 0 alone
    (each ep rank computes the same loss through the exchanges: seeding
    all of them would scale the experts' cotangent by ep) and every ep
    rank runs the backward, whose transposed exchanges are collectives
    too; rank 0's backward reaches every rank's experts through them.
    The grads then go through ``grad_sync.sync_ep_grads``: the dense
    ones summed over ep (the sum selects rank 0's), then the expert and
    the dense leaves synced over dp by the ``EPSyncPlan``'s two plans
    (dp x ep with ``comm_overlap``), else by the default sync: the sum
    over the data axes and sp divided by dp x fsdp, under fsdp a
    reduce-scatter into the ZeRO shards of the rank's boxes
    (``zero_layout_of``). ``grad_norm`` counts each leaf once over the
    axes that hold it whole (``grad_sync.split_grad_norm``). Under
    ``grad_accum`` the microbatches' grads accumulate locally and sync
    once. ep composes with tp (each tp rank its ``F/tp`` columns of its
    experts, ``parallel/moe``), with sp (each rank gates its own block)
    and with fsdp; the JAX package runs these meshes under its default
    schedule, and so does the port: no plan."""
    if batch_pad and grad_accum > 1:
        raise ValueError("batch_pad (micro-batch rebalance) requires grad_accum=1")
    if batch_pad and cfg.num_experts:
        # the router's aux losses would see the pad tokens
        raise ValueError(
            "batch_pad is not supported for MoE models: the gating "
            "aux losses would see the pad tokens"
        )
    check_supported(cfg, mesh)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if plan is not None and mesh is None:
        raise ValueError("an explicit gradient-sync plan needs the mesh")
    data_group = mesh.groups["data"] if mesh is not None else None
    n_data = mesh.config.dp * mesh.config.fsdp if mesh is not None else 1
    sp = mesh.config.sp if mesh is not None else 1
    tp = mesh.config.tp if mesh is not None else 1
    ep = mesh.config.ep if mesh is not None else 1
    moe = bool(cfg.num_experts)
    # the default path's reduction (and the loss's), each tp
    # coordinate's own: with sp the replica group, whose sum is the sp
    # sum and the data sum in one collective
    sync_group = mesh.groups["replica"] if sp > 1 else data_group
    model_mesh = mesh if sp > 1 or tp > 1 or ep > 1 else None
    tp_dims = None
    if tp > 1:
        from dlrover_tpu_torch.parallel.sharding_rules import leaf_tp_dims

        tp_dims = leaf_tp_dims(cfg, tp)
    expert_ids = None
    # the loss's seed on this rank: ep rank 0 alone
    seed = 1.0
    if ep > 1:
        from dlrover_tpu_torch.parallel.sharding_rules import leaf_tp_dims

        expert_ids = [i for i, d in enumerate(leaf_tp_dims(cfg, ep, "ep")) if d is not None]
        seed = 1.0 if mesh.coords.get("ep", 0) == 0 else 0.0
    n_moe = 1
    if moe:
        from dlrover_tpu_torch.models.config import num_moe_layers
        from dlrover_tpu_torch.models.transformer import _pack_aux, _unpack_aux

        n_moe = max(num_moe_layers(cfg), 1)

    def seq_block(tokens, targets):
        """This rank's block of each row under sequence parallelism."""
        if sp == 1:
            return tokens, targets
        from dlrover_tpu_torch.parallel.mesh import sequence_sharding

        block = sequence_sharding(mesh, tokens.shape[1])
        return tokens[:, block], targets[:, block]

    def loss_of(model, tokens, targets, row_w=None, units=None):
        """(the rank's loss, its packed MoE aux or None): over sp, its
        block's mean divided by sp (the sp sum of these is the mean over
        the whole rows), and so its aux (each sp block gates its own
        tokens: their sp sum is the JAX package's mean over sp)."""
        loss, aux = loss_fn(model, tokens, targets, cfg, model_mesh, row_weights=row_w,
                            gather=units, return_aux=True)
        aux = _pack_aux(aux).detach() if moe else None
        if sp > 1:
            return loss / sp, (aux / sp if moe else None)
        return loss, aux

    def backward(loss, params):
        # under ep only rank 0's seed is 1 (every rank runs the backward)
        return list(torch.autograd.grad(loss * seed if ep > 1 else loss, params))

    def row_weights(tokens):
        """This rank's rows' loss weights under ``batch_pad`` (None
        unpadded): its rows of the global batch's ``pad_row_weights``."""
        if not batch_pad:
            return None
        n = tokens.shape[0] * n_data
        w = pad_row_weights(n - batch_pad, n)
        if n_data > 1:
            from dlrover_tpu_torch.parallel.mesh import batch_sharding

            w = w[batch_sharding(mesh, n)]
        return torch.from_numpy(w).to(tokens.device)

    def local_grads(model, params, tokens, targets, units=None):
        """(mean loss over this rank's rows, f32-accumulated local grads,
        or the param-dtype grads at ``grad_accum=1``, the mean packed MoE
        aux or None); ``units``: ZeRO's per-unit gather."""
        if grad_accum == 1:
            loss, aux = loss_of(model, tokens, targets, row_weights(tokens), units)
            return loss.detach(), backward(loss, params), aux
        B = tokens.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} must divide into grad_accum={grad_accum}")
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        aux = None
        for x, y in zip(tokens.chunk(grad_accum), targets.chunk(grad_accum)):
            mb_loss, mb_aux = loss_of(model, x, y, units=units)
            torch._foreach_add_(acc, [g.float() for g in backward(mb_loss, params)])
            loss = loss + mb_loss.detach()
            if moe:
                aux = mb_aux if aux is None else aux + mb_aux
        return loss / grad_accum, [a / grad_accum for a in acc], \
            (aux / grad_accum if moe else None)

    def default_grads(model, params, tokens, targets):
        """The mean over the data axes per microbatch (one all-reduce of
        the whole tree each), f32-accumulated, cast to the param dtype
        once."""
        if data_group is None:
            loss, grads, aux = local_grads(model, params, tokens, targets)
            if sync_group is not None:  # sp alone (it shards no param): the sp sum
                grads = _flat_all_reduce_mean(grads, sync_group, 1)
            return loss, [g.to(p.dtype) for g, p in zip(grads, params)], aux
        B = tokens.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} must divide into grad_accum={grad_accum}")
        acc = None
        aux = None
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for x, y in zip(tokens.chunk(grad_accum), targets.chunk(grad_accum)):
            mb_loss, mb_aux = loss_of(model, x, y, row_weights(x))
            grads = _flat_all_reduce_mean(
                list(torch.autograd.grad(mb_loss, params)), sync_group, n_data
            )
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            loss = loss + mb_loss.detach()
            if moe:
                aux = mb_aux if aux is None else aux + mb_aux
        return loss / grad_accum, [(a / grad_accum).to(p.dtype) for a, p in zip(acc, params)], \
            (aux / grad_accum if moe else None)

    def synced_grads(state, model, params, tokens, targets):
        from dlrover_tpu_torch.parallel import sdc as sdc_mod
        from dlrover_tpu_torch.parallel.grad_sync import sync_grads

        loss, grads, aux = local_grads(model, params, tokens, targets, state.units)
        # residual present => error feedback; gate on the PLAN's
        # resolved mode, not the request string
        residual = state.grad_residual if plan.compressed else None
        if not sdc_mod.enabled():
            # the sync consumes the local grads bucket by bucket
            out, new_res, gnorm = sync_grads(grads, mesh, plan, residual=residual, consume=True)
            return loss, out, gnorm, new_res, None, aux
        # the device.sdc fault: lane ``inj.device`` multiplies its LOCAL
        # gradient by the finite factor from step ``inj.from_step`` on
        inj = sdc_mod.injection_plan(plan.total)
        if inj is not None and state.step + 1 >= inj.from_step and mesh.data_index == inj.device:
            grads = [g * inj.factor for g in grads]
        out, new_res, gnorm, lanes = sync_grads(
            grads, mesh, plan, residual=residual, device_norms=True
        )
        return loss, out, gnorm, new_res, lanes, aux

    def ep_grads(state, model, params, tokens, targets):
        from dlrover_tpu_torch.parallel.grad_sync import sync_ep_grads

        loss, grads, aux = local_grads(model, params, tokens, targets, state.units)
        grads, gnorm = sync_ep_grads(grads, mesh, plan, expert_ids, n_data, units=state.units,
                                     tp_dims=tp_dims)
        return loss, grads, gnorm, aux

    def train_step(state: TrainState, tokens, targets):
        model = state.params
        params = model.jax_ordered_parameters()
        tokens, targets = seq_block(tokens, targets)
        lanes = None
        if ep > 1:
            loss, grads, gnorm, aux = ep_grads(state, model, params, tokens, targets)
            targets_ = params if state.shards is None else state.shards
        elif plan is not None:
            loss, grads, gnorm, new_res, lanes, aux = synced_grads(
                state, model, params, tokens, targets
            )
            if plan.compressed and state.grad_residual is not None:
                state.grad_residual = new_res
            targets_ = state.shards if _zero(plan) else params
        else:
            loss, grads, aux = default_grads(model, params, tokens, targets)
            if tp_dims is None:
                gnorm = global_norm(grads)
            else:
                from dlrover_tpu_torch.parallel.grad_sync import split_grad_norm, tp_axes

                gnorm = split_grad_norm(grads, tp_axes(tp_dims), mesh)
            targets_ = params
        for p, g in zip(targets_, grads):
            p.grad = g.to(p.dtype)
        if sync_group is not None:
            # the metrics are global means over the data axes (under sp
            # the blocks' shares of the rows' mean, summed over sp too;
            # a MoE model's aux rides in the same all-reduce)
            from dlrover_tpu_torch.parallel.grad_sync import _all_reduce

            vec = loss.reshape(1).float()
            vec = torch.cat([vec, aux]) if moe else vec.clone()
            _all_reduce(vec, sync_group).wait()
            vec = vec / n_data
            loss = vec[0]
            if moe:
                aux = vec[1:]
        if before_update is not None:
            before_update()
        state.opt_state.step()
        for p in targets_:
            p.grad = None
        state.step += 1
        metrics = {"loss": loss, "grad_norm": gnorm}
        if lanes is not None:
            # SDC tier-1 fence input: each lane's local pre-sync grad
            # norm, a [plan.total] vector
            metrics["sdc_device_norms"] = lanes
        if moe:
            a = _unpack_aux(aux)
            metrics["moe_balance_loss"] = a["balance"]
            metrics["moe_z_loss"] = a["z"]
            # forward() sums the aux over the blocks: per MoE layer
            metrics["moe_expert_load"] = a["load"] / n_moe
            metrics["moe_drop_rate"] = a["drop"] / n_moe
        return state, metrics

    return train_step
