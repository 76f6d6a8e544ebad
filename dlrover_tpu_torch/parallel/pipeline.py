"""Pipeline parallelism over the ``pp`` mesh axis (the port of
``dlrover_tpu/parallel/pipeline.py``).

The JAX package stacks each stage's layers on a leading axis sharded over
``pp`` and runs the microbatch rotation as a ``lax.scan`` of ``ppermute``
ticks inside a ``shard_map`` that is manual over pp. Here each pp rank is
a process that owns its stage (``PipelineStage``, an ``nn.Module``), and
activations go forward and cotangents go back point to point on the
mesh's ``pp`` group (``_Link``: ``batch_isend_irecv``).

Layout. A stage rank holds the shared leaves (``embed``, ``final_norm``,
``lm_head`` when untied; every stage holds them, as every JAX device
does) and its row of each stage-stacked leaf: ``stages.attn.wq`` of shape
``[1, L/pp, D, H, K]``, row ``[s]`` of the JAX ``[pp, L/pp, ...]`` leaf,
or under interleaving ``[1, v, L/(pp v), ...]``, row ``[d]`` of ``[pp, v,
L/(pp v), ...]`` (chunk ``q`` of device ``d`` is global stage ``q P +
d``). So the JAX stacked tree is the rank's tree at its row
(``stage_dims``; ``models/convert`` and the checkpoint records read it
so), and ``stack_pipeline_params`` / ``unstack_pipeline_params``
(numpy or torch leaves) move a whole tree between the layouts.

Schedules, each a clock of ticks on which a rank runs at most one
chunk forward and one chunk backward, the hops of a tick's results
landing on the next tick (``_slots``):

- **GPipe** (``"gpipe"``): M forwards (stage ``d`` runs microbatch ``j``
  at tick ``d + j``) with autograd, each block under the remat
  checkpoint when ``cfg.remat``; then M backwards in reverse, the last
  stage first. O(M) microbatch graphs live at the turn.
- **1F1B** (``"1f1b"``): stage ``i`` runs the forward of ``j`` at tick
  ``i + j`` without autograd and keeps only its input (at most 2P-1
  inputs at once, the JAX ring buffer); at tick ``2(P-1) - i + j`` it
  recomputes the stage forward from that input under autograd and runs
  its backward: remat at stage granularity, so the recompute runs the
  blocks plainly (a block checkpoint inside it would run each block's
  forward a third time).
- **Interleaved 1F1B** (``"interleaved"``, ``virtual = v >= 2``): the
  JAX tick algebra (``_slots``), microbatches entering in lane groups of
  P with the last group padded to P lanes (``m_pad``; without the pad its
  backward slots fall past the clock and its gradients are lost); at
  most 2vP-1 chunk inputs live.

The embedding runs on stage 0 (chunk 0) outside autograd, and its
backward is the scatter-add of the input cotangent's rows into the
table's gradient (f32), as the JAX 1F1B writes it. The final norm, the
head and ``token_nll`` run on the last stage (the last chunk), the loss
of each microbatch divided by M and its backward run at once (the head
is never held across microbatches); its cotangent feeds the stage's
backward. Only the last stage seeds the loss: seeding every stage would
scale the cotangents by pp. The shared leaves' gradients (stage 0's
gather, the last stage's head: for a tied table both land on
``embed.tokens``) are summed over pp before the update, so every stage
applies the same update to its copy.

pp composed with tp and fsdp (dp on top; the JAX package's GSPMD stages,
manual over pp only): a rank holds its stage row cut again along each
leaf's tp dim at its tp coordinate (``stage_tp_dims``; the shared leaves
are tp boxes when tp divides the vocab, else whole), and under fsdp
ZeRO's 1/fsdp shard of that box (``stage_state``). The ``pp`` group of
a rank is the run of stages at its own (dp, fsdp, tp) coordinate, so tp
rank t of stage s hops with tp rank t of stage s+1, each sending its
whole copy of the (tp-replicated) activations; the blocks, the
embedding and the head run their tp collectives over the stage's ``tp``
group inside a tick, between the tick boundaries' hops. Under fsdp a
unit (``stage_units``: the blocks, the embedding, the head) is gathered
over fsdp just before it runs and freed after: before each chunk
forward and before each backward's recompute (GPipe's backward through
``models/train._GatheredUnit``, which under remat recomputes the stage
as 1F1B does). A microbatch's rows split over the data axes that divide
it (``pipeline_rows``, the JAX ``_microbatch_axes`` rule).

The sync: without a plan, the mean over the data axes, each tp box on
its own: one all-reduce of the whole gradient list over dp, or under
fsdp one reduce-scatter over fsdp a sync unit (the stage leaves, the
shared leaves) into the rank's ZeRO shards and an all-reduce over dp;
with a ``PPSyncPlan`` (pp x dp with ``comm_overlap``), once the drain
ends, the stage plan's buckets over the rank's stage leaves and the
shared plan's over the shared leaves, each bucket a reduce-scatter and
an all-gather over dp. A pp x tp or pp x fsdp mesh gets no plan (the
JAX gate's verdict); ``comm_overlap`` there logs the fallback.
``grad_norm`` is ``sqrt`` of the squares summed over pp, tp and fsdp,
each leaf counted once over the axes that hold it whole (a tp-whole
leaf from tp coordinate 0, a shared leaf from stage 0).

Transport: on NCCL the hops go device to device; over gloo (two ranks
sharing one card) a hop of CUDA tensors is staged through pinned host
buffers, as the ring's (gloo's send does not take a device pointer).
The hops' count and host ms are in ``comm``.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common import cuda_sync
from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.parallel.sharding_rules import ShardingRules, default_lm_rules

STAGE_AXES = ("stage", "layer_stack")  # leading axes of stacked stage params
SCHEDULES = ("gpipe", "1f1b", "interleaved")
_PARTS = ("attn_norm", "mlp_norm", "attn", "mlp")

# the hops sent (one a tensor), those staged through host buffers, the
# host ms spent posting and waiting for them, and with ``time_slots`` set
# the ms of the ticks that ran a slot, each ended by a synchronize of the
# card (read by chip_smoke.py's pp phase: the exposed pp communication a
# step, and the busy share against the clock's bubble)
comm = {"hops": 0, "staged": 0, "ms": 0.0, "busy_ms": 0.0, "time_slots": False}


def reset_comm() -> None:
    comm.update(hops=0, staged=0, ms=0.0, busy_ms=0.0)


def pipeline_rules(rules: Optional[ShardingRules] = None) -> ShardingRules:
    """Extend the LM rule table with the stage axes: "stage" -> pp mesh
    axis, the intra-stage layer-stack axis replicated."""
    rules = rules or default_lm_rules()
    merged = dict(rules.rules)
    merged.setdefault("stage", "pp")
    merged.setdefault("chunk", None)  # virtual stages: per-device slots
    merged.setdefault("layer_stack", None)
    return ShardingRules(rules=merged)


def _check_pipeline_cfg(cfg: TransformerConfig, pp: int, virtual: int = 1) -> None:
    if cfg.num_experts:
        raise ValueError(
            "pipeline parallelism requires homogeneous blocks (MoE layers "
            "interleave a different tree structure); use ep without pp"
        )
    if cfg.scan_layers:
        raise ValueError(
            "pipeline parallelism has its own stage-stacked layout; set "
            "scan_layers=False (stages already scan their layer block)"
        )
    stages = pp * virtual
    if cfg.num_layers % stages != 0:
        what = (
            f"pp={pp} x virtual={virtual} = {stages} chunks"
            if virtual > 1
            else f"pp={pp} stages"
        )
        raise ValueError(
            f"num_layers={cfg.num_layers} must divide into {what}"
        )


# ---------------------------------------------------------------------------
# the stacked layout (numpy or torch leaves)
# ---------------------------------------------------------------------------
def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(xs):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def stack_pipeline_params(params: Dict[str, Any], pp: int, virtual: int = 1) -> Dict[str, Any]:
    """{"embed","final_norm",("lm_head"),"layers":[L dicts]} -> the same
    dict with "layers" replaced by "stages": leaves ``[pp, L/pp, ...]``
    (device d owns the contiguous layer block d), or with ``virtual=v >
    1`` ``[pp, v, L/(v pp), ...]`` (global stage ``s = q pp + d`` at
    ``[d, q]``)."""
    layers = params["layers"]
    lc = len(layers) // (pp * virtual)

    def stacked(*xs):
        x = _stack(xs)
        if virtual > 1:
            return x.reshape((virtual, pp, lc) + tuple(xs[0].shape)).swapaxes(0, 1)
        return x.reshape((pp, lc) + tuple(xs[0].shape))

    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = _map(stacked, *layers)
    return out


def _dechunk_leaf(x, virtual: int):
    """One stacked-stage leaf back to global layer order ``[L, ...]``:
    ``[pp, lc, ...]`` or chunk-major ``[pp, v, lc, ...]``."""
    if virtual > 1:
        x = x.swapaxes(0, 1)
    return x.reshape((-1,) + tuple(x.shape[2 + (virtual > 1):]))


def unstack_pipeline_params(pparams: Dict[str, Any], cfg: TransformerConfig,
                            virtual: int = 1) -> Dict[str, Any]:
    """Inverse of ``stack_pipeline_params``."""
    flat = _map(lambda x: _dechunk_leaf(x, virtual), pparams["stages"])
    out = {k: v for k, v in pparams.items() if k != "stages"}
    out["layers"] = [_map(lambda x: x[i], flat) for i in range(cfg.num_layers)]
    return out


def pipeline_logical_axes(cfg: TransformerConfig, pp: int, virtual: int = 1) -> Dict[str, Any]:
    """Logical-axis tree congruent with ``stack_pipeline_params``'s
    output: the per-layer axes prefixed with the (stage[, chunk],
    layer_stack) axes."""
    from dlrover_tpu_torch.models.transformer import logical_axes

    axes = logical_axes(cfg)
    prefix = ("stage", "chunk", "layer_stack") if virtual > 1 else STAGE_AXES
    out = {k: v for k, v in axes.items() if k != "layers"}
    out["stages"] = _map(lambda t: prefix + t, axes["layers"][0])
    return out


def stage_layers(cfg: TransformerConfig, pp: int, stage: int, virtual: int = 1) -> List[List[int]]:
    """The global layer indices of each chunk of ``stage`` (chunk ``q`` is
    global stage ``q pp + stage``)."""
    lc = cfg.num_layers // (pp * virtual)
    return [list(range((q * pp + stage) * lc, (q * pp + stage + 1) * lc)) for q in range(virtual)]


def stage_dims(cfg: TransformerConfig) -> Dict[str, Optional[int]]:
    """Each ``PipelineStage`` parameter's split dim over pp by name: 0 for
    a stage-stacked leaf (the rank's row), None for a shared leaf every
    stage holds whole."""
    with torch.device("meta"):
        names = [n for n, _ in PipelineStage(cfg, 1, 0).named_parameters()]
    return {n: 0 if n.startswith("stages.") else None for n in names}


def stage_tp_dims(cfg: TransformerConfig, tp: int, virtual: int = 1) -> Dict[str, Optional[int]]:
    """Each ``PipelineStage`` parameter's split dim over tp by name, None
    for a leaf every tp rank holds whole: a stage leaf's is its layer
    leaf's tp dim after the stacked layout's leading (stage[, chunk],
    layer_stack) axes (``pipeline_logical_axes``), a shared leaf's its
    own (the embedding's rows and the head's columns when tp divides
    the vocab, ``sharding_rules.tp_dims``)."""
    from dlrover_tpu_torch.parallel.sharding_rules import list_layout, tp_dims

    dims = tp_dims(list_layout(cfg), tp) if tp > 1 else {}
    lead = len(STAGE_AXES) + (virtual > 1)
    out: Dict[str, Optional[int]] = {}
    for n in stage_dims(cfg):
        if n.startswith("stages."):
            d = dims.get("layers.0." + n[len("stages."):])
            out[n] = None if d is None else d + lead
        else:
            out[n] = dims.get(n)
    return out


def _microbatch_axes(axis_sizes: Dict[str, int], mb: int) -> Tuple[str, ...]:
    """The data axes a microbatch of ``mb`` rows is split over (the JAX
    package's rule): the axes of ("dp", "fsdp"), in order, whose running
    product of degrees divides ``mb``. The ranks that differ only on an
    axis left out read the same rows."""
    axes, n = [], 1
    for ax in ("dp", "fsdp"):
        sz = int(axis_sizes.get(ax, 1))
        if sz > 1 and mb % (n * sz) == 0:
            axes.append(ax)
            n *= sz
    return tuple(axes)


def pipeline_rows(mesh, global_rows: int, microbatches: int) -> np.ndarray:
    """This rank's rows of a global batch, in order: of each of the
    ``microbatches``, its block over the data axes ``_microbatch_axes``
    picks (``mesh.batch_sharding``). Every stage and every tp rank of a
    data coordinate reads the same rows; the mean over the data axes of
    the ranks' means is the batch mean, duplicated rows or not."""
    from dlrover_tpu_torch.parallel.mesh import batch_sharding

    if global_rows % microbatches:
        raise ValueError(f"batch {global_rows} must divide into {microbatches} microbatches")
    axes = _microbatch_axes(mesh.config.axis_sizes(), global_rows // microbatches)
    return batch_sharding(mesh, global_rows, microbatches, axes)


def schedule_occupancy(pp: int, M: int, virtual: int = 1):
    """Pure-Python occupancy model of the (interleaved) 1F1B tick clock
    (the JAX package's, copied): ``(n_ticks, busy_slots, total_slots)``,
    each device 2 slots a tick (a forward and a backward), a slot busy
    when it lands on a real (microbatch, chunk) pair. Bubble fraction =
    1 - busy/total = (v+1)(P-1)/(vM + (v+1)(P-1))."""
    v = virtual
    # v>1: microbatches enter in lane groups of P; a partial last group
    # still takes a full group's ticks (its empty lanes are bubbles)
    m_pad = M if v == 1 else -(-M // pp) * pp
    n_ticks = v * m_pad + (v + 1) * pp - 2
    busy = 0
    for d in range(pp):
        for t in range(n_ticks):
            u = t - d
            if u >= 0:
                i, r = u % pp, u // pp
                if (r // v) * pp + i < M:
                    busy += 1
            wb = t + d - 2 * (pp - 1)
            if wb >= 0:
                i, r = wb % pp, wb // pp
                q = (2 * v - 2 - r) % v
                g = (r - (2 * v - 2 - q)) // v
                if g >= 0 and g * pp + i < M:
                    busy += 1
    return n_ticks, busy, 2 * pp * n_ticks


# ---------------------------------------------------------------------------
# a stage rank's parameters
# ---------------------------------------------------------------------------
class _StageStack(nn.Module):
    """The rank's stage-stacked leaves, under the JAX ``stages`` tree's
    names (``attn.wq``)."""

    def __init__(self, parts: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for part, leaves in parts.items():
            setattr(self, part, nn.ParameterDict({k: nn.Parameter(v) for k, v in leaves.items()}))


class PipelineStage(nn.Module):
    """One pp rank's parameters: the shared leaves and its row of the
    stage-stacked ones (the module docstring's layout). With a ``mesh``
    of tp > 1 (a ``parallel/mesh.Mesh``, or a ``MeshConfig`` for tp
    coordinate 0's shapes) each leaf is that row's tp box
    (``stage_tp_dims``). With a ``generator`` the weights are those of
    ``models/transformer.Transformer`` from the same generator: every
    leaf is drawn whole in its order (on the generator's device), the
    stage's own layers kept, cut to the tp box and stacked, the others
    dropped; without one, norm scales 1 and every other leaf 0 (a tree a
    restore or ``params_from_jax`` fills)."""

    def __init__(self, cfg: TransformerConfig, pp: int, stage: int, virtual: int = 1,
                 generator: Optional[torch.Generator] = None, device=None, mesh=None):
        super().__init__()
        from dlrover_tpu_torch.models.transformer import _Layer, leaf_maker, shared_leaves

        _check_pipeline_cfg(cfg, pp, virtual)
        self.cfg, self.pp, self.stage, self.virtual = cfg, pp, stage, virtual
        self.embed, self.final_norm, head = shared_leaves(
            cfg, leaf_maker(cfg, generator, device, mesh))
        if head is not None:
            self.lm_head = head
        # the blocks are drawn where the generator draws (each a copy of
        # its tp box) and stacked there
        draw = leaf_maker(cfg, generator, mesh=mesh)
        chunks = stage_layers(cfg, pp, stage, virtual)
        mine = {i: (q, k) for q, ids in enumerate(chunks) for k, i in enumerate(ids)}
        lc = len(chunks[0])
        kept: List[List[Any]] = [[None] * lc for _ in range(virtual)]
        for i in range(cfg.num_layers):
            layer = _Layer(cfg, draw, f"layers.{i}.", i)
            if i in mine:
                q, k = mine[i]
                kept[q][k] = layer
        parts, whole = {}, {}
        for part in _PARTS:
            parts[part] = {}
            for key in getattr(kept[0][0], part):
                rows = [torch.stack([getattr(l, part)[key].detach() for l in chunk])
                        for chunk in kept]
                leaf = rows[0] if virtual == 1 else torch.stack(rows)
                parts[part][key] = leaf.unsqueeze(0).to(device)
                first = getattr(kept[0][0], part)[key]
                whole[(part, key)] = (first.numel(), getattr(first, "leaf_numel", first.numel()))
        self.stages = _StageStack(parts)
        for part in _PARTS:
            for key, p in getattr(self.stages, part).items():
                # the whole JAX leaf is [pp, ...] of whole layer leaves:
                # the 8-bit AdamW decides quantization on its size
                box, layer_numel = whole[(part, key)]
                p.leaf_numel = pp * (p.numel() // box) * layer_numel

    def jax_ordered_parameters(self):
        """Parameters in the JAX package's flatten order of the stacked
        tree (``embed``, ``final_norm``, ``lm_head``, ``stages``; keys
        sorted)."""
        from dlrover_tpu_torch.parallel.sharding_rules import jax_order

        named = dict(self.named_parameters())
        return [named[n] for n in jax_order(named)]

    def shared_parameters(self) -> List[nn.Parameter]:
        """The leaves every stage holds whole, in the JAX order."""
        stage_ids = {id(p) for p in self.stages.parameters()}
        return [p for p in self.jax_ordered_parameters() if id(p) not in stage_ids]

    def stage_parameters(self) -> List[nn.Parameter]:
        """The rank's stage-stacked leaves, in the JAX order."""
        stage_ids = {id(p) for p in self.stages.parameters()}
        return [p for p in self.jax_ordered_parameters() if id(p) in stage_ids]

    def chunk_views(self, q: int) -> list:
        """Chunk ``q``'s blocks as per-layer views (the attributes
        ``models/transformer._Layer`` has), made anew on each call: each
        microbatch's graph reaches the stacked parameters through views
        of its own."""
        unbound = {
            part: {k: (p[0] if self.virtual == 1 else p[0, q]).unbind(0)
                   for k, p in getattr(self.stages, part).items()}
            for part in _PARTS
        }
        n = len(next(iter(unbound["attn"].values())))
        return [SimpleNamespace(**{part: {k: v[i] for k, v in d.items()}
                                   for part, d in unbound.items()})
                for i in range(n)]


def stage_units(stage: PipelineStage) -> Dict[str, List[nn.Parameter]]:
    """The parameters each unit of a stage reads, by key: ZeRO gathers
    a unit over fsdp just before it runs and frees it after
    (``models/train.ZeroUnits``): ``"embed"`` (stage 0's gather),
    ``"blocks"`` (the stage's stacked leaves, every chunk of them) and
    ``"head"`` (the final norm and the head, the tied table under
    tying; the last stage's)."""
    head = list(stage.final_norm.values())
    head.append(stage.embed["tokens"] if stage.cfg.tie_embeddings else stage.lm_head)
    return {"embed": list(stage.embed.values()), "blocks": list(stage.stages.parameters()),
            "head": head}


def pipeline_leaves(cfg: TransformerConfig, pp: int, virtual: int = 1,
                    mesh=None) -> Tuple[list, list]:
    """``(stage leaves, shared leaves)`` of a stage rank on the meta device,
    each in the JAX order: the stage leaves at the JAX plan's stage-local
    shapes (``[L/pp, ...]`` or ``[v, L/(pp v), ...]``); with a ``mesh``
    (``MeshConfig``) of tp > 1 tp coordinate 0's boxes."""
    with torch.device("meta"):
        st = PipelineStage(cfg, pp, 0, virtual, mesh=mesh)
        return ([p[0] for p in st.stage_parameters()], st.shared_parameters())


def stage_state(stage: PipelineStage, tx: Callable, mesh):
    """The port's ``TrainState`` of a stage: the optimizer bound to its
    parameters in the JAX order, or on a mesh with fsdp > 1 to this
    rank's ZeRO shards of them (``TrainState.shards``; the module's
    params then hold no storage between the units' gathers,
    ``stage_units``)."""
    from dlrover_tpu_torch.models.train import (
        TrainState, ZeroUnits, free_params, leaf_shards, zero_layout,
    )

    leaves = stage.jax_ordered_parameters()
    fsdp = mesh.config.fsdp if mesh is not None else 1
    if fsdp == 1:
        return TrainState(step=0, params=stage, opt_state=tx(leaves))
    plan = zero_layout(leaves, fsdp)
    shards = leaf_shards(leaves, mesh, plan)
    state = TrainState(step=0, params=stage, opt_state=tx(shards), shards=shards)
    state.units = ZeroUnits(state, mesh, plan, stage_units(stage))
    free_params(state)
    return state


def init_pipeline_state(cfg: TransformerConfig, tx: Callable, mesh, virtual: int = 1,
                        seed: int = 0, devices=None, generator: Optional[torch.Generator] = None):
    """The rank's stage (``PipelineStage`` at ``mesh.stage``, its tp boxes
    under tp) from ``torch.Generator().manual_seed(seed)`` (or
    ``generator``), on the device (the card unless ``devices="cpu"``),
    and the optimizer bound to its parameters in the JAX order, or under
    fsdp to their ZeRO shards (``stage_state``): the port's
    ``TrainState``."""
    from dlrover_tpu_torch.utils.device import resolve_device

    device = resolve_device(devices)
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    stage = PipelineStage(cfg, mesh.config.pp, mesh.stage, virtual, gen, device, mesh=mesh)
    return stage_state(stage, tx, mesh)


# ---------------------------------------------------------------------------
# the tick clock
# ---------------------------------------------------------------------------
def _slots(schedule: str, P: int, M: int, v: int):
    """``(n_ticks, fwd, bwd)``: ``fwd(d, t)`` / ``bwd(d, t)`` the
    ``(microbatch, chunk)`` device ``d`` runs forward / backward at tick
    ``t``, or None. Every hop lands one tick later: a chunk's output on
    the next device (chunk ``q`` of device ``P-1`` to chunk ``q+1`` of
    device 0), a cotangent on the previous one."""
    if schedule == "gpipe":
        span = M + P - 1

        def fwd(d, t):
            j = t - d
            return (j, 0) if t < span and 0 <= j < M else None

        def bwd(d, t):
            j = M - 1 - (t - span - (P - 1 - d))
            return (j, 0) if t >= span and 0 <= j < M else None

        return 2 * span, fwd, bwd
    # (interleaved) 1F1B: forward of (group g, lane i, chunk q) on device
    # d at tick g vP + q P + i + d, its backward (2v-2-2q) P + 2(P-1-d)
    # ticks later (the JAX docstring's algebra)
    m_pad = M if v == 1 else -(-M // P) * P
    n_ticks = v * m_pad + (v + 1) * P - 2

    def fwd(d, t):
        u = t - d
        if u < 0:
            return None
        i, r = u % P, u // P
        j = (r // v) * P + i
        return (j, r % v) if j < M else None

    def bwd(d, t):
        wb = t + d - 2 * (P - 1)
        if wb < 0:
            return None
        i, r = wb % P, wb // P
        q = (2 * v - 2 - r) % v
        g = (r - (2 * v - 2 - q)) // v
        j = g * P + i
        return (j, q) if g >= 0 and j < M else None

    return n_ticks, fwd, bwd


_ACT, _GRAD = 1, 2  # the hops' tags: two may join one pair of ranks a tick


class _Link:
    """This rank's place on the pp ring: the group, the global ranks of
    the next and the previous stage."""

    def __init__(self, mesh):
        ranks = mesh.ranks["pp"]
        i = ranks.index(mesh.rank)
        self.group = mesh.groups["pp"]
        self.nxt, self.prv = ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
                 recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, torch.device, int, int]]):
        """Post one tick boundary's hops and wait for them: ``sends``
        ``(tensor, peer, tag)``, ``recvs`` ``(shape, dtype, device, peer,
        tag)``; returns the received tensors in ``recvs``' order. Every
        rank posts all of its boundary's hops before waiting for any, and
        a hop's pair is posted at the same boundary on both ranks, so no
        order of arrival can deadlock. Over gloo CUDA tensors go through
        pinned host buffers."""
        import torch.distributed as dist

        if not sends and not recvs:
            return []
        t0 = time.perf_counter()
        dev = (sends[0][0].device if sends else recvs[0][2])
        staged = dev.type == "cuda" and dist.get_backend(self.group) == "gloo"
        if staged:
            # the card finishes what was queued before the copies
            torch.cuda.current_stream().synchronize()
            outs = []
            for t, _, _ in sends:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                outs.append(h)
            torch.cuda.current_stream().synchronize()
            inbs = [torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt, _, _, _ in recvs]
            comm["staged"] += len(sends)
        else:
            outs = [t.contiguous() for t, _, _ in sends]
            inbs = [torch.empty(shape, dtype=dt, device=d) for shape, dt, d, _, _ in recvs]
        ops = [dist.P2POp(dist.isend, o, peer, self.group, tag)
               for o, (_, peer, tag) in zip(outs, sends)]
        ops += [dist.P2POp(dist.irecv, b, peer, self.group, tag)
                for b, (_, _, _, peer, tag) in zip(inbs, recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            inbs = [b.to(d, non_blocking=True) for b, (_, _, d, _, _) in zip(inbs, recvs)]
        comm["hops"] += len(sends)
        comm["ms"] += (time.perf_counter() - t0) * 1e3
        return inbs


def _blocks(stage: PipelineStage, q: int, x, positions, remat: bool, mesh=None):
    """Chunk ``q``'s blocks on ``x``; ``remat``: each block under the
    non-reentrant checkpoint (``models/transformer.forward``'s); under
    tp (``mesh``) each block's collectives run over the stage's tp
    group."""
    from dlrover_tpu_torch.models.transformer import _attention_block, _mlp_block

    cfg = stage.cfg

    def block(x, layer):
        return _mlp_block(_attention_block(x, layer, cfg, positions, mesh), layer, cfg, mesh)

    for layer in stage.chunk_views(q):
        x = checkpoint(block, x, layer, use_reentrant=False) if remat else block(x, layer)
    return x


@contextlib.contextmanager
def _gathered(units, key: str):
    """Unit ``key``'s params in place while the body runs (ZeRO's
    per-unit gather over fsdp, freed after), or nothing without
    ``units``."""
    if units is None:
        yield
        return
    units.gather(key)
    try:
        yield
    finally:
        units.free(key)


def _add_grad(p: nn.Parameter, g: torch.Tensor) -> None:
    if p.grad is None:
        p.grad = torch.zeros_like(p)
    p.grad.add_(g.to(p.grad.dtype))


def _embed_backward(stage: PipelineStage, tok: torch.Tensor, dx: torch.Tensor,
                    split=None) -> None:
    """The embedding gather's backward: ``dx``'s rows scatter-added (f32)
    into the table's gradient at their token ids, and summed over the
    rows into the learned positions' (the JAX 1F1B's scatter-add). Under
    a vocab split over tp (``split``: ``transformer.vocab_split``) only
    the rows of this rank's block of the vocab, at their local ids."""
    D = dx.shape[-1]
    contrib = dx.float()
    table = stage.embed["tokens"]
    if table.grad is None:
        table.grad = torch.zeros_like(table)
    ids, rows = tok.reshape(-1), contrib.reshape(-1, D)
    if split is not None:
        local = ids - split[0]
        inside = (local >= 0) & (local < table.shape[0])
        ids, rows = local[inside], rows[inside]
    table.grad.index_add_(0, ids, rows.to(table.grad.dtype))
    if "positions" in stage.embed:
        pos = torch.zeros_like(stage.embed["positions"])
        pos[:dx.shape[1]] = contrib.sum(0)
        _add_grad(stage.embed["positions"], pos)


def run_schedule(stage: PipelineStage, mesh, tokens: Sequence[torch.Tensor],
                 targets: Sequence[torch.Tensor], schedule: str, train: bool = True,
                 units=None) -> torch.Tensor:
    """Run ``schedule`` over the microbatches ``tokens`` / ``targets``
    (this rank's rows of each, in order) on every stage rank of the pp
    group together; returns the last stage's sum of the microbatches'
    mean NLL over M (its loss; zeros on the other stages). ``train``:
    the backward slots run and the gradients accumulate into the
    parameters' ``.grad``; otherwise only the forward slots, without
    autograd (the eval path). Under tp the blocks, the embedding and the
    head run their collectives over the stage's tp group; ``units``
    (``models/train.ZeroUnits`` over ``stage_units``, under fsdp)
    gathers each unit before it runs and frees it after: the blocks
    before each chunk forward and before each backward's recompute
    (GPipe's backward through ``_GatheredUnit``), the embedding and the
    head where they run."""
    from dlrover_tpu_torch.models.transformer import embed_tokens, lm_head, token_nll, vocab_split

    cfg = stage.cfg
    P, v, d = stage.pp, stage.virtual, stage.stage
    M = len(tokens)
    n_ticks, fwd, bwd = _slots(schedule, P, M, v)
    if not train:
        bwd = lambda d_, t_: None  # noqa: E731
    link = _Link(mesh)
    rows, T = tokens[0].shape
    act_dt = getattr(torch, cfg.dtype)
    dev = tokens[0].device
    shape = (rows, T, cfg.model_dim)
    positions = torch.arange(T, device=dev).expand(rows, T)
    last = (P - 1, v - 1)
    gpipe = schedule == "gpipe"
    split = vocab_split(cfg, mesh)

    loss = torch.zeros((), dtype=torch.float32, device=dev)
    saved: Dict[Tuple[int, int], Any] = {}
    dy_head: Dict[int, torch.Tensor] = {}
    act = gin = None
    for t in range(n_ticks):
        f, b = fwd(d, t), bwd(d, t)
        out_act = out_grad = None
        t_tick = time.perf_counter()
        if f is not None:
            j, q = f
            if (d, q) == (0, 0):
                with torch.no_grad(), _gathered(units, "embed"):
                    x = embed_tokens(stage, tokens[j], cfg, mesh=mesh).to(act_dt)
            else:
                x = act
            if gpipe and train:
                xi = x.detach().requires_grad_()
                with torch.enable_grad():
                    if units is None:
                        y = _blocks(stage, q, xi, positions, cfg.remat, mesh)
                    else:
                        # the unit's own recompute is the remat (at
                        # stage granularity, as 1F1B's)
                        y = units("blocks", lambda x_, q=q: _blocks(stage, q, x_, positions,
                                                                     False, mesh),
                                  xi, cfg.remat)
                saved[(j, q)] = (xi, y)
            else:
                with torch.no_grad(), _gathered(units, "blocks"):
                    y = _blocks(stage, q, x, positions, False, mesh)
                if train:
                    saved[(j, q)] = x
            if (d, q) == last:
                yl = y.detach().requires_grad_(train)
                with _gathered(units, "head"), torch.set_grad_enabled(train):
                    mb_loss = token_nll(lm_head(stage, yl, cfg, mesh), targets[j],
                                        split=split) / M
                    if train:
                        mb_loss.backward()
                if train:
                    dy_head[j] = yl.grad.to(act_dt)
                loss = loss + mb_loss.detach()
            else:
                out_act = y.detach()
        if b is not None:
            j, q = b
            dy = dy_head.pop(j) if (d, q) == last else gin
            if gpipe:
                xi, y = saved.pop((j, q))
                torch.autograd.backward(y, dy)
            else:
                xi = saved.pop((j, q)).detach().requires_grad_()
                with _gathered(units, "blocks"):
                    with torch.enable_grad():
                        # remat at stage granularity: the recompute runs
                        # the blocks plainly
                        y = _blocks(stage, q, xi, positions, False, mesh)
                    torch.autograd.backward(y, dy)
            del y
            if (d, q) == (0, 0):
                _embed_backward(stage, tokens[j], xi.grad, split)
            else:
                out_grad = xi.grad.to(act_dt)
        if comm["time_slots"] and (f is not None or b is not None):
            if dev.type == "cuda":
                cuda_sync.synchronize(dev)
            comm["busy_ms"] += (time.perf_counter() - t_tick) * 1e3
        sends = []
        if out_act is not None:
            sends.append((out_act, link.nxt, _ACT))
        if out_grad is not None:
            sends.append((out_grad, link.prv, _GRAD))
        recvs = []
        f2, b2 = fwd(d, t + 1), bwd(d, t + 1)
        if f2 is not None and (d, f2[1]) != (0, 0):
            recvs.append((shape, act_dt, dev, link.prv, _ACT))
        if b2 is not None and (d, b2[1]) != last:
            recvs.append((shape, act_dt, dev, link.nxt, _GRAD))
        got = link.exchange(sends, recvs)
        act = got.pop(0) if f2 is not None and (d, f2[1]) != (0, 0) else None
        gin = got.pop(0) if b2 is not None and (d, b2[1]) != last else None
    if saved or dy_head:
        raise RuntimeError(f"pipeline schedule {schedule!r} left microbatches unfinished")
    return loss


def _reduce_(t: torch.Tensor, group, div: int = 1) -> torch.Tensor:
    """``t`` (f32, the caller's own) summed over ``group`` in place and
    divided by ``div``."""
    from dlrover_tpu_torch.parallel.grad_sync import _all_reduce

    if group is not None:
        _all_reduce(t, group).wait()
    return t.div_(div) if div > 1 else t


def _take_flat(params: Sequence[nn.Parameter]) -> torch.Tensor:
    """The params' grads (zeros where a param took none) as one f32
    vector; each grad is released once copied."""
    parts = []
    for p in params:
        parts.append((p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float())
        p.grad = None
    flat = torch.cat(parts)
    del parts
    return flat


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, off = [], 0
    for g in like:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out


def build_pipeline_train_step(
    cfg: TransformerConfig, tx: Callable = None, mesh=None, num_microbatches: int = 1,
    schedule: str = "gpipe", virtual_stages: int = 2, plan=None,
    before_update: Optional[Callable[[], None]] = None, comm_overlap: bool = False,
):
    """``(state, tokens, targets) -> (state, {"loss", "grad_norm"})`` over
    pp, updating ``state`` in place (params, optimizer, step count), as
    ``models/train.build_train_step`` does. ``tokens`` / ``targets`` are
    this rank's rows of the global batch (``pipeline_rows``: its rows of
    each microbatch, in order); every stage and tp rank of a data
    coordinate passes the same rows. ``schedule``: "gpipe", "1f1b" or
    "interleaved" (with ``virtual_stages`` chunks a device; the state
    from ``init_pipeline_state(..., virtual=v)``). ``plan``: a
    ``grad_sync.PPSyncPlan`` (pp x dp with ``comm_overlap``), else the
    default sync: the mean over the data axes, over fsdp by the
    reduce-scatter of each sync unit (the stage leaves, the shared
    leaves) into the ZeRO shards, each tp box on its own.
    ``comm_overlap`` without a plan (pp composed with tp or fsdp) logs
    the fallback once (``grad_sync.note_gspmd_fallback``), as the JAX
    step does. ``tx`` is accepted for the JAX signature; the step uses
    the optimizer bound in ``state.opt_state``. ``before_update()`` runs
    after the gradients are final and before the optimizer writes
    anything."""
    from dlrover_tpu_torch.models.train import zero_scatter
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.parallel.grad_sync import PPSyncPlan, sync_grads

    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    virtual = virtual_stages if schedule == "interleaved" else 1
    if schedule == "interleaved" and virtual < 2:
        raise ValueError("interleaved schedule needs virtual_stages >= 2")
    m = mesh.config
    pp, tp, n_data = m.pp, m.tp, m.dp * m.fsdp
    _check_pipeline_cfg(cfg, pp, virtual)
    if plan is not None and not isinstance(plan, PPSyncPlan):
        raise ValueError(f"a pipeline step syncs through a PPSyncPlan, not {type(plan).__name__}")
    if comm_overlap and plan is None:
        sizes = mesh.axis_sizes()
        grad_sync.note_gspmd_fallback(sizes, reason=grad_sync.fallback_reason(sizes) or (
            f"num_layers={cfg.num_layers} does not divide into pp={pp} x virtual={virtual} "
            f"stages (or the model cannot pipeline at all)"))
    M = num_microbatches
    pp_group, data_group = mesh.groups["pp"], mesh.groups["data"]
    tp_group, fsdp_group = mesh.groups["tp"], mesh.groups["fsdp"]
    tp_coord, stage_coord = mesh.coords.get("tp", 0), mesh.stage
    tp_dims = stage_tp_dims(cfg, tp, virtual)
    primed = []

    def train_step(state, tokens, targets):
        stage = state.params
        if stage.virtual != virtual or stage.pp != pp:
            raise ValueError(
                f"the state is laid out for pp={stage.pp} x virtual={stage.virtual}; "
                f"the {schedule} step needs pp={pp} x virtual={virtual}"
            )
        if tokens.shape[0] % M:
            raise ValueError(f"batch {tokens.shape[0]} must divide into {M} microbatches")
        if not primed and pp_group is not None:
            # every rank of the group takes part in its first call (NCCL's
            # rule for point-to-point batches)
            _reduce_(torch.zeros(1, device=tokens.device), pp_group)
            primed.append(True)
        params = stage.jax_ordered_parameters()
        for p in params:
            p.grad = None
        units = state.units
        loss = run_schedule(stage, mesh, tokens.chunk(M), targets.chunk(M), schedule,
                            units=units)
        stage_ps, shared_ps = stage.stage_parameters(), stage.shared_parameters()
        # the shared leaves' grads: stage 0's gather, the last stage's
        # head, zeros elsewhere: their pp sum (per tp coordinate) is
        # every stage's update
        shared = _split(_reduce_(_take_flat(shared_ps), pp_group), shared_ps)
        targets_st, targets_sh = stage_ps, shared_ps
        ss_sh = None
        if plan is not None:
            # each grad is released as its bucket is flattened
            local = []
            for p in stage_ps:
                local.append((p.grad if p.grad is not None else torch.zeros_like(p))[0].float())
                p.grad = None
            local, _, gn_st = sync_grads(local, mesh, plan.stage_plan, consume=True)
            shared, _, gn_sh = sync_grads(shared, mesh, plan.shared_plan, consume=True)
            ss_own, ss_sh = gn_st.square(), gn_sh.square()
        else:
            if units is not None:
                index = {id(p): i for i, p in enumerate(params)}
                ids_st = [index[id(p)] for p in stage_ps]
                ids_sh = [index[id(p)] for p in shared_ps]
                local = []
                for p in stage_ps:
                    local.append(p.grad if p.grad is not None else torch.zeros_like(p))
                    p.grad = None
                local = zero_scatter(local, ids_st, units, mesh, n_data)
                shared = zero_scatter(shared, ids_sh, units, mesh, n_data)
                targets_st = [state.shards[i] for i in ids_st]
                targets_sh = [state.shards[i] for i in ids_sh]
            else:
                local = _split(_reduce_(_take_flat(stage_ps), data_group, n_data), stage_ps)
                if data_group is not None:
                    shared = _split(_reduce_(torch.cat([g.reshape(-1) for g in shared]),
                                             data_group, n_data), shared_ps)
            # each leaf's squares once over the axes that hold it whole:
            # a tp-whole leaf from tp coordinate 0, a shared leaf from
            # stage 0 (the ZeRO shards partition their leaves)
            names = {id(p): n for n, p in stage.named_parameters()}
            ss_own = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for ps, gs in ((stage_ps, local), (shared_ps, shared)):
                for p, g in zip(ps, gs):
                    if tp_coord and tp_dims[names[id(p)]] is None:
                        continue
                    if stage_coord and ps is shared_ps:
                        continue
                    ss_own = ss_own + torch.linalg.vector_norm(g.float()).square()
        # the loss is the last stage's, the squares each stage's own:
        # summed over pp in one all-reduce, the loss then averaged over
        # the data axes
        vec = _reduce_(torch.stack([loss, ss_own.reshape(())]), pp_group)
        loss = _reduce_(vec[0].clone(), data_group, n_data)
        if ss_sh is not None:
            gnorm = torch.sqrt(vec[1] + ss_sh)
        else:
            ss = vec[1:].clone()
            if tp > 1:
                _reduce_(ss, tp_group)
            if units is not None:
                _reduce_(ss, fsdp_group)
            gnorm = torch.sqrt(ss[0])
        for p, g in zip(list(targets_st) + list(targets_sh), list(local) + list(shared)):
            p.grad = g.reshape(p.shape).to(p.dtype)
        if before_update is not None:
            before_update()
        state.opt_state.step()
        for p in list(params) + list(state.shards or []):
            p.grad = None
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    train_step.plan = plan
    return train_step


@torch.no_grad()
def pipeline_eval_loss(stage: PipelineStage, mesh, tokens: torch.Tensor, targets: torch.Tensor,
                       num_microbatches: int, units=None) -> float:
    """The mean NLL of ``tokens`` -> ``targets`` through the stages (the
    forward slots of the state's schedule, no autograd), the same number
    on every stage rank (the JAX ``pipeline_loss_fn`` of the eval
    path); under tp over each stage's tp group, under fsdp through the
    state's per-unit gather (``units``)."""
    M = num_microbatches
    if tokens.shape[0] % M:
        raise ValueError(f"batch {tokens.shape[0]} must divide into {M} microbatches")
    schedule = "interleaved" if stage.virtual > 1 else "1f1b"
    loss = run_schedule(stage, mesh, tokens.chunk(M), targets.chunk(M), schedule, train=False,
                        units=units)
    return float(_reduce_(loss, mesh.groups["pp"]))
