"""Logical-axis sharding rules and the tensor- and expert-parallel
layouts (the port of ``dlrover_tpu/parallel/sharding_rules.py``).

The rule table is the JAX package's: each parameter carries logical
axis names (``models/transformer.logical_axes``) and ``default_lm_rules``
maps them to mesh axes — "heads", "kv_heads", "mlp" and "vocab" to
``tp``, "embed" to ``fsdp``. On the TPU, GSPMD derives the Megatron
collectives from that table; here the table decides each leaf's
tp-sharded dim (``tp_dims``) and every tp rank holds plain local tensors,
its box of each global leaf (``local_shard``), with the collectives
written out in the model (``models/transformer``: ``copy_to_tp``,
``reduce_from_tp``, the vocab-parallel loss) and ``gather_tp`` to put a
leaf back together. A dim the tp degree does not divide stays whole on
every tp rank, as the JAX sync's ``_localize_axis`` treats it (gpt2's
vocab of 50257 at tp = 2: the embedding table and the head are whole).

Expert parallelism uses the same boxes on the ``ep`` axis: "experts"
maps to ``ep``, so a rank holds experts ``[i E/ep, (i+1) E/ep)`` of each
expert leaf (dim 0 of ``w_up`` / ``w_down``) and every other leaf whole.
Under ep x tp an expert leaf is cut twice: its ``E/ep`` experts, and of
them its block along "expert_mlp", which the rules map to ``tp`` (dim 2
of ``w_up [E, D, F]``, dim 1 of ``w_down [E, F, D]``); the gate stays
whole. Pipeline parallelism's boxes are rows of the stage-stacked
leaves (``parallel/pipeline.stage_dims``): a stage rank holds row
``[s]`` of each ``[pp, L/pp, ...]`` leaf, and under pp x tp that row's
tp box (``splits_of`` lists the axes a mesh cuts its boxes along, in
order).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclass
class ShardingRules:
    """Mapping from logical axis name -> mesh axis (or axes, or None for
    replicated)."""

    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def axes_for(self, logical: Sequence[Optional[str]]) -> Tuple:
        return tuple(self.rules.get(name) if name else None for name in logical)


def default_lm_rules() -> ShardingRules:
    """The Megatron layout: column-parallel outputs ("mlp", "heads",
    "kv_heads") and the vocab on tp, the residual stream's "embed" on
    fsdp, "seq" on sp, "experts" on ep, "batch" on (dp, fsdp)."""
    return ShardingRules(
        rules={
            "batch": ("dp", "fsdp"),
            "seq": "sp",
            "embed": "fsdp",
            "mlp": "tp",
            "heads": "tp",
            "kv_heads": "tp",
            "head_dim": None,
            "vocab": "tp",
            "experts": "ep",
            "expert_mlp": "tp",
            "norm": None,
            "layer_stack": None,
        }
    )


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]], rules: ShardingRules) -> Tuple:
    """One array's mesh axes per dim (the JAX package's ``PartitionSpec``
    entries, as a tuple)."""
    return rules.axes_for(logical_axes)


def check_tp(cfg, tp: int) -> None:
    """Raise when ``tp`` does not divide the heads, the kv heads or the
    MLP width (``accel/candidates._tp_ok``'s rule: the search never
    proposes such a mesh)."""
    for name, n in (("num_heads", cfg.num_heads), ("kv_heads", cfg.kv_heads),
                    ("ffn_dim", cfg.ffn_dim)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {name}={n}")


def _param_axes(cfg) -> Dict[str, tuple]:
    """Each parameter's logical axes by the port's parameter name
    (``layers.0.attn.wq``; ``layers.attn.wq`` under ``scan_layers``)."""
    from dlrover_tpu_torch.models.transformer import logical_axes

    out: Dict[str, tuple] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = node

    walk("", logical_axes(cfg))
    return out


def _global_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    import torch

    from dlrover_tpu_torch.models.transformer import Transformer

    with torch.device("meta"):
        return {n: tuple(p.shape) for n, p in Transformer(cfg).named_parameters()}


def tp_dims(cfg, tp: int, mesh_axis: str = "tp") -> Dict[str, Optional[int]]:
    """Each parameter's ``mesh_axis``-sharded dim by name, or None for a
    leaf every rank of the axis holds whole: the first dim whose logical
    name the rules map to the axis, unless the degree does not divide it
    (the JAX ``_localize_axis`` rule)."""
    rules = default_lm_rules().rules
    shapes = _global_shapes(cfg)
    out: Dict[str, Optional[int]] = {}
    for name, axes in _param_axes(cfg).items():
        dim = next((i for i, a in enumerate(axes) if a and rules.get(a) == mesh_axis), None)
        if dim is not None and shapes[name][dim] % tp:
            dim = None
        out[name] = dim
    return out


# a MoE layer's leaves are the JAX ``MoEParams`` NamedTuple, which
# flattens in field order, not sorted
_MOE_ORDER = {"gate": "0", "w_up": "1", "w_down": "2"}


def _order_key(name: str) -> tuple:
    parts = name.split(".")
    return tuple(
        int(p) if p.isdigit() else
        _MOE_ORDER[p] if i and parts[i - 1] == "moe" and p in _MOE_ORDER else p
        for i, p in enumerate(parts)
    )


def jax_order(names) -> list:
    """Parameter names in the JAX package's pytree flatten order (dict
    keys sorted, layers in order, a MoE layer's ``gate``, ``w_up``,
    ``w_down`` in the ``MoEParams`` field order):
    ``Transformer.jax_ordered_parameters``'s."""
    return sorted(names, key=_order_key)


def leaf_tp_dims(cfg, tp: int, mesh_axis: str = "tp") -> Tuple[Optional[int], ...]:
    """``tp_dims`` in the JAX flatten order (the gradient leaves')."""
    dims = tp_dims(cfg, tp, mesh_axis)
    return tuple(dims[n] for n in jax_order(dims))


def local_shape(shape, dim: Optional[int], tp: int) -> Tuple[int, ...]:
    return tuple(d // tp if i == dim else d for i, d in enumerate(shape))


def tp_box(shape, dim: Optional[int], tp: int, coord: int):
    """The index ``((lo, hi), ...)`` of tp coordinate ``coord``'s box of
    a leaf of global ``shape``."""
    return tuple(
        (coord * d // tp, (coord + 1) * d // tp) if i == dim else (0, d)
        for i, d in enumerate(shape)
    )


def local_shard(full, dim: Optional[int], tp: int, coord: int):
    """Tp coordinate ``coord``'s box of a global leaf (a torch tensor or
    a numpy array; a view): the ``coord``-th of ``tp`` equal blocks along
    ``dim``, the whole leaf when ``dim`` is None."""
    if dim is None or tp == 1:
        return full
    n = full.shape[dim] // tp
    return full[(slice(None),) * dim + (slice(coord * n, (coord + 1) * n),)]


def gather_tp(shard, dim: Optional[int], group):
    """The inverse of ``local_shard`` over the ``tp`` group: every tp
    rank's box, joined along ``dim`` in tp order (one all-gather). The
    group's ranks are consecutive (tp is the innermost mesh axis), so
    group rank order is tp order."""
    if dim is None or group is None:
        return shard
    from dlrover_tpu_torch.parallel.grad_sync import _all_gather

    full, h = _all_gather(shard.detach().contiguous().reshape(-1), group)
    h.wait()
    tp = full.numel() // shard.numel()
    return full.view((tp,) + tuple(shard.shape)).movedim(0, dim).reshape(
        tuple(d * tp if i == dim else d for i, d in enumerate(shard.shape))
    )


def tp_of(mesh) -> Tuple[int, int, object]:
    """(tp degree, this rank's tp coordinate, the tp group) of a
    ``parallel/mesh.Mesh``, a ``MeshConfig`` (coordinate 0, no group) or
    None."""
    if mesh is None:
        return 1, 0, None
    m = getattr(mesh, "config", mesh)
    tp = int(getattr(m, "tp", 1))
    coords = getattr(mesh, "coords", None) or {}
    groups = getattr(mesh, "groups", None) or {}
    return tp, int(coords.get("tp", 0)), groups.get("tp")


def splits_of(mesh) -> List[Tuple[str, int, int, object]]:
    """``(axis, degree, this rank's coordinate, group)`` of every mesh
    axis that splits parameter leaves, in the order a rank's box is cut
    from the whole leaf: ``pp`` first (a stage rank's row of every
    stage-stacked leaf, ``parallel/pipeline``), then ``tp`` (its block
    along the leaf's tp dim), then ``ep`` (its ``E/ep`` experts). The
    cuts compose: a pp x tp rank's box of a stage leaf is its stage row
    cut again along the tp dim, and an ep x tp rank's box of an expert
    leaf is its tp block (along "expert_mlp") cut again along the
    experts (dim 0). Empty on a mesh that splits no leaf."""
    if mesh is None:
        return []
    m = getattr(mesh, "config", mesh)
    coords = getattr(mesh, "coords", None) or {}
    groups = getattr(mesh, "groups", None) or {}
    out = []
    for axis in ("pp", "tp", "ep"):
        n = int(getattr(m, axis, 1))
        if n > 1:
            out.append((axis, n, int(coords.get(axis, 0)), groups.get(axis)))
    return out


def list_layout(cfg):
    """``cfg`` with its layers as a list (the names a model is drawn
    under, layer by layer, in both layouts)."""
    return replace(cfg, scan_layers=False) if cfg.scan_layers else cfg
