"""Weights and train state between the JAX package and the port.

The JAX tree is nested dicts with a list of layer dicts (numpy leaves,
e.g. ``jax.device_get(params)``); the port's parameter names are the
same path joined with dots (``layers.3.attn.wq``). Conversion is leaf
for leaf: shapes must agree exactly and no leaf may be left over.

``train_state_tree`` gives a port ``TrainState`` the JAX package's
``TrainState`` tree (params, the optimizer's state, the step and
schedule counts), which is what a checkpoint of either package holds;
``state_from_jax_checkpoint`` reads a JAX checkpoint into the port.
``load_jax_train_state`` / ``jax_train_state`` carry a whole JAX dp or
dp x fsdp train state to a rank of the port and back: under ZeRO each
rank holds its block rows of every leaf (the per-leaf 8-bit codes and
scales included), and the int8 sync's residual moves between the two
packages' per-bucket layouts element for element.
Under tensor parallelism (a mesh with tp > 1) a rank holds its tp box
of each split leaf (``parallel/sharding_rules``): ``params_from_jax``
cuts the boxes, ``params_to_numpy`` and ``jax_train_state`` gather them
back to whole leaves (the per-leaf 8-bit codes and scales, quantized in
each box's own blocks, come back stacked ``[tp, ...]``), and a rank
stages a split leaf's tensors as their boxes of the whole leaf.
Under pipeline parallelism (pp > 1) a rank holds its
``parallel/pipeline.PipelineStage``: its row ``[s]`` of each JAX
stage-stacked leaf (``[d]`` of ``[pp, v, L/(pp v), ...]`` when
interleaved), the same machinery's boxes along dim 0 over the ``pp``
group, and the shared leaves (embedding, final norm, head) whole, staged
by stage 0 alone. Under pp x tp a rank's box is its stage row cut again
along the leaf's tp dim (the boxes compose, ``_place``: a leaf whole on
an axis is staged by that axis's coordinate 0), and under pp x fsdp its
ZeRO shard of that box is recorded as its run of the box's flatten.
Optimizer state maps form for form: ``Adam8FlatState`` to
``adamw_8bit_flat`` (the same group layout), ``Adam8State`` to
``adamw_8bit`` (its 4-bit form's nibble-packed first moment included),
``AGDState`` to ``ops/optimizers.agd``, optax's Adam to
``torch.optim.AdamW``, optax's momentum trace to ``torch.optim.SGD``'s
buffers. Params and state convert in either layer layout (a list of
layers, or ``scan_layers``'s stacked leaves). The RLHF critic's and
reward model's ``{trunk, head}`` trees convert with
``head_model_from_jax`` / ``head_model_to_numpy``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import Transformer


def _lookup(tree, path):
    node = tree
    for part in path.split("."):
        if isinstance(node, (list, tuple)) and part.isdigit():
            node = node[int(part)]
        elif isinstance(node, dict):
            node = node[part]
        else:  # a NamedTuple node (the JAX ``MoEParams``)
            node = getattr(node, part)
    return node


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def _splits(model, mesh):
    """``[(axis, degree, coordinate, group, each parameter's split dim by
    name)]`` of every axis that splits the mesh's leaves, in the order a
    rank's box is cut (``sharding_rules.splits_of``): pp's rows of the
    stage-stacked leaves, then tp's (or ep's) blocks."""
    from dlrover_tpu_torch.parallel.sharding_rules import splits_of, tp_dims

    out = []
    for axis, n, coord, group in splits_of(mesh):
        if axis == "pp":
            from dlrover_tpu_torch.parallel.pipeline import stage_dims

            dims = stage_dims(model.cfg)
        elif hasattr(model, "stages"):  # a pipeline stage's tp boxes
            from dlrover_tpu_torch.parallel.pipeline import stage_tp_dims

            dims = stage_tp_dims(model.cfg, n, model.virtual)
        else:
            dims = tp_dims(model.cfg, n, axis)
        out.append((axis, n, coord, group, dims))
    return out


def params_from_jax(np_tree: Dict[str, Any], cfg: TransformerConfig, device=None,
                    mesh=None, virtual: int = 1) -> Transformer:
    """The JAX param pytree (numpy leaves; layers as a list, or stacked
    ``[L, ...]`` leaves under ``cfg.scan_layers``) -> the port's
    ``Transformer`` on ``device`` (default the CPU); with a ``mesh`` of
    tp > 1 this rank's tp boxes of the leaves. ``stack_layer_params`` /
    ``unstack_layer_params`` (``models/transformer.py``) move a tree
    between the two layouts. With a ``mesh`` of pp > 1 the tree is the
    JAX pipeline's stacked one (``stages`` leaves ``[pp, L/pp, ...]``, or
    ``[pp, v, L/(pp v), ...]`` with ``virtual=v``) and the result this
    rank's ``parallel/pipeline.PipelineStage``: its row of each stage
    leaf, the shared leaves whole, and under pp x tp the tp box of
    each."""
    from dlrover_tpu_torch.parallel.sharding_rules import local_shard

    pp = getattr(getattr(mesh, "config", mesh), "pp", 1) if mesh is not None else 1
    if pp > 1 or "stages" in np_tree:
        if pp == 1 or "stages" not in np_tree:
            raise ValueError(
                f"a pipeline tree (stages) goes to a pp mesh: the tree has "
                f"{'no ' if 'stages' not in np_tree else ''}stages, the mesh pp={pp}"
            )
        from dlrover_tpu_torch.parallel.pipeline import PipelineStage

        model = PipelineStage(cfg, pp, getattr(mesh, "stage", 0), virtual, device=device,
                              mesh=mesh)
    else:
        stacked = isinstance(np_tree.get("layers"), dict)
        if stacked != cfg.scan_layers:
            raise ValueError(
                f"the tree's layers are {'stacked' if stacked else 'a list'}, "
                f"the config's scan_layers={cfg.scan_layers}"
            )
        model = Transformer(cfg, device=device, mesh=mesh)
    splits = _splits(model, mesh)
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = np.asarray(_lookup(np_tree, name))
            for _, deg, coord, _, dims in splits:
                arr = local_shard(arr, dims.get(name), deg, coord)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: JAX leaf {arr.shape} vs port {tuple(p.shape)}"
                )
            p.copy_(torch.from_numpy(arr.astype(np.float32)).to(p.dtype))
            n += 1
    if n != _count_leaves(np_tree):
        raise ValueError(
            f"JAX tree has {_count_leaves(np_tree)} leaves, the port {n}"
        )
    return model


def whole_leaf(t: torch.Tensor, name: str, model, mesh, splits=None) -> torch.Tensor:
    """A rank's tensor of parameter ``name`` (its box of the leaf, or a
    tensor of the box's shape such as its gradient, or under ZeRO its
    1-D shard of the box's padded flatten) as the whole leaf: gathered
    over fsdp and cut to the box's shape, then joined over each axis
    that splits it (``_splits``; every rank of the mesh calls it)."""
    from dlrover_tpu_torch.parallel.grad_sync import _all_gather
    from dlrover_tpu_torch.parallel.sharding_rules import gather_tp

    local = dict(model.named_parameters())[name]
    t = t.detach()
    if t.dim() == 1 and t.shape != local.shape:  # a ZeRO shard
        full, h = _all_gather(t.contiguous(), mesh.groups["fsdp"])
        h.wait()
        t = full[:local.numel()].view(local.shape)
    for _, _, _, group, dims in (_splits(model, mesh) if splits is None else splits):
        t = gather_tp(t, dims.get(name), group)
    return t


def params_to_numpy(model: Transformer, mesh=None) -> Dict[str, Any]:
    """The port's parameters as the JAX-structured tree of f32 numpy
    arrays (the inverse of ``params_from_jax``); with a ``mesh`` of tp >
    1 the whole leaves, gathered over tp (every tp rank must call), and
    over pp the stage rows."""
    splits = _splits(model, mesh)
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        p = whole_leaf(p, name, model, mesh, splits)
        parts = name.split(".")
        node = tree
        for i, part in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            if part.isdigit():
                idx = int(part)
                while len(node) <= idx:
                    node.append({})
                node = node[idx]
            else:
                node = node.setdefault(part, [] if nxt.isdigit() else {})
        # a copy: numpy's view of a param's own storage would pin it
        # (ZeRO frees the params' storage between steps)
        node[parts[-1]] = p.detach().to("cpu", torch.float32, copy=True).numpy()
    return tree


# ---------------------------------------------------------------------------
# the whole train state, in the JAX package's TrainState tree
# ---------------------------------------------------------------------------
def _param_paths(model: Transformer):
    """``(path, param)`` in the JAX flatten order, path ``/``-joined
    (``layers/3/attn/wq``): the order the optimizers index their leaves."""
    named = dict(model.named_parameters())
    order = {id(p): i for i, p in enumerate(model.jax_ordered_parameters())}
    return sorted(
        ((n.replace(".", "/"), p) for n, p in named.items()),
        key=lambda item: order[id(item[1])],
    )


def _nest(pairs) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def param_state(model: Transformer) -> Dict[str, Any]:
    """The model's parameters (detached, sharing their storage) as the
    JAX param tree's nesting (``embed/tokens``, ``layers/0/attn/wq``; the
    stacked leaves under ``scan_layers``): the restore target whose
    record paths are a published params tree's (``ckpt/sharding.
    restore_state`` fills it in place)."""
    return _nest((path, p.detach()) for path, p in _param_paths(model))


def head_model_from_jax(np_tree: Dict[str, Any], cfg: TransformerConfig, head_name: str,
                        device=None):
    """The JAX ``{"trunk": params, head_name: [D]}`` tree of the RLHF
    critic (``value_head``) or reward model (``reward_head``), numpy
    leaves, as the port's ``rl.reward.HeadModel`` on ``device``."""
    from dlrover_tpu_torch.rl.reward import HeadModel

    if set(np_tree) != {"trunk", head_name}:
        raise ValueError(f"expected the keys trunk and {head_name}, got {sorted(np_tree)}")
    trunk = params_from_jax(np_tree["trunk"], cfg, device=device)
    head = torch.from_numpy(np.asarray(np_tree[head_name], np.float32).copy())
    return HeadModel(trunk, head.to(device), head_name)


def head_model_to_numpy(model) -> Dict[str, Any]:
    """Inverse of ``head_model_from_jax``."""
    return {"trunk": params_to_numpy(model.trunk),
            model.head_name: model.head.detach().to("cpu", torch.float32, copy=True).numpy()}


def _by_param(model: Transformer, leaves) -> Dict[str, Any]:
    return _nest(
        (path, leaf) for (path, _), leaf in zip(_param_paths(model), leaves)
    )


def _q_tree(q, column_scales: bool):
    """A ``Quantized8`` / ``Quantized4`` as the JAX pytree node's children
    (codes or packed nibbles, scales). The JAX per-leaf form keeps
    ``[nblocks, 1]`` scales: a view, so a restore into it fills the
    optimizer's own ``[nblocks]`` tensor."""
    scales = q.scales.view(-1, 1) if column_scales else q.scales
    return {"0": q.packed if hasattr(q, "packed") else q.codes, "1": scales}


def _torch_adam_state(opt, params):
    """AdamW's per-param state, created now (zeros, step 0) where the
    first step has not created it yet: the same start as torch's own."""
    for p in params:
        st = opt.state[p]
        if not st:
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return [opt.state[p] for p in params]


def _sgd_buffers(opt, params):
    bufs = []
    for p in params:
        st = opt.state[p]
        if st.get("momentum_buffer") is None:
            # torch starts the buffer as the first gradient; zeros give
            # the same bits (0 * momentum + g)
            st["momentum_buffer"] = torch.zeros_like(p)
        bufs.append(st["momentum_buffer"])
    return bufs


def _inner_tree(inner, model: Transformer, params) -> Dict[str, Any]:
    """The optimizer's own state as the JAX package's ``inner_state/0``
    (the chain ``(optimizer, scale(retune_scale))``'s first element);
    ``params`` are the optimizer's, in the JAX order (the leaves, or
    under ZeRO their shards)."""
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.ops.optimizers import agd

    if isinstance(inner, qo.adamw_8bit_flat):  # Adam8FlatState
        return {
            "count": np.asarray(inner.count, np.int32),
            "mu": {str(g): _q_tree(q, False) for g, q in enumerate(inner.mu)},
            "nu": {str(g): _q_tree(q, False) for g, q in enumerate(inner.nu)},
            "mu_small": inner.mu_small,
            "nu_small": inner.nu_small,
        }
    if isinstance(inner, qo.adamw_8bit):  # Adam8State
        st = inner.adam_state

        def moments(ms):
            return _by_param(model, [
                _q_tree(m, True) if isinstance(m, (qo.Quantized8, qo.Quantized4)) else m
                for m in ms
            ])

        return {"count": np.asarray(st.count, np.int32), "mu": moments(st.mu), "nu": moments(st.nu)}
    if isinstance(inner, agd):  # AGDState
        states = [inner.state[p] for p in params]
        tree = {
            "count": np.asarray(inner.count, np.int32),
            "exp_avg": _by_param(model, [s["exp_avg"] for s in states]),
            "exp_avg_sq": _by_param(model, [s["exp_avg_sq"] for s in states]),
        }
        if inner.amsgrad:
            tree["max_exp_avg_sq"] = _by_param(model, [s["max_exp_avg_sq"] for s in states])
        return tree
    if isinstance(inner, torch.optim.AdamW):  # chain(scale_by_adam, ...)
        states = _torch_adam_state(inner, params)
        return {"0": {
            "count": np.asarray(int(states[0]["step"]) if states else 0, np.int32),
            "mu": _by_param(model, [s["exp_avg"] for s in states]),
            "nu": _by_param(model, [s["exp_avg_sq"] for s in states]),
        }}
    if isinstance(inner, torch.optim.SGD):  # chain(add_decayed_weights, sgd)
        if not inner.param_groups[0]["momentum"]:
            return {}
        return {"1": {"0": {"trace": _by_param(model, _sgd_buffers(inner, params))}}}
    raise NotImplementedError(
        f"the state of {type(inner).__name__} has no JAX counterpart here"
    )


def train_state_tree(state, mesh=None) -> Dict[str, Any]:
    """A port ``TrainState`` as the JAX package's ``TrainState`` tree:
    the same nesting and leaf paths (``params/layers/0/attn/wq``,
    ``opt_state/inner_state/0/mu/0/0``, ...), dtypes and shapes. Tensor
    leaves are the live tensors (a restore fills them in place); the
    host values (step, counts, the learning rate and retune scale of
    ``build_optimizer``'s ``ScheduledOptimizer``) are numpy scalars of
    the JAX dtypes. The optimizer must come from ``build_optimizer``.

    Under ZeRO (``state.shards``) the tensors are this rank's shards.
    With ``mesh``, the tree is what this rank stages: a replicated
    tensor only on the first rank of its replica set (the data axes, or
    dp under ZeRO), a shard as a ``BlockLeaf`` holding its run of the
    JAX leaf's row-major flatten (recorded as blocks of the JAX leaf's
    shape, so the JAX package's reader assembles the whole leaf from
    every owner's records; a run wholly in the padding is left out), and
    the host values on every rank. Under tp a split leaf's tensor (or
    its ZeRO shard) is recorded as its box of the whole leaf, its 8-bit
    codes and scales as row ``tp coordinate`` of a ``[tp, ...]`` stack
    (they are the box's own blocks: a restore needs the same tp), and a
    leaf every tp rank holds whole is staged by tp coordinate 0 alone.
    The residual (``state.grad_residual``) is never part of it."""
    opt = state.opt_state
    if not hasattr(opt, "lr_fn"):
        raise NotImplementedError(
            "checkpointing needs the optimizer of build_optimizer (the "
            "JAX package's inject_hyperparams state)"
        )
    params = state.shards if state.shards is not None else [
        p for _, p in _param_paths(state.params)
    ]
    tree = {
        "step": np.asarray(state.step, np.int32),
        "params": _by_param(state.params, params),
        "opt_state": {
            "count": np.asarray(opt.count, np.int32),
            "hyperparams": {
                "learning_rate": np.asarray(opt.learning_rate, np.float32),
                "retune_scale": np.asarray(opt.retune_scale, np.float32),
            },
            "inner_state": {"0": _inner_tree(opt.opt, state.params, params)},
        },
    }
    if mesh is None:
        return tree
    return _rank_tree(tree, mesh, state.params, state.shards is not None)


def replica_group(mesh, zero: bool) -> str:
    """The mesh group a replicated tensor of the state is shared over:
    dp under ZeRO (its shards differ over fsdp), else the data axes,
    and with them sp (sequence parallelism shards no state)."""
    if zero:
        return "dp"
    return "replica" if mesh.config.sp > 1 else "data"


def _tp_parts(model: Transformer, mesh):
    """``[(axis, degree, coordinate, group, [(param path, its split dim,
    its 8-bit blocks are rows of the whole leaf's)])]`` of every axis that
    splits the mesh's leaves, in the order a box is cut (``_splits``)."""
    from dlrover_tpu_torch.ops.quantized_optim import BLOCK

    out = []
    for axis, n, coord, group, dims in _splits(model, mesh):
        rows = axis in ("ep", "pp")
        parts = []
        for pp, p in _param_paths(model):
            d = dims.get(pp.replace("/", "."))
            # an ep rank's experts, a pp rank's stage row (a box along dim
            # 0) whose elements fill whole 128-blocks are a run of the
            # whole leaf's blocks
            parts.append((pp, d, rows and d == 0 and p.numel() % BLOCK == 0))
        out.append((axis, n, coord, group, parts))
    return out


def _tp_part(path: str, parts):
    """How the state tensor at ``path`` splits over the axis: ``("box",
    dim)`` for a split leaf's param or a tensor of its shape (f32
    moments, traces), and for its 8-bit codes or scales when they are
    rows of the whole leaf's blocks (``("box", 0)``), else ``("stack",
    dim)`` (quantized in the box's own blocks), None for a tensor every
    rank of the axis holds whole."""
    for pp, d, rows in parts:
        if path.endswith("/" + pp):
            return None if d is None else ("box", d)
        if path.endswith(("/" + pp + "/0", "/" + pp + "/1")):
            return None if d is None else (("box", 0) if rows else ("stack", d))
    return None


def _place(path: str, shape, splits):
    """(record shape, box) of this rank's tensor at ``path`` of local
    ``shape`` in the checkpoint's leaf, cutting along each split axis in
    turn (a box multiplies its dim by the degree, a stack adds a leading
    dim of the degree), or None when no axis splits it."""
    from dlrover_tpu_torch.ckpt.sharding import full_index

    shape, box, lead, placed = list(shape), list(full_index(shape)), 0, False
    for _, n, coord, _, parts in splits:
        part = _tp_part(path, parts)
        if part is None:
            continue
        placed = True
        kind, d = part
        if kind == "stack":
            shape, box, lead = [n] + shape, [(coord, coord + 1)] + box, lead + 1
        else:
            k, (lo, hi) = shape[d + lead], box[d + lead]
            shape[d + lead] = k * n
            box[d + lead] = (lo + coord * k, hi + coord * k)
    return (tuple(shape), tuple(box)) if placed else None


def axis_whole_tensors(state, mesh, axis: str) -> list:
    """The tensors of ``train_state_tree(state)`` every rank of ``axis``
    (tp, ep or pp) holds whole: its coordinate 0 stages them, and a
    restore hands them on over the axis's group. Empty when the axis
    splits nothing."""
    from dlrover_tpu_torch.ckpt.sharding import flatten_state

    parts = next((s[4] for s in _tp_parts(state.params, mesh) if s[0] == axis), None)
    if parts is None:
        return []
    return [t for path, t in flatten_state(train_state_tree(state))
            if isinstance(t, torch.Tensor) and _tp_part(path, parts) is None]


def _rank_tree(tree, mesh, model: Transformer, zero: bool):
    """``tree`` as this rank stages it (see ``train_state_tree``)."""
    from dlrover_tpu_torch.ckpt.sharding import BlockLeaf

    params = _param_paths(model)
    splits = _tp_parts(model, mesh)
    stager = mesh.group_index(replica_group(mesh, zero)) == 0
    f = mesh.group_index("fsdp")

    def block(path, t):
        # this rank's run of the JAX leaf's row-major flatten: fsdp equal
        # runs of the padded flatten, the padding never recorded
        shape = _jax_shape(path, t, params)
        n = t.numel()
        lo, hi = f * n, min((f + 1) * n, int(np.prod(shape)))
        return BlockLeaf(t, shape, lo, hi, _place(path, shape, splits)) if lo < hi else None

    def leaf(path, t):
        if any(coord and _tp_part(path, parts) is None for _, _, coord, _, parts in splits):
            return None  # whole on every rank of an axis: its coordinate 0 stages it
        if zero:
            return block(path, t)
        where = _place(path, tuple(t.shape), splits)
        return t if where is None else BlockLeaf(t, tuple(t.shape), 0, t.numel(), where)

    def walk(prefix, node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                w = walk(f"{prefix}/{k}" if prefix else k, v)
                if w is not None:
                    out[k] = w
            return out
        if isinstance(node, torch.Tensor):
            return leaf(prefix, node) if stager else None
        return node

    return walk("", tree)


def load_train_state_tree(state, tree: Dict[str, Any]) -> None:
    """Write a restored ``train_state_tree`` back: its tensors were
    filled in place, so this sets the host values (step, counts, the
    learning rate and retune scale)."""
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.ops.optimizers import agd

    opt, o = state.opt_state, tree["opt_state"]
    state.step = int(tree["step"])
    opt.count = int(o["count"])
    opt.learning_rate = float(o["hyperparams"]["learning_rate"])
    opt.retune_scale = float(o["hyperparams"]["retune_scale"])
    inner, io = opt.opt, o["inner_state"]["0"]
    if isinstance(inner, qo.adamw_8bit_flat):
        inner.count = int(io["count"])
    elif isinstance(inner, qo.adamw_8bit):
        inner.adam_state.count = int(io["count"])
    elif isinstance(inner, agd):
        inner.count = int(io["count"])
    elif isinstance(inner, torch.optim.AdamW):
        for p in inner.param_groups[0]["params"]:
            inner.state[p]["step"].fill_(float(io["0"]["count"]))


# ---------------------------------------------------------------------------
# a JAX dp or dp x fsdp train state, whole, to this rank and back
# ---------------------------------------------------------------------------
def _jax_shape(path: str, t: torch.Tensor, params) -> tuple:
    """The JAX package's shape of the state leaf at ``path`` whose port
    tensor (a ZeRO shard) is ``t``: its param's shape, or its 8-bit
    codes' ``(blocks, 128)`` / scales' ``(blocks, 1)``."""
    for pp, p in params:
        for suffix, kind in ((pp, "leaf"), (pp + "/0", "codes"), (pp + "/1", "scales")):
            if path == suffix or path.endswith("/" + suffix):
                if kind == "leaf" and t.dim() == 1:
                    return tuple(p.shape)
                if kind != "leaf" and t.dim() == 2:
                    blocks = -(-p.numel() // 128)
                    # codes [blocks, 128], 4-bit packed nibbles [blocks, 64]
                    return (blocks, t.shape[1]) if kind == "codes" else (blocks, 1)
    raise ValueError(f"no JAX leaf for the port's state leaf {path!r}")


def load_jax_train_state(state, leaves: Dict[str, np.ndarray], mesh=None, plan=None) -> None:
    """Fill this rank's ``state`` from a whole JAX ``TrainState``:
    ``leaves`` maps each of its leaf paths (``params/layers/0/attn/wq``,
    ``opt_state/inner_state/0/mu/...``, ``step``, ...; the paths of its
    checkpoint records) to the full numpy array. Under ZeRO each tensor
    takes its rank's block rows of the leaf's padded row-major flatten
    (params, the per-leaf 8-bit codes and scales, f32 moments), and the
    next step gathers the module's params from them; off ZeRO the params
    fill the module. ``leaves["grad_residual"]``, when given, is
    the JAX package's per-bucket ``(total, shard_elems)`` residual list,
    which ``plan``'s layout takes element for element."""
    from dlrover_tpu_torch.ckpt.sharding import flatten_state
    from dlrover_tpu_torch.parallel.sharding_rules import local_shard

    zero = state.shards is not None
    F = mesh.config.fsdp if zero else 1
    f = mesh.group_index("fsdp") if zero else 0
    splits = _tp_parts(state.params, mesh)

    def cut(path, a):
        # this rank's box of a whole JAX leaf, along each split axis
        for _, n, coord, _, parts in splits:
            part = _tp_part(path, parts)
            if part is None:
                continue
            if part[0] == "stack":
                raise NotImplementedError(
                    f"{path}: the JAX package's 8-bit state quantizes the whole "
                    f"leaf; a tp rank's codes are its box's own blocks"
                )
            a = local_shard(a, part[1], n, coord)
        return np.ascontiguousarray(a)

    with torch.no_grad():
        if not zero:  # under ZeRO the shards carry the params
            for pp, p in _param_paths(state.params):
                a = cut("params/" + pp, np.asarray(leaves["params/" + pp], np.float32))
                p.copy_(torch.from_numpy(a).to(p.dtype))
        tree = train_state_tree(state)
        for path, t in flatten_state(tree):
            a = np.asarray(leaves[path])
            if not isinstance(t, torch.Tensor):
                node, parts = tree, path.split("/")
                for part in parts[:-1]:
                    node = node[part]
                node[parts[-1]] = a
                continue
            a = cut(path, a)
            if zero:
                flat = np.pad(a.reshape(-1), (0, F * t.numel() - a.size))
                a = flat.reshape((F,) + tuple(t.shape))[f]
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)).view(t.shape))
    load_train_state_tree(state, tree)
    if leaves.get("grad_residual") is not None and plan is not None:
        from dlrover_tpu_torch.parallel.grad_sync import residual_from_jax

        dev = state.params.jax_ordered_parameters()[0].device
        state.grad_residual = residual_from_jax(
            plan, leaves["grad_residual"], mesh.data_index, device=dev
        )


def jax_train_state(state, mesh=None, plan=None) -> Dict[str, np.ndarray]:
    """The whole JAX ``TrainState`` of a port run, by leaf path (the
    inverse of ``load_jax_train_state``; every rank of the mesh must
    call it): under ZeRO each leaf's rows are gathered over fsdp and cut
    back to the JAX shape, and ``grad_residual``, when the state carries
    one, is gathered over the data axes into the JAX package's
    per-bucket ``(total, shard_elems)`` arrays (None without one)."""
    from dlrover_tpu_torch.ckpt.sharding import flatten_state
    from dlrover_tpu_torch.parallel.grad_sync import _all_gather, residual_to_jax

    from dlrover_tpu_torch.parallel.sharding_rules import gather_tp

    zero = state.shards is not None
    params = _param_paths(state.params)
    splits = _tp_parts(state.params, mesh)
    out: Dict[str, np.ndarray] = {}
    for path, t in flatten_state(train_state_tree(state)):
        if not isinstance(t, torch.Tensor):
            out[path] = np.asarray(t)
            continue
        a = t.detach()
        if zero and mesh.groups["fsdp"] is not None:
            full, h = _all_gather(a.reshape(-1), mesh.groups["fsdp"])
            h.wait()
            shape = _jax_shape(path, t, params)
            a = full[:int(np.prod(shape))].view(shape)
        lead = 0
        for _, _, _, group, parts in splits:
            part = _tp_part(path, parts)
            if part is None:
                continue
            # a box joined along its dim; 8-bit state stacked [tp, ...]
            if part[0] == "box":
                a = gather_tp(a, part[1] + lead, group)
            else:
                a, lead = gather_tp(a[None], 0, group), lead + 1
        out[path] = a.cpu().numpy().copy()
    out["grad_residual"] = None
    if state.grad_residual is not None and plan is not None:
        rows = []
        for r in state.grad_residual:
            g = mesh.groups["data"]
            if g is None:
                rows.append(r.detach().reshape(1, -1))
                continue
            full, h = _all_gather(r.detach().reshape(-1), g)
            h.wait()
            # group rank order is sorted rank order: back to mesh order
            order = sorted(mesh.ranks["data"])
            full = full.view(len(order), -1)
            rows.append(full[[order.index(x) for x in mesh.ranks["data"]]])
        lanes = [[rows[b][ln].cpu().numpy() for b in range(len(rows))] for ln in range(plan.total)]
        out["grad_residual"] = residual_to_jax(plan, lanes)
    return out


def _read_checkpoint_records(ckpt_dir: str):
    """``(step, {path: [records]})`` of the newest verified step of a
    checkpoint the JAX package (or the port) wrote, read by the port's
    own reader."""
    import os

    from dlrover_tpu_torch.ckpt import saver as saver_mod
    from dlrover_tpu_torch.ckpt.sharding import ShardRecord
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    storage = PosixDiskStorage()
    step = saver_mod.resolve_verified_step(storage, ckpt_dir, repair=False, deep=True)
    if step < 0:
        raise FileNotFoundError(f"no verified checkpoint in {ckpt_dir!r}")
    sdir = saver_mod.step_dir(ckpt_dir, step)
    by_path: Dict[str, list] = {}
    for fname in storage.listdir(sdir):
        if not fname.endswith(".ckpt"):
            continue
        payload = storage.read_state_dict(os.path.join(sdir, fname))
        for m in payload["records"]:
            by_path.setdefault(m["path"], []).append(ShardRecord(
                path=m["path"], global_shape=tuple(m["global_shape"]), dtype=m["dtype"],
                index=tuple(tuple(i) for i in m["index"]), data=m["data"],
            ))
    return step, by_path


def state_from_jax_checkpoint(ckpt_dir: str, cfg: TransformerConfig, tx, devices=None):
    """A checkpoint the JAX package wrote (its ``TrainState`` saved
    alone, or under ``train/`` as its ``ElasticTrainer`` saves it) as a
    port ``TrainState`` on ``devices`` (the card unless ``"cpu"``), with
    ``tx`` from ``build_optimizer`` built with the JAX run's arguments.
    Every leaf must match in path, shape and dtype, and no leaf of the
    checkpoint's train state may be left over."""
    from dlrover_tpu_torch.ckpt.sharding import flatten_state, restore_state
    from dlrover_tpu_torch.models.train import init_state

    _, by_path = _read_checkpoint_records(ckpt_dir)
    prefix = "train/" if any(p.startswith("train/") for p in by_path) else ""
    state = init_state(cfg, tx, seed=0, devices=devices)
    tree = train_state_tree(state)
    want = {prefix + p for p, _ in flatten_state(tree)}
    have = {p for p in by_path if p.startswith(prefix)}
    if want != have:
        raise ValueError(
            f"checkpoint and port state differ: only in the checkpoint "
            f"{sorted(have - want)[:5]}, only in the port {sorted(want - have)[:5]}"
        )
    load_train_state_tree(state, restore_state(tree, lambda p: by_path[prefix + p]))
    return state
