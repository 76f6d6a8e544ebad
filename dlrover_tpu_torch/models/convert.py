"""Weights and train state between the JAX package and the port.

The JAX tree is nested dicts with a list of layer dicts (numpy leaves,
e.g. ``jax.device_get(params)``); the port's parameter names are the
same path joined with dots (``layers.3.attn.wq``). Conversion is leaf
for leaf: shapes must agree exactly and no leaf may be left over.

``train_state_tree`` gives a port ``TrainState`` the JAX package's
``TrainState`` tree (params, the optimizer's state, the step and
schedule counts), which is what a checkpoint of either package holds;
``state_from_jax_checkpoint`` reads a JAX checkpoint into the port.
Optimizer state maps form for form: ``Adam8FlatState`` to
``adamw_8bit_flat`` (the same group layout), ``Adam8State`` to
``adamw_8bit``, optax's Adam to ``torch.optim.AdamW``, optax's momentum
trace to ``torch.optim.SGD``'s buffers.
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
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def params_from_jax(np_tree: Dict[str, Any], cfg: TransformerConfig, device=None) -> Transformer:
    """The JAX param pytree (numpy leaves, layers as a list) -> the
    port's ``Transformer`` on ``device`` (default the CPU)."""
    if not isinstance(np_tree.get("layers"), (list, tuple)):
        raise NotImplementedError(
            "stacked (scan_layers) params are not ported yet (ROADMAP A2)"
        )
    model = Transformer(cfg, device=device)
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = np.asarray(_lookup(np_tree, name))
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


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The port's parameters as the JAX-structured tree of f32 numpy
    arrays (the inverse of ``params_from_jax``)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
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
        node[parts[-1]] = p.detach().float().cpu().numpy()
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


def _by_param(model: Transformer, leaves) -> Dict[str, Any]:
    return _nest(
        (path, leaf) for (path, _), leaf in zip(_param_paths(model), leaves)
    )


def _q8_tree(q, column_scales: bool):
    # the JAX per-leaf Quantized8 keeps [nblocks, 1] scales: a view, so a
    # restore into it fills the optimizer's own [nblocks] tensor
    scales = q.scales.view(-1, 1) if column_scales else q.scales
    return {"0": q.codes, "1": scales}


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


def _inner_tree(inner, model: Transformer) -> Dict[str, Any]:
    """The optimizer's own state as the JAX package's ``inner_state/0``
    (the chain ``(optimizer, scale(retune_scale))``'s first element)."""
    from dlrover_tpu_torch.ops import quantized_optim as qo

    params = [p for _, p in _param_paths(model)]
    if isinstance(inner, qo.adamw_8bit_flat):  # Adam8FlatState
        return {
            "count": np.asarray(inner.count, np.int32),
            "mu": {str(g): _q8_tree(q, False) for g, q in enumerate(inner.mu)},
            "nu": {str(g): _q8_tree(q, False) for g, q in enumerate(inner.nu)},
            "mu_small": inner.mu_small,
            "nu_small": inner.nu_small,
        }
    if isinstance(inner, qo.adamw_8bit):  # Adam8State
        st = inner.adam_state

        def moments(ms):
            return _by_param(model, [
                _q8_tree(m, True) if isinstance(m, qo.Quantized8) else m for m in ms
            ])

        return {"count": np.asarray(st.count, np.int32), "mu": moments(st.mu), "nu": moments(st.nu)}
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


def train_state_tree(state) -> Dict[str, Any]:
    """A port ``TrainState`` as the JAX package's ``TrainState`` tree:
    the same nesting and leaf paths (``params/layers/0/attn/wq``,
    ``opt_state/inner_state/0/mu/0/0``, ...), dtypes and shapes. Tensor
    leaves are the live tensors (a restore fills them in place); the
    host values (step, counts, the learning rate and retune scale of
    ``build_optimizer``'s ``ScheduledOptimizer``) are numpy scalars of
    the JAX dtypes. The optimizer must come from ``build_optimizer``."""
    opt = state.opt_state
    if not hasattr(opt, "lr_fn"):
        raise NotImplementedError(
            "checkpointing needs the optimizer of build_optimizer (the "
            "JAX package's inject_hyperparams state)"
        )
    return {
        "step": np.asarray(state.step, np.int32),
        "params": _by_param(state.params, [p for _, p in _param_paths(state.params)]),
        "opt_state": {
            "count": np.asarray(opt.count, np.int32),
            "hyperparams": {
                "learning_rate": np.asarray(opt.learning_rate, np.float32),
                "retune_scale": np.asarray(opt.retune_scale, np.float32),
            },
            "inner_state": {"0": _inner_tree(opt.opt, state.params)},
        },
    }


def load_train_state_tree(state, tree: Dict[str, Any]) -> None:
    """Write a restored ``train_state_tree`` back: its tensors were
    filled in place, so this sets the host values (step, counts, the
    learning rate and retune scale)."""
    from dlrover_tpu_torch.ops import quantized_optim as qo

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
    elif isinstance(inner, torch.optim.AdamW):
        for p in inner.param_groups[0]["params"]:
            inner.state[p]["step"].fill_(float(io["0"]["count"]))


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
