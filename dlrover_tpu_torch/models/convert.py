"""Weights between the JAX package's param pytree and the port's module.

The JAX tree is nested dicts with a list of layer dicts (numpy leaves,
e.g. ``jax.device_get(params)``); the port's parameter names are the
same path joined with dots (``layers.3.attn.wq``). Conversion is leaf
for leaf: shapes must agree exactly and no leaf may be left over.
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
