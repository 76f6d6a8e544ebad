"""muP (Maximal Update Parametrization) on PyTorch (counterpart of
``dlrover_tpu/models/mup.py``): width-transferable hyperparameters.

The same three pieces, keyed off the config (base width against target
width):

1. init: matrix-like params keep their ``1/fan_in`` variance
   (``init_params`` already draws so); the readout is handled by the
   output multiplier;
2. forward multipliers on ``TransformerConfig``: ``mup_attn_scale``
   (attention logits ``1/d`` normalized to the base head dim) and
   ``mup_output_mult`` (logits times ``base_width / width``), which the
   port's forward applies as the JAX forward does;
3. the optimizer: ``mup_lr_scales`` gives each leaf its LR multiplier
   (``1/width_mult`` for hidden matrices, 1 for vectors, the embedding
   table and the readout), and ``mup_adamw`` scales the Adam direction
   by it BEFORE decoupled weight decay, so the decay stays
   ``-lr * wd * param`` at every width.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Tuple

import torch

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import logical_axes


def width_mult(cfg: TransformerConfig, base: TransformerConfig) -> float:
    return cfg.model_dim / base.model_dim


def mup_config(cfg: TransformerConfig, base: TransformerConfig) -> TransformerConfig:
    """``cfg`` with the muP forward multipliers set relative to ``base``
    (the small proxy whose hyperparameters transfer)."""
    m = width_mult(cfg, base)
    attn_scale = (base.head_dim**0.5) / cfg.head_dim
    return replace(cfg, mup_attn_scale=attn_scale, mup_output_mult=1.0 / m)


# axes whose size grows with model width (the mup package's "infinite
# dims"); vocab / max_seq_len / experts / stage axes are width-finite
WIDTH_AXES = {"embed", "heads", "head_dim", "mlp", "norm", "expert_mlp"}


def _is_matrix_like(axes: Tuple) -> bool:
    """Hidden matrix-like = 2+ width-scaling dims: 1/m LR."""
    if not isinstance(axes, tuple):
        return False
    if "expert_mlp" in axes:
        return True
    return sum(1 for a in axes if a in WIDTH_AXES) >= 2


def _map_axes(fn, node):
    """``fn`` over the axis tuples of a ``logical_axes`` tree."""
    if isinstance(node, dict):
        return {k: _map_axes(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_axes(fn, v) for v in node]
    return fn(node)


def mup_lr_scales(cfg: TransformerConfig, base: TransformerConfig) -> Any:
    """A tree congruent with the params (the JAX package's tree) of
    per-leaf LR multipliers: ``1/width_mult`` for hidden matrices, 1
    elsewhere."""
    m = width_mult(cfg, base)
    return _map_axes(lambda a: 1.0 / m if _is_matrix_like(a) else 1.0, logical_axes(cfg))


def lr_scales_by_param(cfg: TransformerConfig, base: TransformerConfig) -> List[float]:
    """``mup_lr_scales`` as a list in the JAX flatten order of the
    params (``Transformer.jax_ordered_parameters``)."""
    from dlrover_tpu_torch.models.transformer import Transformer

    scales = mup_lr_scales(cfg, base)
    with torch.device("meta"):
        model = Transformer(cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    out = []
    for p in model.jax_ordered_parameters():
        node = scales
        for part in names[id(p)].split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        out.append(float(node))
    return out


class scale_by_adam_mup(torch.optim.Optimizer):
    """The optax chain ``scale_by_adam() -> scale_adam_lr_by_mup(scales)
    -> add_decayed_weights(wd) -> scale_by_learning_rate(lr)`` (what the
    JAX ``mup_adamw`` builds), as one optimizer over a list of params
    with one muP scale each: the update is ``-lr * (s * m_hat /
    (sqrt(v_hat + eps_root) + eps) + wd * p)``, in optax's operation
    order. The group's ``retune_scale`` multiplies the whole update."""

    def __init__(self, params, scales, lr: float = 1e-3, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        super().__init__(params, dict(lr=lr, retune_scale=1.0))
        leaves = self.param_groups[0]["params"]
        if len(self.param_groups) != 1 or len(scales) != len(leaves):
            raise ValueError("mup_adamw takes one param group and one scale a param")
        self.scales = [float(s) for s in scales]
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay
        self.count = 0
        for p in leaves:
            self.state[p]["mu"] = torch.zeros_like(p)
            self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("mup_adamw takes no closure")
        group = self.param_groups[0]
        self.count += 1
        cf = torch.tensor(float(self.count), dtype=torch.float32)
        bc1, bc2 = 1.0 - self.b1**cf, 1.0 - self.b2**cf
        lr = torch.tensor(group["lr"], dtype=torch.float32)
        for p, s in zip(group["params"], self.scales):
            if p.grad is None:
                raise ValueError("every parameter needs a gradient")
            g, st = p.grad, self.state[p]
            mu = (1.0 - self.b1) * g + self.b1 * st["mu"]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * st["nu"]
            u = (mu / bc1.to(p.device)) / (
                torch.sqrt(nu / bc2.to(p.device) + self.eps_root) + self.eps
            )
            u = u * s
            if self.weight_decay:
                u = u + self.weight_decay * p
            u = -lr.to(p.device) * u
            if group["retune_scale"] != 1.0:
                u = u * float(group["retune_scale"])
            p.add_(u)
            st["mu"], st["nu"] = mu, nu
        return None


def mup_adamw(
    params,
    lr: float,
    cfg: TransformerConfig,
    base: TransformerConfig,
    weight_decay: float = 0.0,
    **adam_kwargs,
) -> scale_by_adam_mup:
    """AdamW under muP (the JAX ``mup_adamw``) over a model's params in
    the JAX flatten order (``model.jax_ordered_parameters()``), each
    scaled by its leaf's ``mup_lr_scales`` entry."""
    return scale_by_adam_mup(
        list(params), lr_scales_by_param(cfg, base), lr=lr,
        weight_decay=weight_decay, **adam_kwargs,
    )
