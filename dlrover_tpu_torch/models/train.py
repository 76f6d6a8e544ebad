"""Single-device training step (counterpart of
``dlrover_tpu/models/train.py``: ``TrainState``, state init and
``build_train_step`` with the semantics of its default path,
``gspmd_grads`` + ``train_step``, on one device; there is no mesh).

``tx`` is an optimizer factory: a callable that takes the parameters in
the JAX flatten order and returns an optimizer with ``step()``
(``trainer.elastic.trainer.build_optimizer`` makes one, and so does
``functools.partial`` over any ``torch.optim`` class).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

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
    opt_state: Any  # the optimizer bound to ``params``


def init_state(
    cfg: TransformerConfig, tx: Callable, seed: int = 0, devices=None
) -> TrainState:
    """Params from ``torch.Generator().manual_seed(seed)`` on the device
    (the card unless ``devices="cpu"``) and the optimizer over them."""
    device = resolve_device(devices)
    params = init_params(torch.Generator().manual_seed(seed), cfg, device)
    return state_from_params(params, tx)


def state_from_params(params: Transformer, tx: Callable) -> TrainState:
    return TrainState(
        step=0, params=params, opt_state=tx(params.jax_ordered_parameters())
    )


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def build_train_step(
    cfg: TransformerConfig, tx: Callable = None, grad_accum: int = 1
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, Dict]]:
    """``(state, tokens, targets) -> (state, {"loss", "grad_norm"})``,
    updating ``state`` in place (params, optimizer, step count).

    ``grad_accum=K`` splits the batch into K microbatches in order,
    accumulates their grads in f32 whatever the param dtype, and casts
    the mean back to the param dtype once before ONE optimizer step.
    ``tx`` is accepted for the JAX signature; the step uses the
    optimizer bound in ``state.opt_state``."""
    check_supported(cfg)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: TrainState, tokens, targets):
        model = state.params
        params = model.jax_ordered_parameters()
        for p in params:
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(model, tokens, targets, cfg)
            loss.backward()
            loss = loss.detach()
        else:
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(
                    f"batch {B} must divide into grad_accum={grad_accum}"
                )
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for x, y in zip(
                tokens.chunk(grad_accum), targets.chunk(grad_accum)
            ):
                mb_loss = loss_fn(model, x, y, cfg)
                grads = torch.autograd.grad(mb_loss, params)
                torch._foreach_add_(acc, [g.float() for g in grads])
                loss = loss + mb_loss.detach()
            for p, a in zip(params, acc):
                p.grad = (a / grad_accum).to(p.dtype)
            loss = loss / grad_accum
        gnorm = global_norm(p.grad for p in params)
        state.opt_state.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step
