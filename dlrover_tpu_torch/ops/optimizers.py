"""AGD and WSAM on PyTorch (counterpart of ``dlrover_tpu/ops/optimizers.py``).

``agd`` is a ``torch.optim.Optimizer`` with the JAX transform's step
math, operation for operation in f32 (its bias corrections from the f32
step count); its state is the JAX ``AGDState``: one step count and, per
parameter, ``exp_avg`` and ``exp_avg_sq`` (and ``max_exp_avg_sq`` with
``amsgrad``). The group's ``retune_scale`` multiplies the whole update,
as the ``scale(retune_scale)`` that ``build_optimizer`` chains after it.

WSAM needs a second gradient at perturbed parameters, so it is a
gradient-function wrapper, as in the JAX package: ``make_wsam_grad_fn``
takes ``grad_fn(params, *args) -> (loss, grads)`` over a list of
tensors (``model_grad_fn`` makes one over the port's model loss) and
returns the WSAM gradients and the decoupled sharpness term, which
``apply_wsam_sharpness`` folds into an update. Everything here is
elementwise PyTorch; no kernel of the JAX package stands behind it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


class agd(torch.optim.Optimizer):
    """AGD (the JAX ``agd``; ATorch's ``AGD``): an Adam-shaped update
    whose second moment tracks the stepwise difference of the
    bias-corrected first moments. With ``m_t = b1 m + (1 - b1) g``,
    ``u_t = m_t / bc1_t - m_{t-1} / bc1_{t-1}`` (``m_1 / bc1_1`` at t=1),
    ``v_t = b2 v + (1 - b2) u_t^2``, the update is
    ``-lr sqrt(bc2_t) / bc1_t * m_t / max(sqrt(v_t), delta sqrt(bc2_t))``
    (clipped to ``clip``), then ``- lr wd p`` (decoupled decay)."""

    def __init__(
        self,
        params,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        delta: float = 1e-5,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        clip: Optional[float] = None,
    ):
        super().__init__(params, dict(lr=lr, retune_scale=1.0))
        if len(self.param_groups) != 1:
            raise ValueError("agd takes one param group")
        self.b1, self.b2, self.delta = b1, b2, delta
        self.weight_decay, self.amsgrad, self.clip = weight_decay, amsgrad, clip
        self.count = 0
        for p in self.param_groups[0]["params"]:
            st = self.state[p]
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
            if amsgrad:
                st["max_exp_avg_sq"] = torch.zeros_like(p)

    def _scalars(self, count: int):
        """(bc1_old, bc1, bc2) in f32, from the f32 step count."""
        cf = torch.tensor(float(count), dtype=torch.float32)
        bc1_old = 1.0 - self.b1 ** (cf - 1.0)  # 0 at t=1
        return bc1_old, 1.0 - self.b1**cf, 1.0 - self.b2**cf

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("agd takes no closure")
        group = self.param_groups[0]
        lr = torch.tensor(group["lr"], dtype=torch.float32)
        self.count += 1
        bc1_old, bc1, bc2 = self._scalars(self.count)
        denom_floor = self.delta * torch.sqrt(bc2)
        lr_adjust = lr * torch.sqrt(bc2) / bc1
        old_floor = torch.clamp_min(bc1_old, 1e-38)
        for p in group["params"]:
            if p.grad is None:
                raise ValueError("every parameter needs a gradient")
            g, st = p.grad, self.state[p]
            dev = p.device
            m_old = st["exp_avg"]
            m = self.b1 * m_old + (1.0 - self.b1) * g
            if self.count == 1:
                diff = m / bc1.to(dev)
            else:
                diff = m / bc1.to(dev) - m_old / old_floor.to(dev)
            v = self.b2 * st["exp_avg_sq"] + (1.0 - self.b2) * diff * diff
            if self.amsgrad:
                v_hat = torch.maximum(st["max_exp_avg_sq"], v)
                st["max_exp_avg_sq"] = v_hat
            else:
                v_hat = v
            u = m / torch.maximum(torch.sqrt(v_hat), denom_floor.to(dev))
            if self.clip is not None:
                u = torch.clamp(u, -self.clip, self.clip)
            upd = -lr_adjust.to(dev) * u
            if self.weight_decay:
                upd = upd - (lr * self.weight_decay).to(dev) * p
            if group["retune_scale"] != 1.0:
                upd = upd * float(group["retune_scale"])
            p.add_(upd)
            st["exp_avg"], st["exp_avg_sq"] = m, v
        return None


# ---------------------------------------------------------------------------
# WSAM
# ---------------------------------------------------------------------------
def _global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_wsam_grad_fn(
    grad_fn: Callable,
    *,
    rho: float = 0.05,
    gamma: float = 0.9,
    sam_eps: float = 1e-12,
    adaptive: bool = False,
    decouple: bool = True,
    grad_reduce: Optional[Callable] = None,
):
    """Wrap ``grad_fn(params, *args) -> (loss, grads)`` (lists of
    tensors) into WSAM's gradient function (the JAX
    ``make_wsam_grad_fn``): perturb to ``w + rho g / ||g||`` (times
    ``w^2`` with ``adaptive``), take the gradient there, and either blend
    (``decouple=False``: ``alpha g2 + (1 - alpha) g1``) or hand the base
    optimizer ``g1`` and return the sharpness ``alpha (g2 - g1)`` for
    ``apply_wsam_sharpness`` (``decouple=True``), with ``alpha = gamma /
    (1 - gamma)``. ``grad_reduce`` (e.g. an all-reduce mean over the data
    ranks) is applied to both gradients. Returns ``wsam_grad(params,
    *args) -> (loss, grads, sharpness)``; the sharpness is zeros when
    ``decouple=False``."""
    alpha = gamma / (1.0 - gamma)

    def wsam_grad(params: List[torch.Tensor], *args):
        loss, g1 = grad_fn(params, *args)
        if grad_reduce is not None:
            g1 = grad_reduce(g1)
        with torch.no_grad():
            if adaptive:
                norm = _global_norm([p * p * g for p, g in zip(params, g1)])
            else:
                norm = _global_norm(g1)
            scale = rho / (norm + sam_eps)
            perturbed = [
                p + (p * p if adaptive else 1.0) * g * scale
                for p, g in zip(params, g1)
            ]
        _, g2 = grad_fn(perturbed, *args)
        if grad_reduce is not None:
            g2 = grad_reduce(g2)
        with torch.no_grad():
            if decouple:
                return loss, g1, [alpha * (a - b) for a, b in zip(g2, g1)]
            blended = [alpha * a + (1.0 - alpha) * b for a, b in zip(g2, g1)]
            return loss, blended, [torch.zeros_like(g) for g in g1]

    return wsam_grad


def apply_wsam_sharpness(updates, sharpness, learning_rate: float):
    """Fold the decoupled sharpness term into optimizer updates:
    ``updates - lr * sharpness``."""
    return [u - learning_rate * s for u, s in zip(updates, sharpness)]


class _ModelLoss(torch.nn.Module):
    """The port's model loss as a module call, for ``functional_call``."""

    def __init__(self, model, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, tokens, targets):
        from dlrover_tpu_torch.models.transformer import loss_fn

        return loss_fn(self.model, tokens, targets, self.cfg)


def model_grad_fn(model, cfg) -> Callable:
    """``grad_fn(params, tokens, targets) -> (loss, grads)`` over the
    port's model loss (``models/transformer.loss_fn``), ``params`` a list
    in ``model.jax_ordered_parameters()``'s order: the model evaluated at
    those tensors in place of its own."""
    from torch.func import functional_call

    wrapper = _ModelLoss(model, cfg)
    names = {id(p): "model." + n for n, p in model.named_parameters()}
    order = [names[id(p)] for p in model.jax_ordered_parameters()]

    def grad_fn(params, tokens, targets):
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss = functional_call(wrapper, dict(zip(order, leaves)), (tokens, targets))
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    return grad_fn
