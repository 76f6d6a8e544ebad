"""Trainable reward model for RLHF (counterpart of
``dlrover_tpu/rl/reward.py``).

Parity: the reference's reward model is one of the four managed models
in its RL engine (atorch/rl/model_engine/model_engine.py — actor /
critic / ref / reward), trained separately on preference pairs and then
frozen for PPO. Here the reward model is the same transformer trunk as
the actor/critic (``forward(..., return_hidden=True)`` — reward math can
never drift from the model path) with a scalar head read at each
sequence's LAST token, trained with the Bradley–Terry pairwise loss
-log σ(r_chosen − r_rejected) (the InstructGPT recipe).

The optimizer is optax's ``adamw(lr)`` of the JAX package: betas (0.9,
0.999), eps 1e-8 and weight decay 1e-4 on every leaf (PyTorch's AdamW
defaults to 1e-2).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import Transformer, forward, init_params
from dlrover_tpu_torch.utils.device import resolve_device

# optax.adamw's defaults, which the JAX engines take
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8


def optax_adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` over ``params``."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


class HeadModel(nn.Module):
    """A transformer trunk and one scalar head ``[D]`` (f32), the JAX
    ``{"trunk": params, <head_name>: head}`` tree: the RLHF critic
    (``value_head``) and the reward model (``reward_head``)."""

    def __init__(self, trunk: Transformer, head: torch.Tensor, head_name: str):
        super().__init__()
        self.trunk = trunk
        self.head_name = head_name
        self.register_parameter(head_name, nn.Parameter(head.float()))

    @property
    def head(self) -> torch.Tensor:
        return getattr(self, self.head_name)


def init_head_model(generator: torch.Generator, cfg: TransformerConfig, head_name: str,
                    device=None) -> HeadModel:
    """A trunk drawn as ``init_params`` draws one, then the head ``N(0,
    1/D)`` from the same generator."""
    trunk = init_params(generator, cfg, device=device)
    D = cfg.model_dim
    head = torch.randn((D,), generator=generator, device=generator.device) * D**-0.5
    return HeadModel(trunk, head.to(device), head_name)


def init_reward_params(generator: torch.Generator, cfg: TransformerConfig,
                       device=None) -> HeadModel:
    """Reward model = transformer trunk + scalar reward head."""
    return init_head_model(generator, cfg, "reward_head", device)


def reward_scores(rparams: HeadModel, tokens: torch.Tensor, cfg: TransformerConfig,
                  pad_token_id: Optional[int] = None) -> torch.Tensor:
    """tokens ``[B, T]`` -> scalar reward per sequence ``[B]`` (f32).

    The head reads the hidden state at each sequence's LAST REAL token:
    with ``pad_token_id`` set, the position before the first trailing
    pad (right-padding assumed — lengths count the non-pad tokens, so a
    pad id inside the sequence is the caller's bug). Without it, inputs
    must be unpadded fixed-length sequences and the final position is
    scored."""
    hidden, _ = forward(rparams.trunk, tokens, cfg, return_hidden=True)
    if pad_token_id is None:
        last = hidden[:, -1]
    else:
        idx = ((tokens != pad_token_id).long().sum(-1) - 1).clamp_min(0)
        last = hidden.gather(1, idx[:, None, None].expand(-1, 1, hidden.shape[-1]))[:, 0]
    return last.float() @ rparams.reward_head


def preference_loss(rparams: HeadModel, chosen, rejected, cfg: TransformerConfig,
                    pad_token_id: Optional[int] = None):
    """Bradley–Terry: -log σ(r_chosen − r_rejected), plus accuracy."""
    r_c = reward_scores(rparams, chosen, cfg, pad_token_id)
    r_r = reward_scores(rparams, rejected, cfg, pad_token_id)
    loss = -F.logsigmoid(r_c - r_r).mean()
    acc = (r_c > r_r).float().mean()
    return loss, acc


class RewardModel:
    """Preference-trained reward model + the ``reward_fn`` adapter the
    PPO engine consumes. Runs on the card unless ``device="cpu"``."""

    def __init__(self, cfg: TransformerConfig, lr: float = 1e-4, seed: int = 0,
                 pad_token_id: Optional[int] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pad_token_id = pad_token_id
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_reward_params(gen, cfg, self.device)
        self.lr = lr
        self.opt = optax_adamw(self.params.parameters(), lr)

    def set_params(self, params: HeadModel) -> None:
        """Take other weights (a fresh optimizer state, as the JAX
        engine's ``tx.init``)."""
        self.params = params.to(self.device)
        self.opt = optax_adamw(self.params.parameters(), self.lr)

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def train_on_preferences(self, chosen, rejected, epochs: int = 1) -> dict:
        """chosen/rejected ``[N, T]`` token pairs (chosen preferred).
        Returns the last step's {loss, accuracy}."""
        metrics = {}
        c, r = self._tokens(chosen), self._tokens(rejected)
        for _ in range(epochs):
            metrics = _reward_update(self.params, self.opt, c, r, cfg=self.cfg,
                                     pad_token_id=self.pad_token_id)
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def score(self, tokens) -> np.ndarray:
        return reward_scores(self.params, self._tokens(tokens), self.cfg,
                             self.pad_token_id).cpu().numpy()

    def as_reward_fn(self):
        """The (tokens, prompt_len) → [B] callable RLHFEngine takes —
        a TRAINED model behind the same seam a programmatic reward uses."""
        return lambda tokens, prompt_len: self.score(tokens)


def step_all(opt) -> None:
    """``opt.step()`` with a zero gradient for every parameter the loss
    did not reach (the trunk's unused vocab head): optax updates every
    leaf, its weight decay included, and PyTorch skips a parameter
    without a gradient."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def _reward_update(params: HeadModel, opt, chosen, rejected, *, cfg, pad_token_id=None):
    """One optimizer step on the Bradley–Terry loss; returns {loss,
    accuracy} of the params before the step (the JAX ``_reward_update``)."""
    opt.zero_grad(set_to_none=True)
    loss, acc = preference_loss(params, chosen, rejected, cfg, pad_token_id)
    loss.backward()
    step_all(opt)
    return {"loss": loss.detach(), "accuracy": acc.detach()}
