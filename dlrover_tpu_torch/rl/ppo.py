"""PPO for LM alignment: the RLHF engine (counterpart of
``dlrover_tpu/rl/ppo.py``).

Parity: atorch/rl/trainer (PPO trainer), rl/model_engine/model_engine.py
(actor/critic/ref/reward model management). Rollout and update run on
one device over the same weights, so the reference's hybrid-engine
train↔generate switch has nothing to do here.

Pieces:
- actor = the trained LM; ref = frozen copy (KL anchor); critic = value
  head over the actor's architecture (own params); reward_fn = any
  callable scoring full sequences (a learned reward model or a
  programmatic reward).
- KL-shaped per-token rewards (reward at the last token, minus
  kl_coef·KL everywhere), GAE(λ) advantages, clipped policy + value
  losses — the standard InstructGPT/trlx recipe the reference implements.

Two numbers follow the JAX package and not PyTorch's defaults: the
optimizer is optax's ``adamw(lr)`` (weight decay 1e-4, eps 1e-8;
``reward.optax_adamw``), and the advantage normalisation divides by the
population std (``std(correction=0)``, as ``jnp.std``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import forward, init_params
from dlrover_tpu_torch.rl.buffer import Experience, ReplayBuffer
from dlrover_tpu_torch.rl.generation import generate, sequence_logprobs
from dlrover_tpu_torch.rl.reward import HeadModel, init_head_model, optax_adamw, step_all
from dlrover_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class PPOConfig:
    rollout_batch: int = 8
    max_new_tokens: int = 16
    temperature: float = 1.0
    # restricted-support sampling for rollouts; PPO's importance ratio
    # stays centered on 1 because make_experience re-scores old
    # logprobs with the SAME full-support sequence_logprobs the update
    # uses (the sampler's masked logprobs are diagnostics only)
    top_k: int = 0  # 0 = keep all
    top_p: float = 1.0  # 1.0 = keep all
    kl_coef: float = 0.1
    gamma: float = 1.0
    lam: float = 0.95
    clip_ratio: float = 0.2
    value_clip: float = 0.2
    vf_coef: float = 0.5
    ppo_epochs: int = 2
    minibatch_size: int = 8
    learning_rate: float = 1e-5


def init_critic_params(generator: torch.Generator, cfg: TransformerConfig,
                       device=None) -> HeadModel:
    """Critic = transformer trunk + scalar value head."""
    return init_head_model(generator, cfg, "value_head", device)


def critic_values(cparams: HeadModel, tokens: torch.Tensor, cfg: TransformerConfig,
                  prompt_len: int) -> torch.Tensor:
    """Per-position values over the completion ``[B, N]`` (the value of
    the state *before* each generated token). The trunk IS the LM
    forward (``return_hidden`` skips the vocab projection), so critic
    math can never drift from the model path."""
    hidden, _ = forward(cparams.trunk, tokens, cfg, return_hidden=True)
    values = hidden.float() @ cparams.value_head
    return values[:, prompt_len - 1:-1]


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor, gamma: float, lam: float):
    """``[B, N]`` rewards/values (f32) -> (advantages, returns), standard
    GAE(λ), the JAX scan's recursion from the last token back."""
    B, N = rewards.shape
    adv_next = torch.zeros(B, dtype=rewards.dtype, device=rewards.device)
    advs = [None] * N
    for t in range(N - 1, -1, -1):
        v_next = values[:, t + 1] if t + 1 < N else torch.zeros_like(adv_next)
        delta = rewards[:, t] + gamma * v_next - values[:, t]
        adv_next = delta + gamma * lam * adv_next
        advs[t] = adv_next
    advantages = torch.stack(advs, 1)
    return advantages, advantages + values


class RLHFEngine:
    """Owns actor/ref/critic state and the rollout→train cycle. Runs on
    the card unless ``device="cpu"``."""

    def __init__(
        self,
        cfg: TransformerConfig,
        reward_fn: Callable[[np.ndarray, int], np.ndarray],
        ppo: Optional[PPOConfig] = None,
        seed: int = 0,
        train_mesh=None,
        rollout_mesh=None,
        device=None,
    ):
        if train_mesh is not None or rollout_mesh is not None:
            raise NotImplementedError(
                "hybrid placement (ZeRO-3 train mesh, replicated rollout mesh) "
                "is not ported yet (ROADMAP A14b)"
            )
        self.cfg = cfg
        self.ppo = ppo or PPOConfig()
        self.reward_fn = reward_fn
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        actor = init_params(gen, cfg, device=self.device)
        critic = init_critic_params(gen, cfg, self.device)
        self._rollout_gen = torch.Generator(device=self.device).manual_seed(seed + 99)
        self._np_rng = np.random.default_rng(seed)
        self.buffer = ReplayBuffer()
        self.set_params(actor, critic)

    def set_params(self, actor, critic, ref=None) -> None:
        """Take these weights (the ref a frozen copy of the actor unless
        given) with a fresh optimizer state, as the JAX ``tx.init``."""
        self.actor_params = actor.to(self.device)
        self.critic_params = critic.to(self.device)
        self.ref_params = copy.deepcopy(self.actor_params if ref is None else ref.to(self.device))
        self.ref_params.requires_grad_(False)
        self.opt = optax_adamw(
            list(self.actor_params.parameters()) + list(self.critic_params.parameters()),
            self.ppo.learning_rate)

    # -- rollout --------------------------------------------------------
    def make_experience(self, prompts) -> Experience:
        """Rollout + score + advantage (parity: trlx/atorch
        make_experience): generate with the actor, KL-shape rewards
        against the frozen ref, GAE with the critic."""
        prompts = torch.as_tensor(np.asarray(prompts)).to(self.device)
        P = prompts.shape[1]
        p = self.ppo
        tokens, _ = generate(self.actor_params, prompts, self._rollout_gen, self.cfg,
                             max_new_tokens=p.max_new_tokens, temperature=p.temperature,
                             top_k=p.top_k, top_p=p.top_p)
        # old-policy logprobs MUST come from the same scoring function
        # the update uses (full-support, temperature-1 sequence_logprobs):
        # generate()'s logprobs are the sampler's statistics
        with torch.no_grad():
            logprobs = sequence_logprobs(self.actor_params, tokens, self.cfg, P)
            ref_logprobs = sequence_logprobs(self.ref_params, tokens, self.cfg, P)
            values = critic_values(self.critic_params, tokens, self.cfg, P)
        tokens_np = tokens.cpu().numpy()
        # sequence-level reward lands on the final token; per-token KL
        # penalty shapes the rest (InstructGPT recipe)
        seq_reward = np.asarray(self.reward_fn(tokens_np, P), dtype=np.float32)
        kl = (logprobs - ref_logprobs).cpu().numpy()
        rewards = -p.kl_coef * kl
        rewards[:, -1] += seq_reward
        advantages, returns = gae_advantages(torch.from_numpy(rewards), values.cpu(),
                                             p.gamma, p.lam)
        exp = Experience(
            tokens=tokens_np,
            logprobs=logprobs.cpu().numpy(),
            ref_logprobs=ref_logprobs.cpu().numpy(),
            values=values.cpu().numpy(),
            rewards=rewards,
            advantages=advantages.numpy(),
            returns=returns.numpy(),
        )
        self.buffer.add(exp)
        return exp

    # -- update ---------------------------------------------------------
    def train(self, prompt_len: int, on_update: Optional[Callable[[dict], None]] = None) -> dict:
        """PPO epochs over the buffer; returns the last minibatch's
        metrics (``on_update`` sees every minibatch's, in order)."""
        metrics = {}
        params = {"actor": self.actor_params, "critic": self.critic_params}
        for _ in range(self.ppo.ppo_epochs):
            for mb in self.buffer.minibatches(self.ppo.minibatch_size, self._np_rng):
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in mb.items()}
                metrics = _ppo_update(params, self.opt, batch, prompt_len,
                                      cfg=self.cfg, ppo=self.ppo)
                if on_update is not None:
                    on_update({k: float(v) for k, v in metrics.items()})
        self.buffer.clear()
        return {k: float(v) for k, v in metrics.items()}


def ppo_loss(params, mb, prompt_len, *, cfg, ppo):
    """The clipped policy loss plus ``vf_coef`` x the clipped value loss
    on one minibatch; returns (loss, metrics)."""
    new_logprobs = sequence_logprobs(params["actor"], mb["tokens"], cfg, prompt_len)
    ratio = torch.exp(new_logprobs - mb["logprobs"])
    adv = mb["advantages"]
    # jnp.std is the population std
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - ppo.clip_ratio, 1 + ppo.clip_ratio) * adv
    policy_loss = -torch.minimum(pg1, pg2).mean()

    values = critic_values(params["critic"], mb["tokens"], cfg, prompt_len)
    v_clipped = mb["values"] + torch.clamp(values - mb["values"], -ppo.value_clip,
                                           ppo.value_clip)
    vf_loss = 0.5 * torch.maximum((values - mb["returns"]) ** 2,
                                  (v_clipped - mb["returns"]) ** 2).mean()
    loss = policy_loss + ppo.vf_coef * vf_loss
    metrics = {
        "loss": loss.detach(),
        "policy_loss": policy_loss.detach(),
        "value_loss": vf_loss.detach(),
        "approx_kl": (mb["logprobs"] - new_logprobs).mean().detach(),
        "clip_frac": ((ratio - 1).abs() > ppo.clip_ratio).float().mean().detach(),
    }
    return loss, metrics


def _ppo_update(params, opt, mb, prompt_len, *, cfg, ppo):
    """One optimizer step of ``opt`` (over the actor's and the critic's
    parameters) on ``ppo_loss``; returns the metrics of the params
    before the step, as the JAX ``_ppo_update``."""
    opt.zero_grad(set_to_none=True)
    loss, metrics = ppo_loss(params, mb, prompt_len, cfg=cfg, ppo=ppo)
    loss.backward()
    step_all(opt)
    return metrics
