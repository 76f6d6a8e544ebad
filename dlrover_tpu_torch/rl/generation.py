"""Batched autoregressive generation with a static KV cache (counterpart
of ``dlrover_tpu/rl/generation.py``).

Parity: the reference's inference backend for RLHF rollouts
(atorch/rl/model_engine/model_engine.py generation path + its
vLLM-style backend). Prefill the prompt in one ``forward_step`` call,
then decode one token a step over the preallocated cache, written in
place; the weights are cast to the activation dtype once a rollout
(``decode_weights``).

Sampling takes an explicit ``torch.Generator`` and draws Gumbel-max, as
``jax.random.categorical`` does (a draw cannot match JAX's bit for bit:
the generators differ; the distributions and the greedy paths do).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import (
    Transformer,
    check_positions,
    decode_weights,
    forward,
    forward_step,
    init_kv_cache,
)


def _mask_logits(scaled: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Restrict the sampling support (vLLM-style knobs): ``top_k`` keeps
    the k best logits; ``top_p`` keeps the smallest prefix of the
    probability-sorted vocab whose mass reaches p (nucleus). Masked
    entries go to -inf BEFORE the softmax, so the returned logprobs stay
    the true behavior-policy logprobs. Top-k first, then the nucleus over
    the restricted renormalized distribution (the HF/vLLM composition
    order); the nucleus cutoff is never below the kth value, so its mask
    subsumes top-k's."""
    V = scaled.shape[-1]
    top_k = min(top_k, V) if top_k > 0 else 0  # clamp: keep-all
    neg = torch.tensor(float("-inf"), dtype=scaled.dtype, device=scaled.device)
    if top_p < 1.0:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        if top_k > 0:
            keep_k = torch.arange(V, device=scaled.device)[None, :] < top_k
            sorted_desc = torch.where(keep_k, sorted_desc, neg)
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep every token whose PRECEDING mass is < p (the boundary
        # token that crosses p stays in, per the nucleus definition)
        keep = cum - probs < top_p
        n_keep = keep.sum(-1)  # >= 1 always
        cutoff = sorted_desc.gather(-1, (n_keep - 1)[:, None])
        scaled = torch.where(scaled < cutoff, neg, scaled)
    elif top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, neg, scaled)
    return scaled


def check_sampling(top_k: int, top_p: float, temperature: float = 1.0,
                   greedy: bool = True) -> None:
    """The JAX entries' argument checks."""
    if not 0.0 < top_p <= 1.0:
        # top_p=0 silently meaning "keep all" has bitten people; the
        # near-greedy limit is top_p -> 0+, not 0
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not greedy and temperature <= 0.0:
        raise ValueError(f"temperature must be > 0 for sampling, got {temperature}")


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator], greedy: bool,
                  temperature: float, top_k: int, top_p: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``logits [B, V]`` -> (tokens [B] int64, their logprobs [B] f32)
    under the ACTUAL sampling distribution (temperature-scaled and
    support-restricted): PPO's behavior-policy logprobs. Sampling is
    Gumbel-max with noise from ``generator``."""
    if greedy:
        tok = torch.argmax(logits, dim=-1)
        scaled = logits
    else:
        scaled = _mask_logits(logits / temperature, top_k, top_p)
        u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                       dtype=torch.float32)
        # -log(-log(u)), with u kept off 0 as JAX's gumbel keeps it
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        tok = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    logp = torch.log_softmax(scaled, dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one decode step, derived from a seed and the step
    (the JAX engine's ``fold_in(key, step)``)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "rollout under a mesh (tp-sharded weights, dp-sharded cache) is not "
            "ported yet (ROADMAP A14b)"
        )


@torch.no_grad()
def generate(
    params: Transformer,
    prompt: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: TransformerConfig,
    max_new_tokens: int = 32,
    temperature: float = 1.0,
    greedy: bool = False,
    top_k: int = 0,
    top_p: float = 1.0,
    mesh=None,
    weights=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompt ``[B, P]`` -> (tokens ``[B, P+N]``, logprobs ``[B, N]``) on
    the prompt's device.

    ``logprobs`` are the BEHAVIOR-policy log-probs of each sampled token
    — computed under the actual sampling distribution
    (temperature-scaled, ``top_k``/``top_p``-restricted; 0 / 1.0 disable
    the restrictions). They are sampler diagnostics: a PPO consumer must
    record its old-policy logprobs with the SAME scoring function its
    update uses (``sequence_logprobs``), which the RLHF engine does.
    ``weights``: the params' ``decode_weights`` (cast here when not
    given). ``P + N`` past a learned position table raises
    ``ValueError``."""
    check_sampling(top_k, top_p)
    _no_mesh(mesh)
    B, P = prompt.shape
    N = max_new_tokens
    check_positions(cfg, P + N)
    w = decode_weights(params, cfg) if weights is None else weights
    cache = init_kv_cache(cfg, B, P + N, device=prompt.device)
    # prefill: one chunked call for the whole prompt
    last = forward_step(params, prompt, cfg, cache, 0, w)[:, -1]
    toks, logps = [], []
    for i in range(N):
        tok, tok_logp = sample_tokens(last, generator, greedy, temperature, top_k, top_p)
        toks.append(tok)
        logps.append(tok_logp)
        if i + 1 < N:  # the last token's logits are never read
            last = forward_step(params, tok[:, None], cfg, cache, P + i, w)[:, -1]
    tokens = torch.cat([prompt.long(), torch.stack(toks, 1)], dim=1).to(prompt.dtype)
    return tokens, torch.stack(logps, 1)


def sequence_logprobs(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    prompt_len: int,
) -> torch.Tensor:
    """Teacher-forced per-token log-probs of the completion part of
    ``tokens [B, P+N]`` -> ``[B, N]`` (the flash kernels on the card).
    Used for the reference-policy KL and for re-scoring under updated
    actor weights; differentiable."""
    logits, _ = forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    targets = tokens[:, 1:].long()
    tok_logp = logp.gather(-1, targets[..., None])[..., 0]
    return tok_logp[:, prompt_len - 1:]
