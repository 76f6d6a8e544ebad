"""Candidate strategy generation over mesh factorizations (a copy of
``dlrover_tpu/accel/candidates.py``; pure Python). Here a device is a
rank of the default process group: one card a process.

Parity: atorch's combination strategy generator
(auto/engine/sg_algo/combination_sg.py) enumerates optimization-method
combinations, and the MIP TP planner (auto/opt_lib/shard_planners/
mip_tp_planner.py:496) solves operator placement. On TPU the search space
is the *mesh factorization* itself: every ordered split of the device
count over (pp, dp, fsdp, ep, sp, tp) that respects the model's
divisibility constraints is a candidate; GSPMD handles placement inside
each choice. The generator prunes with the standard TPU priors:

- tp is capped (attention heads / ffn divisibility; TP collectives are
  per-layer, so huge tp only pays off when the model doesn't fit);
- sp only appears for long sequences (ring attention's ppermute pipeline
  needs enough sequence per shard to hide latency);
- pp only for deep models, with microbatches to amortize the bubble;
- ep only for MoE configs (ep divides num_experts).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.parallel.mesh import MeshConfig


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _tp_ok(cfg: TransformerConfig, tp: int) -> bool:
    return (
        cfg.num_heads % tp == 0
        and cfg.kv_heads % tp == 0
        and cfg.ffn_dim % tp == 0
        and cfg.vocab_size % tp == 0
    )


def candidate_strategies(
    cfg: TransformerConfig,
    n_devices: int,
    batch: int,
    seq: int,
    max_candidates: int = 32,
    dtype: Optional[str] = None,
    grad_accum: int = 1,
) -> List[Strategy]:
    """Enumerate valid mesh factorizations, best-prior first.

    ``grad_accum=K`` stamps K onto every non-pipeline candidate and
    tightens the batch-divisibility rule to the per-accumulation
    microbatch (batch/K must still shard over dp*fsdp) — accumulation
    microbatches smaller than the data-parallel axis would make every
    timed measurement run on padding. Pipeline candidates keep
    ``grad_accum=1``: their own microbatch schedule IS the
    accumulation mechanism.
    """
    dtype = dtype or cfg.dtype
    if batch % grad_accum:
        raise ValueError(
            f"batch {batch} must divide into grad_accum={grad_accum}"
        )
    long_context = seq >= 2048
    deep = cfg.num_layers >= 8
    out: List[Strategy] = []
    seen = set()

    for pp in _divisors(n_devices):
        if pp > 1 and (not deep or cfg.num_experts):
            continue
        if cfg.num_layers % pp != 0:
            continue
        rem_pp = n_devices // pp
        for tp in _divisors(rem_pp):
            if not _tp_ok(cfg, tp):
                continue
            if tp > max(cfg.kv_heads, 8):
                continue
            rem_tp = rem_pp // tp
            for sp in _divisors(rem_tp):
                if sp > 1 and (
                    not long_context
                    or pp > 1
                    or seq % sp != 0
                    or seq // sp < 128
                ):
                    continue
                rem_sp = rem_tp // sp
                for ep in _divisors(rem_sp):
                    if ep > 1 and (
                        not cfg.num_experts or cfg.num_experts % ep != 0
                    ):
                        continue
                    rem = rem_sp // ep
                    for fsdp in _divisors(rem):
                        dp = rem // fsdp
                        # the unit that must shard over dp*fsdp is the
                        # per-accumulation microbatch, not the batch
                        unit = batch if pp > 1 else batch // grad_accum
                        if unit % (dp * fsdp) != 0:
                            continue
                        mesh = MeshConfig(
                            dp=dp, fsdp=fsdp, tp=tp, sp=sp, ep=ep, pp=pp
                        )
                        # microbatches: amortize the pp bubble to <=20%
                        # (M >= 4(P-1)) within batch divisibility
                        if pp > 1:
                            mb = 1
                            for m in _divisors(batch // (dp * fsdp)):
                                if batch % m == 0 and (batch // m) % (
                                    dp * fsdp
                                ) == 0:
                                    mb = m
                                    if m >= 4 * (pp - 1):
                                        break
                            if mb < 2:
                                continue
                        else:
                            mb = 1
                        key = (dp, fsdp, tp, sp, ep, pp, mb)
                        if key in seen:
                            continue
                        seen.add(key)
                        out.append(
                            Strategy(
                                mesh=mesh,
                                dtype=dtype,
                                num_microbatches=mb,
                                grad_accum=1 if pp > 1 else grad_accum,
                                # sp candidates pick their scheme from
                                # the measured table (sp_select)
                                opts=("sp_auto",) if sp > 1 else (),
                            )
                        )
                        # deep models with few microbatches: the
                        # interleaved schedule shrinks the bubble
                        # ~v-fold (virtual stages need L % (pp*v) == 0)
                        if (
                            pp > 1
                            and mb < 4 * (pp - 1)
                            and cfg.num_layers % (pp * 2) == 0
                        ):
                            out.append(
                                Strategy(
                                    mesh=mesh,
                                    dtype=dtype,
                                    num_microbatches=mb,
                                    pp_schedule="interleaved",
                                    pp_virtual=2,
                                )
                            )

    out.sort(key=lambda s: _prior(s, cfg, batch, seq))
    return out[:max_candidates]


def _prior(s: Strategy, cfg: TransformerConfig, batch: int, seq: int):
    """Heuristic rank (lower = try first): prefer pure data-parallel
    forms, then fsdp (free memory win), then modest tp, then sp/pp —
    matching how often each wins on real TPU workloads."""
    m = s.mesh
    cost = 0.0
    cost += 0.1 * (m.fsdp > 1)  # fsdp is nearly-free ZeRO-3
    cost += 1.0 * (m.tp > 1) + 0.2 * m.tp
    cost += 2.0 * (m.sp > 1)
    cost += 3.0 * (m.pp > 1) + 0.5 * m.pp
    cost += 0.5 * (m.ep > 1)
    # shards-per-example pressure: tiny per-device batch starves the MXU
    per_dev_batch = batch / max(1, m.dp * m.fsdp * s.num_microbatches)
    if per_dev_batch < 1:
        cost += 10.0
    return cost
