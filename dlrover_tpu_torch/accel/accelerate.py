"""``auto_accelerate`` driver: candidates → dry run → winning step (the
port of ``dlrover_tpu/accel/accelerate.py``).

Parity: atorch accelerate.py:406 (``auto_accelerate``) and :34
(``model_transform``). The search is a pure function of (config, rank
count), so every rank derives the same winner; ``agree_strategy``
additionally pins it through the master KV store.

The port's entry takes ``device=`` (the card unless the caller asks for
the CPU) instead of a device list: the ranks are those of the default
process group, one card each. The step updates the state in place, so
there is no donating twin (``donating_step_fn`` is always None) and
``donate`` is accepted for the JAX signature only. ``before_update``
reaches the winner's ``build_train_step`` (the trainer's fence for a
checkpoint's copies).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace as dc_replace
from typing import Any, Callable, List, Optional, Sequence

from dlrover_tpu_torch.accel.candidates import candidate_strategies
from dlrover_tpu_torch.accel.dry_runner import DryRunReport, _build, _n_ranks, dry_run
from dlrover_tpu_torch.accel.opt_lib import get_optimization
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.config import TransformerConfig


@dataclass
class AccelerateResult:
    strategy: Strategy
    cfg: TransformerConfig  # config with the strategy's remat (and dtype opts) applied
    mesh: Any
    step_fn: Callable  # (state, x, y) -> (state, metrics); ``step_fn.plan`` its sync plan
    init_fn: Callable  # (seed, device_generator=False) -> TrainState
    reports: List[DryRunReport]
    # the JAX package's donating twin; None in the port (the step
    # updates the state in place)
    donating_step_fn: Optional[Callable] = None
    # the gradient-sync plan of the winner (None: the default path)
    plan: Any = None
    # wall seconds of the search (0.0 for a pinned strategy)
    search_s: float = 0.0


def auto_accelerate(
    cfg: TransformerConfig,
    tx,
    batch: int,
    seq: int,
    device=None,
    hbm_budget: Optional[float] = None,
    max_candidates: int = 16,
    max_timed: int = 3,
    strategy: Optional[Strategy] = None,
    donate: bool = True,
    search: str = "combination",
    optimizations: Sequence[str] = (),
    grad_accum: int = 1,
    grad_bucket_mb: Optional[int] = None,
    before_update: Optional[Callable[[], None]] = None,
    stamp: Optional[dict] = None,
) -> AccelerateResult:
    """Pick (or apply) a strategy and return the built artifacts.

    ``strategy`` short-circuits the search (the reference's
    ``load_strategy=`` path); otherwise candidates are generated for the
    process group's ranks and searched. ``search``: "combination"
    statically scores every candidate (``dry_runner.compiled_cost``:
    analytic cost and the static memory estimate) and times the
    finalists; "bayes" spends ``max_timed`` + 2 measured runs steered by
    a TPE. With ``hbm_budget`` and nothing fitting, the search is retried
    with remat; still nothing raises a ``RuntimeError`` naming the
    smallest need. On several ranks every rank searches (the dry runs are
    collective) and rank 0's winner is broadcast, so all build the same
    strategy. ``stamp``: Strategy fields set on the explicit strategy or
    on every candidate (knob values the name-only optimization registry
    cannot carry, such as the trainer's grad-sync knobs).
    """
    # fail fast on unknown names; actual application happens ONCE, in
    # _build (strategies only *record* opt names, so non-idempotent
    # registered opts can't compound across candidate/search/build)
    opt_names = tuple(dict.fromkeys(optimizations))
    for n in opt_names:
        get_optimization(n)
    reports: List[DryRunReport] = []
    search_s = 0.0
    if strategy is not None and opt_names:
        strategy = dc_replace(
            strategy,
            opts=tuple(dict.fromkeys(tuple(strategy.opts) + opt_names)),
        )
    # the sync bucket-size target is an integer the (name-only) opt
    # registry cannot carry — stamp it (and the caller's ``stamp``) onto
    # the explicit strategy or every candidate (same shape as grad_accum
    # below)
    fields = dict(stamp or {})
    if grad_bucket_mb is not None:
        fields["grad_bucket_mb"] = grad_bucket_mb
    if strategy is not None and fields:
        strategy = dc_replace(strategy, **fields)
    if grad_accum > 1 and batch % grad_accum:
        raise ValueError(
            f"batch {batch} must divide into grad_accum={grad_accum}"
        )
    if strategy is not None and grad_accum > 1:
        if strategy.mesh.pp > 1:
            # the pipeline's own microbatch schedule IS the accumulation
            # mechanism
            raise ValueError(
                "grad_accum does not apply to pipeline strategies — "
                "use num_microbatches"
            )
        unit = batch // grad_accum
        shards = strategy.mesh.dp * strategy.mesh.fsdp
        if unit % shards:
            raise ValueError(
                f"per-accumulation microbatch {unit} cannot shard over "
                f"dp*fsdp={shards} (most devices would compute padding)"
            )
        strategy = dc_replace(strategy, grad_accum=grad_accum)
    if strategy is None:
        t0 = time.time()
        n = _n_ranks(None)
        cands = candidate_strategies(
            cfg, n, batch, seq,
            max_candidates=max_candidates, grad_accum=grad_accum,
        )
        if not cands:
            raise ValueError(
                f"no valid mesh factorization for {n} ranks, "
                f"batch={batch}, seq={seq}"
            )
        if opt_names:
            cands = [dc_replace(s, opts=opt_names) for s in cands]
        if fields:
            cands = [dc_replace(s, **fields) for s in cands]

        def run_search(cands):
            if search == "bayes":
                from dlrover_tpu_torch.accel.bayes import tpe_search

                return tpe_search(
                    cands, cfg, tx, batch, seq, device,
                    budget=max_timed + 2, hbm_budget=hbm_budget,
                )
            if search == "combination":
                return dry_run(
                    cands, cfg, tx, batch, seq, device,
                    hbm_budget=hbm_budget, max_timed=max_timed,
                )
            raise ValueError(f"unknown search algorithm {search!r}")

        reports = run_search(cands)
        best = reports[0]
        if (
            not (best.ok and best.fits is not False)
            and hbm_budget
            and "remat" not in opt_names
        ):
            # nothing plain fits: retry with activation checkpointing
            # (FLOPs for memory — the reference's checkpoint
            # optimization). Lazy on purpose: when the plain candidates
            # fit, the extra dry runs never happen
            logger.info(
                "auto_accelerate: no plain candidate fits the memory "
                "budget; retrying the search with remat"
            )
            reports = run_search(
                [
                    dc_replace(s, opts=tuple(s.opts) + ("remat",))
                    for s in cands
                ]
            )
            best = reports[0]
        if not (best.ok and best.fits is not False):
            # fits=None means "no memory figure", not "needs 0 bytes"
            over = [
                r for r in reports
                if r.ok and r.fits is False and r.mem_bytes > 0
            ]
            detail = (
                f"smallest candidate needs {min(r.mem_bytes for r in over):.3e} "
                f"bytes vs budget {hbm_budget:.3e}"
                if over
                else f"best candidate error: {best.error}"
            )
            raise RuntimeError(
                f"no candidate strategy compiled within budget; {detail}"
            )
        strategy = _rank0_choice(best.strategy)
        search_s = time.time() - t0
        logger.info(
            f"auto_accelerate: picked {strategy.describe()} from "
            f"{len(cands)} candidates in {search_s:.1f}s "
            f"(measured {best.step_s}, est {best.est_step_s:.3e}s/step "
            f"[{best.est_source}])"
        )

    cfg2, mesh, step_fn, init_fn, _, _ = _build(
        strategy, cfg, tx, device, before_update=before_update
    )
    return AccelerateResult(
        strategy=strategy,
        cfg=cfg2,
        mesh=mesh,
        step_fn=step_fn,
        init_fn=init_fn,
        reports=reports,
        plan=step_fn.plan,
        search_s=search_s,
    )


def _rank0_choice(strategy: Strategy) -> Strategy:
    """Rank 0's winner on every rank (a broadcast over the default
    process group): the ranks' timings differ, and every rank must build
    the same mesh and step. Alone: ``strategy``."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return strategy
    box = [strategy.to_json()]
    dist.broadcast_object_list(box, src=0)
    return Strategy.from_json(box[0])


_STRATEGY_KEY = "auto_accelerate/strategy"


def agree_strategy(
    master_client,
    cfg: TransformerConfig,
    tx,
    batch: int,
    seq: int,
    timeout: float = 600.0,
    **kwargs,
) -> Strategy:
    """Cross-rank agreement on the winning strategy.

    Every rank must issue the same collectives, so all ranks run the
    identical search together (candidate order is deterministic, so they
    make the same dry runs in lockstep); only the *decision* is
    centralized: per-rank clock jitter could tie-break finalists
    differently, so rank 0's winner is published through the master KV
    store (``master_client``: the port's ``MasterClient``) under a key
    that counts the ranks, and every other rank adopts it, discarding its
    own pick."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    key = f"{_STRATEGY_KEY}/{world}"
    result = auto_accelerate(cfg, tx, batch, seq, **kwargs)
    if rank == 0:
        master_client.kv_store_set(
            key, result.strategy.to_json().encode()
        )
        return result.strategy
    deadline = time.time() + timeout
    while time.time() < deadline:
        raw = master_client.kv_store_get(key)
        if raw:
            return Strategy.from_json(raw.decode())
        time.sleep(1.0)
    raise TimeoutError(f"no strategy published under {key}")
