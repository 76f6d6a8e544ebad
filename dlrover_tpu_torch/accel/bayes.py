"""Bayesian strategy search: TPE over mesh factorizations (a copy of
``dlrover_tpu/accel/bayes.py``: with the same observations the TPE
proposes the same candidate). ``tpe_search`` times candidates through
the port's ``dry_runner.timed_run`` on ``device`` (the card unless the
caller asks for the CPU), in place of the JAX package's device list.

Parity: atorch's acceleration engine ships two strategy-generation
algorithms — exhaustive combination (sg_algo/combination_sg.py) and
Bayesian optimization over a vendored HEBO (sg_algo/bayes_opt_sg.py,
sg_algo/hebo/). The TPU equivalent of "which strategy to *measure*
next" is cheap to express as a Tree-structured Parzen Estimator over
the strategy's feature vector (log axis sizes, remat, microbatches,
dtype): no GP library, no acquisition optimizer — the candidate set is
finite, so the acquisition (good-density / bad-density ratio) is just
argmax over the untried candidates.

Where the combination path (`dry_run`) statically compiles EVERY
candidate and times the top few, the TPE path spends its budget on
*timed measurements only*, steered by the observations so far — the
right trade when the candidate list is large and compiles are slow
(big models), at the cost of no exhaustive fits-in-HBM table.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from dlrover_tpu_torch.accel.dry_runner import DryRunReport, hbm_fits, timed_run
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger


def strategy_features(s: Strategy) -> np.ndarray:
    m = s.mesh
    return np.array(
        [
            math.log2(max(m.dp, 1)),
            math.log2(max(m.fsdp, 1)),
            math.log2(max(m.tp, 1)),
            math.log2(max(m.sp, 1)),
            math.log2(max(m.pp, 1)),
            math.log2(max(m.ep, 1)),
            math.log2(max(s.num_microbatches, 1)),
            1.0 if s.remat else 0.0,
            1.0 if s.dtype == "bfloat16" else 0.0,
        ],
        dtype=np.float64,
    )


def _kde_logpdf(x: np.ndarray, obs: np.ndarray) -> float:
    """Diagonal-bandwidth Gaussian Parzen window log-density of ``x``
    under the observation set (rows of ``obs``)."""
    if len(obs) == 0:
        return 0.0
    bw = np.std(obs, axis=0) + 0.5  # wide floor: features are log2-ints
    z = (x[None, :] - obs) / bw
    logk = -0.5 * np.sum(z * z, axis=1) - np.sum(np.log(bw))
    mx = np.max(logk)
    return float(mx + np.log(np.mean(np.exp(logk - mx))))


def tpe_propose(
    tried: Sequence[Strategy],
    scores: Sequence[Optional[float]],
    pool: Sequence[Strategy],
    gamma: float = 0.34,
) -> Strategy:
    """Pick the untried candidate maximizing l(x)/g(x), where l models
    the best ``gamma`` fraction of observations and g the rest. Failed
    measurements (None) count as bad observations."""
    feats = [strategy_features(s) for s in tried]
    finite = [(f, sc) for f, sc in zip(feats, scores) if sc is not None]
    failed = [f for f, sc in zip(feats, scores) if sc is None]
    if finite:
        order = np.argsort([sc for _, sc in finite])
        n_good = max(1, int(np.ceil(gamma * len(finite))))
        good = np.array([finite[i][0] for i in order[:n_good]])
        bad_rows = [finite[i][0] for i in order[n_good:]] + failed
        bad = np.array(bad_rows) if bad_rows else np.empty((0, 9))
    else:
        good = np.empty((0, 9))
        bad = np.array(failed) if failed else np.empty((0, 9))

    def acq(s: Strategy) -> float:
        x = strategy_features(s)
        return _kde_logpdf(x, good) - _kde_logpdf(x, bad)

    return max(pool, key=acq)


def tpe_search(
    candidates: Sequence[Strategy],
    cfg,
    tx,
    batch: int,
    seq: int,
    device=None,
    budget: int = 6,
    n_init: int = 2,
    timed_steps: int = 3,
    hbm_budget: Optional[float] = None,
) -> List[DryRunReport]:
    """Measure up to ``budget`` candidates, the first ``n_init`` in prior
    order (candidate_strategies pre-sorts by the TPU priors) and the rest
    by TPE proposal. Returns reports best-first, measured entries first.
    """
    pool = list(candidates)
    tried: List[Strategy] = []
    scores: List[Optional[float]] = []
    mems: List[float] = []
    for i in range(min(budget, len(candidates))):
        if i < n_init:
            pick = pool[0]
        else:
            pick = tpe_propose(tried, scores, pool)
        pool.remove(pick)
        t, mem = timed_run(
            pick, cfg, tx, batch, seq, device, steps=timed_steps
        )
        logger.info(
            f"tpe_search[{i}]: {pick.describe()} -> "
            f"{'%.4fs/step' % t if t is not None else 'failed'}"
        )
        tried.append(pick)
        scores.append(t)
        mems.append(mem)
        if not pool:
            break

    reports = [
        DryRunReport(
            strategy=s,
            ok=sc is not None,
            step_s=sc,
            mem_bytes=mem,
            error=None if sc is not None else "timed run failed",
        )
        for s, sc, mem in zip(tried, scores, mems)
    ]
    # untried pool members are NOT ok: returning one as the winner would
    # hand production an unvalidated strategy (the combination path
    # raises in the same all-failed situation)
    reports += [
        DryRunReport(strategy=s, ok=False, error="not measured")
        for s in pool
    ]

    def rank(r: DryRunReport):
        if r.step_s is not None:
            return (0, r.step_s)
        return (1, 0.0)

    reports.sort(key=rank)
    if hbm_budget:
        # every measured report already carries mem_bytes from the very
        # run that was timed (timed_run's peak) — no second pass, and
        # no report keeps an unexamined default fits=True
        for r in reports:
            if r.step_s is None:
                continue
            # the one shared gate (dry_runner.hbm_fits): no memory
            # analysis -> None ("unknown"), still viable — the strategy
            # DID run its timed steps. Failing it here while the
            # combination path passes it would let the search-algorithm
            # choice flip pass/fail for one job.
            r.fits = hbm_fits(r.mem_bytes, hbm_budget)
        reports.sort(
            key=lambda r: (
                0 if (r.step_s is not None and r.fits) else
                1 if (r.step_s is not None and r.fits is None) else
                2 if r.step_s is not None else 3,
                r.step_s or 0.0,
            )
        )
    return reports
