"""Job resource optimizer: runtime stats → resource/scale plans.

Parity: dlrover/python/master/resource/job.py:171
(``JobResourceOptimizer`` driving the auto-scaler) and
local_optimizer.py:66 (``PSLocalOptimizer`` heuristics over runtime
metrics: worker speed ratios, OOM recovery, hot-node detection). The
TPU job shape changes what is worth optimizing:

- worker count is slice-quantized and throughput-driven: scaling from N
  to M slices only pays if observed steps/sec actually scaled with the
  last size change (diminishing-returns detection, the analog of the
  reference's ``_compute_worker_speed_ratio``);
- per-worker memory is headroom-driven from observed usage (the OOM
  doubling lives in the job manager's relaunch path; this trims the
  other direction);
- the Brain seam is a callable: a cluster service can replace the local
  heuristics without touching the auto-scaler (parity: the
  ``BrainResoureOptimizer``/local split).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.log import default_logger as logger


# one shared notion of "scaling one step up was worth it": the larger
# size must buy at least this fraction of linear speedup. Used by BOTH
# the job-local scale-down heuristic and the Brain's cross-job
# cold-start sizing — tune it in one place.
DEFAULT_MIN_SPEEDUP_PER_UNIT = 0.6


def scaling_worth_it(
    prev_size: int,
    cur_size: int,
    prev_speed: float,
    cur_speed: float,
    min_speedup: float = DEFAULT_MIN_SPEEDUP_PER_UNIT,
) -> bool:
    """True when growing prev_size -> cur_size bought at least
    ``min_speedup`` of the linear throughput gain."""
    if prev_speed <= 0:
        return False
    actual = cur_speed / prev_speed
    linear = cur_size / prev_size
    return actual >= 1 + min_speedup * (linear - 1)


@dataclass
class ResourcePlan:
    """What the optimizer recommends (parity: common ResourcePlan)."""

    worker_count: Optional[int] = None
    worker_memory_mb: Optional[int] = None
    reason: str = ""
    # hostnames to schedule away from (Brain bad-node detection).
    # Tri-state: None = "no statement" (job-local plans — a Brain outage
    # falling back to local must NOT clear standing exclusions);
    # () = authoritative "nothing condemned" (clears stale exclusions).
    exclude_nodes: Optional[tuple] = None

    def empty(self) -> bool:
        return (
            self.worker_count is None
            and self.worker_memory_mb is None
            and not self.exclude_nodes
        )


class JobResourceOptimizer:
    def __init__(
        self,
        metric_collector=None,
        node_unit: int = 1,
        memory_headroom: float = 1.5,
        min_speedup_per_unit: float = DEFAULT_MIN_SPEEDUP_PER_UNIT,
        brain: Optional[Callable[[List[comm.JobMetricsSample]], ResourcePlan]] = None,
    ):
        self._collector = metric_collector
        self._node_unit = max(1, node_unit)
        self._memory_headroom = memory_headroom
        # scaling up one node-unit must buy at least this fraction of
        # linear speedup, else recommend scaling back down
        self._min_speedup = min_speedup_per_unit
        self._brain = brain
        # (node_count, steps_per_sec) observed at each stable size
        self._speed_by_size: Dict[int, float] = {}

    # -- observation ----------------------------------------------------
    def observe(self, sample: comm.JobMetricsSample):
        """Record throughput at the current world size (keep the best
        seen — transient dips must not poison the table)."""
        if sample.alive_nodes <= 0 or sample.steps_per_sec <= 0:
            return
        prev = self._speed_by_size.get(sample.alive_nodes, 0.0)
        self._speed_by_size[sample.alive_nodes] = max(
            prev, sample.steps_per_sec
        )

    # -- plans ----------------------------------------------------------
    def plan_from_samples(
        self, samples: List[comm.JobMetricsSample]
    ) -> ResourcePlan:
        """Run the local algorithm suite over a metric series (also the
        entry the Brain service calls for its stored series)."""
        for s in samples:
            self.observe(s)
        plan = ResourcePlan()
        self._check_scaling_efficiency(plan)
        self._check_memory(plan, samples)
        return plan

    def generate_plan(self) -> ResourcePlan:
        """Current recommendation from everything observed so far."""
        samples = (
            self._collector.snapshot().samples if self._collector else []
        )
        if self._brain is not None:
            try:
                return self._brain(samples)
            except Exception as e:
                logger.warning(f"brain optimizer failed, local: {e!r}")
        return self.plan_from_samples(samples)

    def _check_scaling_efficiency(self, plan: ResourcePlan):
        """Diminishing-returns: if the largest size's throughput gain
        over the previous size is under min_speedup × linear, recommend
        the smaller size (freeing slices for other jobs — the reference
        Brain's cluster-level goal)."""
        if len(self._speed_by_size) < 2:
            return
        sizes = sorted(self._speed_by_size)
        big, small = sizes[-1], sizes[-2]
        speed_big = self._speed_by_size[big]
        speed_small = self._speed_by_size[small]
        if speed_small <= 0:
            return
        actual = speed_big / speed_small
        linear = big / small
        if not scaling_worth_it(
            small, big, speed_small, speed_big, self._min_speedup
        ):
            # slice-align DOWNWARD: rounding up could re-recommend (or
            # exceed) the size already judged inefficient, turning a
            # scale-down into a no-op or a scale-UP
            want = max(
                self._node_unit, small - small % self._node_unit
            )
            if want >= big:
                return  # alignment ate the whole recommendation
            plan.worker_count = want
            plan.reason = (
                f"scaling {small}->{big} nodes bought only "
                f"{actual:.2f}x (linear {linear:.2f}x); recommend {want}"
            )

    def _check_memory(
        self, plan: ResourcePlan, samples: List[comm.JobMetricsSample]
    ):
        """Right-size memory requests to observed peak × headroom.
        Per-worker peak is the max over PER-SAMPLE ratios — pairing one
        sample's total with another's node count would understate it."""
        per_worker = max(
            (
                s.total_memory_mb / s.alive_nodes
                for s in samples
                if s.alive_nodes > 0
            ),
            default=0.0,
        )
        if per_worker > 0:
            plan.worker_memory_mb = int(
                per_worker * self._memory_headroom
            )

    def generate_oom_recovery_plan(
        self, current_memory_mb: int
    ) -> ResourcePlan:
        """Parity: local_optimizer.py:98 — double on OOM."""
        return ResourcePlan(
            worker_memory_mb=current_memory_mb * 2, reason="oom recovery"
        )
