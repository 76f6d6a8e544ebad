"""Step-budget reconciliation: priced-vs-observed, per component (a
copy of ``dlrover_tpu/obs/audit.py``).

The pricing side (``accel/dry_runner`` rooflines, the
``grad_sync.comm_time_legs_s`` sync legs priced from the measured
``parallel/topology.LinkModel``) and the span stream of the trainer
meet here:

- :class:`StepBudget` — the pricing side's per-component *predicted*
  seconds for one train step (``compute`` / ``ici_sync`` / ``dcn_sync``
  / ``host_xfer`` / ``data_wait``); components the plan does not price
  (``data_wait``, and ``compute`` in the trainer) are seeded from a
  warmup observation window.
- :class:`StepAuditor` — harvests the matching *observed* seconds from
  the span tracer each step (incremental ``drain`` cursor, the same
  contract as ``GoodputLedger``), computes signed per-component
  residuals, and feeds them to

  1. a per-component EWMA **drift estimator** (:class:`ComponentDrift`)
     that reprices rebalance plans by the component that actually
     drifted, persisted beside the link-model cache
     (``auditcal-<fp>.json``);
  2. a CUSUM-style **regression detector** (:class:`CusumDetector`)
     whose sustained alarms *name* the offending component, trigger a
     flight-recorder bundle, and ride the runtime-metrics file to the
     master.

In the port the ``compute`` span of a step is closed on a CUDA event
recorded after the optimizer and read once the card has passed it: it
holds the step's time on the device's clock, placed on the host's
clock. The host term (``host_xfer``) is priced by the host-link
arbiter (``transfer_sched.aggregate_host_exposed_s``: the registered
streams' standing demand through the link model's host leg, less the
measured hidden fraction), as in the JAX package.

Drift vs regression — the decision rule (docs/observability.md):
an observation within ``DRIFT_GATE``× of the drift-corrected budget is
treated as price drift and folded into the component's EWMA (no alarm);
an observation beyond the gate is withheld from the EWMA and feeds the
CUSUM on the drift-corrected normalized residual instead — sustained
excess raises the alarm. Mispricing heals silently; regressions alarm.

Observed-side mapping: components with per-step spans (``data_wait``,
``compute``, ``host_sync``) are clipped to each ``step`` window exactly
like the goodput ledger clips categories. The sync legs run *inside*
the ``compute`` span and have no per-step spans — the trainer
installs the standalone probe's measured leg times via
:meth:`StepAuditor.set_measured`, and the auditor deducts that share
from observed compute so the partition stays disjoint. ``OBSERVED`` is
the component→span-name registry, one entry per ``StepBudget`` field:
a newly priced component cannot silently go unmeasured.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs.trace import SpanTracer, get_tracer

# the priced/audited components, in export order. StepBudget carries
# one ``<component>_s`` field per entry; OBSERVED maps each to the span
# names that realize it.
COMPONENTS = ("compute", "ici_sync", "dcn_sync", "host_xfer", "data_wait")

# component -> span names whose step-window-clipped time observes it.
# ici/dcn sync: the per-step sync runs inside the ``compute`` span; these names only appear around the standalone measure probes,
# so per-step observation comes from ``set_measured`` and the listed
# spans matter when a probe lands inside a step window (rare) and for
# the coverage lint.
OBSERVED: Dict[str, Tuple[str, ...]] = {
    "compute": ("compute",),
    "ici_sync": ("grad_sync_ici",),
    "dcn_sync": ("grad_sync_dcn",),
    "host_xfer": ("host_sync",),
    "data_wait": ("data_wait",),
}

# EWMA weight for drift folding (matches the observed rail-rate cache's
# convergence character: ~4 samples to mostly adopt a new price)
DRIFT_EWMA_WEIGHT = 0.25

# an observation within this factor (either side) of the drift-
# corrected budget is price drift — folded, never alarmed. Beyond it,
# the EWMA is left alone and the CUSUM sees the full residual.
DRIFT_GATE = 2.0

# two-sided CUSUM parameters on the normalized residual
# r = (obs - pred*drift) / denom: per-step slack K is forgiven, the
# accumulated excess must cross H to alarm. With these values a
# sustained 2.5x regression alarms in ~3 steps; a 1.6x mispricing
# decays through the EWMA without ever crossing H.
CUSUM_K = 0.25
CUSUM_H = 3.0

# components where both prediction and observation sit under this are
# noise (an unpriced, unexercised leg) — skipped entirely
MIN_COMPONENT_S = 1e-3
# floor of the residual-normalization denominator, as a fraction of the
# whole step budget: gives unpriced components (data_wait's budget is
# legitimately ~0) a meaningful scale instead of an infinite ratio
DENOM_FLOOR_FRACTION = 0.05

# observed-seeded budgets average this many audited steps
WARMUP_STEPS = 5

# drift-cache persistence cadence (same best-effort durability contract
# as railrates-<fp>.json)
PERSIST_MIN_INTERVAL_S = 30.0

METRIC_PREFIX = "dlrover_audit_"


# ---------------------------------------------------------------------------
# budget


@dataclass
class StepBudget:
    """Predicted seconds per component for one train step. ``source``
    records provenance per component (``priced`` / ``measured`` /
    ``observed``) so an alarm report can say what the budget was
    anchored to."""

    compute_s: float = 0.0
    ici_sync_s: float = 0.0
    dcn_sync_s: float = 0.0
    host_xfer_s: float = 0.0
    data_wait_s: float = 0.0
    source: Dict[str, str] = field(default_factory=dict)

    def component(self, name: str) -> float:
        return float(getattr(self, name + "_s"))

    def set_component(self, name: str, seconds: float, source: str = ""):
        setattr(self, name + "_s", float(max(0.0, seconds)))
        if source:
            self.source[name] = source

    def total_s(self) -> float:
        return sum(self.component(c) for c in COMPONENTS)

    def as_dict(self) -> dict:
        d = {c + "_s": round(self.component(c), 6) for c in COMPONENTS}
        d["source"] = dict(self.source)
        return d


# ---------------------------------------------------------------------------
# drift estimator + persistence


@dataclass
class ComponentDrift:
    """Multiplicative price-drift EWMA for one component: the factor
    the priced seconds must be scaled by to match observation.
    ``seed()`` installs a first estimate from a single measurement (the
    dry-runner's one timed row) without EWMA damping, so the very first
    resize is already repriced."""

    factor: float = 1.0
    samples: int = 0

    def seed(self, ratio: float):
        if not ratio > 0.0:
            return
        if self.samples == 0:
            self.factor = float(ratio)
            self.samples = 1

    def fold(self, ratio: float, weight: float = DRIFT_EWMA_WEIGHT):
        if not ratio > 0.0:
            return
        if self.samples == 0:
            self.factor = float(ratio)
        else:
            self.factor = (1.0 - weight) * self.factor + weight * float(
                ratio
            )
        self.samples += 1


@dataclass
class AuditCalibration:
    """Persisted per-component drift snapshot, fingerprint-keyed like
    the probed LinkModel / observed rail-rate caches: a restart (or the
    next dry-run pricing pass) starts from the prices the last
    incarnation converged to, not from raw rooflines."""

    fingerprint: str = ""
    factors: Dict[str, float] = field(default_factory=dict)
    samples: Dict[str, int] = field(default_factory=dict)
    updated_at: float = 0.0

    def to_payload(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "factors": {k: float(v) for k, v in self.factors.items()},
            "samples": {k: int(v) for k, v in self.samples.items()},
            "updated_at": float(self.updated_at),
        }

    @staticmethod
    def from_payload(d: dict) -> "AuditCalibration":
        return AuditCalibration(
            fingerprint=str(d["fingerprint"]),
            factors={
                str(k): float(v) for k, v in dict(d["factors"]).items()
            },
            samples={
                str(k): int(v)
                for k, v in dict(d.get("samples", {})).items()
            },
            updated_at=float(d.get("updated_at", 0.0)),
        )


def audit_cal_path(
    fingerprint: str, dir_override: Optional[str] = None
) -> str:
    from dlrover_tpu_torch.parallel.topology import cache_dir

    import os

    return os.path.join(
        cache_dir(dir_override), f"auditcal-{fingerprint}.json"
    )


def load_audit_calibration(
    fingerprint: Optional[str] = None,
    dir_override: Optional[str] = None,
) -> Optional[AuditCalibration]:
    import json

    if fingerprint is None:
        try:
            from dlrover_tpu_torch.parallel.topology import device_fingerprint

            fingerprint = device_fingerprint()
        except Exception:  # no backend yet (early import paths)
            return None
    try:
        with open(audit_cal_path(fingerprint, dir_override)) as f:
            cal = AuditCalibration.from_payload(json.load(f))
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if cal.fingerprint != fingerprint:
        return None  # stale file copied across worlds
    return cal


def save_audit_calibration(
    cal: AuditCalibration, dir_override: Optional[str] = None
) -> Optional[str]:
    """Durable best-effort persist (fsync-before-rename); a read-only
    cache dir degrades to process-local drift, never to a failure."""
    path = audit_cal_path(cal.fingerprint, dir_override)
    try:
        from dlrover_tpu_torch.agent.monitor import atomic_write_json

        atomic_write_json(path, cal.to_payload(), durable=True)
        return path
    except OSError as e:
        logger.warning(f"audit calibration cache write failed: {e!r}")
        return None


# ---------------------------------------------------------------------------
# regression detector


class CusumDetector:
    """Two-sided CUSUM on the drift-corrected normalized residual.
    Only the positive (slower-than-budget) side raises the regression
    alarm — a component running persistently *faster* than its
    corrected price is mispricing, which the drift EWMA owns. The
    negative accumulator is still tracked so ``state()`` can report
    how far off-price the fast side is."""

    def __init__(self, k: float = CUSUM_K, h: float = CUSUM_H):
        self.k = float(k)
        self.h = float(h)
        self.pos = 0.0
        self.neg = 0.0

    def update(self, r: float) -> bool:
        """Fold one residual; True when the slow-side alarm fires
        (the accumulator resets so a persisting regression re-alarms
        only after re-accumulating — a built-in refire hysteresis)."""
        self.pos = max(0.0, self.pos + r - self.k)
        self.neg = max(0.0, self.neg - r - self.k)
        if self.pos > self.h:
            self.pos = 0.0
            return True
        return False

    def reset(self):
        self.pos = 0.0
        self.neg = 0.0

    def state(self) -> Tuple[float, float]:
        return self.pos, self.neg


# ---------------------------------------------------------------------------
# the auditor


@dataclass
class AuditStepResult:
    """One audited step: observed/predicted/residual seconds per
    component plus any alarms raised."""

    step_index: int = 0
    observed: Dict[str, float] = field(default_factory=dict)
    predicted: Dict[str, float] = field(default_factory=dict)
    residual: Dict[str, float] = field(default_factory=dict)
    ratio: Dict[str, float] = field(default_factory=dict)
    alarms: List[str] = field(default_factory=list)


class StepAuditor:
    """Incremental priced-vs-observed reconciler over a ``SpanTracer``.

    ``collect()`` is meant for log cadence (it drains only records
    appended since the previous call, grouping completed ``step`` spans
    on the train thread and window-clipping their children into
    component buckets). Thread-safe.

    ``on_alarm(component, ratio, detail)`` fires on each regression
    alarm — the trainer hangs a flight-recorder dump off it.
    """

    def __init__(
        self,
        tracer: Optional[SpanTracer] = None,
        tid_fn: Optional[Callable[[], Optional[int]]] = None,
        budget: Optional[StepBudget] = None,
        on_alarm: Optional[Callable[[str, float, str], None]] = None,
        drift_weight: float = DRIFT_EWMA_WEIGHT,
        cusum_k: float = CUSUM_K,
        cusum_h: float = CUSUM_H,
    ):
        # `is None`, not truthiness — SpanTracer defines __len__ (the
        # footgun SpanHeartbeat/GoodputLedger both document)
        self._tracer = tracer if tracer is not None else get_tracer()
        self._tid_fn = tid_fn
        self._on_alarm = on_alarm
        self._drift_weight = float(drift_weight)
        self._lock = threading.Lock()
        self._cursor = 0
        self._dropped = 0
        # completed records not yet claimed by a completed ``step``
        # span (children of an in-flight step drain before their parent
        # does; they are held here until the step record arrives)
        self._held: List[tuple] = []
        self._held_cap = 8192
        self._budget = budget if budget is not None else StepBudget()
        self.drift: Dict[str, ComponentDrift] = {
            c: ComponentDrift() for c in COMPONENTS
        }
        self._cusum: Dict[str, CusumDetector] = {
            c: CusumDetector(cusum_k, cusum_h) for c in COMPONENTS
        }
        # probe-measured per-step seconds for span-less components
        # (the sync legs); deducted from observed compute
        self._measured: Dict[str, float] = {}
        self._steps_audited = 0
        self._last: Optional[AuditStepResult] = None
        self._alarm_active: Dict[str, bool] = {c: False for c in COMPONENTS}
        self._alarm_clear: Dict[str, int] = {c: 0 for c in COMPONENTS}
        self._alarms_total: Dict[str, int] = {c: 0 for c in COMPONENTS}
        # warmup accumulation for observed-seeded budgets
        self._warmup_sum: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        self._warmup_n = 0
        self._persisted_samples = -1
        self._persisted_ts = 0.0

    # -- configuration -------------------------------------------------
    def set_budget(self, budget: StepBudget, reset_detectors: bool = True):
        """Install a new budget (setup / after resize). Detectors reset
        by default: the old accumulation was against the old prices."""
        with self._lock:
            self._budget = budget
            if reset_detectors:
                for det in self._cusum.values():
                    det.reset()
                self._alarm_active = {c: False for c in COMPONENTS}
                self._alarm_clear = {c: 0 for c in COMPONENTS}
            self._warmup_sum = {c: 0.0 for c in COMPONENTS}
            self._warmup_n = 0

    def budget(self) -> StepBudget:
        with self._lock:
            return replace(
                self._budget, source=dict(self._budget.source)
            )

    def set_measured(self, component: str, seconds: float):
        """Install a probe-measured per-step observation for a
        component without per-step spans (``ici_sync``/``dcn_sync``
        from ``measure_sync_legs_ms``)."""
        if component not in COMPONENTS:
            raise ValueError(f"unknown component {component!r}")
        with self._lock:
            self._measured[component] = float(max(0.0, seconds))

    def skip_to_now(self):
        """Drop every already-recorded span from audit consideration
        (called across a resize: spans from the old incarnation must
        not be reconciled against the new budget)."""
        with self._lock:
            _records, self._cursor, dropped = self._tracer.drain(
                self._cursor
            )
            self._dropped += dropped
            self._held = []

    # -- drift calibration seams --------------------------------------
    def drift_factors(self) -> Dict[str, float]:
        with self._lock:
            return {c: self.drift[c].factor for c in COMPONENTS}

    def seed_drift(self, component: str, ratio: float):
        """Seed one component's drift from a single out-of-band
        measurement (the dry-runner's timed row); a no-op once real
        observations exist."""
        if component not in COMPONENTS:
            raise ValueError(f"unknown component {component!r}")
        with self._lock:
            self.drift[component].seed(ratio)

    def apply_calibration(self, cal: AuditCalibration):
        """Adopt a persisted drift snapshot — only for components this
        process has not observed yet (live EWMAs outrank disk)."""
        with self._lock:
            for c in COMPONENTS:
                f = cal.factors.get(c)
                if f is not None and self.drift[c].samples == 0:
                    self.drift[c].factor = float(f)
                    self.drift[c].samples = int(
                        cal.samples.get(c, 1)
                    ) or 1

    def calibration(self, fingerprint: str = "") -> AuditCalibration:
        with self._lock:
            return AuditCalibration(
                fingerprint=fingerprint,
                factors={
                    c: self.drift[c].factor
                    for c in COMPONENTS
                    if self.drift[c].samples > 0
                },
                samples={
                    c: self.drift[c].samples
                    for c in COMPONENTS
                    if self.drift[c].samples > 0
                },
                updated_at=time.time(),
            )

    def persist(
        self,
        fingerprint: Optional[str] = None,
        dir_override: Optional[str] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Rate-limited best-effort persist of the drift snapshot
        beside ``railrates-<fp>.json`` (only when new samples arrived
        since the last write)."""
        if fingerprint is None:
            try:
                from dlrover_tpu_torch.parallel.topology import (
                    device_fingerprint,
                )

                fingerprint = device_fingerprint()
            except Exception:
                return None
        with self._lock:
            total = sum(d.samples for d in self.drift.values())
            now = time.time()
            if not force and (
                total == self._persisted_samples
                or now - self._persisted_ts < PERSIST_MIN_INTERVAL_S
            ):
                return None
            self._persisted_samples = total
            self._persisted_ts = now
        return save_audit_calibration(
            self.calibration(fingerprint), dir_override
        )

    # -- introspection -------------------------------------------------
    @property
    def steps_audited(self) -> int:
        with self._lock:
            return self._steps_audited

    @property
    def dropped_records(self) -> int:
        with self._lock:
            return self._dropped

    def last_result(self) -> Optional[AuditStepResult]:
        with self._lock:
            return self._last

    def alarm_components(self) -> List[str]:
        with self._lock:
            return [c for c in COMPONENTS if self._alarm_active[c]]

    def alarms_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._alarms_total)

    # -- collection ----------------------------------------------------
    def collect(self) -> List[AuditStepResult]:
        """Drain new records, audit every newly completed ``step``
        span, return the per-step results (empty when no step
        finished since the last call)."""
        alarm_cbs: List[Tuple[str, float, str]] = []
        with self._lock:
            records, self._cursor, dropped = self._tracer.drain(
                self._cursor
            )
            self._dropped += dropped
            tid = self._tid_fn() if self._tid_fn is not None else None
            held = self._held
            held.extend(records)
            results: List[AuditStepResult] = []
            last_step_seq = -1
            for rec in held:
                name, rtid, start, dur, depth, _attrs, seq = rec
                if name != "step" or (tid is not None and rtid != tid):
                    continue
                obs = self._observe_window(
                    held, rtid, start, start + dur, depth
                )
                res = self._audit_step(obs, alarm_cbs)
                results.append(res)
                last_step_seq = seq
            if last_step_seq >= 0:
                # children of completed steps are claimed; anything
                # newer may belong to an in-flight step — hold it
                held[:] = [r for r in held if r[6] > last_step_seq]
            if len(held) > self._held_cap:
                # bound memory when no step spans flow (a non-trainer
                # process sharing the tracer): keep the fresh tail
                del held[: len(held) - self._held_cap]
            if results:
                self._last = results[-1]
        for component, ratio, detail in alarm_cbs:
            # callbacks run outside the lock: a flight dump inside it
            # could deadlock against another thread's collect/export
            if self._on_alarm is not None:
                try:
                    self._on_alarm(component, ratio, detail)
                except Exception:
                    pass  # forensics must never hurt training
        return results

    def _observe_window(
        self,
        held: List[tuple],
        tid: int,
        lo: int,
        hi: int,
        parent_depth: int,
    ) -> Dict[str, float]:
        """Component seconds observed inside one step window: direct
        children (same tid, depth parent+1) clipped to the window and
        overlap-merged per component — a span straddling the window
        edge (e.g. across a mesh rebuild) contributes only its inside
        portion, never double-counts into a neighbor step."""
        span_comp: Dict[str, str] = {}
        for comp, names in OBSERVED.items():
            for n in names:
                span_comp[n] = comp
        per: Dict[str, List[Tuple[int, int]]] = {}
        for name, rtid, start, dur, depth, _attrs, _seq in held:
            comp = span_comp.get(name)
            if comp is None or rtid != tid:
                continue
            if depth != parent_depth + 1:
                continue
            a, b = max(start, lo), min(start + dur, hi)
            if b > a:
                per.setdefault(comp, []).append((a, b))
        obs: Dict[str, float] = {}
        for comp, ivs in per.items():
            total = 0.0
            end = float("-inf")
            for s, e in sorted(ivs):
                if e <= end:
                    continue
                total += e - max(s, end)
                end = e
            obs[comp] = total / 1e9
        return obs

    def _audit_step(
        self,
        obs: Dict[str, float],
        alarm_cbs: List[Tuple[str, float, str]],
    ) -> AuditStepResult:
        """Reconcile one step's observation against the budget (caller
        holds the lock)."""
        # sync legs observe via the standalone probe unless probe spans
        # landed inside this very window; the measured share is then
        # deducted from the compute span it runs inside of
        deduct = 0.0
        for leg in ("ici_sync", "dcn_sync"):
            if leg not in obs and leg in self._measured:
                obs[leg] = self._measured[leg]
                deduct += self._measured[leg]
        if deduct and "compute" in obs:
            obs["compute"] = max(0.0, obs["compute"] - deduct)

        self._steps_audited += 1
        res = AuditStepResult(step_index=self._steps_audited)
        budget = self._budget
        self._warmup_n += 1
        # the first steps after a (re)budget are the baseline window:
        # observed-seeded components have no budget yet and priced ones
        # are still settling post-compile — drift may fold, but the
        # regression detector stays quiet until the baseline exists
        in_warmup = self._warmup_n <= WARMUP_STEPS
        corr_total = sum(
            budget.component(c) * self.drift[c].factor
            for c in COMPONENTS
        )
        denom_floor = max(
            MIN_COMPONENT_S, DENOM_FLOOR_FRACTION * corr_total
        )
        for c in COMPONENTS:
            o = float(obs.get(c, 0.0))
            pred = budget.component(c)
            self._warmup_sum[c] += o
            # observed-seeded budget: a component the plan did not
            # price adopts its warmup-window mean as the budget — the
            # baseline later regressions are judged against
            if pred <= 0.0 and self._warmup_n == WARMUP_STEPS:
                mean = self._warmup_sum[c] / WARMUP_STEPS
                if mean >= MIN_COMPONENT_S:
                    budget.set_component(c, mean, source="observed")
            dr = self.drift[c]
            pred_corr = pred * dr.factor
            res.observed[c] = o
            res.predicted[c] = pred_corr
            res.residual[c] = o - pred_corr
            if max(o, pred_corr) < MIN_COMPONENT_S:
                res.ratio[c] = 1.0
                continue  # unexercised leg: noise, not evidence
            denom = max(pred_corr, denom_floor)
            res.ratio[c] = o / denom if denom > 0 else 0.0
            ratio_corr = o / pred_corr if pred_corr > 0 else float(
                "inf"
            )
            if (
                pred >= MIN_COMPONENT_S
                and 1.0 / DRIFT_GATE <= ratio_corr <= DRIFT_GATE
            ):
                # plausibly mispriced, not broken: heal the price
                dr.fold(o / pred, weight=self._drift_weight)
                pred_corr = pred * dr.factor
                denom = max(pred_corr, denom_floor)
            if in_warmup:
                continue
            r = (o - pred_corr) / denom
            fired = self._cusum[c].update(r)
            if fired:
                self._alarms_total[c] += 1
                self._alarm_clear[c] = 0
                ratio = o / pred_corr if pred_corr > 0 else res.ratio[c]
                detail = (
                    f"{c} observed {o * 1e3:.1f}ms vs budget "
                    f"{pred_corr * 1e3:.1f}ms ({ratio:.2f}x, "
                    f"source={budget.source.get(c, 'priced')})"
                )
                res.alarms.append(c)
                if not self._alarm_active[c]:
                    self._alarm_active[c] = True
                    alarm_cbs.append((c, ratio, detail))
                logger.warning(f"audit regression alarm: {detail}")
            elif self._alarm_active[c]:
                if r <= self._cusum[c].k:
                    self._alarm_clear[c] += 1
                    if self._alarm_clear[c] >= 3:
                        self._alarm_active[c] = False
                        self._alarm_clear[c] = 0
                else:
                    self._alarm_clear[c] = 0
        return res

    # -- export --------------------------------------------------------
    def export(self, registry) -> Optional[AuditStepResult]:
        """Collect + publish the ``dlrover_audit_*`` series. The
        trainer calls this at log cadence so the scalars ride the
        runtime-metrics file to the master like every other registry
        number."""
        results = self.collect()
        with self._lock:
            last = self._last
            if last is None:
                return None
            g_res = registry.gauge(
                METRIC_PREFIX + "residual_seconds",
                "last-step observed minus drift-corrected budget, "
                "seconds (signed)",
                labelnames=("component",),
            )
            g_obs = registry.gauge(
                METRIC_PREFIX + "observed_seconds",
                "last-step observed seconds per audited component",
                labelnames=("component",),
            )
            g_bud = registry.gauge(
                METRIC_PREFIX + "budget_seconds",
                "drift-corrected per-step budget seconds per component",
                labelnames=("component",),
            )
            g_drift = registry.gauge(
                METRIC_PREFIX + "drift_factor",
                "per-component price-drift EWMA factor "
                "(observed/priced)",
                labelnames=("component",),
            )
            g_ratio = registry.gauge(
                METRIC_PREFIX + "budget_ratio",
                "last-step observed over drift-corrected budget "
                "(floored denominator)",
                labelnames=("component",),
            )
            g_alarm = registry.gauge(
                METRIC_PREFIX + "alarm",
                "1 while a sustained regression alarm is active for "
                "the component",
                labelnames=("component",),
            )
            h_ratio = registry.histogram(
                METRIC_PREFIX + "step_ratio",
                "distribution of per-step observed/budget ratios "
                "across audited components",
            )
            for c in COMPONENTS:
                g_res.labels(c).set(last.residual.get(c, 0.0))
                g_obs.labels(c).set(last.observed.get(c, 0.0))
                g_bud.labels(c).set(last.predicted.get(c, 0.0))
                g_drift.labels(c).set(self.drift[c].factor)
                g_ratio.labels(c).set(last.ratio.get(c, 0.0))
                g_alarm.labels(c).set(
                    1.0 if self._alarm_active[c] else 0.0
                )
            for res in results:
                for c in COMPONENTS:
                    if res.ratio.get(c):
                        h_ratio.observe(res.ratio[c])
            registry.gauge(
                METRIC_PREFIX + "steps_total",
                "train steps reconciled by the step auditor",
            ).set(float(self._steps_audited))
            return last


# ---------------------------------------------------------------------------
# process-default auditor (the dry-runner's repricing reaches the live
# drift estimate without holding a trainer reference)

_default: Optional[StepAuditor] = None
_default_lock = threading.Lock()
# dry-run seeded factors used before any trainer installs an auditor
_seeded_factors: Dict[str, float] = {}


def install_default_auditor(auditor: StepAuditor) -> StepAuditor:
    global _default
    with _default_lock:
        _default = auditor
        for c, f in _seeded_factors.items():
            auditor.seed_drift(c, f)
    return auditor


def default_auditor() -> Optional[StepAuditor]:
    return _default


def seed_default_drift(component: str, ratio: float):
    """Dry-runner seam: record a single-measurement drift seed so the
    factor survives until (and into) the trainer's auditor."""
    if component not in COMPONENTS or not ratio > 0.0:
        return
    with _default_lock:
        aud = _default
        if aud is not None:
            aud.seed_drift(component, ratio)
        elif component not in _seeded_factors:
            _seeded_factors[component] = float(ratio)


def current_drift_factors() -> Dict[str, float]:
    """The best per-component drift estimate this process has: the
    live auditor's EWMAs, overlaid on the persisted calibration,
    overlaid on any dry-run seeds. Missing components price at 1.0."""
    factors: Dict[str, float] = {c: 1.0 for c in COMPONENTS}
    cal = load_audit_calibration()
    if cal is not None:
        factors.update(cal.factors)
    with _default_lock:
        factors.update(_seeded_factors)
        aud = _default
    if aud is not None:
        for c, d in aud.drift.items():
            if d.samples > 0:
                factors[c] = d.factor
    return factors


def reset_default_auditor():
    """Test seam: forget the installed auditor and dry-run seeds."""
    global _default
    with _default_lock:
        _default = None
        _seeded_factors.clear()
