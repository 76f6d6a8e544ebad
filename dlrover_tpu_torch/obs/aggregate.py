"""Master-side telemetry aggregation: per-worker step times, straggler
detection, hang attribution.

The master already knows the FLEET's speed (SpeedMonitor's sliding
window over the max global step) — what it cannot answer is *which
worker* is slow or *what* a stuck worker is doing. This module holds
the per-worker view:

- **step-time histograms** — one bounded window per worker, fed two
  ways: an explicit ``step_time_ms`` scalar when the worker reports it
  (the ElasticTrainer does, at log cadence), else derived from
  consecutive ``GlobalStepReport`` (Δtimestamp / Δstep). Explicit wins:
  once a worker has sent a real measurement the coarse derivation for
  that worker is ignored.
- **straggler detection** — a worker whose p50 step time exceeds
  ``ratio`` × the fleet median p50 (``ratio`` defaults to the
  ``straggler_time_ratio`` context knob) is flagged; newly-flagged
  workers are pushed to the Brain datastore through ``brain_reporter``
  (event ``"straggler"``, see brain/ingestion.straggler_sink) so the
  evidence survives this master, and the auto-scaler reads the flags
  off ``stragglers``.
- **hang attribution** — each worker's last reported open span (the
  SpanHeartbeat channel through the runtime-metrics file →
  TrainingMonitor → ``TrainMetricsReport``) is kept with its receipt
  time, so a hang report can say "worker 3 stuck in ckpt_commit for
  42s" instead of "no step progress".
- **step-budget attribution** — the per-component audit scalars
  (``dlrover_audit_*``, obs/audit.py) ride the same metrics channel;
  a straggler flag is upgraded from "worker 3 is slow" to "worker 3's
  dcn_sync is 2.4× its budget while its compute is on-price", and that
  *why* travels to the Brain in the straggler row's ``detail``.
"""

from __future__ import annotations

import re
import statistics
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs.goodput import (
    CATEGORIES as GOODPUT_CATEGORIES,
    compute_goodput_pct,
)

_ctx = Context.singleton_instance()

# a (derived or explicit) step-time sample longer than this is a stall
# artifact (restart, resize, rendezvous), not a speed signal
_MAX_SAMPLE_S = 3600.0

# the ledger scalars as they arrive through the runtime-metrics file ->
# TrainingMonitor -> TrainMetricsReport flattening, e.g.
# 'dlrover_goodput_seconds_total{category="ckpt_block"}'
_GOODPUT_SECONDS_RE = re.compile(
    r'^dlrover_goodput_seconds_total\{category="([a-z_]+)"\}$'
)
_GOODPUT_WALL_KEY = "dlrover_goodput_wall_seconds"

# the step-budget auditor's per-component scalars (obs/audit.py) ride
# the same flattened channel: the observed/budget ratio and the alarm
# latch per priced component, e.g.
# 'dlrover_audit_budget_ratio{component="dcn_sync"}'
_AUDIT_RATIO_RE = re.compile(
    r'^dlrover_audit_budget_ratio\{component="([a-z_]+)"\}$'
)
_AUDIT_ALARM_RE = re.compile(
    r'^dlrover_audit_alarm\{component="([a-z_]+)"\}$'
)
# a component within this band of its (drift-corrected) budget reads
# as "on-price" in the straggler attribution line
_AUDIT_ON_PRICE_BAND = (0.75, 1.25)


class TelemetryAggregator:
    def __init__(
        self,
        straggler_ratio: Optional[float] = None,
        window: int = 64,
        min_samples: int = 4,
        brain_reporter: Optional[Callable[[int, float, float], None]] = None,
    ):
        # > 1.0 multiple of the fleet median p50; the context knob is
        # the job-wide default, per-master override via the ctor
        self.straggler_ratio = float(
            straggler_ratio
            if straggler_ratio is not None
            else _ctx.straggler_time_ratio
        )
        self._window = max(int(window), 4)
        self._min_samples = max(int(min_samples), 1)
        self._brain_reporter = brain_reporter
        self._lock = threading.Lock()
        self._samples: Dict[int, Deque[float]] = {}
        self._explicit: set = set()  # workers with real step_time_ms
        self._last_report: Dict[int, Tuple[int, float]] = {}
        # worker -> (span name, elapsed_s at receipt, monotonic receipt)
        self._open_spans: Dict[int, Tuple[str, float, float]] = {}
        self._last_metrics: Dict[int, dict] = {}
        self._flagged: set = set()
        # worker -> {"wall_s": float, "seconds": {category: s}} — the
        # latest goodput-ledger snapshot each worker reported
        self._goodput: Dict[int, dict] = {}
        # worker -> {"ratio": {component: x}, "alarm": {component: 0/1}}
        # — the latest step-budget audit snapshot (obs/audit.py)
        self._audit: Dict[int, dict] = {}
        # straggler auto-profile: called once per newly-flagged worker
        # (the master wires this to queue a `profile` worker command)
        self._profile_requester: Optional[Callable[[int], None]] = None
        # deliberate-maintenance window (eviction drain, resize): new
        # straggler flags and hang forensics are suppressed while the
        # fleet is DESIGNED to be stalled
        self._maintenance_until = 0.0

    # -- maintenance window --------------------------------------------
    def note_maintenance(self, duration_s: float):
        """Declare the next ``duration_s`` a deliberate maintenance
        window (a resize or an eviction drain is in flight): straggler
        attribution must not flag workers for pausing on purpose, and
        the master's hang path must not aim ``flight_dump`` commands at
        healthy workers. Windows extend, never shrink."""
        with self._lock:
            self._maintenance_until = max(
                self._maintenance_until,
                time.monotonic() + float(duration_s),
            )

    def in_maintenance(self) -> bool:
        with self._lock:
            return time.monotonic() < self._maintenance_until

    # -- ingestion (servicer / speed-monitor hooks) --------------------
    def observe_step_report(
        self, worker_id: int, step: int, timestamp: float
    ):
        """Per-worker step-time derivation from the global-step channel
        (every worker reports; no trainer changes needed)."""
        if worker_id < 0:
            return
        with self._lock:
            prev = self._last_report.get(worker_id)
            self._last_report[worker_id] = (step, timestamp)
            if (
                prev is None
                or step <= prev[0]
                or timestamp <= prev[1]
                or worker_id in self._explicit
            ):
                return
            per_step = (timestamp - prev[1]) / (step - prev[0])
            if 0.0 < per_step <= _MAX_SAMPLE_S:
                self._bucket(worker_id).append(per_step)

    def observe_metrics(
        self,
        worker_id: int,
        step: int,
        metrics: Optional[dict] = None,
        open_span: str = "",
        open_span_elapsed_s: float = 0.0,
    ):
        """The TrainMetricsReport hook: explicit step-time samples plus
        the hang-attribution span snapshot."""
        if worker_id < 0:
            return
        metrics = metrics or {}
        with self._lock:
            if metrics:
                self._last_metrics[worker_id] = dict(metrics)
                self._ingest_goodput(worker_id, metrics)
                self._ingest_audit(worker_id, metrics)
            st_ms = metrics.get("step_time_ms")
            if st_ms is not None and st_ms > 0:
                if worker_id not in self._explicit:
                    # switch sources: coarse derived samples would skew
                    # the percentile the explicit channel now owns
                    self._explicit.add(worker_id)
                    self._samples.pop(worker_id, None)
                s = float(st_ms) / 1e3
                if s <= _MAX_SAMPLE_S:
                    self._bucket(worker_id).append(s)
            if open_span:
                self._open_spans[worker_id] = (
                    str(open_span),
                    float(open_span_elapsed_s),
                    time.monotonic(),
                )
            elif worker_id in self._open_spans:
                # the worker reported "nothing open": clear stale frames
                self._open_spans.pop(worker_id, None)

    def _ingest_goodput(self, worker_id: int, metrics: dict):
        """Pick the goodput-ledger scalars out of a metrics report
        (lock held by caller). Workers export absolute category seconds
        since their ledger started; the fleet view re-derives fractions
        so restarts (which reset a worker's ledger) stay consistent."""
        seconds: Dict[str, float] = {}
        wall = None
        for key, value in metrics.items():
            if key == _GOODPUT_WALL_KEY:
                wall = float(value)
                continue
            m = _GOODPUT_SECONDS_RE.match(key)
            if m and m.group(1) in GOODPUT_CATEGORIES:
                seconds[m.group(1)] = float(value)
        if wall is not None and wall > 0 and seconds:
            self._goodput[worker_id] = {
                "wall_s": wall, "seconds": seconds,
            }

    def _ingest_audit(self, worker_id: int, metrics: dict):
        """Pick the step-budget audit scalars out of a metrics report
        (lock held by caller): per-component observed/budget ratio plus
        the alarm latch. This is what upgrades a straggler flag from
        "worker 3 is slow" to "worker 3's dcn_sync is 2.4x its budget
        while its compute is on-price"."""
        ratio: Dict[str, float] = {}
        alarm: Dict[str, float] = {}
        for key, value in metrics.items():
            m = _AUDIT_RATIO_RE.match(key)
            if m:
                ratio[m.group(1)] = float(value)
                continue
            m = _AUDIT_ALARM_RE.match(key)
            if m:
                alarm[m.group(1)] = float(value)
        if ratio or alarm:
            self._audit[worker_id] = {"ratio": ratio, "alarm": alarm}

    def set_profile_requester(self, fn: Optional[Callable[[int], None]]):
        """``fn(worker_id)`` fires once per newly-flagged straggler —
        the master wires it to queue a ``profile`` worker command so a
        flagged worker ships jax.profiler evidence with its
        attribution (at most once per episode: recovery clears the
        flag, a relapse re-triggers)."""
        self._profile_requester = fn

    # -- goodput (fleet accounting) ------------------------------------
    def worker_goodput(self, worker_id: int) -> Optional[dict]:
        """Latest reported ledger snapshot for one worker:
        ``{"wall_s", "seconds": {category: s}, "goodput_pct"}``."""
        with self._lock:
            rec = self._goodput.get(worker_id)
        if rec is None:
            return None
        productive = rec["seconds"].get("productive_compute", 0.0)
        return {
            **rec,
            "goodput_pct": compute_goodput_pct(productive, rec["wall_s"]),
        }

    def fleet_goodput(self) -> Optional[dict]:
        """Wall-time-weighted fleet rollup — THE number ROADMAP item 1
        plans against: ``goodput_pct`` plus summed per-category
        seconds. None until any worker has reported its ledger."""
        with self._lock:
            recs = list(self._goodput.values())
        if not recs:
            return None
        wall = sum(r["wall_s"] for r in recs)
        seconds = {c: 0.0 for c in GOODPUT_CATEGORIES}
        for r in recs:
            for cat, s in r["seconds"].items():
                seconds[cat] = seconds.get(cat, 0.0) + s
        return {
            "wall_s": wall,
            "seconds": seconds,
            "goodput_pct": compute_goodput_pct(
                seconds.get("productive_compute", 0.0), wall
            ),
            "workers": len(recs),
        }

    # -- step-budget audit (fleet attribution) -------------------------
    def worker_audit(self, worker_id: int) -> Optional[dict]:
        """Latest audit snapshot for one worker:
        ``{"ratio": {component: x}, "alarm": {component: 0/1}}``."""
        with self._lock:
            rec = self._audit.get(worker_id)
        if rec is None:
            return None
        return {
            "ratio": dict(rec["ratio"]),
            "alarm": dict(rec["alarm"]),
        }

    def audit_alarms(self) -> Dict[int, List[str]]:
        """worker -> components with an active regression alarm — the
        fleet view of the auditor's CUSUM latches."""
        with self._lock:
            items = [
                (w, rec["alarm"]) for w, rec in self._audit.items()
            ]
        return {
            w: sorted(c for c, v in alarm.items() if v >= 1.0)
            for w, alarm in items
            if any(v >= 1.0 for v in alarm.values())
        }

    def audit_attribution(self, worker_id: int) -> str:
        """The per-component *why* behind a slow worker, from its last
        audit snapshot: names the components over budget (worst first,
        alarmed components always included) and contrasts with the
        on-price ones. Empty string when the worker never reported
        audit scalars — attribution then stays the bare time flag."""
        rec = self.worker_audit(worker_id)
        if rec is None:
            return ""
        lo, hi = _AUDIT_ON_PRICE_BAND
        over = sorted(
            (
                (c, r)
                for c, r in rec["ratio"].items()
                if r > hi or rec["alarm"].get(c, 0.0) >= 1.0
            ),
            key=lambda cr: -cr[1],
        )
        if not over:
            return ""
        on_price = sorted(
            c
            for c, r in rec["ratio"].items()
            if lo <= r <= hi and c not in {c for c, _ in over}
        )
        parts = [
            f"{c} is {r:.1f}x its budget"
            + (" [alarm]" if rec["alarm"].get(c, 0.0) >= 1.0 else "")
            for c, r in over
        ]
        line = ", ".join(parts)
        if on_price:
            line += f" while {', '.join(on_price)} " + (
                "are" if len(on_price) > 1 else "is"
            ) + " on-price"
        return line

    def remove_worker(self, worker_id: int):
        """A departed worker's history must not haunt the fleet median."""
        with self._lock:
            self._samples.pop(worker_id, None)
            self._explicit.discard(worker_id)
            self._last_report.pop(worker_id, None)
            self._open_spans.pop(worker_id, None)
            self._last_metrics.pop(worker_id, None)
            self._flagged.discard(worker_id)
            self._goodput.pop(worker_id, None)
            self._audit.pop(worker_id, None)

    def _bucket(self, worker_id: int) -> Deque[float]:
        b = self._samples.get(worker_id)
        if b is None:
            b = self._samples[worker_id] = deque(maxlen=self._window)
        return b

    # -- queries -------------------------------------------------------
    def worker_p50(self, worker_id: int) -> Optional[float]:
        with self._lock:
            samples = list(self._samples.get(worker_id, ()))
        if len(samples) < self._min_samples:
            return None
        return float(statistics.median(samples))

    def worker_step_times(self, worker_id: int) -> List[float]:
        with self._lock:
            return list(self._samples.get(worker_id, ()))

    def fleet_median(self) -> Optional[float]:
        """Median of the per-worker p50s (each worker one vote — a
        straggler's own slow samples must not drag the baseline up the
        way a pooled median would on small fleets)."""
        p50s = [
            p
            for p in (
                self.worker_p50(w) for w in self.workers()
            )
            if p is not None
        ]
        if not p50s:
            return None
        return float(statistics.median(p50s))

    def workers(self) -> List[int]:
        with self._lock:
            return sorted(self._samples.keys())

    # -- straggler detection -------------------------------------------
    def detect_stragglers(self) -> List[int]:
        """Workers whose p50 step time exceeds ``straggler_ratio`` × the
        fleet median p50. Newly flagged workers are reported to the
        Brain once per flagging episode (recovery clears the flag, so a
        relapse reports again). During a maintenance window (resize /
        eviction drain) the pass is a no-op: a deliberate fleet pause
        must not mint straggler verdicts or auto-profile commands."""
        if self.in_maintenance():
            return self.stragglers
        med = self.fleet_median()
        flagged: List[int] = []
        details: Dict[int, float] = {}
        if med is not None and med > 0 and len(self.workers()) >= 2:
            for w in self.workers():
                p50 = self.worker_p50(w)
                if p50 is not None and p50 > self.straggler_ratio * med:
                    flagged.append(w)
                    details[w] = p50
        with self._lock:
            new = [w for w in flagged if w not in self._flagged]
            self._flagged = set(flagged)
        for w in new:
            # the audit upgrade: when the worker ships step-budget
            # scalars the flag carries the component-level *why*
            why = self.audit_attribution(w)
            logger.warning(
                f"straggler: worker {w} p50 step time "
                f"{details[w] * 1e3:.0f} ms > {self.straggler_ratio}x "
                f"fleet median {med * 1e3:.0f} ms"
                + (f" — {why}" if why else "")
            )
            if self._brain_reporter is not None:
                try:
                    try:
                        self._brain_reporter(w, details[w], med, why)
                    except TypeError:
                        # pre-audit reporter contract (3-arg sinks)
                        self._brain_reporter(w, details[w], med)
                except Exception as e:
                    logger.warning(
                        f"straggler brain report failed: {e!r}"
                    )
            if self._profile_requester is not None:
                # once per episode (only NEW flags reach here): the
                # flagged worker ships profiler evidence with its
                # attribution
                try:
                    self._profile_requester(w)
                except Exception as e:
                    logger.warning(
                        f"straggler profile request failed: {e!r}"
                    )
        return sorted(flagged)

    @property
    def stragglers(self) -> List[int]:
        """Last detection pass's verdict (the auto-scaler's read side —
        call ``detect_stragglers`` to recompute)."""
        with self._lock:
            return sorted(self._flagged)

    # -- hang attribution ----------------------------------------------
    def last_open_span(
        self, worker_id: int
    ) -> Optional[Tuple[str, float]]:
        """(span name, elapsed_s advanced to NOW) of the worker's last
        reported open span."""
        with self._lock:
            rec = self._open_spans.get(worker_id)
        if rec is None:
            return None
        name, elapsed, received = rec
        return name, elapsed + (time.monotonic() - received)

    def hang_attribution(self) -> Dict[int, str]:
        """Per-worker one-liners for the hang report."""
        out: Dict[int, str] = {}
        with self._lock:
            workers = set(self._last_report) | set(self._open_spans)
        for w in sorted(workers):
            span = self.last_open_span(w)
            if span is not None:
                out[w] = f"stuck in {span[0]} for {span[1]:.0f}s"
            else:
                out[w] = "no open span reported"
        return out

    def describe_hang(self) -> str:
        """The enrichment line for 'job hanged' logs: every worker's
        last open span, stragglers called out."""
        attribution = self.hang_attribution()
        if not attribution:
            return "no per-worker telemetry"
        parts = [
            f"worker {w} {desc}" for w, desc in attribution.items()
        ]
        if self.stragglers:
            parts.append(f"stragglers={self.stragglers}")
        return "; ".join(parts)

    # -- registry export ------------------------------------------------
    def export(self, registry) -> None:
        """Per-worker p50s + fleet median into a MetricsRegistry (the
        master's Prometheus surface)."""
        g = registry.gauge(
            "dlrover_worker_step_time_p50_seconds",
            "per-worker median step time",
            labelnames=("worker",),
        )
        live = set()
        for w in self.workers():
            p50 = self.worker_p50(w)
            if p50 is not None:
                g.labels(str(w)).set(p50)
                live.add((str(w),))
        # prune departed workers' label children: a scaled-away worker
        # must not keep exposing its last p50 as a frozen ghost series
        with g._lock:
            for key in [k for k in g._children if k not in live]:
                del g._children[key]
        med = self.fleet_median()
        if med is not None:
            registry.gauge(
                "dlrover_fleet_step_time_median_seconds",
                "median of per-worker p50 step times",
            ).set(med)
        registry.gauge(
            "dlrover_straggler_count", "currently flagged stragglers"
        ).set(len(self.stragglers))
        # fleet view of the step-budget auditor's regression latches:
        # how many workers currently hold at least one component alarm
        registry.gauge(
            "dlrover_audit_alarm_workers",
            "workers with an active step-budget regression alarm",
        ).set(float(len(self.audit_alarms())))
        # fleet goodput accounting (the Brain objective + dashboards)
        fleet = self.fleet_goodput()
        gw = registry.gauge(
            "dlrover_goodput_worker_pct",
            "per-worker productive share of wall time, percent",
            labelnames=("worker",),
        )
        live_g = set()
        with self._lock:
            goodput_workers = sorted(self._goodput)
        for w in goodput_workers:
            rec = self.worker_goodput(w)
            if rec is not None:
                gw.labels(str(w)).set(rec["goodput_pct"])
                live_g.add((str(w),))
        with gw._lock:
            for key in [k for k in gw._children if k not in live_g]:
                del gw._children[key]
        if fleet is not None:
            registry.gauge(
                "dlrover_goodput_fleet_pct",
                "fleet productive share of wall time, percent",
            ).set(fleet["goodput_pct"])
            gc = registry.gauge(
                "dlrover_goodput_fleet_seconds_total",
                "fleet wall seconds attributed per goodput category",
                labelnames=("category",),
            )
            for cat, secs in fleet["seconds"].items():
                gc.labels(cat).set(secs)
