"""Goodput ledger: attribute EVERY second of a worker's wall time to one
bucket (a copy of ``dlrover_tpu/obs/goodput.py``).

Wall time since the ledger started is partitioned into the taxonomy
below from the span stream; the categories sum back to wall time (the
**closure invariant**: ``closure_error_pct`` stays under
``CLOSURE_GATE_PCT``), and the goodput fraction is exported as
``dlrover_goodput_*`` gauges that ride the runtime-metrics file to the
master, whose ``TelemetryAggregator`` (``obs/aggregate.py``) rolls them
up per worker and for the fleet.

Taxonomy (priority order — an instant claimed by a higher row is
subtracted from every lower row, so the partition is disjoint):

| category            | claimed by                                     |
|---------------------|------------------------------------------------|
| eviction            | ``eviction_begin()``..``end()`` episodes: the  |
|                     | grace-window drain after a preemption notice   |
|                     | (claims the emergency-checkpoint spans inside) |
| resize_downtime     | ``resize_drain/build/reshard/compile`` spans   |
| restart_replay      | ``replay_begin()``..``replay_end()`` episodes: |
|                     | re-earning steps lost to a restart             |
| ckpt_block          | ``ckpt_save/stage/commit/persist`` spans       |
| data_stall          | ``data_wait`` spans                            |
| comm_exposed        | ``grad_sync_ici/dcn/probe`` spans (exposed on  |
|                     | the train thread, not overlapped)              |
| productive_compute  | ``compute`` spans                              |
| degraded            | ``degraded_enter()``..``exit()`` episode time  |
|                     | not already claimed above (shm-only mode)      |
| serving_soak        | ``serving_begin()``..``end()`` episodes: a     |
|                     | co-located inference plane decoding in idle    |
|                     | step gaps; ranked below every training row     |
| other               | the remainder (bring-up, eval, logging, ...)   |

Only spans on the train thread count (``tid_fn``, same convention as
``SpanHeartbeat``): the prefetcher's ``h2d`` overlaps ``compute`` by
design and must not double-claim wall time.

The ledger consumes the tracer incrementally (``SpanTracer.drain``
cursors), so a long job can ``collect()`` at log cadence without ever
re-reading the ring; spans still open at collect time (a wedged
``ckpt_commit``) are attributed up to "now" and the completed record is
clipped against the already-counted window, so a hang shows up in the
ledger *while it is happening*.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.obs.trace import SpanTracer, get_tracer

# the closed taxonomy, in priority order (highest claim first);
# "other" is the remainder and always closes the partition.
# "eviction" outranks everything: the drain window deliberately runs
# checkpoint/report work inside it, and that time is the price of the
# preemption, not of checkpointing policy
CATEGORIES = (
    "eviction",
    "resize_downtime",
    "restart_replay",
    "ckpt_block",
    "data_stall",
    "comm_exposed",
    "productive_compute",
    "degraded",
    "serving_soak",
    "other",
)

# span name -> category (docs/observability.md span taxonomy)
SPAN_CATEGORY = {
    "resize_drain": "resize_downtime",
    "resize_build": "resize_downtime",
    "resize_reshard": "resize_downtime",
    "resize_compile": "resize_downtime",
    "ckpt_save": "ckpt_block",
    "ckpt_stage": "ckpt_block",
    "ckpt_commit": "ckpt_block",
    "ckpt_persist": "ckpt_block",
    "data_wait": "data_stall",
    "grad_sync_ici": "comm_exposed",
    "grad_sync_dcn": "comm_exposed",
    "grad_sync_probe": "comm_exposed",
    "grad_sync_overlap_probe": "comm_exposed",
    "compute": "productive_compute",
}

# the closure gate: |sum(categories) - wall| / wall must stay under
# this (the chip smoke's launcher line holds a worker's report to it)
CLOSURE_GATE_PCT = 1.0

METRIC_PREFIX = "dlrover_goodput_"


def _merge(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, overlap-merged copy of ``ivs``."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(ivs):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _subtract(
    ivs: List[Tuple[int, int]], cover: List[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """``ivs`` minus ``cover`` (both merged/sorted)."""
    out: List[Tuple[int, int]] = []
    for lo, hi in ivs:
        cur = lo
        for clo, chi in cover:
            if chi <= cur:
                continue
            if clo >= hi:
                break
            if clo > cur:
                out.append((cur, clo))
            cur = max(cur, chi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def _total_s(ivs: List[Tuple[int, int]]) -> float:
    return sum(hi - lo for lo, hi in ivs) / 1e9


def compute_goodput_pct(productive_s: float, wall_s: float) -> float:
    """The one shared goodput formula (the master's aggregator divides
    through here too, so the definition cannot drift)."""
    if wall_s <= 0:
        return 0.0
    return 100.0 * max(0.0, productive_s) / wall_s


@dataclass
class GoodputReport:
    """One closed accounting of a wall-time window."""

    wall_s: float = 0.0
    seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def goodput_pct(self) -> float:
        return compute_goodput_pct(
            self.seconds.get("productive_compute", 0.0), self.wall_s
        )

    @property
    def closure_error_pct(self) -> float:
        """|sum(categories) - wall| as a % of wall — the invariant the
        smoke gate holds at ≤ ``CLOSURE_GATE_PCT``. Nonzero means the
        interval arithmetic double- or under-claimed time."""
        if self.wall_s <= 0:
            return 0.0
        total = sum(self.seconds.values())
        return 100.0 * abs(total - self.wall_s) / self.wall_s

    def as_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6),
            "goodput_pct": round(self.goodput_pct, 3),
            "closure_error_pct": round(self.closure_error_pct, 4),
            **{k: round(v, 6) for k, v in self.seconds.items()},
        }


class GoodputLedger:
    """Incremental wall-time accountant over a ``SpanTracer``.

    Thread-safe; ``collect()`` is meant for log cadence (it drains only
    records appended since the previous call). ``snapshot()`` collects
    and returns the cumulative :class:`GoodputReport` since the ledger
    started.
    """

    def __init__(
        self,
        tracer: Optional[SpanTracer] = None,
        tid_fn: Optional[Callable[[], Optional[int]]] = None,
    ):
        # `is None`, not truthiness — SpanTracer defines __len__ (same
        # footgun SpanHeartbeat documents)
        self._tracer = tracer if tracer is not None else get_tracer()
        self._tid_fn = tid_fn
        self._lock = threading.Lock()
        now = time.monotonic_ns()
        self._t0_ns = now
        self._last_ns = now  # end of the last collected window
        self._cursor = 0
        self._dropped = 0  # records lost to ring lapping
        self._seconds: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        # live episodes (None = not active) + closed-but-uncollected
        self._degraded_since: Optional[int] = None
        self._degraded_closed: List[Tuple[int, int]] = []
        self._replay_since: Optional[int] = None
        self._replay_closed: List[Tuple[int, int]] = []
        self._eviction_since: Optional[int] = None
        self._eviction_closed: List[Tuple[int, int]] = []
        self._serving_since: Optional[int] = None
        self._serving_closed: List[Tuple[int, int]] = []

    # -- event-derived categories (node events) ------------------------
    def degraded_enter(self):
        """Storage persists failing; checkpoints are shm-only (the
        saver's ``ckpt_degraded`` node event)."""
        with self._lock:
            if self._degraded_since is None:
                self._degraded_since = time.monotonic_ns()

    def degraded_exit(self):
        with self._lock:
            if self._degraded_since is not None:
                self._degraded_closed.append(
                    (self._degraded_since, time.monotonic_ns())
                )
                self._degraded_since = None

    def replay_begin(self):
        """Entering the lost-progress window after a restore: steps run
        until ``replay_end()`` re-earn work a previous incarnation had
        already done."""
        with self._lock:
            if self._replay_since is None:
                self._replay_since = time.monotonic_ns()

    def replay_end(self):
        with self._lock:
            if self._replay_since is not None:
                self._replay_closed.append(
                    (self._replay_since, time.monotonic_ns())
                )
                self._replay_since = None

    def eviction_begin(self):
        """Entering the eviction grace-window drain (a preemption
        notice arrived): every second until ``eviction_end()`` — the
        finishing step, the emergency checkpoint, the forensics flush —
        is the preemption's cost, booked above every span category."""
        with self._lock:
            if self._eviction_since is None:
                self._eviction_since = time.monotonic_ns()

    def eviction_end(self):
        with self._lock:
            if self._eviction_since is not None:
                self._eviction_closed.append(
                    (self._eviction_since, time.monotonic_ns())
                )
                self._eviction_since = None

    def serving_begin(self):
        """The co-located serving plane started decoding a batch.
        Ranked below every training category, so serving only claims
        wall time training left unclaimed — the idle gaps it is meant
        to soak; a batch that overlaps a ``compute`` span costs the
        serving row nothing (training already owns that second)."""
        with self._lock:
            if self._serving_since is None:
                self._serving_since = time.monotonic_ns()

    def serving_end(self):
        with self._lock:
            if self._serving_since is not None:
                self._serving_closed.append(
                    (self._serving_since, time.monotonic_ns())
                )
                self._serving_since = None

    def mark_interval(self, category: str, start_ns: int, end_ns: int):
        """Attribute an explicit monotonic-ns interval to an
        event-derived category (the sparse trainer books a state
        refresh window as ``restart_replay`` this way)."""
        buckets = {
            "restart_replay": self._replay_closed,
            "degraded": self._degraded_closed,
            "eviction": self._eviction_closed,
            "serving_soak": self._serving_closed,
        }
        if category not in buckets:
            raise ValueError(
                f"mark_interval supports the event-derived categories "
                f"({', '.join(buckets)}), got {category!r}"
            )
        with self._lock:
            buckets[category].append((int(start_ns), int(end_ns)))

    # -- collection ----------------------------------------------------
    def _episode_intervals(
        self, closed: List[Tuple[int, int]], since: Optional[int],
        a: int, b: int,
    ) -> List[Tuple[int, int]]:
        """Window-clipped intervals for one episode kind; consumes the
        closed list (portions beyond ``b`` are put back)."""
        ivs = []
        keep = []
        for lo, hi in closed:
            if hi > b:
                keep.append((max(lo, b), hi))
                hi = b
            lo, hi = max(lo, a), min(hi, b)
            if hi > lo:
                ivs.append((lo, hi))
        closed[:] = keep
        if since is not None:
            lo = max(since, a)
            if b > lo:
                ivs.append((lo, b))
        return ivs

    def collect(self, now_ns: Optional[int] = None):
        """Attribute the window since the last collect. Records are
        clipped to the window, so a span that was partially counted
        while still open (or that straddles two collects) never
        double-claims."""
        with self._lock:
            b = int(now_ns) if now_ns is not None else time.monotonic_ns()
            a = self._last_ns
            if b <= a:
                return
            self._last_ns = b
            tid = self._tid_fn() if self._tid_fn is not None else None
            # open spans are snapshotted BEFORE the drain: a span that
            # completes in between is then claimed by BOTH views of the
            # same window, and the per-category merge coalesces the
            # overlap — the reverse order would let it slip past both
            # (gone from the open list, clipped to emptiness when its
            # record arrives next window) and lose its entire duration
            open_records = self._tracer.open_span_records(tid=tid)
            records, self._cursor, dropped = self._tracer.drain(
                self._cursor
            )
            self._dropped += dropped

            per_cat: Dict[str, List[Tuple[int, int]]] = {
                c: [] for c in CATEGORIES
            }
            for name, rtid, start, dur, _depth, _attrs, _seq in records:
                cat = SPAN_CATEGORY.get(name)
                if cat is None or (tid is not None and rtid != tid):
                    continue
                lo, hi = max(start, a), min(start + dur, b)
                if hi > lo:
                    per_cat[cat].append((lo, hi))
            # spans open at snapshot time (a wedged ckpt_commit, a long
            # data_wait): claim their elapsed part up to b; the
            # completed record is later clipped to the next window
            for name, rtid, start, _depth in open_records:
                cat = SPAN_CATEGORY.get(name)
                if cat is None:
                    continue
                lo = max(start, a)
                if b > lo:
                    per_cat[cat].append((lo, b))
            per_cat["restart_replay"].extend(
                self._episode_intervals(
                    self._replay_closed, self._replay_since, a, b
                )
            )
            per_cat["degraded"].extend(
                self._episode_intervals(
                    self._degraded_closed, self._degraded_since, a, b
                )
            )
            per_cat["eviction"].extend(
                self._episode_intervals(
                    self._eviction_closed, self._eviction_since, a, b
                )
            )
            per_cat["serving_soak"].extend(
                self._episode_intervals(
                    self._serving_closed, self._serving_since, a, b
                )
            )

            covered: List[Tuple[int, int]] = []
            for cat in CATEGORIES:
                if cat == "other":
                    continue
                claimed = _subtract(_merge(per_cat[cat]), covered)
                self._seconds[cat] += _total_s(claimed)
                covered = _merge(covered + claimed)

    # -- reporting -----------------------------------------------------
    def snapshot(self, now_ns: Optional[int] = None) -> GoodputReport:
        self.collect(now_ns=now_ns)
        with self._lock:
            wall = (self._last_ns - self._t0_ns) / 1e9
            seconds = dict(self._seconds)
            attributed = sum(seconds.values())
            # "other" closes the partition; interval bugs surface as a
            # negative remainder => closure_error_pct > 0, which the
            # smoke gate catches instead of silently clamping
            seconds["other"] = wall - attributed
            return GoodputReport(wall_s=wall, seconds=seconds)

    @property
    def dropped_records(self) -> int:
        """Spans lost to ring-buffer lapping between collects (their
        time lands in "other" — collect more often if nonzero)."""
        with self._lock:
            return self._dropped

    def export(self, registry) -> GoodputReport:
        """Snapshot + publish the ``dlrover_goodput_*`` gauges. The
        trainer calls this at log cadence, so the scalars ride the
        runtime-metrics file to the master like every other registry
        number."""
        report = self.snapshot()
        g = registry.gauge(
            METRIC_PREFIX + "seconds_total",
            "wall seconds attributed per goodput category",
            labelnames=("category",),
        )
        for cat, secs in report.seconds.items():
            g.labels(cat).set(secs)
        registry.gauge(
            METRIC_PREFIX + "wall_seconds",
            "wall seconds accounted by the goodput ledger",
        ).set(report.wall_s)
        registry.gauge(
            METRIC_PREFIX + "pct",
            "productive_compute share of wall time, percent",
        ).set(report.goodput_pct)
        return report


# -- process-default ledger (the saver's degraded hooks and the trainer
# both reach it without holding a reference to each other) ------------

_default: Optional[GoodputLedger] = None
_default_lock = threading.Lock()


def install_default_ledger(ledger: GoodputLedger) -> GoodputLedger:
    global _default
    with _default_lock:
        _default = ledger
    return ledger


def default_ledger() -> Optional[GoodputLedger]:
    return _default


def note_degraded(entered: bool):
    """Degraded-mode seam: the checkpoint saver flips this on
    episode entry/exit; a no-op until a trainer installs a ledger."""
    ledger = _default
    if ledger is None:
        return
    if entered:
        ledger.degraded_enter()
    else:
        ledger.degraded_exit()


def note_serving(active: bool):
    """Serving-plane seam: the co-located inference engine flips this
    around each decode batch so the trainer's ledger prices exactly
    what co-location costs; a no-op until a trainer installs a
    ledger."""
    ledger = _default
    if ledger is None:
        return
    if active:
        ledger.serving_begin()
    else:
        ledger.serving_end()
