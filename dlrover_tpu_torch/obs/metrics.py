"""Metrics registry: counters / gauges / histograms with one export path
(a copy of ``dlrover_tpu/obs/metrics.py``).

Every fast-path subsystem of the port (the checkpoint engine and saver,
the fault points, the control plane's RPC counters, the trainer) writes
into one registry with two read sides:

- ``prometheus_text()`` — the Prometheus text exposition format, for
  scraping / file drops, and the ``metrics.prom`` of a flight bundle;
- ``scalars()`` — a flat ``{name: float}`` dict the trainer merges into
  ``report_runtime_metrics`` so the agent forwards every registry
  scalar to the master's collector unchanged.

``fold_pipeline_stats`` makes the port's ``PipelineStats``
(``data/prefetch.py``) a *view* into the registry: it walks
``as_dict()`` generically, so a field added there shows up in both
exports without touching this file.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# seconds-scale latency buckets (prometheus client defaults)
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# every PipelineStats-derived gauge is exported under this prefix
PIPELINE_PREFIX = "dlrover_pipeline_"

# cardinality guard: a label value drawn from an unbounded set (step
# numbers, pod names of a churning fleet) would grow the exposition —
# and every scalars() forward to the master — without bound. Past the
# cap a metric warns ONCE and refuses growth: unseen label sets share
# one detached overflow child that never enters the exposition, so
# writes stay cheap no-ops instead of raising on the hot path.
# (Departed-WORKER pruning is the aggregator's job; this protects the
# registry itself from any mislabeled series.)
ENV_MAX_LABEL_SETS = "DLROVER_TPU_METRIC_MAX_LABEL_SETS"
DEFAULT_MAX_LABEL_SETS = 256


def _default_max_label_sets() -> int:
    try:
        return int(
            os.getenv(ENV_MAX_LABEL_SETS, str(DEFAULT_MAX_LABEL_SETS))
        )
    except ValueError:
        return DEFAULT_MAX_LABEL_SETS


def _label_key(
    labelnames: Sequence[str], labelvalues: Sequence[str]
) -> Tuple[str, ...]:
    if len(labelvalues) != len(labelnames):
        raise ValueError(
            f"expected labels {tuple(labelnames)}, got {tuple(labelvalues)}"
        )
    return tuple(str(v) for v in labelvalues)


def _fmt_labels(labelnames, key) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{n}="{v}"' for n, v in zip(labelnames, key)
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str],
        max_label_sets: Optional[int] = None,
    ):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_label_sets = (
            int(max_label_sets)
            if max_label_sets is not None
            else _default_max_label_sets()
        )
        self._children: Dict[Tuple[str, ...], object] = {}
        self._overflow = None  # shared sink past the cardinality cap
        self._overflow_warned = False
        self._lock = threading.Lock()

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            labelvalues = tuple(
                labelkw[n] for n in self.labelnames
            )
        key = _label_key(self.labelnames, labelvalues)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= self.max_label_sets:
                        return self._overflow_child()
                    child = self._children.setdefault(
                        key, self._new_child()
                    )
        return child

    def _overflow_child(self):
        """Detached child for label sets past the cap (lock held):
        callers keep working, but the series never reaches the
        exposition — bounded memory beats a hot-path exception."""
        if not self._overflow_warned:
            self._overflow_warned = True
            from dlrover_tpu_torch.common.log import default_logger as logger

            logger.warning(
                f"metric {self.name} hit its label-set cap "
                f"({self.max_label_sets}); new label sets are dropped "
                f"from the exposition — an unbounded label value "
                f"(step? pod name?) is leaking into "
                f"{self.labelnames} (cap: {ENV_MAX_LABEL_SETS})"
            )
        if self._overflow is None:
            self._overflow = self._new_child()
        return self._overflow

    def label_set_count(self) -> int:
        """Distinct label sets currently live (the guard's read side)."""
        with self._lock:
            return len(self._children)

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                f".labels(...) first"
            )
        return self.labels()

    def _new_child(self):
        raise NotImplementedError


class _Value:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    @property
    def value(self) -> float:
        return self._v


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._v += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild(_Value):
    def set(self, v: float):
        with self._lock:
            self._v = float(v)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float):
        self._default_child().set(v)

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: Sequence[float]):
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, le in enumerate(self._buckets):
                if v <= le:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] including +Inf — the exposition
        shape."""
        out = []
        running = 0
        for le, c in zip(self._buckets, self._counts):
            running += c
            out.append((le, running))
        out.append((math.inf, running + self._counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th observation lands in) — good enough for straggler ratios,
        not for SLO math."""
        if not self._count:
            return None
        target = q * self._count
        for le, cum in self.cumulative():
            if cum >= target:
                return le if le != math.inf else self._buckets[-1]
        return self._buckets[-1]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self, name, help, labelnames=(), buckets=DEFAULT_BUCKETS,
        max_label_sets=None,
    ):
        super().__init__(
            name, help, labelnames, max_label_sets=max_label_sets
        )
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float):
        self._default_child().observe(v)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def quantile(self, q: float) -> Optional[float]:
        return self._default_child().quantile(q)


class MetricsRegistry:
    """Get-or-create metric catalog. Re-requesting a name returns the
    existing metric (so call sites don't coordinate creation), but a
    kind mismatch is a hard error — two subsystems disagreeing about
    what a name *is* must fail loudly, not silently shadow."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"{name} already registered as {m.kind}, "
                        f"requested {cls.kind}"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(
        self, name: str, help: str = "", labelnames=(),
        max_label_sets=None,
    ) -> Counter:
        return self._get_or_create(
            Counter, name, help, labelnames,
            max_label_sets=max_label_sets,
        )

    def gauge(
        self, name: str, help: str = "", labelnames=(),
        max_label_sets=None,
    ) -> Gauge:
        return self._get_or_create(
            Gauge, name, help, labelnames,
            max_label_sets=max_label_sets,
        )

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames=(),
        buckets=DEFAULT_BUCKETS,
        max_label_sets=None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets,
            max_label_sets=max_label_sets,
        )

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- export --------------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition (the format a /metrics endpoint
        or node-exporter textfile drop serves)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            children = list(m._children.items()) or (
                [] if m.labelnames else [((), m._default_child())]
            )
            for key, child in children:
                labels = _fmt_labels(m.labelnames, key)
                if isinstance(m, Histogram):
                    for le, cum in child.cumulative():
                        le_lbl = (
                            _fmt_labels(
                                m.labelnames + ("le",),
                                key + (_fmt_value(le),),
                            )
                        )
                        lines.append(
                            f"{m.name}_bucket{le_lbl} {cum}"
                        )
                    lines.append(
                        f"{m.name}_sum{labels} {_fmt_value(child.sum)}"
                    )
                    lines.append(f"{m.name}_count{labels} {child.count}")
                else:
                    lines.append(
                        f"{m.name}{labels} {_fmt_value(child.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def scalars(self) -> Dict[str, float]:
        """Flat ``{name[{labels}]: value}`` — the shape the trainer
        merges into the runtime-metrics file for master forwarding.
        Histograms export ``_sum``/``_count`` (the master re-derives
        rates; raw buckets stay scrape-side)."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            children = list(m._children.items()) or (
                [] if m.labelnames else [((), m._default_child())]
            )
            for key, child in children:
                labels = _fmt_labels(m.labelnames, key)
                if isinstance(m, Histogram):
                    out[f"{m.name}_sum{labels}"] = float(child.sum)
                    out[f"{m.name}_count{labels}"] = float(child.count)
                else:
                    out[f"{m.name}{labels}"] = float(child.value)
        return out


def fold_pipeline_stats(stats, registry: "MetricsRegistry") -> int:
    """Fold a ``PipelineStats`` record into the registry as gauges —
    ONE export path for the pipeline counters. Walks ``as_dict()``
    generically: numeric entries become ``dlrover_pipeline_<field>``
    gauges, ``None`` entries export as NaN-free 0-gauges so the name
    still exists (dashboards key on presence), list-valued ratio pairs
    are skipped (their scalar components are separate fields already).
    Returns the number of gauges written."""
    n = 0
    for key, value in stats.as_dict().items():
        if isinstance(value, (list, tuple, dict, str)):
            continue  # composite view; components are separate fields
        g = registry.gauge(
            PIPELINE_PREFIX + key,
            "pipeline stat (data/prefetch.PipelineStats)",
        )
        g.set(0.0 if value is None else float(value))
        n += 1
    return n


# -- process-wide default registry ------------------------------------------

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
