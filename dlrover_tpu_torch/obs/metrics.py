"""Metrics registry: counters, gauges and histograms (a copy of what the
port's checkpoint path, fault points and control plane read of
``dlrover_tpu/obs/metrics.py``: ``default_registry().counter(...)`` /
``.gauge(...)`` / ``.histogram(...)``, labelled children and ``value``;
no export yet).

Re-requesting a name returns the existing metric; a kind mismatch is a
hard error. A metric refuses to grow past ``max_label_sets`` label sets:
later sets share one detached child.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_MAX_LABEL_SETS = 256
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


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


class _GaugeChild(_Value):
    def set(self, v: float):
        with self._lock:
            self._v = float(v)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class _Metric:
    kind = "untyped"
    _child_cls = _Value

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 max_label_sets: Optional[int] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_label_sets = int(max_label_sets or DEFAULT_MAX_LABEL_SETS)
        self._children: Dict[Tuple[str, ...], _Value] = {}
        self._overflow: Optional[_Value] = None
        self._lock = threading.Lock()

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            labelvalues = tuple(labelkw[n] for n in self.labelnames)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"expected labels {self.labelnames}, got {tuple(labelvalues)}"
            )
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    if self._overflow is None:
                        self._overflow = self._new_child()
                    return self._overflow
                child = self._children[key] = self._new_child()
        return child

    def _new_child(self):
        return self._child_cls()

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels(...) first"
            )
        return self.labels()

    @property
    def value(self) -> float:
        return self._default_child().value


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float):
        self._default_child().set(v)

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default_child().dec(amount)


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
        """[(le, cumulative_count)] including +Inf."""
        out = []
        running = 0
        for le, c in zip(self._buckets, self._counts):
            running += c
            out.append((le, running))
        out.append((math.inf, running + self._counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th observation lands in)."""
        if not self._count:
            return None
        target = q * self._count
        for le, cum in self.cumulative():
            if cum >= target:
                return le if le != math.inf else self._buckets[-1]
        return self._buckets[-1]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), max_label_sets=None,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, max_label_sets)
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
    """Get-or-create metric catalog."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, max_label_sets, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, max_label_sets, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"{name} already registered as {m.kind}, requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "", labelnames=(),
                max_label_sets=None) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames, max_label_sets)

    def gauge(self, name: str, help: str = "", labelnames=(),
              max_label_sets=None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames, max_label_sets)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS, max_label_sets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   max_label_sets, buckets=buckets)


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
