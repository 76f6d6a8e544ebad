"""Step-phase span tracer: where did each step's wall time go? (a copy
of ``dlrover_tpu/obs/trace.py``, with one addition: ``record``.)

A process-wide, thread-safe tracer built for the train loop's cadence:

- **low overhead** — an enabled span costs two ``time.monotonic_ns``
  calls, one small object and one deque append under a tiny lock; a
  disabled tracer hands back a shared no-op context manager.
- **bounded memory** — spans land in a ring buffer (``capacity``
  events, oldest dropped); a multi-day job can leave tracing on.
- **hang attribution** — every thread's currently-open span stack is
  observable from any other thread (``open_spans`` /
  ``last_open_span``), so a wedged step can be described as "stuck in
  ckpt_commit for 42s" instead of "no progress". ``SpanHeartbeat``
  publishes that snapshot into the runtime-metrics file the agent's
  TrainingMonitor forwards to the master — the one channel that keeps
  working while the train loop itself is stuck inside a span.
- **Chrome trace-event export** — ``chrome_trace()`` / ``dump()`` emit
  the JSON object format (``{"traceEvents": [...]}``) chrome://tracing
  and Perfetto load directly; span depth rides in ``args.depth`` so
  ``step_coverage`` can be recomputed from a dumped artifact.
- **spans timed by their caller** — ``record(name, start_ns, dur_ns)``
  appends a completed span whose interval the caller measured: the
  port's trainer closes ``compute`` on a CUDA event recorded after the
  optimizer, read once the card has passed it, so the span holds the
  step's device time without a per-step host sync.

Span taxonomy: the trainer emits ``step`` with children ``data_wait`` /
``compute`` / ``host_sync`` / ``report`` / ``eval`` / ``ckpt_save``;
the prefetcher's producer thread emits ``prefetch_pull`` / ``h2d``; the
checkpoint engine and saver emit ``ckpt_stage`` / ``ckpt_commit`` /
``ckpt_persist``; the eviction drain emits ``eviction_drain``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

_TRACE_ENV = "DLROVER_TPU_TRACE"  # "0"/"false" disables at import

# record layout: (name, tid, start_ns, dur_ns, depth, attrs-or-None, seq)
# seq is a process-lifetime monotonic id (``drain`` cursors key on it)
_Record = Tuple[str, int, int, int, int, Optional[dict], int]


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass

    def cancel(self):
        pass

    def set(self, **attrs):
        pass


_NOOP = _NoopSpan()


class _OpenSpan:
    """A live span: ``end()`` records it, ``cancel()`` discards it.
    Also a context manager (``with tracer.span(...)``)."""

    __slots__ = (
        "_tracer", "name", "start_ns", "depth", "attrs", "_tid", "_done",
    )

    def __init__(self, tracer, name, start_ns, depth, attrs, tid):
        self._tracer = tracer
        self.name = name
        self.start_ns = start_ns
        self.depth = depth
        self.attrs = attrs
        self._tid = tid
        self._done = False

    def set(self, **attrs):
        """Attach/override attributes before the span ends (e.g. the
        resize compile leg stamping cache_hit once known)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    def end(self):
        self._tracer._end(self)

    def cancel(self):
        self._tracer._cancel(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class SpanTracer:
    """Ring-buffer span tracer; see module docstring."""

    def __init__(self, capacity: int = 65536, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.getenv(_TRACE_ENV, "1").lower() not in (
                "0", "false", "off",
            )
        self.enabled = bool(enabled)
        self._buf: deque = deque(maxlen=max(int(capacity), 16))
        self._appended = 0  # total ever; dropped = appended - len(buf)
        # process-lifetime record ids. Seq draw + append happen under
        # one tiny lock so buffer order == seq order — without it, a
        # thread preempted between next(seq) and append would let a
        # HIGHER seq land first, and a drain cursor advancing past it
        # would silently drop the straggler record forever (~100ns
        # acquire vs the ~µs span cost the bench gate bounds)
        self._seq = itertools.count()
        self._end_lock = threading.Lock()
        # tid -> stack of live _OpenSpan (each thread mutates only its
        # own list; snapshots copy, so no lock is needed around them)
        self._stacks: Dict[int, list] = {}
        self._thread_names: Dict[int, str] = {}
        self._t0_ns = time.monotonic_ns()
        # wall-clock anchor of the monotonic epoch: lets an offline
        # tool (tools/merge_timeline.py) align traces from different
        # processes/hosts onto one master-timestamp axis
        self._wall_t0 = time.time()
        self._pid = os.getpid()

    # -- hot path ------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager / handle for one span. Usage::

            with tracer.span("data_wait"):
                batch = next(it)

        or manually: ``s = tracer.span("step"); ...; s.end()``."""
        if not self.enabled:
            return _NOOP
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
            self._thread_names[tid] = threading.current_thread().name
        sp = _OpenSpan(
            self, name, time.monotonic_ns(), len(stack),
            attrs or None, tid,
        )
        stack.append(sp)
        return sp

    def _end(self, sp: _OpenSpan):
        if sp._done:
            return  # idempotent: a double end must not duplicate records
        sp._done = True
        dur_ns = time.monotonic_ns() - sp.start_ns
        stack = self._stacks.get(sp._tid)
        if stack and sp in stack:
            # tolerate out-of-order ends (an inner span leaked open):
            # drop everything above sp — their records are lost, which
            # is the observable symptom of the caller's bug
            while stack and stack.pop() is not sp:
                pass
        with self._end_lock:
            self._buf.append(
                (
                    sp.name, sp._tid, sp.start_ns, dur_ns, sp.depth,
                    sp.attrs, next(self._seq),
                )
            )
            self._appended += 1

    def _cancel(self, sp: _OpenSpan):
        if sp._done:
            return
        sp._done = True
        stack = self._stacks.get(sp._tid)
        if stack and sp in stack:
            while stack and stack.pop() is not sp:
                pass

    def record(
        self, name: str, start_ns: int, dur_ns: int, depth: int = 0,
        **attrs,
    ):
        """Append a completed span of the calling thread whose start and
        duration (monotonic ns) the caller measured, e.g. on the device's
        clock; it never enters the open-span stack."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name
        with self._end_lock:
            self._buf.append(
                (
                    name, tid, int(start_ns), max(int(dur_ns), 0), depth,
                    attrs or None, next(self._seq),
                )
            )
            self._appended += 1

    def traced(self, name: Optional[str] = None) -> Callable:
        """Decorator form: ``@tracer.traced("load_config")``."""

        def wrap(fn):
            import functools

            label = name or fn.__name__

            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.span(label):
                    return fn(*args, **kwargs)

            return inner

        return wrap

    # -- introspection -------------------------------------------------
    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return self._appended - len(self._buf)

    def reset(self):
        """Drop recorded spans (open stacks stay live — their ends land
        in the fresh buffer)."""
        self._buf.clear()
        self._appended = 0

    def drain(self, cursor: int = 0) -> Tuple[List[_Record], int, int]:
        """``(records, new_cursor, dropped)`` — every completed span
        with ``seq >= cursor`` still in the ring, in append order.

        The incremental-consumer API (GoodputLedger): each record is
        delivered exactly once per cursor chain, concurrent appends are
        safe (records are immutable tuples, ``list(deque)`` snapshots
        under the GIL), and a consumer lapped by the hot path learns
        how many records it lost (``dropped``) instead of silently
        double-counting or tearing."""
        snap = list(self._buf)
        fresh = [r for r in snap if r[6] >= cursor]
        if not fresh:
            return [], cursor, 0
        dropped = max(0, fresh[0][6] - cursor) if cursor else 0
        return fresh, fresh[-1][6] + 1, dropped

    def open_span_records(
        self, tid: Optional[int] = None
    ) -> List[Tuple[str, int, int, int]]:
        """``(name, tid, start_ns, depth)`` of every live span —
        the raw-timestamp twin of :meth:`open_spans` (the ledger
        attributes the elapsed part of still-open spans from this)."""
        out = []
        for t, stack in list(self._stacks.items()):
            if tid is not None and t != tid:
                continue
            for sp in list(stack):
                out.append((sp.name, t, sp.start_ns, sp.depth))
        return out

    def open_spans(self, tid: Optional[int] = None) -> List[dict]:
        """Snapshot of every live span, outermost first per thread."""
        now = time.monotonic_ns()
        out = []
        for t, stack in list(self._stacks.items()):
            if tid is not None and t != tid:
                continue
            for sp in list(stack):
                out.append(
                    {
                        "name": sp.name,
                        "tid": t,
                        "thread": self._thread_names.get(t, ""),
                        "elapsed_s": (now - sp.start_ns) / 1e9,
                        "depth": sp.depth,
                    }
                )
        return out

    def last_open_span(
        self, tid: Optional[int] = None
    ) -> Optional[Tuple[str, float]]:
        """(name, elapsed_s) of the most specific stuck frame: the
        INNERMOST open span of the thread whose innermost span has been
        open longest (restricted to ``tid`` when given). None when
        nothing is open. This is the string a hang report attaches:
        'worker 3 stuck in ckpt_commit for 42s'."""
        now = time.monotonic_ns()
        best: Optional[Tuple[str, float]] = None
        for t, stack in list(self._stacks.items()):
            if tid is not None and t != tid:
                continue
            frames = list(stack)
            if not frames:
                continue
            inner = frames[-1]
            elapsed = (now - inner.start_ns) / 1e9
            if best is None or elapsed > best[1]:
                best = (inner.name, elapsed)
        return best

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto/chrome://tracing).
        ``ts``/``dur`` are microseconds from the tracer's epoch; span
        depth is exported under ``args.depth`` so coverage can be
        recomputed from the artifact alone."""
        events: List[dict] = []
        for tid, tname in list(self._thread_names.items()):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self._pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        for name, tid, start_ns, dur_ns, depth, attrs, _seq in list(
            self._buf
        ):
            args: Dict[str, Any] = {"depth": depth}
            if attrs:
                args.update(attrs)
            events.append(
                {
                    "name": name,
                    "ph": "X",
                    "pid": self._pid,
                    "tid": tid,
                    "ts": (start_ns - self._t0_ns) / 1e3,
                    "dur": dur_ns / 1e3,
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            # extra top-level keys are legal in the JSON object format;
            # merge_timeline.py uses wall_t0_s for cross-worker clock
            # alignment (ts 0 of this trace == this wall-clock second)
            "otherData": {"wall_t0_s": self._wall_t0, "pid": self._pid},
        }

    def dump(self, path: str) -> str:
        """Atomically write the Chrome-trace JSON to ``path``."""
        from dlrover_tpu_torch.agent.monitor import atomic_write_json

        atomic_write_json(path, self.chrome_trace())
        return path


# -- artifact validation / analysis ----------------------------------------


def validate_chrome_trace(obj: Any) -> Tuple[bool, str]:
    """(ok, reason) for a loaded trace artifact: the JSON object format
    with a non-empty ``traceEvents`` list of well-formed events."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return False, "not a Chrome trace JSON object (no traceEvents)"
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return False, "traceEvents empty or not a list"
    for e in events:
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            return False, f"malformed event: {e!r}"
        if e["ph"] == "X" and ("ts" not in e or "dur" not in e):
            return False, f"complete event without ts/dur: {e!r}"
    if not any(e.get("ph") == "X" for e in events):
        return False, "no complete (ph=X) span events"
    return True, "ok"


def _merged_total(intervals: List[Tuple[float, float]]) -> float:
    total = 0.0
    end = float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def step_coverage(trace: Any, parent: str = "step") -> Optional[float]:
    """Fraction of ``parent`` span wall time covered by its direct
    children (same tid, depth parent+1, overlap-merged) — the
    "spans explain the step" acceptance number. Accepts a tracer, a
    Chrome-trace dict, or a raw event list; None when no parent spans
    exist."""
    if isinstance(trace, SpanTracer):
        trace = trace.chrome_trace()
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    xs = [e for e in events if e.get("ph") == "X"]
    by_tid: Dict[Any, List[dict]] = {}
    for e in xs:
        by_tid.setdefault(e.get("tid"), []).append(e)
    total = covered = 0.0
    for evs in by_tid.values():
        for p in evs:
            if p["name"] != parent:
                continue
            pdepth = (p.get("args") or {}).get("depth", 0)
            lo, hi = p["ts"], p["ts"] + p["dur"]
            if hi <= lo:
                continue
            kids = [
                (max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                for e in evs
                if e is not p
                and (e.get("args") or {}).get("depth", -1) == pdepth + 1
                and e["ts"] < hi
                and e["ts"] + e["dur"] > lo
            ]
            total += hi - lo
            covered += _merged_total(kids)
    if total <= 0:
        return None
    return covered / total


# -- process-wide default tracer --------------------------------------------

_default = SpanTracer()


def get_tracer() -> SpanTracer:
    return _default


def span(name: str, **attrs):
    """Span on the process default tracer (the instrumentation points
    in trainer/prefetch/ckpt/grad_sync all use this)."""
    return _default.span(name, **attrs)


def traced(name: Optional[str] = None) -> Callable:
    return _default.traced(name)


def enable(on: bool = True):
    _default.enabled = bool(on)


def last_open_span(tid: Optional[int] = None) -> Optional[Tuple[str, float]]:
    return _default.last_open_span(tid=tid)


# -- hang-attribution heartbeat ---------------------------------------------


class SpanHeartbeat:
    """Background publisher of the current open span into the
    runtime-metrics file (``agent.monitor`` path conventions).

    The train loop writes that file itself at log cadence — but a loop
    wedged inside a span by definition stops writing, which is exactly
    when attribution matters. This daemon thread keeps the file's
    ``open_span`` / ``open_span_elapsed_s`` / ``span_heartbeat_ts``
    fields fresh so the agent's TrainingMonitor can forward "stuck in
    ckpt_commit for 42s" to the master while the step is stuck.

    ``tid_fn`` (optional) narrows attribution to one thread — the
    trainer passes its loop thread so a by-design-parked prefetch
    producer can't masquerade as the stuck frame.
    """

    def __init__(
        self,
        tracer: Optional[SpanTracer] = None,
        path: str = "",
        interval: float = 5.0,
        tid_fn: Optional[Callable[[], Optional[int]]] = None,
    ):
        # `is None`, not truthiness: SpanTracer defines __len__, so an
        # EMPTY tracer is falsy and `tracer or _default` would silently
        # publish someone else's spans
        self._tracer = tracer if tracer is not None else _default
        self._path = path
        self._interval = interval
        self._tid_fn = tid_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self):
        """One read-modify-write of the metrics file (benign last-write
        race with the trainer's own reports: the next write of either
        side repairs the file)."""
        from dlrover_tpu_torch.agent.monitor import (
            _metrics_path,
            atomic_write_json,
            read_runtime_metrics,
        )

        path = self._path or _metrics_path()
        payload = read_runtime_metrics(path)
        tid = self._tid_fn() if self._tid_fn is not None else None
        open_span = self._tracer.last_open_span(tid=tid)
        payload["open_span"] = open_span[0] if open_span else ""
        payload["open_span_elapsed_s"] = (
            round(open_span[1], 3) if open_span else 0.0
        )
        payload["span_heartbeat_ts"] = time.time()
        atomic_write_json(path, payload)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.publish_once()
            except Exception:
                pass  # a telemetry hiccup must never hurt training

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="span-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
