"""Span tracer: where did the wall time go? (a copy of the part of
``dlrover_tpu/obs/trace.py`` that the port's checkpoint path and
prefetcher call: ``span(name, **attrs)``, a context manager.)

Off by default here: a disabled tracer hands back one shared no-op
span. ``enable()`` (or ``DLROVER_TPU_TRACE=1``) records each span as
``(name, thread id, start ns, duration ns, depth, attrs)`` in a ring
buffer that ``records()`` reads. Span names are the JAX package's:
``ckpt_stage`` / ``ckpt_commit`` / ``ckpt_persist`` from the
checkpoint engine and saver, ``prefetch_pull`` / ``h2d`` from the
prefetcher's producer thread.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

_TRACE_ENV = "DLROVER_TPU_TRACE"

Record = Tuple[str, int, int, int, int, Optional[dict]]


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _OpenSpan:
    __slots__ = ("_tracer", "name", "start_ns", "depth", "attrs", "_tid", "_done")

    def __init__(self, tracer, name, start_ns, depth, attrs, tid):
        self._tracer = tracer
        self.name = name
        self.start_ns = start_ns
        self.depth = depth
        self.attrs = attrs
        self._tid = tid
        self._done = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer._finish(self)
        return False


class SpanTracer:
    def __init__(self, capacity: int = 65536, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.getenv(_TRACE_ENV, "0").lower() in ("1", "true", "on")
        self.enabled = bool(enabled)
        self._buf: deque = deque(maxlen=max(int(capacity), 16))
        self._stacks: Dict[int, list] = {}
        self._lock = threading.Lock()

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NOOP
        tid = threading.get_ident()
        stack = self._stacks.setdefault(tid, [])
        sp = _OpenSpan(self, name, time.monotonic_ns(), len(stack), attrs or None, tid)
        stack.append(sp)
        return sp

    def _finish(self, sp: _OpenSpan):
        if sp._done:
            return
        sp._done = True
        dur = time.monotonic_ns() - sp.start_ns
        stack = self._stacks.get(sp._tid)
        if stack and sp in stack:
            while stack and stack.pop() is not sp:
                pass
        with self._lock:
            self._buf.append((sp.name, sp._tid, sp.start_ns, dur, sp.depth, sp.attrs))

    def records(self) -> List[Record]:
        with self._lock:
            return list(self._buf)


_default = SpanTracer()


def span(name: str, **attrs):
    """``with span("ckpt_stage", step=n): ...`` on the default tracer."""
    return _default.span(name, **attrs)


def enable(on: bool = True):
    _default.enabled = bool(on)
