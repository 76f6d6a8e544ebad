"""Crash flight recorder: an always-on black box for training forensics
(the port of ``dlrover_tpu/obs/flight_recorder.py``).

When a trainer dies, hangs, or drops into degraded mode, the evidence
usually dies with it — the span ring lives in process memory, the
metrics registry was last exported a log-interval ago, and the thread
that knows why is the one that is wedged. The flight recorder keeps a
bounded event log while everything is healthy and, on trigger, dumps a
self-contained **bundle** (``DLROVER_TPU_FLIGHT_DIR``, default
``$TMPDIR/dlrover_tpu/flight``):

```
<flight_dir>/<utc-stamp>_<reason>_pid<pid>/
  manifest.json   trigger reason, wall/monotonic stamps, node identity,
                  open spans, goodput snapshot, exception (crash dumps)
  trace.json      last-N spans as a valid Chrome trace
  metrics.prom    Prometheus text exposition of the whole registry
  stacks.txt      every thread's current Python stack
  events.json     recent node events (degraded entry/exit, evictions,
                  hangs — whatever note_event saw)
```

Triggers:

- **crash** — ``ElasticTrainer.train`` dumps on any escaping exception;
- **hang** — the built-in watchdog thread dumps when the train thread's
  innermost span stays open past ``hang_dump_after_s`` (once per
  episode; the loop being wedged is exactly when only a daemon thread
  can still write);
- **eviction** — the trainer's grace-window drain dumps at its end;
- **master request** — the master queues a ``flight_dump`` worker
  command (RPC → agent relay file → trainer poll) to pull a bundle
  from one specific worker while it is still alive.

``ProfilerCapture`` is the companion evidence channel: a master
``profile`` command (auto-queued at most once per straggler episode)
arms a K-step ``torch.profiler`` capture (CPU and, on the card, CUDA
activity) whose Chrome trace lands under the same directory tree, so a
flagged straggler ships device-level evidence with its attribution.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.log import default_logger as logger

ENV_FLIGHT_DIR = ConfigPath.ENV_FLIGHT_DIR
DEFAULT_FLIGHT_DIR = ConfigPath.FLIGHT_DIR

# two dumps closer than this are one incident — the second trigger
# (e.g. crash right after the hang watchdog fired) is folded into the
# first bundle's story instead of doubling the artifacts
MIN_DUMP_INTERVAL_S = 5.0

_EVENT_LOG_CAP = 256


def flight_dir() -> str:
    return os.getenv(ENV_FLIGHT_DIR, DEFAULT_FLIGHT_DIR)


def _thread_stacks() -> str:
    """Every thread's current Python stack, hang-safe (no locks the
    train loop could hold)."""
    lines: List[str] = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} (tid {tid}) ---")
        lines.extend(
            line.rstrip("\n")
            for line in traceback.format_stack(frame)
        )
        lines.append("")
    return "\n".join(lines)


class FlightRecorder:
    """Bounded event log + bundle dumper. One per process is the
    intended shape (``default_recorder``); construct directly in tests.
    """

    def __init__(
        self,
        base_dir: str = "",
        tracer=None,
        registry=None,
        identity: Optional[Dict] = None,
    ):
        from dlrover_tpu_torch.obs.metrics import default_registry
        from dlrover_tpu_torch.obs.trace import get_tracer

        # "" = resolve flight_dir() per dump, so redirecting the env
        # var works even after the process-default recorder exists
        # (bench legs and tests point it at a scratch dir)
        self._base_dir = base_dir
        self._tracer = tracer if tracer is not None else get_tracer()
        self._registry = (
            registry if registry is not None else default_registry()
        )
        # node identity + config/mesh fingerprint, set by the trainer
        self._identity: Dict = dict(identity or {})
        self._events: deque = deque(maxlen=_EVENT_LOG_CAP)
        self._lock = threading.Lock()
        self._last_dump_ts = 0.0
        self._dumps: List[str] = []
        # hang watchdog state
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        self._hang_dumped_for: Optional[float] = None
        # deliberate-maintenance window (eviction drain, resize): the
        # train thread is SUPPOSED to sit in one long span, and a hang
        # dump of a healthy drain is forged evidence
        self._suppress_until = 0.0

    # -- deliberate-maintenance suppression ----------------------------
    def suppress_watchdog(self, duration_s: float):
        """Declare the next ``duration_s`` a deliberate maintenance
        window (graceful drain, resize): the hang watchdog must not
        dump a bundle for a stall the trainer chose. Windows extend,
        never shrink; ``clear_suppression()`` ends one early."""
        with self._lock:
            self._suppress_until = max(
                self._suppress_until, time.monotonic() + duration_s
            )

    def clear_suppression(self):
        with self._lock:
            self._suppress_until = 0.0

    def watchdog_suppressed(self) -> bool:
        with self._lock:
            return time.monotonic() < self._suppress_until

    # -- identity / events ---------------------------------------------
    def set_identity(self, **fields):
        """Stamp node/job/mesh identity into every future manifest
        (e.g. ``node_id``, ``job_name``, ``mesh``, ``config_digest``)."""
        with self._lock:
            self._identity.update(fields)

    def note_event(self, kind: str, detail: str = ""):
        """Append to the bounded black-box event log (degraded entry,
        fault injections, restarts...)."""
        self._events.append(
            {"ts": time.time(), "kind": str(kind), "detail": str(detail)}
        )

    def events(self) -> List[dict]:
        return list(self._events)

    @property
    def dumps(self) -> List[str]:
        """Bundle directories written by this recorder."""
        with self._lock:
            return list(self._dumps)

    # -- the dump ------------------------------------------------------
    def dump(
        self,
        reason: str,
        exc: Optional[BaseException] = None,
        extra: Optional[Dict] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Write one bundle; returns its directory (None when rate-
        limited or when the dump itself failed — forensics must never
        take the job down with it)."""
        now = time.time()
        with self._lock:
            if not force and now - self._last_dump_ts < MIN_DUMP_INTERVAL_S:
                return None
            self._last_dump_ts = now
        try:
            return self._dump_locked(reason, exc, extra, now)
        except Exception as e:  # pragma: no cover - defensive
            logger.error(f"flight-recorder dump failed: {e!r}")
            return None

    def _dump_locked(self, reason, exc, extra, now) -> str:
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )
        bundle = os.path.join(
            self._base_dir or flight_dir(),
            f"{stamp}_{safe_reason}_pid{os.getpid()}",
        )
        n = 1
        while os.path.exists(bundle):
            bundle = f"{bundle}.{n}"
            n += 1
        os.makedirs(bundle, exist_ok=True)

        # stacks first: the most perishable evidence, and the cheapest
        with open(os.path.join(bundle, "stacks.txt"), "w") as f:
            f.write(_thread_stacks())
        with open(os.path.join(bundle, "trace.json"), "w") as f:
            json.dump(self._tracer.chrome_trace(), f)
        with open(os.path.join(bundle, "metrics.prom"), "w") as f:
            f.write(self._registry.prometheus_text())
        with open(os.path.join(bundle, "events.json"), "w") as f:
            json.dump(self.events(), f, indent=1)

        manifest = {
            "reason": reason,
            "wall_ts": now,
            "monotonic_ns": time.monotonic_ns(),
            "pid": os.getpid(),
            "identity": dict(self._identity),
            "open_spans": self._tracer.open_spans(),
            "span_records_buffered": len(self._tracer),
        }
        try:
            from dlrover_tpu_torch.obs.goodput import default_ledger

            ledger = default_ledger()
            if ledger is not None:
                manifest["goodput"] = ledger.snapshot().as_dict()
        except Exception:
            pass
        if exc is not None:
            manifest["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__
                ),
            }
        if extra:
            manifest["extra"] = dict(extra)
        with open(os.path.join(bundle, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with self._lock:
            self._dumps.append(bundle)
        logger.warning(f"flight recorder: bundle dumped to {bundle}")
        return bundle

    # -- hang watchdog -------------------------------------------------
    def start_watchdog(
        self,
        hang_dump_after_s: float = 120.0,
        tid_fn: Optional[Callable[[], Optional[int]]] = None,
        interval_s: float = 5.0,
    ):
        """Daemon thread: dump once per hang episode when the watched
        thread's innermost open span exceeds ``hang_dump_after_s``.
        This is the only trigger that works while the train loop is
        wedged — the whole reason the recorder is a separate thread."""
        if self._watchdog is not None:
            return

        def _run():
            while not self._watchdog_stop.wait(interval_s):
                try:
                    if self.watchdog_suppressed():
                        # deliberate drain/resize window: a long open
                        # span here is the PLAN, not a hang. A span
                        # still open past the threshold AFTER the
                        # window expires dumps then — a wedged resize
                        # is a real hang
                        self._hang_dumped_for = None
                        continue
                    tid = tid_fn() if tid_fn is not None else None
                    hit = self._tracer.last_open_span(tid=tid)
                    if hit is None or hit[1] < hang_dump_after_s:
                        self._hang_dumped_for = None
                        continue
                    # one dump per episode: the span's start identifies
                    # the episode (elapsed keeps growing while stuck)
                    episode = time.monotonic() - hit[1]
                    prev = self._hang_dumped_for
                    if prev is not None and abs(prev - episode) < 1.0:
                        continue
                    self._hang_dumped_for = episode
                    self.note_event(
                        "hang",
                        f"stuck in {hit[0]} for {hit[1]:.0f}s",
                    )
                    self.dump(
                        "hang",
                        extra={"span": hit[0], "elapsed_s": hit[1]},
                    )
                except Exception:
                    pass  # the watchdog must never hurt training

        self._watchdog_stop.clear()
        self._watchdog = threading.Thread(
            target=_run, name="flight-watchdog", daemon=True
        )
        self._watchdog.start()

    def stop_watchdog(self):
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            self._watchdog = None


class ProfilerCapture:
    """On-demand K-step ``torch.profiler`` capture, armed by a master
    ``profile`` worker command and driven by the train loop's
    ``on_step_begin``/``on_step_end`` hooks (both no-ops while idle).

    The profiler records CPU activity and, when a card is present, CUDA
    activity (every kernel by name, on the device's clock). It starts at
    the first step boundary after the request and stops after ``steps``
    steps: ``on_step_end`` of the last one waits for the card to finish
    that step's work, stops the profiler and writes
    ``<out>/trace.json`` (Chrome trace-event JSON). A capture that fails
    to start or to stop is logged and dropped; training goes on.

    At most one capture runs at a time; re-requests during a live or
    cooling-down capture are dropped, which combined with the master's
    once-per-straggler-episode queueing bounds artifact volume."""

    def __init__(self, out_root: str = "", cooldown_s: float = 300.0):
        self._out_root = out_root  # "" = <flight_dir()>/profiles per use
        self._cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._pending_steps = 0
        self._reason = ""
        self._active_dir: Optional[str] = None
        self._prof = None
        self._last_done_ts = 0.0
        self.artifacts: List[str] = []

    def request(self, steps: int = 3, reason: str = "manual") -> bool:
        """Arm a capture of ``steps`` train steps; False when refused
        (already active / cooling down / bad arg)."""
        steps = int(steps)
        if steps <= 0:
            return False
        with self._lock:
            if self._active_dir is not None or self._pending_steps:
                return False
            if time.time() - self._last_done_ts < self._cooldown_s:
                return False
            self._pending_steps = steps
            self._reason = reason
            return True

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    @staticmethod
    def _start_profiler():
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def on_step_begin(self):
        with self._lock:
            if self._pending_steps <= 0 or self._active_dir is not None:
                return
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            out = os.path.join(
                self._out_root or os.path.join(flight_dir(), "profiles"),
                f"{stamp}_{self._reason}",
            )
            os.makedirs(out, exist_ok=True)
            try:
                self._prof = self._start_profiler()
            except Exception as e:
                logger.warning(f"profiler capture failed to start: {e!r}")
                self._pending_steps = 0
                return
            self._active_dir = out
            logger.info(
                f"profiler capture started ({self._pending_steps} "
                f"steps -> {out}, reason={self._reason})"
            )

    def on_step_end(self):
        with self._lock:
            if self._active_dir is None:
                return
            self._pending_steps -= 1
            if self._pending_steps > 0:
                return
            out, prof = self._active_dir, self._prof
            self._active_dir, self._prof = None, None
            self._last_done_ts = time.time()
            try:
                import torch

                if torch.cuda.is_available():
                    # the last step's kernels are still queued: the
                    # trace must hold them
                    torch.cuda.synchronize()
                prof.stop()
                prof.export_chrome_trace(os.path.join(out, "trace.json"))
            except Exception as e:
                logger.warning(f"profiler capture failed to stop: {e!r}")
                return
            self.artifacts.append(out)
            logger.info(f"profiler capture finished: {out}")

    def abort(self):
        """Stop a live capture without writing it (trainer close)."""
        with self._lock:
            self._pending_steps = 0
            if self._active_dir is None:
                return
            prof = self._prof
            self._active_dir, self._prof = None, None
            try:
                prof.stop()
            except Exception as e:
                logger.warning(f"profiler capture abort failed: {e!r}")


# -- process-default recorder ------------------------------------------------

_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder:
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def note_event(kind: str, detail: str = ""):
    """Event-log seam for subsystems that must not hold a recorder
    reference (ckpt saver, fault injector): always records; only the
    degraded-mode entry also triggers a dump (once per episode via the
    rate limiter)."""
    rec = default_recorder()
    rec.note_event(kind, detail)
    if kind == "ckpt_degraded":
        rec.dump("degraded", extra={"detail": detail})
