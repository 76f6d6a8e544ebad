"""Windowed global-step throughput + hang signals on the master.

Parity: dlrover/python/master/monitor/speed_monitor.py:43 — keeps a sliding
window of (timestamp, global_step) samples, computes steps/sec used by the
auto-scaler, and flags "all nodes running but no step progress" as a hang.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional, Set, Tuple

from dlrover_tpu_torch.common.global_context import Context

_ctx = Context.singleton_instance()


class SpeedMonitor:
    def __init__(self, window: int = 0, telemetry=None):
        self._window = window or _ctx.train_speed_record_num
        self._samples: Deque[Tuple[float, int]] = deque(maxlen=self._window)
        self._global_step = 0
        self._start_training_time: Optional[float] = None
        self._sample_count_per_step: dict = {}
        self._running_workers: Set[int] = set()
        self._init_time = time.time()
        self._last_reset_time = 0.0
        self.first_step_time: Optional[float] = None
        # per-worker step-time aggregation / straggler detection
        # (obs/aggregate.TelemetryAggregator) — every step report is
        # forwarded with its worker identity so the master can localize
        # slowness, not just see the fleet max
        self.telemetry = telemetry

    # -- reporting -----------------------------------------------------
    def set_start_timestamp(self):
        if self._start_training_time is None:
            self._start_training_time = time.time()

    def collect_global_step(
        self,
        step: int,
        timestamp: Optional[float] = None,
        node_id: int = -1,
    ):
        # `is None`, NOT truthiness: an explicit timestamp of 0.0 is a
        # caller-provided value (epoch zero) and must be honored — the
        # old `timestamp or time.time()` silently replaced it with now.
        # (Falsy-vs-None audit of this path: the wire default 0.0 in
        # GlobalStepReport is mapped to None at the servicer boundary,
        # where 0.0 IS the documented "unset" sentinel.)
        timestamp = time.time() if timestamp is None else timestamp
        if self.first_step_time is None:
            self.first_step_time = timestamp
        if step >= self._global_step:
            self._global_step = step
            self._samples.append((timestamp, step))
        if self.telemetry is not None and node_id >= 0:
            self.telemetry.observe_step_report(node_id, step, timestamp)

    def set_completed_step_baseline(self, step: int):
        """Failover restore: a relaunched master must not read the next
        step report as 'progress since 0' (hang/scaling baselines)."""
        if step > self._global_step:
            self._global_step = step

    def add_running_worker(self, node_id: int):
        self._running_workers.add(node_id)

    def remove_running_worker(self, node_id: int):
        self._running_workers.discard(node_id)
        if self.telemetry is not None:
            # a departed worker's history must not haunt the fleet
            # median the straggler detector compares against
            self.telemetry.remove_worker(node_id)

    @property
    def running_workers(self) -> Set[int]:
        return set(self._running_workers)

    @property
    def completed_global_step(self) -> int:
        return self._global_step

    # -- queries -------------------------------------------------------
    def running_speed(self) -> float:
        """Steps per second over the sample window."""
        if len(self._samples) < 2:
            return 0.0
        (t0, s0), (t1, s1) = self._samples[0], self._samples[-1]
        if t1 <= t0:
            return 0.0
        return (s1 - s0) / (t1 - t0)

    def all_worker_hanged(self, timeout: Optional[float] = None) -> bool:
        """True if workers are running but the step has not advanced for
        longer than ``timeout`` seconds (parity: all_running_node_hanged)."""
        timeout = timeout if timeout is not None else _ctx.hang_detection_secs
        if not self._running_workers:
            return False
        if not self._samples:
            # No samples yet: count from the most recent of training start /
            # window reset, so a rendezvous late in the job (which resets the
            # window) doesn't instantly read as a hang.
            base = max(
                self._start_training_time or self._init_time,
                self._last_reset_time,
            )
            return time.time() - base > timeout
        last_time = self._samples[-1][0]
        return time.time() - last_time > timeout

    def reset_running_speed_monitor(self):
        self._samples.clear()
        self._last_reset_time = time.time()
