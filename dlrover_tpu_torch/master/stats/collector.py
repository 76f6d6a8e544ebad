"""Job metric collector: runtime stats series for operators and the
Brain seam.

Parity: dlrover/python/master/stats/job_collector.py:177
(JobMetricCollector periodically collects node resource usage + training
speed and hands them to a reporter) and reporter.py:233 (LocalStatsReporter
vs BrainReporter). The TPU build keeps the same two pieces:

- ``JobMetricCollector`` samples the SpeedMonitor and the job manager's
  node table on a cadence into a bounded in-memory series, queryable over
  the master RPC (``JobMetricsRequest``);
- the ``reporter`` callable is the Brain seam — by default it stores
  locally; a Brain-backed reporter would POST the same samples to the
  cluster service (reference brain.proto:196 persist_metrics).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.daemon import PollingDaemon
from dlrover_tpu_torch.common.log import default_logger as logger


class JobMetricCollector(PollingDaemon):
    def __init__(
        self,
        job_manager,
        speed_monitor,
        interval: float = 30.0,
        max_samples: int = 512,
        reporter: Optional[Callable[[comm.JobMetricsSample], None]] = None,
        telemetry=None,
    ):
        super().__init__("job-metric-collector", interval)
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        # obs/aggregate.TelemetryAggregator: source of the fleet
        # goodput number every sample carries to the Brain
        self._telemetry = telemetry
        self._samples: Deque[comm.JobMetricsSample] = deque(
            maxlen=max_samples
        )
        self._reporter = reporter
        self._report_thread = None
        # latest scalar training metrics per node (loss/eval_loss/lr …)
        # reported through TrainMetricsReport — the trainer's periodic
        # metric-logging leg (ref atorch_trainer.py:127)
        self.train_metrics: Dict[int, dict] = {}

    def collect(self) -> comm.JobMetricsSample:
        running = (
            self._job_manager.get_running_nodes()
            if self._job_manager
            else []
        )
        goodput_pct = 0.0
        if self._telemetry is not None:
            fleet = self._telemetry.fleet_goodput()
            if fleet is not None:
                goodput_pct = fleet["goodput_pct"]
        sample = comm.JobMetricsSample(
            timestamp=time.time(),
            global_step=self._speed_monitor.completed_global_step,
            steps_per_sec=self._speed_monitor.running_speed(),
            alive_nodes=len(running),
            total_cpu_percent=sum(
                n.used_resource.cpu for n in running
            ),
            total_memory_mb=sum(
                n.used_resource.memory_mb for n in running
            ),
            goodput_pct=goodput_pct,
        )
        self._samples.append(sample)
        self._dispatch_to_reporter(sample)
        return sample

    def _dispatch_to_reporter(self, sample):
        """Fire-and-forget: a networked reporter (Brain) doing its RPC
        retries must not stall the collection cadence. One in-flight
        report at a time; samples arriving while it blocks are skipped
        for reporting (they stay in the local series)."""
        if self._reporter is None:
            return
        if self._report_thread is not None and self._report_thread.is_alive():
            return

        def _run():
            try:
                self._reporter(sample)
            except Exception as e:
                logger.warning(f"metrics reporter failed: {e!r}")

        import threading

        self._report_thread = threading.Thread(
            target=_run, name="metrics-reporter", daemon=True
        )
        self._report_thread.start()

    def _tick(self):
        self.collect()

    def report_train_metrics(self, node_id: int, step: int, metrics: dict):
        self.train_metrics[node_id] = {
            "step": step,
            "timestamp": time.time(),
            **{k: float(v) for k, v in metrics.items()},
        }

    def flush_reports(self, timeout: float = 10.0):
        """Join the in-flight reporter dispatch (tests / shutdown)."""
        if self._report_thread is not None:
            self._report_thread.join(timeout=timeout)

    def snapshot(self, last_n: int = 0) -> comm.JobMetrics:
        samples = list(self._samples)
        if last_n:
            samples = samples[-last_n:]
        return comm.JobMetrics(samples=samples)
