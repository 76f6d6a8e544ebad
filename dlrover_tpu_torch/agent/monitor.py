"""Agent-side daemons: resource monitor, training monitor, paral-config
tuner (a copy of ``dlrover_tpu/agent/monitor.py``; the process-tree walk
reads ``/proc`` instead of psutil, so the port needs no package past
PyTorch and numpy).

Parity:
- ``ResourceMonitor`` — dlrover/python/elastic_agent/monitor/resource.py:86
  (host CPU/memory usage reported to the master; feeds heartbeats, the
  auto-scaler and the future Brain collector). The agent creates no CUDA
  context, so device stats stay zero unless a runtime metrics file
  provides them.
- ``TrainingMonitor`` — monitor/training.py:77 (reads the metrics file the
  training process appends, reports global step to the master's
  SpeedMonitor — the signal hang detection and auto-scaling run on).
- ``ParalConfigTuner`` — config/paral_config_tuner.py:30: polls the
  master's tuned ParallelConfig over RPC and (re)writes the JSON file
  ``ElasticDataLoader`` re-reads, completing the master → agent →
  dataloader retune loop.

The training process's side of the metrics file is
``report_runtime_metrics(step)`` — call it from the train loop (the
``ElasticTrainer`` facade does it automatically).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.daemon import PollingDaemon
from dlrover_tpu_torch.common.log import default_logger as logger


def _metrics_path() -> str:
    return os.getenv(
        ConfigPath.ENV_RUNTIME_METRICS, ConfigPath.RUNTIME_METRICS
    )


def atomic_write_json(path: str, payload, durable: bool = False) -> None:
    """Write-tmp-then-rename publish of a JSON payload, creating parent
    directories when the path has any (a bare filename has no directory
    component and ``makedirs("")`` raises). One definition for every
    metrics/config file writer — the monitors, the paral-config tuner
    and the span heartbeat all publish through this.

    ``durable=True`` fsyncs the tmp file before the rename so the
    published file can never be an empty inode after a crash — use it
    for state that must survive a restart (the observed rail-rate
    cache). The default stays rename-only: runtime-metrics telemetry is
    republished every few seconds, readers need atomicity only, and an
    fsync per heartbeat would put a disk barrier on the monitor
    cadence."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # a tmp file per thread: the span heartbeat's thread and the train
    # loop publish the same file, and a shared tmp name lets one's
    # rename take the other's file away (its rename then raises)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


# the train process's writers of the metrics file (the loop's reports
# and the span heartbeat's read-modify-write) take turns: a heartbeat
# that read the file before a report must not write back over it (a
# process's last report, the eviction drain's, has no later write to
# repair the file)
METRICS_FILE_LOCK = threading.Lock()


def report_runtime_metrics(step: int, path: str = "", **extra) -> None:
    """Train-proc side: atomically publish the latest global step (plus
    optional metrics like loss/tpu stats) for the agent's
    TrainingMonitor."""
    path = path or _metrics_path()
    with METRICS_FILE_LOCK:
        atomic_write_json(
            path, {"global_step": int(step), "timestamp": time.time(), **extra}
        )


def read_runtime_metrics(path: str = "") -> dict:
    path = path or _metrics_path()
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _proc_stat(pid: int):
    """(ppid, cpu seconds, rss bytes) of ``pid`` from ``/proc``, or None
    once the process is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            raw = f.read()
    except OSError:
        return None
    # the command name may hold spaces and parentheses: split after the
    # last ')'
    fields = raw[raw.rindex(")") + 2:].split()
    ppid = int(fields[1])
    cpu_s = (int(fields[11]) + int(fields[12])) / _CLK_TCK
    return ppid, cpu_s, int(fields[21]) * _PAGE


class ProcessTree:
    """CPU percent and resident memory of a process and its recursive
    children, read from ``/proc`` (the counterpart of the reference's
    psutil walk). A process's CPU percent is its CPU time since the
    previous sample over the wall time since then, 0 on its first
    sample, as psutil's ``cpu_percent(None)`` gives it."""

    def __init__(self, pid: int = 0):
        self.pid = pid or os.getpid()
        self._last: dict = {}  # pid -> (cpu seconds, wall seconds)
        self.sample()  # prime the percent baseline

    def _tree(self) -> dict:
        stats = {}
        for name in os.listdir("/proc"):
            if name.isdigit():
                st = _proc_stat(int(name))
                if st is not None:
                    stats[int(name)] = st
        children: dict = {}
        for pid, (ppid, _, _) in stats.items():
            children.setdefault(ppid, []).append(pid)
        out, todo = {}, [self.pid]
        while todo:
            pid = todo.pop()
            if pid in stats and pid not in out:
                out[pid] = stats[pid]
                todo += children.get(pid, [])
        return out

    def sample(self):
        """(cpu_percent, rss_mb) summed over the tree."""
        now = time.monotonic()
        cpu = 0.0
        rss = 0
        last = {}
        for pid, (_, cpu_s, rss_b) in self._tree().items():
            prev = self._last.get(pid)
            if prev is not None and now > prev[1]:
                cpu += 100.0 * (cpu_s - prev[0]) / (now - prev[1])
            last[pid] = (cpu_s, now)
            rss += rss_b
        self._last = last
        return cpu, rss // (1024 * 1024)


class ResourceMonitor(PollingDaemon):
    """Report host CPU/memory usage of this node's process tree to the
    master (parity: resource.py:86)."""

    def __init__(self, client, interval: float = 15.0):
        super().__init__("resource-monitor", interval)
        self._client = client
        self._tree = ProcessTree()

    def current_usage(self):
        return self._tree.sample()

    def _tick(self):
        cpu, mem_mb = self.current_usage()
        metrics = read_runtime_metrics()
        self._client.report_resource_stats(
            cpu_percent=cpu,
            used_memory_mb=mem_mb,
            tpu_duty_cycle=float(metrics.get("tpu_duty_cycle", 0.0)),
        )


# keys that are NOT training scalars: step/clock bookkeeping, span
# plumbing, and the resource stats the ResourceMonitor (or the batch's
# resource leg) reports through its own channel
_SCALAR_SKIP_KEYS = (
    "global_step", "timestamp", "span_heartbeat_ts",
    "open_span_elapsed_s", "tpu_duty_cycle",
    "tpu_hbm_used_mb", "cpu_percent", "used_memory_mb",
)


def extract_scalar_metrics(metrics: dict) -> dict:
    """TRAINING scalars (loss / eval_loss / lr / registry exports …)
    from a runtime-metrics payload — not bools, not bookkeeping keys.
    One definition shared by the legacy ``TrainingMonitor`` forward
    and the batched aggregation tier, so both wire formats carry the
    same values."""
    return {
        k: float(v)
        for k, v in metrics.items()
        if k not in _SCALAR_SKIP_KEYS
        and isinstance(v, (int, float))
        and not isinstance(v, bool)
    }


class EvictionRelay:
    """The eviction-notice leg of the metrics-file channel: the
    draining trainer has no RPC client of its own — the metrics file
    carries the notice and the agent daemon turns it into the master's
    ``EvictionNotice`` (the proactive-resize trigger). Memoized so the
    notice is re-reported only when it changes (the drain's final
    write adds the measured drain_ms). Must run FIRST on a tick: the
    whole point is the master acting while the worker still drains."""

    def __init__(self, client):
        self._client = client
        # memo keyed by source (proc id) — one shared tuple would
        # thrash between two draining procs with different grace/drain
        # values and re-send both notices every tick
        self._last: dict = {}

    def maybe_relay(self, metrics: dict, key: int = 0) -> None:
        if not metrics.get("eviction_pending"):
            return
        grace = float(metrics.get("eviction_grace_s", 0.0) or 0.0)
        drain_ms = float(metrics.get("eviction_drain_ms", 0.0) or 0.0)
        if self._last.get(key) == (grace, drain_ms):
            return
        self._last[key] = (grace, drain_ms)
        try:
            self._client.report_eviction_notice(
                grace, drain_ms=drain_ms, reason="worker_drain"
            )
        except Exception as e:
            # clear the memo so the next tick retries; the notice
            # path must never kill the daemon
            self._last.pop(key, None)
            logger.warning(f"eviction notice relay failed: {e!r}")


class TrainingMonitor(PollingDaemon):
    """Forward the training procs' global step to the master
    (parity: training.py:77).

    Two independent advance signals gate forwarding:

    - the global step advancing → ``report_global_step`` (the hang /
      auto-scale signal);
    - the PAYLOAD advancing (the trainer's ``timestamp`` or the span
      heartbeat's ``span_heartbeat_ts``) → ``report_train_metrics``.
      Gating scalars on step alone dropped updated values at an
      unchanged step (a fresh loss right after restore, a post-eval
      refresh) and — worse — silenced the open-span channel exactly
      when a wedged step stopped advancing, which is when hang
      attribution matters.

    This is the LEGACY (per-channel RPC) path; the default agent runs
    the ``agent.aggregator.AgentReportBatcher`` instead, which carries
    the same signals in one delta-encoded RPC per tick. Kept for mixed
    fleets and as the documented fallback
    (``DLROVER_TPU_AGENT_BATCH=0``)."""

    def __init__(self, client, interval: float = 10.0):
        super().__init__("training-monitor", interval)
        self._client = client
        self._last_step = -1
        self._last_payload_ts = 0.0
        self._eviction = EvictionRelay(client)

    def _tick(self):
        metrics = read_runtime_metrics()
        step = int(metrics.get("global_step", -1))
        self._eviction.maybe_relay(metrics)
        if step > self._last_step:
            self._last_step = step
            self._client.report_global_step(step)
        payload_ts = max(
            float(metrics.get("timestamp", 0.0) or 0.0),
            float(metrics.get("span_heartbeat_ts", 0.0) or 0.0),
        )
        if step >= 0 and payload_ts > self._last_payload_ts:
            self._last_payload_ts = payload_ts
            scalars = extract_scalar_metrics(metrics)
            open_span = str(metrics.get("open_span", "") or "")
            if scalars or open_span:
                self._client.report_train_metrics(
                    step,
                    scalars,
                    open_span=open_span,
                    open_span_elapsed_s=float(
                        metrics.get("open_span_elapsed_s", 0.0) or 0.0
                    ),
                )


def _commands_path() -> str:
    return os.getenv(
        ConfigPath.ENV_WORKER_COMMANDS, ConfigPath.WORKER_COMMANDS
    )


def read_worker_commands(path: str = "") -> list:
    """Trainer side: the relayed master->worker commands, newest last.
    Each entry: ``{"id", "kind", "arg", "reason"}`` — consumers track
    the highest ``id`` they executed (ids are master-monotonic)."""
    path = path or _commands_path()
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return []
    cmds = payload.get("commands", [])
    return cmds if isinstance(cmds, list) else []


def last_command_id(path: str = "") -> int:
    """Highest command id in the relay file — THE watermark definition,
    shared by the relay's ack (what it tells the master it has) and the
    trainer's startup skip (commands already in the file target a
    previous incarnation)."""
    return max(
        (int(c.get("id", 0)) for c in read_worker_commands(path)),
        default=0,
    )


def append_worker_commands(path: str, cmds, keep: int = 16) -> None:
    """Append relayed commands to the bounded-tail command file the
    training process polls (shared by the legacy relay daemon and the
    batched aggregation tier)."""
    existing = read_worker_commands(path)
    for c in cmds:
        existing.append(
            {"id": c.id, "kind": c.kind, "arg": c.arg, "reason": c.reason}
        )
    atomic_write_json(path, {"commands": existing[-keep:]})


class WorkerCommandRelay(PollingDaemon):
    """Mirror the master's pending worker commands (flight dumps,
    profiler captures) into the command file the training process
    polls — the paral-config pattern, because the master never opens a
    connection INTO a worker and a training process has no RPC client.
    The file keeps a bounded tail of relayed commands so a trainer that
    polls slower than the relay cannot miss one."""

    def __init__(self, client, interval: float = 5.0, path: str = "",
                 keep: int = 16):
        super().__init__("worker-command-relay", interval)
        self._client = client
        self._path = path or _commands_path()
        self._keep = keep
        # highest id durably in the file = what we ack to the master
        # (resuming from the file keeps the ack watermark across agent
        # restarts, so the master doesn't redeliver forever)
        self._ack = last_command_id(self._path)

    def _tick(self):
        cmds = [
            c
            for c in self._client.poll_worker_commands(ack_id=self._ack)
            if c.id > self._ack  # redelivery of an unacked poll: dedup
        ]
        if not cmds:
            return
        append_worker_commands(self._path, cmds, keep=self._keep)
        self._ack = max(c.id for c in cmds)
        logger.info(
            f"relayed {len(cmds)} worker command(s): "
            + ", ".join(f"{c.kind}#{c.id}" for c in cmds)
        )


class ParalConfigTuner(PollingDaemon):
    """Poll the master's tuned config and rewrite the JSON file the
    ElasticDataLoader re-reads (parity: paral_config_tuner.py:30)."""

    def __init__(self, client, interval: float = 10.0, path: str = ""):
        super().__init__("paral-config-tuner", interval)
        self._client = client
        self._path = path or os.getenv(
            ConfigPath.ENV_PARAL_CONFIG, ConfigPath.PARAL_CONFIG
        )
        self._last_version = -1

    def _tick(self):
        config = self._client.get_paral_config()
        version = getattr(config.dataloader, "version", 0)
        if version == self._last_version:
            return
        self._last_version = version
        atomic_write_json(self._path, dataclasses.asdict(config))
        logger.info(
            f"paral config v{version} written to {self._path} "
            f"(batch_size={config.dataloader.batch_size})"
        )
