"""Agent aggregation tier: one delta-encoded RPC per node per tick.

The paper's L4/L5 split makes the per-node agent the master's peer, but
until this module every *channel* of every training process still spoke
to the single gRPC master on its own cadence: global step, training
scalars, resource stats, the worker-command poll and the paral-config
poll were 4-5 RPCs per node per tick — and each telemetry report
re-sent the full scalar dictionary. At 10k nodes the master burns its
CPU deserializing identical floats.

``AgentReportBatcher`` replaces the ``TrainingMonitor`` +
``ResourceMonitor`` + ``WorkerCommandRelay`` + ``ParalConfigTuner``
quartet with ONE daemon that per tick:

1. reads every local training process's runtime-metrics file;
2. relays any eviction notice FIRST on its dedicated RPC (the one leg
   that must not wait for a batch cadence — the master pre-arms the
   resize while the worker drains);
3. delta-encodes the scalars against the last snapshot the master
   ACKED (``common/telemetry_delta.DeltaEncoder``) — unchanged keys
   and label sets are not re-sent;
4. sends one ``comm.AgentReportBatch`` carrying the per-proc deltas,
   the step signals, the command-ack watermark, the paral-config
   version and this node's resource usage;
5. applies the response: relayed commands land in the bounded-tail
   command file (the trainer's poll path, unchanged), a newer paral
   config lands in the dataloader's file, and ``resync=True`` arms a
   full snapshot for the next tick.

Steady state is therefore ~1 RPC per node per tick; the wire carries
only what changed. A master restart costs one resync round trip. The
legacy per-channel daemons stay available (``DLROVER_TPU_AGENT_BATCH=0``
in ``trainer/run.py``) for mixed-version fleets.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.agent.monitor import (
    EvictionRelay,
    _commands_path,
    _metrics_path,
    append_worker_commands,
    atomic_write_json,
    extract_scalar_metrics,
    last_command_id,
    read_runtime_metrics,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.daemon import PollingDaemon
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.telemetry_delta import DeltaEncoder

# (proc_id, worker_id, metrics_path): one entry per local training
# process. worker_id is the global process id the master's telemetry
# keys on; -1 = the node id (single-proc nodes).
ProcSpec = Tuple[int, int, str]


class AgentReportBatcher(PollingDaemon):
    """The aggregation-tier daemon (see module docstring)."""

    def __init__(
        self,
        client,
        interval: float = 10.0,
        procs: Optional[Sequence[ProcSpec]] = None,
        commands_path: str = "",
        paral_path: str = "",
        resource_fn: Optional[Callable[[], Optional[comm.ResourceStats]]] = None,
        keep_commands: int = 16,
    ):
        super().__init__("agent-report-batcher", interval)
        self._client = client
        self._procs: List[ProcSpec] = list(
            procs if procs is not None else [(0, -1, _metrics_path())]
        )
        self._commands_path = commands_path or _commands_path()
        self._paral_path = paral_path or os.getenv(
            ConfigPath.ENV_PARAL_CONFIG, ConfigPath.PARAL_CONFIG
        )
        self._resource_fn = resource_fn
        self._keep = keep_commands
        self._enc = DeltaEncoder()
        self._eviction = EvictionRelay(client)
        # per-proc forward gates — the same two advance signals the
        # legacy TrainingMonitor used (step for SpeedMonitor, payload
        # ts for scalars/open-span)
        self._last_step: Dict[int, int] = {}
        self._last_payload_ts: Dict[int, float] = {}
        # command watermark resumes from the file (agent restarts must
        # not make the master redeliver forever)
        self._ack = last_command_id(self._commands_path)
        self._paral_version = -1
        # introspection for tests / the load harness
        self.batches_sent = 0
        self.resyncs = 0
        self._last_batch: Optional[comm.AgentReportBatch] = None

    # -- one tick ------------------------------------------------------
    def _tick(self):
        per_proc_metrics = {
            proc_id: read_runtime_metrics(path)
            for proc_id, _worker, path in self._procs
        }
        # eviction first, on its dedicated single-attempt RPC: the
        # master must pre-arm while the worker drains, not after the
        # batch cadence catches up
        for proc_id, _worker, _path in self._procs:
            self._eviction.maybe_relay(
                per_proc_metrics[proc_id], key=proc_id
            )
        batch = self.build_batch(per_proc_metrics)
        try:
            resp = self._client.report_batch(batch)
        except Exception as e:
            # transport failure: the master may or may not have applied
            # the batch — rollback arms a FULL snapshot next tick, the
            # one recovery that converges either way
            self._enc.rollback(batch.seq)
            logger.warning(f"agent batch report failed: {e!r}")
            return
        self.batches_sent += 1
        self._apply_response(batch, resp)

    def build_batch(
        self, per_proc_metrics: Dict[int, dict]
    ) -> comm.AgentReportBatch:
        """Coalesce the per-proc runtime metrics into one delta-encoded
        batch (pure; the tick sends it). Split out for the load harness
        and tests."""
        snapshots = {
            proc_id: extract_scalar_metrics(m)
            for proc_id, m in per_proc_metrics.items()
        }
        full, seq, deltas = self._enc.encode(snapshots)
        worker_of = {p: w for p, w, _ in self._procs}
        procs: List[comm.ProcDelta] = []
        for proc_id, m in per_proc_metrics.items():
            step = int(m.get("global_step", -1))
            advanced = step > self._last_step.get(proc_id, -1)
            payload_ts = max(
                float(m.get("timestamp", 0.0) or 0.0),
                float(m.get("span_heartbeat_ts", 0.0) or 0.0),
            )
            payload_advanced = payload_ts > self._last_payload_ts.get(
                proc_id, 0.0
            )
            changed, removed = deltas.get(proc_id, ({}, []))
            if not (advanced or payload_advanced or changed or removed):
                # nothing new from this proc: omitting it means "no
                # change" to the decoder (NOT removal) — the batch
                # still goes out as the poll leg
                continue
            procs.append(
                comm.ProcDelta(
                    proc_id=proc_id,
                    worker_id=worker_of.get(proc_id, -1),
                    step=step,
                    step_ts=float(m.get("timestamp", 0.0) or 0.0),
                    step_advanced=advanced,
                    changed=changed,
                    removed=removed,
                    open_span=str(m.get("open_span", "") or ""),
                    open_span_elapsed_s=float(
                        m.get("open_span_elapsed_s", 0.0) or 0.0
                    ),
                )
            )
            # the gates advance optimistically; a failed send rolls the
            # ENCODER back but these signals re-fire only on the next
            # real advance — acceptable: the delta still carries the
            # values, and step_advanced=False at an unchanged step is
            # exactly the legacy monitor's behavior after its own send
            if advanced:
                self._last_step[proc_id] = step
            if payload_advanced:
                self._last_payload_ts[proc_id] = payload_ts
        resource = None
        if self._resource_fn is not None:
            try:
                resource = self._resource_fn()
            except Exception as e:
                logger.warning(f"resource sample failed: {e!r}")
        batch = comm.AgentReportBatch(
            node_id=self._client.node_id,
            epoch=self._enc.epoch,
            seq=seq,
            full=full,
            procs=procs,
            command_ack_id=self._ack,
            paral_version=self._paral_version,
            resource=resource,
        )
        self._last_batch = batch
        return batch

    @property
    def last_wire_bytes(self) -> int:
        """Serialized size of the last built batch — computed lazily
        (tests/harness only); the hot tick must not serialize twice."""
        if self._last_batch is None:
            return 0
        return len(comm.serialize_message(self._last_batch))

    def _apply_response(
        self, batch: comm.AgentReportBatch, resp: comm.AgentBatchResponse
    ) -> None:
        if resp.resync:
            self.resyncs += 1
            self._enc.force_resync()
            logger.info(
                "master asked for a telemetry resync; next batch is a "
                "full snapshot"
            )
        else:
            self._enc.ack(batch.seq)
        cmds = [c for c in resp.commands if c.id > self._ack]
        if cmds:
            append_worker_commands(
                self._commands_path, cmds, keep=self._keep
            )
            self._ack = max(c.id for c in cmds)
            logger.info(
                f"relayed {len(cmds)} worker command(s): "
                + ", ".join(f"{c.kind}#{c.id}" for c in cmds)
            )
        if resp.paral_config is not None:
            cfg = resp.paral_config
            version = getattr(cfg.dataloader, "version", 0)
            self._paral_version = version
            atomic_write_json(self._paral_path, dataclasses.asdict(cfg))
            logger.info(
                f"paral config v{version} written to {self._paral_path} "
                f"(batch_size={cfg.dataloader.batch_size})"
            )


def host_resource_fn(node_id: int) -> Callable[[], comm.ResourceStats]:
    """Build the batcher's piggybacked resource leg from the shared
    ``ProcessTree`` walk ``ResourceMonitor`` also uses."""
    from dlrover_tpu_torch.agent.monitor import ProcessTree

    tree = ProcessTree()

    def sample() -> comm.ResourceStats:
        cpu, mem_mb = tree.sample()
        metrics = read_runtime_metrics()
        return comm.ResourceStats(
            node_id=node_id,
            cpu_percent=cpu,
            used_memory_mb=mem_mb,
            tpu_duty_cycle=float(metrics.get("tpu_duty_cycle", 0.0)),
        )

    return sample
