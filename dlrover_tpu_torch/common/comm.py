"""Typed message catalog + codec for master<->agent RPC.

Parity: dlrover/python/common/grpc.py:30-445 — the reference carries pickled
dataclasses through a 2-RPC proto (``report``/``get``). We keep that minimal
protocol surface (it makes rolling upgrades trivial) but harden the codec:
messages are dataclasses registered in a catalog, and deserialization uses a
restricted unpickler that only resolves classes from this module.

TPU deltas vs the reference catalog:
- ``CommWorld`` carries the JAX-distributed coordinator address (our analog
  of the torch rendezvous store endpoints) plus the slice/node-unit layout;
- resource stats describe TPU hosts (chips, HBM) instead of GPUs.
"""

from __future__ import annotations

import io
import pickle
import socket
from contextlib import closing
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def find_free_port(host: str = "127.0.0.1") -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind((host, 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def addr_connected(addr: str, timeout: float = 1.0) -> bool:
    try:
        host, port = addr.rsplit(":", 1)
        with closing(socket.create_connection((host, int(port)), timeout)):
            return True
    except OSError:
        return False


class Message:
    """Base class; every RPC payload subclasses this."""


# ---------------------------------------------------------------------------
# codec — restricted pickle
# ---------------------------------------------------------------------------

_SAFE_MODULES = ("dlrover_tpu_torch.common.comm", "builtins", "collections")


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("dlrover_tpu_torch.common.comm") or module in _SAFE_MODULES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"forbidden class in message: {module}.{name}"
        )


def serialize_message(msg) -> bytes:
    return pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_message(data: bytes):
    if not data:
        return None
    return _RestrictedUnpickler(io.BytesIO(data)).load()


# ---------------------------------------------------------------------------
# envelopes
# ---------------------------------------------------------------------------


@dataclass
class BaseRequest(Message):
    node_id: int = -1
    node_type: str = ""
    data: bytes = b""


@dataclass
class BaseResponse(Message):
    success: bool = True
    message: str = ""
    data: bytes = b""


# ---------------------------------------------------------------------------
# task / data sharding messages (parity: grpc.py Task/TaskRequest/ShardConfig)
# ---------------------------------------------------------------------------


@dataclass
class Shard(Message):
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: List[int] = field(default_factory=list)


@dataclass
class Task(Message):
    task_id: int = -1
    task_type: str = ""
    shard: Shard = field(default_factory=Shard)

    @property
    def is_empty(self) -> bool:
        return self.task_id < 0


@dataclass
class TaskRequest(Message):
    dataset_name: str = ""


@dataclass
class TaskResult(Message):
    dataset_name: str = ""
    task_id: int = -1


@dataclass
class DatasetShardParams(Message):
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = ""
    storage_type: str = "text"


@dataclass
class StreamingDataReport(Message):
    """Producer → master: advance a streaming dataset's watermark or
    close the stream (parity: the message-queue offsets feeding the
    reference's StreamingDatasetSplitter, dataset_splitter.py:359)."""

    dataset_name: str = ""
    new_records: int = 0
    end: bool = False


@dataclass
class ShardCheckpointRequest(Message):
    dataset_name: str = ""


@dataclass
class ShardCheckpoint(Message):
    content: str = ""


@dataclass
class DatasetEpochRequest(Message):
    dataset_name: str = ""


@dataclass
class DatasetEpoch(Message):
    epoch: int = 0


# ---------------------------------------------------------------------------
# rendezvous messages (parity: grpc.py JoinRendezvousRequest/CommWorld etc.)
# ---------------------------------------------------------------------------


@dataclass
class JoinRendezvousRequest(Message):
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""
    node_unit: int = 1
    node_group: int = -1


@dataclass
class RendezvousParamsReport(Message):
    """Agent -> master: configure a rendezvous (parity: the rdzv params the
    MasterRendezvousHandler reports at construction, training.py:732)."""

    rdzv_name: str = ""
    min_nodes: int = 1
    max_nodes: int = 1
    waiting_timeout: float = 30.0
    node_unit: int = 1


@dataclass
class WaitingNodeNumRequest(Message):
    node_id: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""


@dataclass
class WaitingNodeNum(Message):
    waiting_num: int = 0


@dataclass
class CommWorldRequest(Message):
    node_id: int = 0
    rdzv_name: str = ""


@dataclass
class CommWorld(Message):
    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    # node_rank -> local_world_size for every participant of this round
    world: Dict[int, int] = field(default_factory=dict)
    # JAX bootstrap: coordinator address chosen by master (host:port of the
    # lowest-rank node in the world) — the TPU analog of the torch rdzv store.
    coordinator_addr: str = ""


@dataclass
class NetworkReadyRequest(Message):
    node_id: int = 0


@dataclass
class NetworkCheckResultRequest(Message):
    node_id: int = 0
    elapsed_time: float = 0.0
    succeeded: bool = True


@dataclass
class NetworkCheckStatus(Message):
    nodes: List[int] = field(default_factory=list)
    reason: str = ""


@dataclass
class StragglerExistRequest(Message):
    node_id: int = 0


# ---------------------------------------------------------------------------
# node / job lifecycle messages
# ---------------------------------------------------------------------------


@dataclass
class NodeMeta(Message):
    node_type: str = ""
    node_id: int = 0
    rank_index: int = 0
    addr: str = ""
    cpu: float = 0.0
    memory_mb: int = 0
    tpu_chips: int = 0
    tpu_type: str = ""


@dataclass
class NodeEventReport(Message):
    event_type: str = ""
    node_type: str = ""
    node_id: int = 0
    status: str = ""
    exit_reason: str = ""
    message: str = ""


@dataclass
class NodeFailureReport(Message):
    node_id: int = 0
    node_rank: int = 0
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


@dataclass
class EvictionNotice(Message):
    """A worker received an eviction/preemption notice and is draining
    (SIGTERM, ``DLROVER_TPU_EVICTION_DEADLINE_S``, master ``evict``
    command). The master treats this as a SCHEDULED departure: exclude
    the doomed rank from rendezvous, pre-arm the warm resize, relaunch
    without burning relaunch budget. Re-reported after the drain with
    ``drain_ms`` set — the measured drain latency the Brain's dwell
    gate prices (idempotent: the second report updates the event)."""

    node_id: int = 0
    grace_s: float = 0.0
    drain_ms: float = 0.0
    reason: str = ""


@dataclass
class HeartbeatReport(Message):
    node_id: int = 0
    timestamp: float = 0.0


@dataclass
class HeartbeatResponse(Message):
    action: str = ""  # "" | "restart" | "stop"


@dataclass
class ResourceStats(Message):
    node_id: int = 0
    cpu_percent: float = 0.0
    used_memory_mb: int = 0
    tpu_duty_cycle: float = 0.0
    tpu_hbm_used_mb: int = 0


@dataclass
class GlobalStepReport(Message):
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0


@dataclass
class JobMetricsSample(Message):
    """One point of the job metric series (parity: the stats the
    reference's JobMetricCollector hands its reporter)."""

    timestamp: float = 0.0
    global_step: int = 0
    steps_per_sec: float = 0.0
    alive_nodes: int = 0
    total_cpu_percent: float = 0.0
    total_memory_mb: int = 0
    # fleet goodput (obs/goodput.py ledger, aggregated per worker by
    # TelemetryAggregator): the %-of-wall-time-productive number the
    # Brain's allocation objective plans against. 0.0 = not reported.
    goodput_pct: float = 0.0


@dataclass
class JobMetricsRequest(Message):
    last_n: int = 0  # 0 = whole retained series


# -- Brain service (cluster-level optimizer) --------------------------------
@dataclass
class BrainMetricsReport(Message):
    """persist_metrics (parity: brain.proto:196)."""

    job_name: str = ""
    sample: JobMetricsSample = field(default_factory=JobMetricsSample)


@dataclass
class BrainOptimizeRequest(Message):
    job_name: str = ""
    node_unit: int = 1


@dataclass
class BrainOptimizePlan(Message):
    worker_count: int = 0  # 0 = no recommendation
    worker_memory_mb: int = 0
    reason: str = ""
    # hostnames the scheduler should avoid (cluster-level bad-node /
    # hot-node detection, parity: hot-PS exclusion in optalgorithm/)
    exclude_nodes: List[str] = field(default_factory=list)


@dataclass
class BrainJobEndReport(Message):
    """Terminal summary of a job — the rows cross-job cold-start
    resourcing fits from (parity: the reference Brain's job_metrics
    table keyed by ExitReason, optimize_job_worker_create_resource.go)."""

    job_name: str = ""
    exit_reason: str = "completed"  # completed | failed | oom
    worker_count: int = 0
    worker_memory_mb: int = 0


@dataclass
class BrainNodeEventReport(Message):
    """One node-level incident (oom/failed/hot) with its host — feeds
    OOM-adjust and cluster-level bad-node detection."""

    job_name: str = ""
    node_id: int = 0
    hostname: str = ""
    event: str = ""  # oom | failed | hot | eviction | ...
    memory_mb: int = 0
    cpu_percent: float = 0.0
    # free-form context ("grace=30.0s drain_ms=412"): eviction events
    # carry the measured drain latency the Brain dwell gate parses
    detail: str = ""


@dataclass
class BrainJobMetricsRequest(Message):
    job_name: str = ""
    last_n: int = 0


# -- Brain cluster scheduler (closed-loop multi-job allocation) -------------
@dataclass
class ClusterScalePlanRequest(Message):
    """Master → Brain poll for this job's slice of the cluster plan.

    ``ack_version`` is the highest plan version the master has durably
    EXECUTED: the Brain marks versions up to it acked and redelivers
    anything newer still pending — the PR-7 worker-command
    redeliver-until-acked pattern, so a lost response re-executes an
    idempotent ``scale_to`` instead of silently dropping the plan."""

    job_name: str = ""
    ack_version: int = 0


@dataclass
class ClusterScalePlanSlice(Message):
    """One job's slice of a versioned cluster plan. ``version == 0``
    means "no pending plan". ``sig`` is the scheduler's sign-off
    (crc32 over the version/job/count/ts tuple) — executors verify it
    before acting so a corrupted or spoofed row cannot resize a job."""

    version: int = 0
    job_name: str = ""
    worker_count: int = 0
    prev_count: int = 0
    reason: str = ""
    # cluster-level bad-node exclusion riding the plan (the scheduler's
    # bad_node_exclusion verdict at emission time)
    exclude_hosts: List[str] = field(default_factory=list)
    issued_ts: float = 0.0
    sig: int = 0


@dataclass
class PlanOutcomeReport(Message):
    """Master → Brain realized-outcome feedback for an executed plan
    slice: decision→resized latency plus the goodput the job actually
    ran at afterwards — the row that lets the scheduler's next pass see
    the result of its last one. Recording it is the plan's sign-off
    (status → acked)."""

    job_name: str = ""
    version: int = 0
    worker_count: int = 0
    decision_to_resized_ms: float = 0.0
    resized_to_training_ms: float = 0.0
    realized_goodput_pct: float = 0.0


@dataclass
class JobMetrics(Message):
    samples: List[JobMetricsSample] = field(default_factory=list)


@dataclass
class TrainMetricsReport(Message):
    """Periodic scalar training metrics (loss / eval_loss / lr / ...)
    from a worker to the master's collector — the AtorchTrainer
    metric-logging hook's master leg (ref atorch_trainer.py:127).

    ``open_span`` / ``open_span_elapsed_s`` carry the worker's current
    open trace span (obs/trace.SpanHeartbeat via the runtime-metrics
    file): the hang-attribution channel that lets the master say
    "worker 3 stuck in ckpt_commit for 42s" instead of "no step
    progress". Empty string = nothing open at last report."""

    node_id: int = 0
    step: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    open_span: str = ""
    open_span_elapsed_s: float = 0.0


@dataclass
class TrainingStatusReport(Message):
    node_id: int = 0
    status: int = 0  # TrainingLoopStatus
    timestamp: float = 0.0


@dataclass
class NodeAddressRequest(Message):
    node_type: str = ""


@dataclass
class NodeAddresses(Message):
    # rank_index -> addr
    addrs: Dict[int, str] = field(default_factory=dict)


@dataclass
class ClusterVersionRequest(Message):
    node_type: str = ""
    node_id: int = 0
    version_type: str = "global"


@dataclass
class ClusterVersion(Message):
    version: int = 0


@dataclass
class UpdateClusterVersionRequest(Message):
    node_type: str = ""
    node_id: int = 0
    version_type: str = "global"
    version: int = 0


# ---------------------------------------------------------------------------
# kv store (rendezvous store backing; parity: grpc.py KeyValuePair)
# ---------------------------------------------------------------------------


@dataclass
class KeyValuePair(Message):
    key: str = ""
    value: bytes = b""


@dataclass
class KeyValueQuery(Message):
    key: str = ""


@dataclass
class KeyValueAdd(Message):
    key: str = ""
    amount: int = 0


@dataclass
class KeyValueWait(Message):
    keys: List[str] = field(default_factory=list)
    timeout: float = 60.0


# ---------------------------------------------------------------------------
# sync / barrier service (parity: sync_service.py messages)
# ---------------------------------------------------------------------------


@dataclass
class SyncJoinRequest(Message):
    sync_name: str = ""
    node_id: int = 0
    node_type: str = ""


@dataclass
class SyncFinishRequest(Message):
    sync_name: str = ""


@dataclass
class SyncResult(Message):
    done: bool = False


@dataclass
class BarrierRequest(Message):
    barrier_name: str = ""
    notify: bool = False


# ---------------------------------------------------------------------------
# auto-paral config (parity: grpc.py ParallelConfig family)
# ---------------------------------------------------------------------------


@dataclass
class DataLoaderConfig(Message):
    dataloader_name: str = ""
    batch_size: int = 0
    num_workers: int = 0
    version: int = 0


@dataclass
class OptimizerConfig(Message):
    optimizer_name: str = ""
    learning_rate: float = 0.0
    # multiply the LR by this when the master retunes the batch size
    # (linear-scaling rule)
    batch_size_factor: float = 1.0
    version: int = 0


@dataclass
class ParallelConfig(Message):
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # TPU strategy knobs the master can retune at runtime:
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    remat_policy: str = ""
    restart: bool = False
    # the auto-scaler's top-k predicted next worker counts, most likely
    # first — workers pre-lower the train step for these meshes in the
    # background (the speculative leg of the elastic-resize fast path)
    candidate_worker_counts: List[int] = field(default_factory=list)


@dataclass
class ParallelConfigRequest(Message):
    node_id: int = 0


@dataclass
class CheckpointReadyRequest(Message):
    """Agent tells master the latest in-memory checkpoint step per node."""

    node_id: int = 0
    step: int = 0


@dataclass
class ElasticRunConfigRequest(Message):
    pass


@dataclass
class ElasticRunConfig(Message):
    configs: Dict[str, str] = field(default_factory=dict)


@dataclass
class ScaleRequest(Message):
    """Ask master to scale node group(s) — used by tests/tools."""

    node_type: str = ""
    count: int = 0


# -- master -> worker command channel (forensics / profiling) ---------------
@dataclass
class WorkerCommand(Message):
    """One master-issued command for a specific worker. Kinds:

    - ``flight_dump`` — dump a flight-recorder bundle now;
    - ``profile`` — capture ``arg`` train steps with torch.profiler;
    - ``evict`` — enter the graceful-drain state machine with a grace
      window of ``arg`` seconds (0 = the trainer's configured default):
      finish the in-flight step, emergency shm checkpoint, flush
      forensics, exit clean.

    Commands ride the existing pull architecture: the agent polls them
    off the master (``WorkerCommandRequest``) and relays them to the
    training process through a JSON file (the paral-config pattern) —
    the master never needs a connection INTO a worker."""

    id: int = 0  # master-assigned, monotonic per worker
    kind: str = ""
    arg: int = 0
    reason: str = ""


@dataclass
class WorkerCommandRequest(Message):
    node_id: int = -1  # -1 = the requesting node (BaseRequest.node_id)
    # highest command id the agent has durably relayed: the master
    # clears only acked commands, so a lost RESPONSE redelivers
    # instead of dropping (the pop itself must not be the ack — the
    # poll is a read with a side effect otherwise)
    ack_id: int = 0


@dataclass
class WorkerCommands(Message):
    commands: List[WorkerCommand] = field(default_factory=list)


# -- hierarchical control plane (agent aggregation tier) ---------------------
@dataclass
class ProcDelta(Message):
    """One training process's slice of an ``AgentReportBatch``.

    ``changed``/``removed`` are the delta-encoded scalar telemetry
    (``common/telemetry_delta.py``): only keys whose value changed
    since the last batch the master ACKED, plus keys that disappeared.
    ``step_advanced`` gates the SpeedMonitor leg exactly the way the
    legacy ``TrainingMonitor`` gated ``report_global_step`` — ``step``
    itself always carries the current step for metric attribution."""

    proc_id: int = 0
    # global worker id for telemetry/collector attribution; -1 = use
    # the batch's node_id (the single-proc-per-node common case)
    worker_id: int = -1
    step: int = -1  # -1 = no step known yet
    step_ts: float = 0.0
    step_advanced: bool = False
    changed: Dict[str, float] = field(default_factory=dict)
    removed: List[str] = field(default_factory=list)
    open_span: str = ""
    open_span_elapsed_s: float = 0.0


@dataclass
class AgentReportBatch(Message):
    """One node's whole control-plane tick in a single RPC: the agent
    aggregation tier coalesces every per-process runtime-metrics /
    global-step / telemetry report into this message, delta-encoded
    against the last acked snapshot, and piggybacks the poll legs
    (worker commands, paral config) on the same round trip — steady
    state is ~1 RPC per node per tick instead of one per process per
    channel.

    ``epoch``/``seq``/``full`` are the delta protocol
    (``common/telemetry_delta.py``): the master reconstructs full
    scalars from its per-node snapshot and answers ``resync=True``
    when it cannot (restart, gap) — the next batch is then a full
    snapshot under a fresh epoch. No scalar is ever dropped."""

    node_id: int = 0
    epoch: int = 0
    seq: int = 0
    full: bool = False
    procs: List[ProcDelta] = field(default_factory=list)
    # piggybacked command-poll leg (WorkerCommandRequest semantics:
    # ack clears, the rest redelivers)
    command_ack_id: int = 0
    # piggybacked paral-config poll leg: the dataloader version the
    # agent last wrote (-1 = none yet). The response carries the
    # config only when the agent's copy is stale.
    paral_version: int = -1
    # piggybacked resource leg (the ResourceMonitor channel)
    resource: Optional[ResourceStats] = None


@dataclass
class AgentBatchResponse(Message):
    """Master's answer to an ``AgentReportBatch``: the batched poll
    legs ride back on the same round trip. ``resync=True`` means the
    delta could not be applied (nothing was) — the agent must re-send
    a full snapshot."""

    resync: bool = False
    commands: List[WorkerCommand] = field(default_factory=list)
    # only set when the agent's paral_version is stale
    paral_config: Optional[ParallelConfig] = None
