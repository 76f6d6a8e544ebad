"""Constant catalogs of the port (a copy of
``dlrover_tpu/common/constants.py``; the environment names are the same,
so an agent of either package drives workers of either alike).

``ConfigPath`` is the port's own: its default files lie under the
process's temp directory (``$TMPDIR``), not a fixed ``/tmp`` path.
``NodeEnv`` has no platform variable: the port's workers take their
device from ``DLROVER_TPU_DEVICE_SPEC`` (``cpu`` or ``cuda``).
"""

import os
import tempfile

_TMP = os.path.join(tempfile.gettempdir(), "dlrover_tpu")


class ConfigPath:
    """Runtime paral-config plumbing (master -> agent -> dataloader), the
    runtime-metrics file (worker -> agent) and the worker-command file
    (master -> agent -> worker)."""

    ENV_PARAL_CONFIG = "DLROVER_TPU_PARAL_CONFIG_PATH"
    PARAL_CONFIG = os.path.join(_TMP, "auto_paral_config.json")
    ENV_RUNTIME_METRICS = "DLROVER_TPU_RUNTIME_METRICS_PATH"
    RUNTIME_METRICS = os.path.join(_TMP, "runtime_metrics.json")
    ENV_WORKER_COMMANDS = "DLROVER_TPU_WORKER_COMMANDS_PATH"
    WORKER_COMMANDS = os.path.join(_TMP, "worker_commands.json")
    # flight-recorder bundles and profiler captures (obs/flight_recorder)
    ENV_FLIGHT_DIR = "DLROVER_TPU_FLIGHT_DIR"
    FLIGHT_DIR = os.path.join(_TMP, "flight")


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "k8s"


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    # TF-PS parity types (sparse/elastic-PS layer):
    PS = "ps"
    CHIEF = "chief"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"  # hardware fault detected by health check


class TaskType:
    TRAIN = "train"
    EVAL = "eval"
    # streaming: no shard ready yet, worker should retry (not exhausted)
    WAIT = "wait"


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    UNKNOWN_ERROR = "unknown_error"
    RELAUNCHED = "relaunched"
    # deliberately removed by a scale-down; the rank may come back later
    # with a fresh relaunch budget
    SCALED_DOWN = "scaled_down"
    # evicted by the platform (spot/preemptible reclaim): a SCHEDULED
    # departure — the replacement does not burn relaunch budget, the
    # gap is booked to the `eviction` goodput category, and the Brain
    # prices the job's floor/dwell accordingly
    PREEMPTED = "preempted"
    # convicted of silent data corruption by the paired-device audit
    # vote (parallel/sdc.py): the chip computes wrong-but-finite
    # numbers, so it must NEVER rejoin — permanent rendezvous
    # quarantine until hardware replacement, and the scheduler treats
    # the host as absent capacity
    SDC_QUARANTINED = "sdc_quarantined"


class JobExitReason:
    SUCCEEDED = "succeeded"
    CODE_ERROR = "code_error"
    WORKER_OOM = "worker_oom"
    WORKER_ERROR = "worker_error"
    HANG_ERROR = "hang_error"
    RDZV_TIMEOUT_ERROR = "rdzv_timeout_error"
    PENDING_TIMEOUT = "pending_timeout"
    UNKNOWN_ERROR = "unknown_error"


class TrainingExceptionLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    WARNING = "warning"
    INFO = "info"


class RendezvousName:
    ELASTIC_TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class NetworkFailureReason:
    NO_INIT = "not_initialized"
    NODE_FAILURE = "node_failure"
    WAITING_NODE = "waiting_node"


class TrainingLoopStatus:
    START = 1
    END = 2
    PENDING = 3


class JobStage:
    """Lifecycle stage of the whole job on the master."""

    INIT = "init"
    RUNNING = "running"
    SUSPENDED = "suspended"
    STOPPING = "stopping"
    STOPPED = "stopped"


class CheckpointConstant:
    MODEL_STATES_NAME = "model_states"
    TRAIN_STATE_NAME = "train_state"
    TRACKER_FILE = "latest_step"
    SAVE_TIMEOUT = 600


class NodeEnv:
    """Env vars the agent exports into training processes."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # torch.distributed bootstrap: the master assigns the coordinator,
    # whose address becomes the tcp:// rendezvous of init_process_group
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"


class TrainerEnv:
    """Env vars the trainer and the node check read."""

    # a platform's preemption deadline: sets the eviction grace window
    # and installs the SIGTERM drain handler
    EVICTION_DEADLINE_S = "DLROVER_TPU_EVICTION_DEADLINE_S"
    # the flight recorder's hang watchdog threshold (default 120 s)
    HANG_DUMP_AFTER_S = "DLROVER_TPU_HANG_DUMP_AFTER_S"
    # the node check: where each rank writes its timing, and the ranks
    # made to fail or lag on purpose
    CHECK_RESULT_FILE = "DLROVER_TPU_CHECK_RESULT_FILE"
    MOCK_ERR_RANK = "DLROVER_TPU_MOCK_ERR_RANK"
    MOCK_SLOW_RANK = "DLROVER_TPU_MOCK_SLOW_RANK"


class DefaultValues:
    SERVICE_PORT = 0  # pick a free port
    RDZV_TIMEOUT_SECS = 600
    PENDING_TIMEOUT_SECS = 900
    HANG_TIMEOUT_SECS = 1800
    HEARTBEAT_INTERVAL_SECS = 15
    MONITOR_INTERVAL_SECS = 5
    MAX_RELAUNCH_COUNT = 3
    SHARD_QUEUE_TIMEOUT = 600


class NodeCheckResult:
    """Outcome of a node health (network) check round."""

    NORMAL = "normal"
    FAULT = "fault"
    STRAGGLER = "straggler"
