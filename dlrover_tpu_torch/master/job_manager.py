"""Job manager: authoritative node table, heartbeats, failure handling and
relaunch policy.

Parity: dlrover/python/master/node/dist_job_manager.py:88 (``_monitor_nodes``,
``_should_relaunch:561``, ``_relaunch_node:605``) and local_job_manager.py:175.
This module holds the platform-independent core; the k8s-backed manager
(pod watcher + scaler) plugs a `scaler` and `watcher` into the same class.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node, NodeResource

_ctx = Context.singleton_instance()


class NodeEvent:
    def __init__(self, event_type: str, node: Node):
        self.event_type = event_type
        self.node = node


class JobManager:
    """Tracks every node of the job and decides relaunches."""

    def __init__(
        self,
        speed_monitor=None,
        scaler=None,
        max_relaunch_count: int = 3,
        brain_reporter: Optional[Callable] = None,
    ):
        # brain_reporter(node_id, hostname, event, memory_mb, detail):
        # incident feed for the cluster Brain
        # (BrainClient.report_node_event) — fire-and-forget, failures
        # never block relaunch
        self._brain_reporter = brain_reporter
        self._lock = threading.Lock()
        # serializes replacement decisions between the servicer's event
        # path (_relaunch_node) and the auto-scaler thread, so a node in
        # the released-but-not-yet-replaced window isn't replaced twice
        self.scale_lock = threading.Lock()
        self._job_nodes: Dict[str, Dict[int, Node]] = {}
        self._speed_monitor = speed_monitor
        self._scaler = scaler
        self._max_relaunch_count = max_relaunch_count
        self._next_node_id: Dict[str, int] = {}
        self._stopped = False
        self._relaunch_listeners: List[Callable[[Node, Node], None]] = []
        # eviction listeners: the master wires rendezvous exclusion,
        # auto-scaler pre-arming and telemetry maintenance here —
        # cb(node_type, node_id, grace_s, drain_ms)
        self._eviction_listeners: List[Callable] = []
        # SDC conviction listeners (the master wires permanent
        # rendezvous quarantine, scheduler anti-affinity and telemetry
        # maintenance here) — cb(node_type, node_id, detail)
        self._sdc_listeners: List[Callable] = []
        # (node_type, node_id) convicted of silent data corruption:
        # quarantined capacity, treated as absent until hardware
        # replacement clears it
        self._quarantined: List[Tuple[str, int]] = []
        # bounded log of non-fatal node incidents (degraded checkpoint
        # mode, recoveries, ...): queryable by operators/tests and
        # mirrored to the Brain when a reporter is wired
        self._node_events: List[Dict] = []

    # -- node table ----------------------------------------------------
    def add_node(self, node: Node):
        with self._lock:
            self._job_nodes.setdefault(node.type, {})[node.id] = node
            nxt = self._next_node_id.get(node.type, 0)
            self._next_node_id[node.type] = max(nxt, node.id + 1)

    def create_initial_nodes(
        self,
        node_num: int,
        node_type: str = NodeType.WORKER,
        resource: Optional[NodeResource] = None,
        group_size: int = 1,
    ):
        for i in range(node_num):
            self.add_node(
                Node(
                    node_type=node_type,
                    node_id=i,
                    rank_index=i,
                    config_resource=resource or NodeResource(),
                    max_relaunch_count=self._max_relaunch_count,
                    group=i // group_size,
                    group_size=group_size,
                )
            )

    def get_node(self, node_type: str, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._job_nodes.get(node_type, {}).get(node_id)

    def get_nodes(self, node_type: str = "") -> List[Node]:
        with self._lock:
            if node_type:
                return list(self._job_nodes.get(node_type, {}).values())
            return [
                n
                for group in self._job_nodes.values()
                for n in group.values()
            ]

    def get_running_nodes(self) -> List[Node]:
        return [
            n
            for n in self.get_nodes()
            if n.status == NodeStatus.RUNNING and not n.is_released
        ]

    # -- heartbeats / usage --------------------------------------------
    def collect_node_heartbeat(self, node_type: str, node_id: int) -> str:
        node = self.get_node(node_type, node_id)
        if node is None:
            return ""
        node.heartbeat_time = time.time()
        if node.restart_training:
            node.restart_training = False
            return "restart"
        return ""

    def update_node_resource_usage(
        self, node_type: str, node_id: int, cpu: float, memory_mb: int
    ):
        node = self.get_node(node_type, node_id)
        if node is not None:
            node.used_resource.cpu = cpu
            node.used_resource.memory_mb = memory_mb

    def get_heartbeat_timeout_nodes(
        self, timeout: Optional[float] = None
    ) -> List[Node]:
        timeout = timeout or _ctx.node_heartbeat_timeout_secs
        return [
            n
            for n in self.get_running_nodes()
            if n.timeout(timeout)
        ]

    # -- events & relaunch policy --------------------------------------
    def process_event(self, event: NodeEvent):
        """Apply a reported node event; may trigger relaunch."""
        node = self.get_node(event.node.type, event.node.id)
        if node is None:
            self.add_node(event.node)
            node = event.node
        if event.event_type == NodeEventType.DELETED:
            node.is_released = True
            node.update_status(NodeStatus.DELETED)
        else:
            node.exit_reason = event.node.exit_reason or node.exit_reason
            if event.node.hostname:
                node.hostname = event.node.hostname
            node.update_status(event.node.status)
        if node.status in (NodeStatus.FAILED, NodeStatus.BREAKDOWN):
            self._handle_node_failure(node)
        elif node.status == NodeStatus.RUNNING and self._speed_monitor:
            self._speed_monitor.add_running_worker(node.id)

    def _should_relaunch(self, node: Node) -> bool:
        """Parity: dist_job_manager.py:561 — relaunch unless the failure is
        unrecoverable (fatal user error or out of relaunch budget)."""
        if self._stopped or node.is_released:
            return False
        if _ctx.relaunch_always:
            return True
        if node.exit_reason == NodeExitReason.FATAL_ERROR:
            return False
        if node.exit_reason == NodeExitReason.PREEMPTED:
            # scheduled departures replace regardless of budget — the
            # budget exists to stop crash loops, and an eviction is
            # the platform's fault, not the workload's
            return True
        return node.relaunch_count < node.max_relaunch_count

    def _handle_node_failure(self, node: Node):
        if self._speed_monitor:
            self._speed_monitor.remove_running_worker(node.id)
        if node.evicting:
            # a death that was ANNOUNCED (eviction notice) is a
            # scheduled departure, not a crash: no OOM doubling, the
            # Brain sees `eviction_exit` (not `failed`), and the
            # replacement keeps the old relaunch budget
            node.exit_reason = NodeExitReason.PREEMPTED
            self._report_to_brain(
                node, "eviction_exit", node.config_resource.memory_mb
            )
        else:
            self._report_to_brain(
                node,
                "oom"
                if node.exit_reason == NodeExitReason.OOM
                else "failed",
                node.config_resource.memory_mb,
            )
        if node.exit_reason == NodeExitReason.OOM:
            # give the replacement more memory (parity: reference doubles
            # memory on OOM relaunch via the resource optimizer)
            node.config_resource.memory_mb = int(
                node.config_resource.memory_mb * 2
            )
        if self._should_relaunch(node):
            self._relaunch_node(node)
        else:
            logger.warning(
                f"node {node.name} failed unrecoverably: "
                f"{node.exit_reason}"
            )

    def allocate_node_id(self, node_type: str) -> int:
        with self._lock:
            new_id = self._next_node_id.get(node_type, 0)
            self._next_node_id[node_type] = new_id + 1
        return new_id

    def _relaunch_node(self, node: Node):
        """Parity: dist_job_manager.py:605."""
        with self.scale_lock:
            node.is_released = True
            new_id = self.allocate_node_id(node.type)
            new_node = node.get_relaunch_node_info(new_id)
            new_node.exit_reason = NodeExitReason.RELAUNCHED
            if node.exit_reason == NodeExitReason.PREEMPTED:
                # a scheduled departure must not burn relaunch budget:
                # spot fleets are evicted daily, and three evictions
                # exhausting max_relaunch_count would turn routine
                # churn into an unrecoverable rank
                new_node.relaunch_count = node.relaunch_count
            self.add_node(new_node)
        logger.info(
            f"relaunch {node.name} -> {new_node.name} "
            f"(attempt {new_node.relaunch_count}/{node.max_relaunch_count})"
        )
        if self._scaler is not None:
            self._scaler.relaunch_node(node, new_node)
        self.notify_relaunch(node, new_node)

    def add_relaunch_listener(self, cb: Callable[[Node, Node], None]):
        self._relaunch_listeners.append(cb)

    def notify_relaunch(self, old: Optional[Node], new_node: Node):
        """Fire the relaunch listeners — the event-path relaunch AND
        the auto-scaler's replacement creation both go through here,
        so a listener (e.g. the master clearing a dead rank's
        rendezvous exclusion for its healthy replacement) sees every
        way a rank comes back."""
        for cb in self._relaunch_listeners:
            try:
                cb(old, new_node)
            except Exception as e:
                logger.warning(f"relaunch listener failed: {e!r}")

    def handle_training_failure(
        self,
        node_type: str,
        node_id: int,
        restart_count: int = 0,
        error_data: str = "",
        level: str = TrainingExceptionLevel.PROCESS_ERROR,
    ):
        """A training process (not the whole node) failed.

        Process errors are retried in place by the agent; node errors mark
        the node failed so the relaunch policy runs.
        """
        node = self.get_node(node_type, node_id)
        if node is None:
            return
        logger.warning(
            f"training failure on {node.name}: level={level} "
            f"restart={restart_count} err={error_data[:200]}"
        )
        if level == TrainingExceptionLevel.NODE_ERROR:
            node.exit_reason = NodeExitReason.HARDWARE_ERROR
            node.update_status(NodeStatus.BREAKDOWN)
            self._handle_node_failure(node)
        elif level == TrainingExceptionLevel.WARNING:
            # non-fatal incident (e.g. the saver's "ckpt_degraded: ..."
            # shm-only-persistence alert): record a node event, don't
            # touch the relaunch machinery — the node is healthy, its
            # storage is not
            event = error_data.split(":", 1)[0].strip() or "warning"
            self.record_node_event(
                node_type, node_id, event, detail=error_data
            )

    def add_eviction_listener(self, cb: Callable):
        """``cb(node_type, node_id, grace_s, drain_ms)`` fires on every
        eviction notice (the master wires rendezvous exclusion, resize
        pre-arming and telemetry maintenance here)."""
        self._eviction_listeners.append(cb)

    def handle_eviction_notice(
        self,
        node_type: str,
        node_id: int,
        grace_s: float = 0.0,
        drain_ms: float = 0.0,
        reason: str = "",
    ):
        """A worker announced its eviction (SIGTERM / platform deadline
        / operator): book it as a SCHEDULED departure. The node is
        marked ``evicting`` — its coming death relaunches without
        burning budget and reports ``eviction_exit`` to the Brain —
        and the notice fans out to the listeners that pre-arm the warm
        resize and exclude the doomed rank from rendezvous. Idempotent:
        the post-drain re-report (``drain_ms`` > 0) updates the
        recorded event with the measured drain latency."""
        node = self.get_node(node_type, node_id)
        if node is not None:
            node.evicting = True
        detail = f"grace={grace_s:.1f}s drain_ms={drain_ms:.0f}"
        if reason:
            detail += f" {reason}"
        self.record_node_event(node_type, node_id, "eviction", detail)
        logger.warning(
            f"eviction notice for {node_type}-{node_id}: {detail}"
        )
        for cb in self._eviction_listeners:
            try:
                cb(node_type, node_id, grace_s, drain_ms)
            except Exception as e:
                logger.warning(f"eviction listener failed: {e!r}")

    # -- silent-data-corruption quarantine (parallel/sdc.py tier 3) ----
    def add_sdc_listener(self, cb: Callable):
        """``cb(node_type, node_id, detail)`` fires on every SDC
        conviction (the master wires permanent rendezvous quarantine,
        scheduler anti-affinity and telemetry maintenance here)."""
        self._sdc_listeners.append(cb)

    def handle_sdc_conviction(
        self, node_type: str, node_id: int, detail: str = ""
    ):
        """A worker's paired-device audit convicted this node's chip of
        silent data corruption. Unlike an eviction this is NOT a
        scheduled departure the node recovers from: the hardware lies,
        so the node is quarantined — breakdown status, permanent
        rendezvous exclusion via the listeners, and a
        ``sdc_conviction`` node event (carrying the vote-matrix
        evidence) rides to the Brain so the cluster-wide exclusion list
        condemns the host for every job. Idempotent per node."""
        node = self.get_node(node_type, node_id)
        key = (node_type, node_id)
        with self._lock:
            already = key in self._quarantined
            if not already:
                self._quarantined.append(key)
        if node is not None:
            node.exit_reason = NodeExitReason.SDC_QUARANTINED
            node.update_status(NodeStatus.BREAKDOWN)
        self.record_node_event(
            node_type, node_id, "sdc_conviction", detail
        )
        logger.error(
            f"sdc conviction for {node_type}-{node_id}: chip "
            f"quarantined (treated as absent capacity until hardware "
            f"replacement)"
        )
        if already:
            return
        for cb in self._sdc_listeners:
            try:
                cb(node_type, node_id, detail)
            except Exception as e:
                logger.warning(f"sdc listener failed: {e!r}")

    def quarantined_nodes(self) -> List[Tuple[str, int]]:
        """Nodes convicted of silent data corruption this master's
        lifetime — absent capacity for every scheduling decision."""
        with self._lock:
            return list(self._quarantined)

    def record_node_event(
        self, node_type: str, node_id: int, event: str, detail: str = ""
    ):
        with self._lock:
            self._node_events.append(
                {
                    "node_type": node_type,
                    "node_id": node_id,
                    "event": event,
                    "detail": detail,
                    "ts": time.time(),
                }
            )
            del self._node_events[:-200]
        node = self.get_node(node_type, node_id)
        if node is not None:
            self._report_to_brain(node, event, 0, detail=detail)

    def _report_to_brain(
        self, node: Node, event: str, memory_mb: int, detail: str = ""
    ):
        """Mirror one node incident to the Brain. Only with a PHYSICAL
        host identity: falling back to the per-job logical name would
        let two unrelated jobs' "worker-0" incidents condemn a phantom
        host cluster-wide. Fire-and-forget on a daemon thread: the
        client retries with backoff, so an unreachable Brain would
        otherwise stall the servicer's event path (and every relaunch)
        for ~30s."""
        if self._brain_reporter is None or not node.hostname:
            return
        args = (node.id, node.hostname, event, memory_mb, detail)

        def _report():
            try:
                self._brain_reporter(*args)
            except Exception as e:
                logger.warning(f"brain node-event report failed: {e!r}")

        threading.Thread(
            target=_report, name="brain-node-event", daemon=True
        ).start()

    def node_events(self, event: str = "") -> List[Dict]:
        """Recorded incidents, optionally filtered by event name."""
        with self._lock:
            return [
                dict(e)
                for e in self._node_events
                if not event or e["event"] == event
            ]

    # -- hang detection -------------------------------------------------
    def all_running_node_hanged(self) -> bool:
        if self._speed_monitor is None:
            return False
        return self._speed_monitor.all_worker_hanged()

    def restart_all_workers(self) -> int:
        """Order every running node's agent to restart its training procs
        via the heartbeat action channel (parity: the reference's hang path
        relaunches through the agent, dist_job_manager.py hang handling —
        it does NOT kill the job). Returns the number of nodes signalled."""
        nodes = self.get_running_nodes()
        for node in nodes:
            node.restart_training = True
        if self._speed_monitor is not None:
            self._speed_monitor.reset_running_speed_monitor()
        logger.warning(
            f"ordered restart of {len(nodes)} running nodes (hang recovery)"
        )
        return len(nodes)

    def stop(self):
        self._stopped = True


class LocalJobManager(JobManager):
    """Single-host job manager (parity: local_job_manager.py:175) — nodes
    are local agent processes; no external scheduler involved."""
