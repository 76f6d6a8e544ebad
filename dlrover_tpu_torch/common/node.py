"""Node/job data model and the node-status state machine.

Parity: dlrover/python/common/node.py:37-358 (Node/NodeResource/
NodeGroupResource) and dlrover/python/master/node/status_flow.py:136
(allowed status transitions). Re-designed for TPU: a Node is one *host* of
a TPU slice; ``group`` identifies the slice (all hosts of a slice restart
together), ``tpu_chips`` replaces GPU counts.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)

# Allowed transitions of the node status state machine. Anything not listed
# is an invalid transition and is ignored by the job manager.
_STATUS_FLOW = {
    NodeStatus.INITIAL: {
        NodeStatus.PENDING,
        NodeStatus.RUNNING,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
    },
    NodeStatus.PENDING: {
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.RUNNING: {
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
    NodeStatus.FAILED: {NodeStatus.DELETED, NodeStatus.PENDING},
    NodeStatus.BREAKDOWN: {NodeStatus.DELETED},
    NodeStatus.DELETED: set(),
}


def is_allowed_transition(frm: str, to: str) -> bool:
    if frm == to:
        return False
    return to in _STATUS_FLOW.get(frm, set())


@dataclass
class NodeResource:
    """Resources of one TPU host.

    ``tpu_chips`` = local accelerator chips (e.g. 4 on v5p hosts);
    ``tpu_topology`` = slice topology string (e.g. "2x2x2") when known.
    """

    cpu: float = 0.0
    memory_mb: int = 0
    tpu_chips: int = 0
    tpu_type: str = ""
    tpu_topology: str = ""

    def to_dict(self) -> Dict:
        return {
            "cpu": self.cpu,
            "memory_mb": self.memory_mb,
            "tpu_chips": self.tpu_chips,
            "tpu_type": self.tpu_type,
            "tpu_topology": self.tpu_topology,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "NodeResource":
        return cls(**d)


@dataclass
class NodeGroupResource:
    """Resource spec for a group of identical nodes (one replica type)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: Optional[int] = None, resource: Optional[NodeResource] = None):
        if count is not None and count >= 0:
            self.count = count
        if resource is not None:
            self.node_resource = resource


class Node:
    """One schedulable host in the job.

    State machine + relaunch bookkeeping. The master's job manager owns the
    authoritative instance; agents refer to nodes by (type, id).
    """

    def __init__(
        self,
        node_type: str = NodeType.WORKER,
        node_id: int = 0,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
        group: int = 0,
        group_size: int = 1,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.max_relaunch_count = max_relaunch_count
        self.relaunch_count = 0
        self.relaunchable = True
        self.is_released = False
        self.exit_reason: str = ""
        self.group = group
        self.group_size = group_size
        self.create_time: float = time.time()
        # physical host identity (k8s spec.nodeName / VM hostname) — set
        # by watchers/agents; "" when the platform doesn't expose it.
        # Cluster-level bad-node detection keys on THIS, never on the
        # per-job logical name (every job has a "worker-0")
        self.hostname: str = ""
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.start_hang_time: float = 0.0
        self.paral_config: Dict = {}
        self.reported_status: str = ""
        self.restart_training = False
        # an eviction notice arrived for this node: its coming death is
        # a SCHEDULED departure (no relaunch budget burned, booked as
        # `eviction`, host excluded from the next rendezvous)
        self.evicting = False

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    def update_status(self, status: str) -> bool:
        """Apply a status transition; returns True if it was legal."""
        if not is_allowed_transition(self.status, status):
            return False
        self.status = status
        now = time.time()
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = now
        if status in (
            NodeStatus.SUCCEEDED,
            NodeStatus.FAILED,
            NodeStatus.BREAKDOWN,
            NodeStatus.DELETED,
        ):
            self.finish_time = now
        return True

    def update_node_check_result(self, result: str):
        self.reported_status = result

    def is_unrecoverable_failure(self) -> bool:
        """Failures that must not be relaunched.

        Parity: exitcode policy in dlrover/python/elastic_agent/torch/
        training.py:354-357 — fatal user-code errors don't get new pods.
        """
        if self.relaunch_count >= self.max_relaunch_count:
            return True
        return self.exit_reason == NodeExitReason.FATAL_ERROR

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def get_relaunch_node_info(self, new_id: int) -> "Node":
        """Clone this node as its relaunch replacement."""
        new_node = Node(
            node_type=self.type,
            node_id=new_id,
            rank_index=self.rank_index,
            status=NodeStatus.INITIAL,
            config_resource=copy.deepcopy(self.config_resource),
            max_relaunch_count=self.max_relaunch_count,
            group=self.group,
            group_size=self.group_size,
        )
        new_node.relaunch_count = self.relaunch_count + 1
        return new_node

    def timeout(self, timeout_secs: float) -> bool:
        return (
            self.heartbeat_time > 0
            and time.time() - self.heartbeat_time > timeout_secs
        )

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"Node({self.type}-{self.id} rank={self.rank_index} "
            f"status={self.status} relaunch={self.relaunch_count})"
        )
