"""Scalers: turn a ScalePlan into running nodes.

Parity: dlrover/python/master/scaler/base_scaler.py (ScalePlan + Scaler
interface), pod_scaler.py:76 (PodScaler creates/deletes pods directly)
and elasticjob_scaler.py:153 (writes a ScalePlan CRD for the operator).
The TPU build keeps the same seam: the auto-scaler and job manager speak
only ``Scaler``; deployments plug in

- ``LocalProcessScaler`` — nodes are `dlrover-tpu-run` agent processes on
  this host (local jobs, tests);
- ``ElasticJobScaler`` (dlrover_tpu/k8s/scaler.py) — writes the ScalePlan
  custom resource and lets the operator converge pods, the preferred
  production path on GKE/TPU-VM;
- any callback-driven scaler for test harnesses (``CallbackScaler``).
"""

from __future__ import annotations

import abc
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


@dataclass
class ScalePlan:
    """Desired-state delta the scaler must converge.

    Parity: the reference's ScalePlan CRD spec (go/operator/api/v1alpha1/
    scaleplan_types.go): replica counts plus explicit node create/remove
    lists (used for relaunch, which is remove+create with inherited
    rank).
    """

    node_group: Dict[str, int] = field(default_factory=dict)
    launch_nodes: List[Node] = field(default_factory=list)
    remove_nodes: List[Node] = field(default_factory=list)

    def empty(self) -> bool:
        return not (self.node_group or self.launch_nodes or self.remove_nodes)


class Scaler(abc.ABC):
    @abc.abstractmethod
    def scale(self, plan: ScalePlan) -> None:
        """Converge the platform to the plan. Must be idempotent."""

    def relaunch_node(self, old: Node, new: Node) -> None:
        self.scale(ScalePlan(launch_nodes=[new], remove_nodes=[old]))

    def set_exclude_hosts(self, hosts) -> None:
        """Hosts future launches must avoid (Brain bad-node exclusion).
        Default no-op: platforms without host placement ignore it."""


class CallbackScaler(Scaler):
    """Test/embedding seam: forwards the plan to a callable."""

    def __init__(self, fn: Callable[[ScalePlan], None]):
        self._fn = fn
        self.plans: List[ScalePlan] = []

    def scale(self, plan: ScalePlan) -> None:
        self.plans.append(plan)
        self._fn(plan)


class LocalProcessScaler(Scaler):
    """Nodes are launcher subprocesses on this host.

    Parity: the reference has no local scaler (local jobs never scale);
    on TPU-VM single-host jobs this gives the same elasticity story as
    k8s — the master can replace a dead agent process — and it is the
    scaler the subprocess-cluster tests drive.

    ``command_for(node)`` builds the agent command line; by default it
    re-runs ``dlrover-tpu-run`` with the recorded training command
    against this master.
    """

    def __init__(
        self,
        master_addr: str,
        training_cmd: Optional[List[str]] = None,
        nproc_per_node: int = 1,
        spawn_fn: Optional[Callable[[Node], object]] = None,
    ):
        self._master_addr = master_addr
        self._training_cmd = training_cmd or []
        self._nproc = nproc_per_node
        self._spawn_fn = spawn_fn
        self._procs: Dict[str, subprocess.Popen] = {}
        self._terminated: List[subprocess.Popen] = []
        self._lock = threading.Lock()

    def command_for(self, node: Node) -> List[str]:
        return [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.trainer.run",
            f"--master-addr={self._master_addr}",
            f"--node-rank={node.rank_index}",
            f"--nproc-per-node={self._nproc}",
            *self._training_cmd,
        ]

    def _reap(self):
        """Collect exited children (poll() reaps the zombie) and drop
        their table entries, including nodes that died on their own."""
        with self._lock:
            dead = [
                name
                for name, p in self._procs.items()
                if p.poll() is not None
            ]
            for name in dead:
                del self._procs[name]
            self._terminated = [
                p for p in self._terminated if p.poll() is None
            ]

    def scale(self, plan: ScalePlan) -> None:
        from dlrover_tpu_torch.utils.env import child_env

        self._reap()
        for node in plan.remove_nodes:
            with self._lock:
                proc = self._procs.pop(node.name, None)
            if proc is not None and proc.poll() is None:
                logger.info(f"scaler terminating {node.name}")
                proc.terminate()
                with self._lock:
                    self._terminated.append(proc)
        for node in plan.launch_nodes:
            if self._spawn_fn is not None:
                self._spawn_fn(node)
                continue
            cmd = self.command_for(node)
            logger.info(f"scaler launching {node.name}: {' '.join(cmd)}")
            proc = subprocess.Popen(cmd, env=child_env())
            with self._lock:
                self._procs[node.name] = proc

    def stop(self, grace: float = 5.0):
        with self._lock:
            procs = list(self._procs.values()) + self._terminated
            self._procs.clear()
            self._terminated = []
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + grace
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
