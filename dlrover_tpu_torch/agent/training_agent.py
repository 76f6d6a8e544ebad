"""Per-host elastic agent: master-driven rendezvous, training-process
supervision, restart policy, membership-change handling (a copy of
``dlrover_tpu/agent/training_agent.py``).

Parity: dlrover/python/elastic_agent/torch/training.py:347
(``ElasticTrainingAgent`` with ``_invoke_run:548``, ``_rendezvous:389``,
``_restart_workers:652``, ``_monitor_workers``) and
``MasterRendezvousHandler:166``: the agent spawns training processes with
the distributed bootstrap env (coordinator address, process id, process
count) computed from the master-assigned comm world, monitors them, and
implements the goodput-critical state machine:

  HEALTHY --(proc fails)--> FAILED: report, save-at-breakpoint hook,
      restart workers (counts against max_restarts)
  HEALTHY --(num_nodes_waiting > 0)--> membership change: restart workers
      WITHOUT counting against max_restarts (training.py:606-610)
  HEALTHY --(master heartbeat action)--> restart/stop on master's order

The coordinator is the ``tcp://`` rendezvous of
``torch.distributed.init_process_group``: the lowest node's
``host:_coordinator_port``, a port picked free at each rendezvous that
process 0's store binds. Should another process take the port first,
process 0 fails to bind and exits non-zero, and the agent restarts the
round on a fresh port. The agent process itself never touches the card:
it imports torch only for the checkpoint saver's host side.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.utils.env import ensure_framework_on_pythonpath


# bound at import time: a preexec hook runs between fork and exec in a
# multithreaded parent, where an import/dlopen can deadlock on a lock
# whose owner doesn't exist in the child (subprocess docs warn exactly
# this for preexec_fn)
try:
    import ctypes

    _libc_prctl = ctypes.CDLL("libc.so.6", use_errno=True).prctl
except Exception:  # non-Linux
    _libc_prctl = None
_PR_SET_PDEATHSIG = 1


def _die_with_parent(expected_ppid: int = 0):
    """preexec hook: SIGKILL this worker if its agent dies.

    A SIGKILL'd agent (chaos, OOM-killer) cannot reap its training
    procs; orphaned workers then fight the relaunched node's workers
    for the job's shm segments and checkpoint locks and hang the job
    (found by the chaos soak). On k8s the pod cgroup provides this
    guarantee; the local/process platform needs PR_SET_PDEATHSIG.
    Linux-only; a no-op elsewhere. Only calls pre-bound symbols and
    syscalls — nothing here may allocate, import, or lock.

    Classic pdeathsig race: the parent can die between fork and prctl,
    in which case the signal never fires — so after arming it, verify
    the parent is still the process that forked us (callers bind their
    own pid into the hook before spawning) and exit if it changed.
    """
    if _libc_prctl is not None:
        _libc_prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
        if expected_ppid and os.getppid() != expected_ppid:
            os._exit(1)


def die_with_parent_hook():
    """Build a preexec_fn with the spawning process's pid bound in."""
    import functools

    return functools.partial(_die_with_parent, os.getpid())


class WorkerState(str, Enum):
    INIT = "INIT"
    HEALTHY = "HEALTHY"
    FAILED = "FAILED"
    SUCCEEDED = "SUCCEEDED"
    STOPPED = "STOPPED"


@dataclass
class WorkerSpec:
    """What to run on this host."""

    entrypoint: str  # script path, or "-m module" style handled by args
    args: List[str] = field(default_factory=list)
    nproc_per_node: int = 1
    max_restarts: int = 3
    monitor_interval: float = 3.0
    rdzv_name: str = RendezvousName.ELASTIC_TRAINING
    log_dir: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    # device spec forwarded to workers ("cpu:2" for CPU-hosted tests)
    device_spec: str = ""


@dataclass
class RunResult:
    state: WorkerState
    restarts: int = 0
    message: str = ""


def _host_ip() -> str:
    """The address other hosts reach this one at: ``DLROVER_TPU_HOST_IP``
    (a multi-host job sets it on every host), else the loopback address
    of a single-host job. The JAX package probes its route to a public
    address instead; the port contacts nothing to find it."""
    return os.getenv("DLROVER_TPU_HOST_IP", "") or "127.0.0.1"


class ElasticTrainingAgent:
    def __init__(
        self,
        node_rank: int,
        spec: WorkerSpec,
        client: MasterClient,
        node_id: Optional[int] = None,
    ):
        self._node_rank = node_rank
        self._spec = spec
        self._client = client
        self._node_id = node_id if node_id is not None else node_rank
        self._workers: List[subprocess.Popen] = []
        self._restart_count = 0
        self._membership_restarts = 0
        self._stop_event = threading.Event()
        self._worker_log_files: List = []
        # the port offered to the master as this host's coordinator
        self._coordinator_port = comm.find_free_port()
        self._host_addr = _host_ip()
        self._current_world: Optional[comm.CommWorld] = None
        self._ckpt_hook = None  # set by the flash-ckpt integration

    # ------------------------------------------------------------------
    # rendezvous
    # ------------------------------------------------------------------
    def _rendezvous(self, timeout: float = 600.0) -> comm.CommWorld:
        """Join the master rendezvous and poll for the comm world.

        Parity: MasterRendezvousHandler.next_rendezvous (training.py:237).
        """
        # fresh coordinator port per rendezvous: the old one may still be
        # held in TIME_WAIT by the previous round's process 0
        self._coordinator_port = comm.find_free_port()
        self._client.register_node_addr(
            self._node_rank, f"{self._host_addr}:{self._coordinator_port}"
        )
        self._client.join_rendezvous(
            self._node_rank,
            self._spec.nproc_per_node,
            rdzv_name=self._spec.rdzv_name,
        )
        deadline = time.time() + timeout
        while time.time() < deadline and not self._stop_event.is_set():
            world = self._client.get_comm_world(
                self._spec.rdzv_name, self._node_rank
            )
            if world.world and self._node_rank in world.world:
                self._current_world = world
                logger.info(
                    f"node {self._node_rank}: joined round {world.round} "
                    f"world={sorted(world.world)} "
                    f"coordinator={world.coordinator_addr}"
                )
                return world
            time.sleep(1)
        raise TimeoutError(
            f"rendezvous {self._spec.rdzv_name} timed out on node "
            f"{self._node_rank}"
        )

    def _worker_env(self, local_rank: int, world: comm.CommWorld) -> Dict[str, str]:
        ranks = sorted(world.world)
        base = sum(world.world[r] for r in ranks if r < self._node_rank)
        num_processes = sum(world.world.values())
        env = dict(os.environ)
        env.update(self._spec.env)
        env.update(
            {
                NodeEnv.MASTER_ADDR: self._client._master_addr,
                NodeEnv.NODE_ID: str(self._node_id),
                NodeEnv.NODE_RANK: str(self._node_rank),
                NodeEnv.NODE_NUM: str(len(ranks)),
                NodeEnv.COORDINATOR_ADDR: world.coordinator_addr,
                NodeEnv.PROCESS_ID: str(base + local_rank),
                NodeEnv.NUM_PROCESSES: str(num_processes),
                NodeEnv.RESTART_COUNT: str(self._restart_count),
                "DLROVER_TPU_LOCAL_RANK": str(local_rank),
                "DLROVER_TPU_LOCAL_WORLD_SIZE": str(
                    self._spec.nproc_per_node
                ),
                "DLROVER_TPU_RDZV_ROUND": str(world.round),
            }
        )
        if self._spec.device_spec:
            env["DLROVER_TPU_DEVICE_SPEC"] = self._spec.device_spec
        ensure_framework_on_pythonpath(env)
        return env

    # ------------------------------------------------------------------
    # worker process management
    # ------------------------------------------------------------------
    def _start_workers(self, world: comm.CommWorld):
        self._close_log_files()
        self._workers = []
        log_dir = self._spec.log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        for local_rank in range(self._spec.nproc_per_node):
            cmd = [sys.executable, self._spec.entrypoint, *self._spec.args]
            if log_dir:
                path = os.path.join(
                    log_dir,
                    f"worker_{self._node_rank}_{local_rank}"
                    f"_r{self._restart_count + self._membership_restarts}.log",
                )
                out = open(path, "ab")
                self._worker_log_files.append(out)
                stdout = stderr = out
            else:
                stdout = stderr = None
            proc = subprocess.Popen(
                cmd,
                env=self._worker_env(local_rank, world),
                stdout=stdout,
                stderr=stderr,
                preexec_fn=die_with_parent_hook(),
            )
            self._workers.append(proc)
        logger.info(
            f"node {self._node_rank}: started {len(self._workers)} workers "
            f"(restart {self._restart_count})"
        )

    def _stop_workers(self, timeout: float = 15.0):
        for p in self._workers:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + timeout
        for p in self._workers:
            remaining = max(0.1, deadline - time.time())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._close_log_files()

    def _close_log_files(self):
        for f in self._worker_log_files:
            try:
                f.close()
            except OSError:
                pass
        self._worker_log_files = []

    def _monitor_workers(self) -> WorkerState:
        states = [p.poll() for p in self._workers]
        if any(rc is not None and rc != 0 for rc in states):
            return WorkerState.FAILED
        if all(rc == 0 for rc in states):
            return WorkerState.SUCCEEDED
        return WorkerState.HEALTHY

    def _failed_worker_info(self) -> str:
        infos = []
        for i, p in enumerate(self._workers):
            rc = p.poll()
            if rc is not None and rc != 0:
                infos.append(f"local_rank={i} exitcode={rc}")
        return "; ".join(infos)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self) -> RunResult:
        """Parity: _invoke_run training.py:548."""
        try:
            return self._run_loop()
        except BaseException:
            # never leave training processes orphaned (they would keep the
            # card's memory and hang in collectives)
            self._stop_workers()
            raise

    def _run_loop(self) -> RunResult:
        spec = self._spec
        world = self._rendezvous()
        self._start_workers(world)
        last_heartbeat = 0.0
        while not self._stop_event.is_set():
            time.sleep(spec.monitor_interval)
            state = self._monitor_workers()

            if time.time() - last_heartbeat > 15:
                last_heartbeat = time.time()
                try:
                    action = self._client.report_heartbeat()
                except ConnectionError:
                    action = ""
                if action == "stop":
                    self._stop_workers()
                    return RunResult(WorkerState.STOPPED, self._restart_count)
                if action == "restart":
                    self._restart_workers(count_restart=False)
                    continue

            if state == WorkerState.SUCCEEDED:
                logger.info(f"node {self._node_rank}: workers succeeded")
                return RunResult(WorkerState.SUCCEEDED, self._restart_count)

            if state == WorkerState.FAILED:
                err = self._failed_worker_info()
                logger.warning(
                    f"node {self._node_rank}: worker failure: {err}"
                )
                try:
                    self._client.report_failure(
                        err,
                        TrainingExceptionLevel.PROCESS_ERROR,
                        restart_count=self._restart_count,
                        node_rank=self._node_rank,
                    )
                except ConnectionError:
                    pass
                if self._restart_count >= spec.max_restarts:
                    self._stop_workers()
                    return RunResult(
                        WorkerState.FAILED, self._restart_count, err
                    )
                self._restart_workers(count_restart=True)
                continue

            # membership change: new nodes waiting => restart into a bigger
            # (or smaller) world; does NOT consume the restart budget
            try:
                waiting = self._client.num_nodes_waiting(spec.rdzv_name)
            except ConnectionError:
                waiting = 0
            if waiting > 0:
                logger.info(
                    f"node {self._node_rank}: membership change "
                    f"({waiting} nodes waiting); restarting workers"
                )
                self._restart_workers(count_restart=False)

        self._stop_workers()
        return RunResult(WorkerState.STOPPED, self._restart_count)

    def _restart_workers(self, count_restart: bool):
        """Parity: _restart_workers training.py:652 + save-at-breakpoint
        (training.py:614-623): persist any in-memory checkpoint first."""
        if self._ckpt_hook is not None:
            try:
                logger.info(f"node {self._node_rank}: save-at-breakpoint")
                self._ckpt_hook()
            except Exception as e:
                logger.warning(f"save-at-breakpoint failed: {e!r}")
        logger.info(f"node {self._node_rank}: stopping workers for restart")
        self._stop_workers()
        logger.info(f"node {self._node_rank}: workers stopped")
        # a worker killed mid-staging leaves its shm shard lock held;
        # release orphaned locks before the new generation starts saving
        # (parity: reset_shared_memory ckpt_saver.py:527)
        try:
            from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

            AsyncCheckpointSaver.reset_shared_memory_if_any()
        except Exception as e:
            logger.warning(f"shard-lock reset failed: {e!r}")
        if count_restart:
            self._restart_count += 1
        else:
            self._membership_restarts += 1
        world = self._rendezvous()
        self._start_workers(world)

    def stop(self):
        self._stop_event.set()
        self._stop_workers()

    def set_checkpoint_hook(self, hook):
        self._ckpt_hook = hook
