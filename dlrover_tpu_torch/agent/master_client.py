"""Agent-side client of the master's 2-RPC service (a copy of
``dlrover_tpu/agent/master_client.py`` over the port's TCP frames:
``master/servicer.py``).

Parity: dlrover/python/elastic_agent/master_client.py:50 (MasterClient) —
every control-plane interaction of agents and training processes goes
through this: rendezvous, data shards, failure reports, heartbeats, kv
store, paral config.

One connection per client, held under a lock: a call sends one frame
and reads one answer. Any ``OSError`` (a refused connect, a reset, a
timeout) closes the connection, and the next attempt connects anew, so
the retry and backoff below ride over a master restart as they do over
gRPC. The JAX package compresses messages with gzip unless told not to;
the port sends them uncompressed.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import comm, faults
from dlrover_tpu_torch.common.constants import NodeEnv, RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.servicer import (
    METHOD_GET,
    METHOD_REPORT,
    recv_response,
    send_request,
)


class _ClientRpcObs:
    """``dlrover_rpc_client_*`` counters through the obs registry: the
    worker-side view of a master brownout. Retries and budget
    exhaustion ride the registry into flight-recorder bundles
    (metrics.prom) and the runtime-metrics forward, so a master that
    stops answering is visible in forensics, not just in logs."""

    _instance = None

    def __init__(self):
        from dlrover_tpu_torch.obs.metrics import default_registry

        reg = default_registry()
        self.requests = reg.counter(
            "dlrover_rpc_client_requests_total",
            "client RPC attempts, by message type",
            ("message",),
        )
        self.retries = reg.counter(
            "dlrover_rpc_client_retries_total",
            "client RPC retries after a transport error",
            ("message",),
        )
        self.budget_exhausted = reg.counter(
            "dlrover_rpc_client_budget_exhausted_total",
            "calls that gave up because retry_budget_s ran out",
            ("message",),
        )
        self.unreachable = reg.counter(
            "dlrover_rpc_client_unreachable_total",
            "calls that exhausted every attempt (master unreachable)",
            ("message",),
        )
        self.bytes = reg.counter(
            "dlrover_rpc_client_bytes_total",
            "request/response payload bytes through this client",
            ("direction",),
        )

    @classmethod
    def get(cls) -> "_ClientRpcObs":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


class MasterClient:
    _instance: Optional["MasterClient"] = None

    def __init__(
        self,
        master_addr: str,
        node_id: int = 0,
        node_type: str = "worker",
        timeout: float = 30.0,
    ):
        self._master_addr = master_addr
        self._node_id = node_id
        self._node_type = node_type
        self._timeout = timeout
        host, port = master_addr.rsplit(":", 1)
        self._endpoint = (host, int(port))
        self._sock: Optional[socket.socket] = None
        self._sock_lock = threading.Lock()
        self._get_rpc = lambda req, timeout: self._roundtrip(
            METHOD_GET, req, timeout
        )
        self._report_rpc = lambda req, timeout: self._roundtrip(
            METHOD_REPORT, req, timeout
        )
        self._obs = _ClientRpcObs.get()

    @property
    def node_id(self) -> int:
        return self._node_id

    def close(self):
        with self._sock_lock:
            self._drop_connection()

    # -- transport -----------------------------------------------------
    def _drop_connection(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, method: int, req: bytes, timeout: float) -> bytes:
        """One frame out, one frame back, on this client's connection
        (made on first use and after any transport error)."""
        with self._sock_lock:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self._endpoint, timeout=timeout
                    )
                    self._sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                self._sock.settimeout(timeout)
                send_request(self._sock, method, req)
                return recv_response(self._sock)
            except OSError:
                # half-written or half-read: the stream is out of step
                self._drop_connection()
                raise

    # -- plumbing ------------------------------------------------------
    def _wrap(self, message) -> bytes:
        req = comm.BaseRequest(
            node_id=self._node_id,
            node_type=self._node_type,
            data=comm.serialize_message(message),
        )
        return comm.serialize_message(req)

    def _call(
        self,
        rpc,
        message,
        retries: int = 3,
        rpc_timeout: Optional[float] = None,
        retry_budget_s: float = 60.0,
    ):
        """One RPC with bounded retries.

        Backoff is FULL JITTER (``uniform(0, min(2**i, 8))``): after a
        master restart every agent in the fleet retries at once, and the
        old fixed ``sleep(min(2**i, 8))`` phase-locked those retries into
        synchronized storms that hammered the fresh master in lockstep.
        ``retry_budget_s`` bounds the total time THIS CALL may spend
        retrying (attempt time + backoff) — a caller holding a lock or a
        monitor tick must fail in bounded time, not ride an unbounded
        exponential tail."""
        err: Optional[Exception] = None
        deadline = time.monotonic() + retry_budget_s
        msg_name = type(message).__name__
        # getattr: test doubles build the client via __new__ without
        # running __init__ — the registry singleton covers them
        obs = getattr(self, "_obs", None) or _ClientRpcObs.get()
        for i in range(retries):
            try:
                obs.requests.labels(msg_name).inc()
                if i:
                    # the retry counter feeds the goodput/forensics
                    # path: a master brownout shows up as a retry ramp
                    # in flight bundles, not just a log tail
                    obs.retries.labels(msg_name).inc()
                # fault point rpc.send: injected OSError/delay exercises
                # exactly the retry/backoff path a flaky network does
                faults.fire("rpc.send")
                req_bytes = self._wrap(message)
                obs.bytes.labels("out").inc(len(req_bytes))
                resp_bytes = rpc(
                    req_bytes,
                    timeout=rpc_timeout or self._timeout,
                )
                obs.bytes.labels("in").inc(len(resp_bytes))
                # fault point rpc.recv: the RESPONSE leg — the server
                # applied the request but the reply was lost/garbled.
                # Must ride the same jittered-retry path as send-leg
                # failures (non-idempotent reports stay single-attempt
                # through the retries=1 contract, exactly as designed)
                faults.fire("rpc.recv")
                resp: comm.BaseResponse = comm.deserialize_message(resp_bytes)
                if not resp.success:
                    raise RuntimeError(
                        f"master rejected {msg_name}: "
                        f"{resp.message}"
                    )
                return comm.deserialize_message(resp.data)
            except OSError as e:
                err = e
                if i >= retries - 1:
                    break
                delay = random.uniform(0.0, min(2.0**i, 8.0))
                if time.monotonic() + delay >= deadline:
                    obs.budget_exhausted.labels(msg_name).inc()
                    logger.warning(
                        f"{msg_name}: retry budget "
                        f"({retry_budget_s}s) exhausted after "
                        f"{i + 1} attempts"
                    )
                    break
                time.sleep(delay)
        obs.unreachable.labels(msg_name).inc()
        raise ConnectionError(
            f"master {self._master_addr} unreachable: {err!r}"
        )

    def get(
        self,
        message,
        retries: int = 3,
        rpc_timeout: Optional[float] = None,
        retry_budget_s: float = 60.0,
    ):
        return self._call(
            self._get_rpc,
            message,
            retries=retries,
            rpc_timeout=rpc_timeout,
            retry_budget_s=retry_budget_s,
        )

    def report(
        self,
        message,
        retries: int = 3,
        idempotent: bool = True,
        retry_budget_s: float = 60.0,
    ):
        """``idempotent=False`` declares that replaying the message on a
        lost *response* would double-apply it server-side (counter adds,
        joins with side effects): such reports get exactly one attempt —
        the caller owns recovery — instead of each call site hand-rolling
        a ``retries=1`` with a comment. ``retry_budget_s`` bounds the
        total retry time (see ``_call``) — callers on a cadence (the
        Brain metrics reporter) pass a budget matching it."""
        return self._call(
            self._report_rpc,
            message,
            retries=retries if idempotent else 1,
            retry_budget_s=retry_budget_s,
        )

    # -- data sharding -------------------------------------------------
    def report_dataset_shard_params(self, params: comm.DatasetShardParams):
        return self.report(params)

    def get_task(self, dataset_name: str) -> comm.Task:
        task = self.get(comm.TaskRequest(dataset_name=dataset_name))
        return task if task is not None else comm.Task()

    def report_task_result(self, dataset_name: str, task_id: int):
        return self.report(
            comm.TaskResult(dataset_name=dataset_name, task_id=task_id)
        )

    def get_shard_checkpoint(self) -> str:
        ckpt = self.get(comm.ShardCheckpointRequest())
        return ckpt.content if ckpt else ""

    def report_shard_checkpoint(self, content: str):
        return self.report(comm.ShardCheckpoint(content=content))

    def get_dataset_epoch(self, dataset_name: str) -> int:
        resp = self.get(comm.DatasetEpochRequest(dataset_name=dataset_name))
        return resp.epoch if resp else 0

    # -- rendezvous ----------------------------------------------------
    def register_node_addr(self, rank_index: int, addr: str):
        return self.report(
            comm.NodeMeta(
                node_type=self._node_type,
                node_id=self._node_id,
                rank_index=rank_index,
                addr=addr,
            )
        )

    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str = RendezvousName.ELASTIC_TRAINING,
        node_group: int = -1,
    ) -> int:
        # fault point rendezvous.join: death/flake exactly at the join
        # report — the window where a preempted node can poison world
        # assembly (the chaos harness scripts `kill` here)
        faults.fire("rendezvous.join")
        resp = self.report(
            comm.JoinRendezvousRequest(
                node_id=self._node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
                node_group=node_group,
            )
        )
        return resp.version if isinstance(resp, comm.ClusterVersion) else 0

    def get_comm_world(
        self, rdzv_name: str, node_rank: int
    ) -> comm.CommWorld:
        resp = self.get(
            comm.CommWorldRequest(node_id=node_rank, rdzv_name=rdzv_name)
        )
        return resp if resp else comm.CommWorld(rdzv_name=rdzv_name)

    def num_nodes_waiting(
        self, rdzv_name: str = RendezvousName.ELASTIC_TRAINING
    ) -> int:
        resp = self.get(
            comm.WaitingNodeNumRequest(
                node_id=self._node_id, rdzv_name=rdzv_name
            )
        )
        return resp.waiting_num if resp else 0

    # -- network check -------------------------------------------------
    def report_network_check_result(
        self, node_rank: int, succeeded: bool, elapsed: float
    ):
        return self.report(
            comm.NetworkCheckResultRequest(
                node_id=node_rank,
                succeeded=succeeded,
                elapsed_time=elapsed,
            )
        )

    def check_fault_node(self) -> Tuple[List[int], str]:
        resp = self.get(comm.NetworkCheckStatus())
        return (resp.nodes, resp.reason) if resp else ([], "no_response")

    def check_straggler(self) -> Tuple[List[int], str]:
        resp = self.get(comm.StragglerExistRequest(node_id=self._node_id))
        return (resp.nodes, resp.reason) if resp else ([], "no_response")

    def network_check_success(self) -> bool:
        resp = self.get(comm.NetworkReadyRequest(node_id=self._node_id))
        return bool(resp and resp.done)

    # -- lifecycle reports ---------------------------------------------
    def report_heartbeat(self) -> str:
        resp = self.report(
            comm.HeartbeatReport(node_id=self._node_id, timestamp=time.time())
        )
        return resp.action if isinstance(resp, comm.HeartbeatResponse) else ""

    def report_failure(
        self,
        error_data: str,
        level: str,
        restart_count: int = 0,
        node_rank: int = -1,
    ):
        return self.report(
            comm.NodeFailureReport(
                node_id=self._node_id,
                node_rank=node_rank if node_rank >= 0 else self._node_id,
                error_data=error_data,
                level=level,
                restart_count=restart_count,
            )
        )

    def report_resource_stats(
        self, cpu_percent: float, used_memory_mb: int, tpu_duty_cycle: float = 0.0
    ):
        return self.report(
            comm.ResourceStats(
                node_id=self._node_id,
                cpu_percent=cpu_percent,
                used_memory_mb=used_memory_mb,
                tpu_duty_cycle=tpu_duty_cycle,
            )
        )

    def report_global_step(self, step: int):
        return self.report(
            comm.GlobalStepReport(
                node_id=self._node_id, step=step, timestamp=time.time()
            )
        )

    def report_train_metrics(
        self,
        step: int,
        metrics: dict,
        open_span: str = "",
        open_span_elapsed_s: float = 0.0,
    ):
        """Scalar training metrics (loss/eval_loss/lr …) → the master's
        collector (the trainer's periodic metric-logging leg), plus the
        hang-attribution open-span snapshot for the telemetry
        aggregator."""
        return self.report(
            comm.TrainMetricsReport(
                node_id=self._node_id,
                step=step,
                metrics=dict(metrics),
                open_span=open_span,
                open_span_elapsed_s=open_span_elapsed_s,
            )
        )

    def report_batch(
        self, batch: comm.AgentReportBatch
    ) -> comm.AgentBatchResponse:
        """The aggregation tier's one-RPC-per-tick leg: the whole
        node's coalesced delta telemetry plus the piggybacked poll
        legs. Retried on transport errors — the delta protocol's
        same-seq replay is idempotent server-side, so a lost response
        costs nothing (``common/telemetry_delta.py``)."""
        resp = self.report(batch)
        return (
            resp
            if isinstance(resp, comm.AgentBatchResponse)
            else comm.AgentBatchResponse()
        )

    def poll_worker_commands(
        self, ack_id: int = 0
    ) -> List[comm.WorkerCommand]:
        """This node's pending master->worker commands (flight dumps,
        profiler captures). ``ack_id`` is the highest id the caller
        has durably relayed: the master clears up to it and redelivers
        the rest, so a lost response cannot drop a command (the caller
        — the agent's WorkerCommandRelay — dedups by id)."""
        resp = self.get(comm.WorkerCommandRequest(ack_id=ack_id))
        return list(resp.commands) if resp is not None else []

    def report_eviction_notice(
        self, grace_s: float, drain_ms: float = 0.0, reason: str = ""
    ):
        """This node received an eviction/preemption notice (SIGTERM,
        platform deadline, master ``evict`` command) and is draining.
        The master books it as a SCHEDULED departure — rendezvous
        exclusion, pre-armed resize, no relaunch budget burned — rather
        than a crash. ``drain_ms`` > 0 on the post-drain re-report
        carries the measured drain latency (Brain dwell pricing).

        Single attempt: the caller (the TrainingMonitor's relay) runs
        on a daemon tick and retries on its own cadence — a backoff
        tail here would stall the global-step channel exactly while a
        time-critical drain is in flight (the BrainClient mirror-leg
        convention)."""
        return self.report(
            comm.EvictionNotice(
                node_id=self._node_id,
                grace_s=float(grace_s),
                drain_ms=float(drain_ms),
                reason=reason,
            ),
            retries=1,
        )

    def report_node_event(
        self,
        event_type: str,
        status: str = "",
        exit_reason: str = "",
        message: str = "",
    ):
        """Node lifecycle event → the master's job manager (the agent's
        analog of the platform watcher feed: a non-k8s launcher reports
        its own ADDED/DELETED/FAILED transitions through this leg).
        Idempotent: the job manager's event processing is keyed by node
        and status, so a replayed event re-applies the same transition."""
        return self.report(
            comm.NodeEventReport(
                event_type=event_type,
                node_type=self._node_type,
                node_id=self._node_id,
                status=status,
                exit_reason=exit_reason,
                message=message,
            )
        )

    def report_training_status(self, status: int):
        return self.report(
            comm.TrainingStatusReport(
                node_id=self._node_id, status=status, timestamp=time.time()
            )
        )

    def report_ckpt_step(self, step: int):
        return self.report(
            comm.CheckpointReadyRequest(node_id=self._node_id, step=step)
        )

    # -- kv store ------------------------------------------------------
    def kv_store_set(self, key: str, value: bytes):
        return self.report(comm.KeyValuePair(key=key, value=value))

    def kv_store_get(self, key: str) -> bytes:
        resp = self.get(comm.KeyValueQuery(key=key))
        return resp.value if resp else b""

    def kv_store_add(self, key: str, amount: int) -> int:
        # a lost response would re-add on replay
        resp = self.report(
            comm.KeyValueAdd(key=key, amount=amount), idempotent=False
        )
        if isinstance(resp, comm.KeyValuePair):
            return int(resp.value or b"0")
        return 0

    def kv_store_wait(self, keys: List[str], timeout: float = 60.0) -> bool:
        # the RPC deadline must outlive the server-side wait
        resp = self.get(
            comm.KeyValueWait(keys=keys, timeout=timeout),
            rpc_timeout=timeout + 10,
        )
        return bool(resp and resp.done)

    # -- streaming data / metrics --------------------------------------
    def report_streaming_data(
        self, dataset_name: str, new_records: int = 0, end: bool = False
    ):
        return self.report(
            comm.StreamingDataReport(
                dataset_name=dataset_name, new_records=new_records, end=end
            )
        )

    def get_job_metrics(self, last_n: int = 0) -> comm.JobMetrics:
        resp = self.get(comm.JobMetricsRequest(last_n=last_n))
        return resp if resp else comm.JobMetrics()

    def request_scale(self, count: int, node_type: str = "worker") -> bool:
        """Ask the master to scale its worker group to ``count``
        (tools/operator seam; executed through the auto-scaler's
        ``scale_to`` → warm resize path). False when the master has no
        auto-scaler wired."""
        resp = self.report(
            comm.ScaleRequest(node_type=node_type, count=count)
        )
        return bool(resp and resp.done)

    # -- paral config / misc -------------------------------------------
    def get_elastic_run_config(self) -> Dict[str, str]:
        """The master's run-config registry (operator-set feature flags;
        parity: the reference MasterClient.get_elastic_run_config)."""
        resp = self.get(comm.ElasticRunConfigRequest())
        return dict(resp.configs) if resp else {}

    def get_paral_config(self) -> comm.ParallelConfig:
        resp = self.get(comm.ParallelConfigRequest(node_id=self._node_id))
        return resp if resp else comm.ParallelConfig()

    def get_candidate_worker_counts(self) -> List[int]:
        """The auto-scaler's predicted next worker counts (most likely
        first) — the feed for a worker's speculative train-step
        compiles. Empty on masters predating the field."""
        cfg = self.get_paral_config()
        return list(getattr(cfg, "candidate_worker_counts", []) or [])

    def get_node_addrs(self, node_type: str = "worker") -> Dict[int, str]:
        resp = self.get(comm.NodeAddressRequest(node_type=node_type))
        return resp.addrs if resp else {}

    def get_cluster_version(self, version_type: str = "global") -> int:
        resp = self.get(
            comm.ClusterVersionRequest(
                node_type=self._node_type,
                node_id=self._node_id,
                version_type=version_type,
            )
        )
        return resp.version if resp else 0

    def update_cluster_version(
        self, version: int, version_type: str = "global"
    ):
        return self.report(
            comm.UpdateClusterVersionRequest(
                node_type=self._node_type,
                node_id=self._node_id,
                version_type=version_type,
                version=version,
            )
        )

    def join_sync(self, sync_name: str) -> bool:
        resp = self.report(
            comm.SyncJoinRequest(
                sync_name=sync_name,
                node_id=self._node_id,
                node_type=self._node_type,
            )
        )
        return bool(resp)

    def sync_finished(self, sync_name: str) -> bool:
        resp = self.get(comm.SyncJoinRequest(sync_name=sync_name))
        return bool(resp and resp.done)

    def finish_sync(self, sync_name: str) -> bool:
        """Close a named sync barrier so late joiners stop waiting
        (idempotent: finishing a finished sync is a no-op). The leg the
        servicer always dispatched but no client could send. A rejected
        or unreachable report raises; reaching here means it applied."""
        self.report(comm.SyncFinishRequest(sync_name=sync_name))
        return True

    def barrier(self, barrier_name: str, notify: bool = False) -> bool:
        if notify:
            return bool(
                self.report(
                    comm.BarrierRequest(
                        barrier_name=barrier_name, notify=True
                    )
                )
            )
        resp = self.get(comm.BarrierRequest(barrier_name=barrier_name))
        return bool(resp and resp.done)

    # -- singleton bootstrap -------------------------------------------
    @classmethod
    def singleton(cls) -> "MasterClient":
        """Build from the env the agent exports (NodeEnv)."""
        if cls._instance is None:
            addr = os.getenv(NodeEnv.MASTER_ADDR, "")
            if not addr:
                raise RuntimeError(
                    f"{NodeEnv.MASTER_ADDR} is not set; not inside a "
                    "dlrover-tpu job?"
                )
            node_id = int(os.getenv(NodeEnv.NODE_ID, "0"))
            cls._instance = cls(addr, node_id=node_id)
        return cls._instance
