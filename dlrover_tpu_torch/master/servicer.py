"""Master servicer: a 2-RPC surface (``report``/``get``) dispatching
typed messages to the master's subsystems (a copy of
``dlrover_tpu/master/servicer.py`` with a stdlib transport).

Parity: dlrover/python/master/servicer.py:62 (MasterServicer, dispatch in
``get:88``/``report:285``) and ``create_master_service:570``. The JAX
package serves the two RPCs over gRPC; the port serves the same pickled
``comm`` messages over plain TCP (``socketserver``), since the card's
host has no ``grpc``. A frame is a 5-byte header (``>BI``: the method,
``get`` or ``report``, then the payload's length) and the payload; the
answer is a 4-byte length and the pickled ``BaseResponse``. A frame
past 256 MiB is refused on either side, the gRPC channel's limit.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.telemetry_delta import DeltaDecoder

SERVICE_NAME = "dlrover_tpu_torch.Master"

# the wire: one request frame, one response frame, per call
METHOD_GET = 0
METHOD_REPORT = 1
MAX_FRAME_BYTES = 256 * 1024 * 1024
_REQUEST_HEADER = struct.Struct(">BI")
_RESPONSE_HEADER = struct.Struct(">I")

# dispatch-latency buckets: master-side service time is tens of µs to
# a few ms per message — the default seconds-scale buckets would dump
# everything into the first bucket and p99 would read as 5 ms forever
RPC_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 1.0, 5.0,
)


class _RpcObs:
    """Per-message-type ``dlrover_rpc_*`` counters and latency
    histograms through the obs registry (docs/observability.md). One
    instance per servicer; metric names are registry-global so every
    export path (prometheus_text, scalars→runtime-metrics, flight
    bundles) sees them without extra wiring."""

    def __init__(self, registry=None):
        from dlrover_tpu_torch.obs.metrics import default_registry

        reg = registry or default_registry()
        labels = ("rpc", "message")
        self.requests = reg.counter(
            "dlrover_rpc_requests_total",
            "master RPCs dispatched, by entrypoint and message type",
            labels,
        )
        self.errors = reg.counter(
            "dlrover_rpc_errors_total",
            "master RPC dispatches that raised",
            labels,
        )
        self.latency = reg.histogram(
            "dlrover_rpc_latency_seconds",
            "master-side dispatch service time",
            labels,
            buckets=RPC_LATENCY_BUCKETS,
        )
        self.bytes = reg.counter(
            "dlrover_rpc_bytes_total",
            "request/response payload bytes through the master",
            ("rpc", "message", "direction"),
        )
        self.resyncs = reg.counter(
            "dlrover_rpc_delta_resyncs_total",
            "agent delta batches the master could not reconstruct "
            "(answered resync: restart, epoch change or seq gap)",
        )
        self.batch_procs = reg.counter(
            "dlrover_rpc_batch_procs_total",
            "per-process sub-reports coalesced into AgentReportBatch "
            "RPCs (the fan-in the aggregation tier saves)",
        )

    def observe(self, rpc, message_name, seconds, in_bytes, out_bytes, ok):
        self.requests.labels(rpc, message_name).inc()
        if not ok:
            self.errors.labels(rpc, message_name).inc()
        self.latency.labels(rpc, message_name).observe(seconds)
        self.bytes.labels(rpc, message_name, "in").inc(in_bytes)
        self.bytes.labels(rpc, message_name, "out").inc(out_bytes)


def _event_status(report) -> str:
    from dlrover_tpu_torch.common.constants import NodeEventType, NodeStatus

    if report.status:
        return report.status
    return {
        NodeEventType.ADDED: NodeStatus.RUNNING,
        NodeEventType.DELETED: NodeStatus.DELETED,
    }.get(report.event_type, NodeStatus.FAILED)


class MasterServicer:
    def __init__(
        self,
        task_manager=None,
        job_manager=None,
        rdzv_managers=None,
        kv_store=None,
        sync_service=None,
        speed_monitor=None,
        elastic_ps_service=None,
        paral_config_service=None,
        metric_collector=None,
        telemetry=None,
        auto_scaler=None,
    ):
        self._task_manager = task_manager
        self._job_manager = job_manager
        self._rdzv_managers = rdzv_managers or {}
        self._kv_store = kv_store
        self._sync_service = sync_service
        self._speed_monitor = speed_monitor
        self._elastic_ps_service = elastic_ps_service
        self._paral_config_service = paral_config_service
        self._metric_collector = metric_collector
        # obs/aggregate.TelemetryAggregator: per-worker step times,
        # straggler detection, hang attribution
        self._telemetry = telemetry
        # JobAutoScaler: the ScaleRequest entry (tools/operator-driven
        # explicit resizes through the same scale_to seam Brain plans use)
        self._auto_scaler = auto_scaler
        self._lock = threading.Lock()
        self._node_addrs: dict = {}  # node_type -> {rank: addr}
        self._ckpt_steps: dict = {}  # node_id -> latest in-memory ckpt step
        self._run_configs: dict = {}
        # master -> worker command channel (flight dumps, profiler
        # captures): queued here, drained by the agent's poll
        self._worker_commands: dict = {}  # node_id -> [WorkerCommand]
        # ids already handed to an agent (pending only until acked):
        # coalescing into one of these would return an id the trainer
        # has already executed-and-deduped — the new request would
        # silently never run
        self._delivered_commands: dict = {}  # node_id -> {id, ...}
        self._command_seq = 0
        # agent aggregation tier: per-node delta-telemetry reconstruction
        self._delta = DeltaDecoder()
        self._rpc_obs = _RpcObs()

    # ------------------------------------------------------------------
    # RPC entrypoints (bytes in/out)
    # ------------------------------------------------------------------
    def get(self, request_bytes: bytes, context=None) -> bytes:
        req: comm.BaseRequest = comm.deserialize_message(request_bytes)
        message = comm.deserialize_message(req.data)
        response = comm.BaseResponse()
        t0 = time.perf_counter()
        try:
            result = self._dispatch_get(req, message)
            if result is not None:
                response.data = comm.serialize_message(result)
        except Exception as e:
            logger.error(f"get({type(message).__name__}) failed: {e!r}")
            response.success = False
            response.message = repr(e)
        out = comm.serialize_message(response)
        self._rpc_obs.observe(
            "get",
            type(message).__name__,
            time.perf_counter() - t0,
            len(request_bytes),
            len(out),
            response.success,
        )
        return out

    def report(self, request_bytes: bytes, context=None) -> bytes:
        req: comm.BaseRequest = comm.deserialize_message(request_bytes)
        message = comm.deserialize_message(req.data)
        response = comm.BaseResponse()
        t0 = time.perf_counter()
        try:
            result = self._dispatch_report(req, message)
            if result is False:
                response.success = False
            elif result is not None and result is not True:
                response.data = comm.serialize_message(result)
        except Exception as e:
            logger.error(f"report({type(message).__name__}) failed: {e!r}")
            response.success = False
            response.message = repr(e)
        out = comm.serialize_message(response)
        self._rpc_obs.observe(
            "report",
            type(message).__name__,
            time.perf_counter() - t0,
            len(request_bytes),
            len(out),
            response.success,
        )
        return out

    # ------------------------------------------------------------------
    # GET dispatch
    # ------------------------------------------------------------------
    def _dispatch_get(self, req: comm.BaseRequest, message):
        if isinstance(message, comm.TaskRequest):
            return self._get_task(req.node_id, message)
        if isinstance(message, comm.CommWorldRequest):
            return self._get_comm_world(message)
        if isinstance(message, comm.WaitingNodeNumRequest):
            return self._get_waiting_node_num(message)
        if isinstance(message, comm.KeyValueQuery):
            value = self._kv_store.get(message.key) if self._kv_store else b""
            return comm.KeyValuePair(key=message.key, value=value)
        if isinstance(message, comm.JobMetricsRequest):
            if self._metric_collector is None:
                return comm.JobMetrics()
            return self._metric_collector.snapshot(message.last_n)
        if isinstance(message, comm.KeyValueWait):
            ok = (
                self._kv_store.wait(message.keys, message.timeout)
                if self._kv_store
                else False
            )
            return comm.SyncResult(done=ok)
        if isinstance(message, comm.NetworkReadyRequest):
            mgr = self._rdzv_managers.get("network-check")
            if mgr is None:
                return comm.NetworkCheckStatus(reason="no_manager")
            ok, reason = mgr.network_check_success()
            return comm.SyncResult(done=ok)
        if isinstance(message, comm.NetworkCheckStatus):
            # query fault nodes
            mgr = self._rdzv_managers.get("network-check")
            if mgr is None:
                return comm.NetworkCheckStatus(reason="no_manager")
            nodes, reason = mgr.check_fault_node()
            return comm.NetworkCheckStatus(nodes=nodes, reason=reason)
        if isinstance(message, comm.StragglerExistRequest):
            mgr = self._rdzv_managers.get("network-check")
            if mgr is None:
                return comm.NetworkCheckStatus(reason="no_manager")
            nodes, reason = mgr.get_stragglers()
            return comm.NetworkCheckStatus(nodes=nodes, reason=reason)
        if isinstance(message, comm.ShardCheckpointRequest):
            content = self._task_manager.checkpoint() if self._task_manager else ""
            return comm.ShardCheckpoint(content=content)
        if isinstance(message, comm.DatasetEpochRequest):
            epoch = (
                self._task_manager.get_epoch(message.dataset_name)
                if self._task_manager
                else 0
            )
            return comm.DatasetEpoch(epoch=epoch)
        if isinstance(message, comm.ClusterVersionRequest):
            version = 0
            if self._elastic_ps_service:
                version = self._elastic_ps_service.get_version(
                    message.version_type, message.node_type, message.node_id
                )
            return comm.ClusterVersion(version=version)
        if isinstance(message, comm.ParallelConfigRequest):
            if self._paral_config_service:
                return self._paral_config_service.get_config(req.node_id)
            return comm.ParallelConfig()
        if isinstance(message, comm.NodeAddressRequest):
            with self._lock:
                addrs = dict(self._node_addrs.get(message.node_type, {}))
            return comm.NodeAddresses(addrs=addrs)
        if isinstance(message, comm.ElasticRunConfigRequest):
            return comm.ElasticRunConfig(configs=dict(self._run_configs))
        if isinstance(message, comm.SyncJoinRequest):
            # query join-sync completion
            done = (
                self._sync_service.sync_finished(message.sync_name)
                if self._sync_service
                else False
            )
            return comm.SyncResult(done=done)
        if isinstance(message, comm.BarrierRequest):
            done = (
                self._sync_service.barrier(message.barrier_name)
                if self._sync_service
                else False
            )
            return comm.SyncResult(done=done)
        if isinstance(message, comm.WorkerCommandRequest):
            node_id = message.node_id if message.node_id >= 0 else req.node_id
            ack = getattr(message, "ack_id", 0)
            return comm.WorkerCommands(
                commands=self._drain_commands(node_id, ack)
            )
        raise ValueError(f"unknown get message: {type(message).__name__}")

    def _drain_commands(self, node_id: int, ack: int) -> list:
        """Pending commands for ``node_id``, clearing only what the
        agent ACKED (its previous poll's ids): a lost response
        redelivers rather than drops. Shared by the legacy
        ``WorkerCommandRequest`` poll and the batched report leg."""
        with self._lock:
            pending = self._worker_commands.get(node_id, [])
            pending[:] = [c for c in pending if c.id > ack]
            delivered = self._delivered_commands.setdefault(node_id, set())
            delivered.difference_update(
                i for i in list(delivered) if i <= ack
            )
            delivered.update(c.id for c in pending)
            if not pending:
                self._worker_commands.pop(node_id, None)
            return list(pending)

    # ------------------------------------------------------------------
    # worker command queue (master-side producers: hang handler,
    # straggler auto-profile, operators)
    # ------------------------------------------------------------------
    def queue_worker_command(
        self, node_id: int, kind: str, arg: int = 0, reason: str = ""
    ) -> comm.WorkerCommand:
        """Queue one command for ``node_id``; delivered on the agent's
        next ``WorkerCommandRequest`` poll and cleared once that poll's
        ids come back acked. Duplicate (kind, reason) pairs still
        pending are coalesced (newest ``arg`` wins) — a hang handler
        firing every tick must not flood a wedged worker."""
        with self._lock:
            pending = self._worker_commands.setdefault(node_id, [])
            delivered = self._delivered_commands.get(node_id, set())
            for c in pending:
                if (
                    c.kind == kind
                    and c.reason == reason
                    and c.id not in delivered
                ):
                    # still undelivered: safe to fold the new request
                    # in (a delivered id may already be executed and
                    # deduped trainer-side — folding into it would
                    # silently drop this request)
                    c.arg = arg  # last request's argument wins
                    return c
            self._command_seq += 1
            cmd = comm.WorkerCommand(
                id=self._command_seq, kind=kind, arg=arg, reason=reason
            )
            pending.append(cmd)
            return cmd

    def clear_worker_commands(self, node_id: Optional[int] = None):
        """Purge undelivered queued commands (all nodes when
        ``node_id`` is None). The master calls this before restarting
        workers: a pending command targets the incarnation that is
        about to die, and executing it against the healthy replacement
        would forge evidence."""
        with self._lock:
            if node_id is None:
                self._worker_commands.clear()
                self._delivered_commands.clear()
            else:
                self._worker_commands.pop(node_id, None)
                self._delivered_commands.pop(node_id, None)

    def _get_task(self, node_id: int, message: comm.TaskRequest) -> comm.Task:
        if self._task_manager is None:
            return comm.Task()
        return self._task_manager.get_dataset_task(
            node_id, message.dataset_name
        )

    def _get_comm_world(self, message: comm.CommWorldRequest) -> comm.CommWorld:
        mgr = self._rdzv_managers.get(message.rdzv_name)
        if mgr is None:
            return comm.CommWorld(rdzv_name=message.rdzv_name)
        rnd, group, world, coord = mgr.get_comm_world(message.node_id)
        return comm.CommWorld(
            rdzv_name=message.rdzv_name,
            round=rnd,
            group=group,
            world=world,
            coordinator_addr=coord,
        )

    def _get_waiting_node_num(
        self, message: comm.WaitingNodeNumRequest
    ) -> comm.WaitingNodeNum:
        mgr = self._rdzv_managers.get(message.rdzv_name)
        num = mgr.num_nodes_waiting() if mgr else 0
        return comm.WaitingNodeNum(waiting_num=num)

    # ------------------------------------------------------------------
    # REPORT dispatch
    # ------------------------------------------------------------------
    def _dispatch_report(self, req: comm.BaseRequest, message):
        if isinstance(message, comm.DatasetShardParams):
            if self._task_manager:
                self._task_manager.new_dataset(message)
            return True
        if isinstance(message, comm.TaskResult):
            if self._task_manager:
                return self._task_manager.report_dataset_task(
                    message.dataset_name, message.task_id
                )
            return True
        if isinstance(message, comm.ShardCheckpoint):
            if self._task_manager:
                self._task_manager.restore_checkpoint(message.content)
            return True
        if isinstance(message, comm.JoinRendezvousRequest):
            return self._join_rendezvous(req, message)
        if isinstance(message, comm.RendezvousParamsReport):
            mgr = self._rdzv_managers.get(message.rdzv_name)
            if mgr:
                mgr.update_rdzv_params(
                    message.min_nodes,
                    message.max_nodes,
                    message.waiting_timeout,
                    message.node_unit,
                )
            return True
        if isinstance(message, comm.NetworkCheckResultRequest):
            mgr = self._rdzv_managers.get("network-check")
            if mgr:
                mgr.report_network_check_result(
                    message.node_id, message.succeeded, message.elapsed_time
                )
            return True
        if isinstance(message, comm.NodeFailureReport):
            if self._job_manager:
                self._job_manager.handle_training_failure(
                    req.node_type or "worker",
                    message.node_id,
                    message.restart_count,
                    message.error_data,
                    message.level,
                )
            return True
        if isinstance(message, comm.EvictionNotice):
            # a scheduled departure, not a crash: the job manager marks
            # the node evicting and fans out to the listeners that
            # exclude the rank from rendezvous and pre-arm the resize
            if self._job_manager:
                self._job_manager.handle_eviction_notice(
                    req.node_type or "worker",
                    message.node_id,
                    grace_s=message.grace_s,
                    drain_ms=message.drain_ms,
                    reason=message.reason,
                )
            return True
        if isinstance(message, comm.NodeEventReport):
            if self._job_manager:
                from dlrover_tpu_torch.common.node import Node
                from dlrover_tpu_torch.master.job_manager import NodeEvent

                node = Node(
                    node_type=message.node_type or "worker",
                    node_id=message.node_id,
                )
                node.status = _event_status(message)
                node.exit_reason = message.exit_reason
                self._job_manager.process_event(
                    NodeEvent(message.event_type, node)
                )
            return True
        if isinstance(message, comm.HeartbeatReport):
            action = ""
            if self._job_manager:
                action = self._job_manager.collect_node_heartbeat(
                    req.node_type or "worker", message.node_id
                )
            return comm.HeartbeatResponse(action=action)
        if isinstance(message, comm.StreamingDataReport):
            if self._task_manager:
                return self._task_manager.report_streaming_data(
                    message.dataset_name, message.new_records, message.end
                )
            return False
        if isinstance(message, comm.ResourceStats):
            if self._job_manager:
                self._job_manager.update_node_resource_usage(
                    req.node_type or "worker",
                    message.node_id,
                    message.cpu_percent,
                    message.used_memory_mb,
                )
            return True
        if isinstance(message, comm.GlobalStepReport):
            if self._speed_monitor:
                # the wire default 0.0 means "sender did not stamp";
                # it maps to None HERE (the one boundary where 0.0 is
                # the documented unset sentinel) so SpeedMonitor's
                # `is None` contract stays honest for direct callers
                self._speed_monitor.collect_global_step(
                    message.step,
                    message.timestamp if message.timestamp else None,
                    node_id=message.node_id,
                )
            return True
        if isinstance(message, comm.TrainMetricsReport):
            if self._metric_collector is not None:
                self._metric_collector.report_train_metrics(
                    message.node_id, message.step, message.metrics
                )
            if self._telemetry is not None:
                self._telemetry.observe_metrics(
                    message.node_id,
                    message.step,
                    message.metrics,
                    open_span=getattr(message, "open_span", ""),
                    open_span_elapsed_s=getattr(
                        message, "open_span_elapsed_s", 0.0
                    ),
                )
            return True
        if isinstance(message, comm.TrainingStatusReport):
            if self._speed_monitor and message.status == 1:
                self._speed_monitor.set_start_timestamp()
            return True
        if isinstance(message, comm.KeyValuePair):
            if self._kv_store:
                self._kv_store.set(message.key, message.value)
            return True
        if isinstance(message, comm.KeyValueAdd):
            if self._kv_store:
                value = self._kv_store.add(message.key, message.amount)
                return comm.KeyValuePair(
                    key=message.key, value=str(value).encode()
                )
            return True
        if isinstance(message, comm.UpdateClusterVersionRequest):
            if self._elastic_ps_service:
                self._elastic_ps_service.update_version(
                    message.version_type,
                    message.node_type,
                    message.node_id,
                    message.version,
                )
            return True
        if isinstance(message, comm.SyncJoinRequest):
            if self._sync_service:
                return self._sync_service.join_sync(
                    message.sync_name, message.node_type, message.node_id
                )
            return True
        if isinstance(message, comm.SyncFinishRequest):
            if self._sync_service:
                self._sync_service.finish_sync(message.sync_name)
            return True
        if isinstance(message, comm.BarrierRequest):
            if self._sync_service and message.notify:
                return self._sync_service.notify_barrier(message.barrier_name)
            return True
        if isinstance(message, comm.NodeMeta):
            with self._lock:
                self._node_addrs.setdefault(message.node_type, {})[
                    message.rank_index
                ] = message.addr
            return True
        if isinstance(message, comm.CheckpointReadyRequest):
            with self._lock:
                self._ckpt_steps[message.node_id] = message.step
            return True
        if isinstance(message, comm.AgentReportBatch):
            return self._handle_agent_batch(req, message)
        if isinstance(message, comm.ScaleRequest):
            # has_scaler gate: a scalerless master executing scale_to
            # would fabricate node entries nothing launches (the ghost-
            # node problem local_master.py gates its daemons on)
            if (
                self._auto_scaler is None
                or not self._auto_scaler.has_scaler
                or message.count < 0
            ):
                return comm.SyncResult(done=False)
            self._auto_scaler.scale_to(message.count)
            return comm.SyncResult(done=True)
        raise ValueError(f"unknown report message: {type(message).__name__}")

    # ------------------------------------------------------------------
    # agent aggregation tier (AgentReportBatch)
    # ------------------------------------------------------------------
    def _handle_agent_batch(
        self, req: comm.BaseRequest, message: comm.AgentReportBatch
    ) -> comm.AgentBatchResponse:
        """One node's whole tick: reconstruct the delta-encoded
        per-process telemetry and feed it to exactly the subsystems the
        legacy per-message reports fed (SpeedMonitor, collector,
        telemetry aggregator, resource usage), then answer the
        piggybacked poll legs on the same round trip. A delta the
        decoder cannot reconstruct applies NOTHING and answers
        ``resync=True`` — the agent re-sends a full snapshot next tick,
        so a master restart costs one tick of latency, never a dropped
        scalar."""
        node_id = message.node_id
        resp = comm.AgentBatchResponse()
        snaps = self._delta.apply(
            node_id,
            message.epoch,
            message.seq,
            message.full,
            {
                p.proc_id: (p.changed, p.removed)
                for p in message.procs
            },
        )
        if snaps is None:
            self._rpc_obs.resyncs.inc()
            resp.resync = True
        else:
            self._rpc_obs.batch_procs.inc(max(len(message.procs), 1))
            for p in message.procs:
                worker_id = p.worker_id if p.worker_id >= 0 else node_id
                scalars = snaps.get(p.proc_id, {})
                if (
                    p.step_advanced
                    and p.step >= 0
                    and self._speed_monitor
                ):
                    # same wire-0.0→None sentinel mapping as the
                    # GlobalStepReport branch
                    self._speed_monitor.collect_global_step(
                        p.step,
                        p.step_ts if p.step_ts else None,
                        node_id=worker_id,
                    )
                if p.step >= 0 and (scalars or p.open_span):
                    if self._metric_collector is not None:
                        self._metric_collector.report_train_metrics(
                            worker_id, p.step, dict(scalars)
                        )
                    if self._telemetry is not None:
                        self._telemetry.observe_metrics(
                            worker_id,
                            p.step,
                            dict(scalars),
                            open_span=p.open_span,
                            open_span_elapsed_s=p.open_span_elapsed_s,
                        )
            if message.resource is not None and self._job_manager:
                self._job_manager.update_node_resource_usage(
                    req.node_type or "worker",
                    node_id,
                    message.resource.cpu_percent,
                    message.resource.used_memory_mb,
                )
        # the poll legs ride back even on resync: a wedged telemetry
        # stream must not also stall the forensics command channel
        resp.commands = self._drain_commands(
            node_id, message.command_ack_id
        )
        if self._paral_config_service:
            # version mismatch INCLUDING the agent's initial -1 ("I
            # have nothing — send whatever you have"): the response
            # carries the config only when the agent's copy is stale
            cfg = self._paral_config_service.get_config(node_id)
            if (
                cfg is not None
                and getattr(cfg.dataloader, "version", 0)
                != message.paral_version
            ):
                resp.paral_config = cfg
        return resp

    def _join_rendezvous(
        self, req: comm.BaseRequest, message: comm.JoinRendezvousRequest
    ):
        mgr = self._rdzv_managers.get(message.rdzv_name)
        if mgr is None:
            return False
        with self._lock:
            addr = self._node_addrs.get("worker", {}).get(
                message.node_rank, ""
            )
        rnd = mgr.join_rendezvous(
            message.node_rank,
            message.local_world_size,
            addr=addr,
            node_group=message.node_group,
        )
        if self._speed_monitor:
            self._speed_monitor.reset_running_speed_monitor()
        return comm.ClusterVersion(version=rnd)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """``n`` bytes from ``sock``; ``ConnectionError`` when the peer
    closes first."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        buf += chunk
    return bytes(buf)


def check_frame_size(n: int):
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(
            f"frame of {n} bytes exceeds the {MAX_FRAME_BYTES}-byte limit"
        )


def send_request(sock: socket.socket, method: int, payload: bytes):
    check_frame_size(len(payload))
    sock.sendall(_REQUEST_HEADER.pack(method, len(payload)) + payload)


def recv_response(sock: socket.socket) -> bytes:
    (n,) = _RESPONSE_HEADER.unpack(recv_exact(sock, _RESPONSE_HEADER.size))
    check_frame_size(n)
    return recv_exact(sock, n)


class _FrameHandler(socketserver.BaseRequestHandler):
    """One client connection: request frames in, response frames out,
    until the client closes."""

    def handle(self):
        servicer: MasterServicer = self.server.servicer
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                method, n = _REQUEST_HEADER.unpack(
                    recv_exact(sock, _REQUEST_HEADER.size)
                )
                check_frame_size(n)
                payload = recv_exact(sock, n)
            except (ConnectionError, OSError):
                return
            if method == METHOD_GET:
                out = servicer.get(payload)
            elif method == METHOD_REPORT:
                out = servicer.report(payload)
            else:
                logger.error(f"unknown RPC method {method}; closing")
                return
            try:
                sock.sendall(_RESPONSE_HEADER.pack(len(out)) + out)
            except OSError:
                return


class MasterServer(socketserver.ThreadingTCPServer):
    """The master's TCP server: a thread per client connection."""

    daemon_threads = True
    allow_reuse_address = True
    # a fleet of agents connecting at once
    request_queue_size = 128

    def __init__(self, port: int, servicer: MasterServicer):
        self.servicer = servicer
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(("0.0.0.0", port), _FrameHandler)
        self._thread = threading.Thread(
            target=self.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="master-server",
            daemon=True,
        )
        self._thread.start()

    def process_request_thread(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conns_lock:
                self._conns.discard(request)

    def stop(self, timeout: float = 5.0):
        """Stop accepting, close the listening socket and every open
        connection (clients reconnect to a successor on this port)."""
        self.shutdown()
        self.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=timeout)


def create_master_service(
    port: int, servicer: MasterServicer
) -> MasterServer:
    """Start serving ``servicer`` on ``port`` (all interfaces).

    Parity: servicer.py:570 create_master_service, over TCP frames
    instead of gRPC."""
    return MasterServer(port, servicer)
