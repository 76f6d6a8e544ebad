"""Local job master: the full master wired up on localhost (a copy of
``dlrover_tpu/master/local_master.py`` without the cluster Brain: a set
``DLROVER_TPU_BRAIN_ADDR`` raises until ROADMAP A17 ports ``brain/``).

Parity: dlrover/python/master/local_master.py:38 (LocalJobMaster) — used
both as the real master for single-host launcher jobs and as the
in-process fixture for tests (the reference's key test pattern,
test_utils.py ``start_local_master``).
"""

from __future__ import annotations

import os
import threading
import time

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    JobExitReason,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.elastic_ps import ElasticPsService
from dlrover_tpu_torch.master.job_auto_scaler import JobAutoScaler
from dlrover_tpu_torch.master.job_manager import LocalJobManager
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.paral_config import ParalConfigService
from dlrover_tpu_torch.master.resource.optimizer import JobResourceOptimizer
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import MasterServicer, create_master_service
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.stats.collector import JobMetricCollector
from dlrover_tpu_torch.master.sync_service import SyncService

_ctx = Context.singleton_instance()


class LocalJobMaster:
    def __init__(
        self,
        port: int = 0,
        node_num: int = 1,
        scaler=None,
        node_unit: int = 1,
    ):
        self.port = port or comm.find_free_port()
        # the cluster Brain (metric reporting, node-incident events,
        # the job summary, cluster plans) is not ported yet
        if os.getenv("DLROVER_TPU_BRAIN_ADDR", ""):
            raise NotImplementedError("ROADMAP A17")
        # unified telemetry (obs/): per-worker step times, straggler
        # detection, hang attribution
        from dlrover_tpu_torch.obs.aggregate import TelemetryAggregator

        self.telemetry = TelemetryAggregator()
        self.speed_monitor = SpeedMonitor(telemetry=self.telemetry)
        self.job_manager = LocalJobManager(
            speed_monitor=self.speed_monitor, scaler=scaler
        )
        self.job_manager.create_initial_nodes(node_num)
        self.metric_collector = JobMetricCollector(
            self.job_manager,
            self.speed_monitor,
            telemetry=self.telemetry,
        )
        self.resource_optimizer = JobResourceOptimizer(
            metric_collector=self.metric_collector,
            node_unit=node_unit,
        )
        self.paral_config_service = ParalConfigService()
        self.auto_scaler = JobAutoScaler(
            self.job_manager,
            speed_monitor=self.speed_monitor,
            scaler=scaler,
            target_nodes=node_num,
            node_unit=node_unit,
            resource_optimizer=self.resource_optimizer,
            # predicted next worker counts flow to the workers'
            # speculative compilers through the paral-config channel
            paral_config_service=self.paral_config_service,
            # straggler flags surface to the scaler's periodic pass
            telemetry=self.telemetry,
        )
        self.task_manager = TaskManager(self.speed_monitor)
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = KVStoreService()
        self.sync_service = SyncService(self.job_manager)
        self.elastic_ps_service = ElasticPsService()
        self.servicer = MasterServicer(
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            sync_service=self.sync_service,
            speed_monitor=self.speed_monitor,
            elastic_ps_service=self.elastic_ps_service,
            paral_config_service=self.paral_config_service,
            metric_collector=self.metric_collector,
            telemetry=self.telemetry,
            auto_scaler=self.auto_scaler,
        )
        # straggler auto-profile: a newly-flagged worker gets ONE
        # `profile` command per episode, so the flag ships with
        # jax.profiler evidence (obs/flight_recorder.ProfilerCapture)
        self.telemetry.set_profile_requester(
            lambda w: self.servicer.queue_worker_command(
                w, "profile", arg=3, reason="straggler"
            )
        )
        # eviction notices fan out here: exclude the doomed rank from
        # world assembly, pre-arm the warm resize (speculative n-1
        # compile on the survivors), and open the telemetry
        # maintenance window so the deliberate drain stall is never
        # attributed as a straggler or hang
        self.job_manager.add_eviction_listener(self._on_eviction_notice)
        # SDC convictions fan out here too: permanent rendezvous
        # quarantine (the chip must never rejoin), scheduler
        # anti-affinity for the convicted host, and the same telemetry
        # maintenance window — the convicted worker's rollback-replay
        # is deliberate, not a straggler or a hang
        self.job_manager.add_sdc_listener(self._on_sdc_conviction)
        # ...and the rank's HEALTHY replacement must not inherit the
        # doomed incarnation's exclusion: any relaunch/replacement of
        # a rank clears it immediately instead of waiting out the TTL.
        # EXCEPT quarantined ranks — a relaunch is the same silicon;
        # only explicit hardware replacement (clear_exclusion by the
        # operator path) lifts an SDC quarantine
        self.job_manager.add_relaunch_listener(
            self._on_relaunch_clear_exclusion
        )
        self._server = None
        self._stopped = threading.Event()
        # master failover: snapshot/restore through a state file when
        # DLROVER_TPU_MASTER_STATE names one (the k8s operator relaunches
        # the master pod; agents ride out the outage — master/state.py)
        from dlrover_tpu_torch.master.state import (
            MasterStateSaver,
            state_path_from_env,
        )

        self._state_saver = None
        state_path = state_path_from_env()
        if state_path:
            self._state_saver = MasterStateSaver(self, state_path)

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def prepare(self):
        if self._state_saver is not None:
            if self._state_saver.restore_if_any():
                logger.info("master restarted from persisted state")
            self._state_saver.start()
        self._server = create_master_service(self.port, self.servicer)
        # Without a platform scaler the periodic pass would fabricate
        # replacement Node entries nothing ever launches — ghosts that
        # make the world look full while it is short. The table is then
        # maintained only by the event/relaunch path.
        if self.auto_scaler.has_scaler:
            self.auto_scaler.start()
        self.metric_collector.start()
        logger.info(f"local master serving on {self.addr}")

    def run(self, max_hang_recoveries: int = 3) -> str:
        """Block until the job finishes; returns the exit reason.

        A hang first triggers worker restarts through the agents'
        heartbeat action channel (parity: the reference relaunches on
        hang, dist_job_manager.py, rather than failing the job); only
        after ``max_hang_recoveries`` fruitless restarts does the job
        exit with HANG_ERROR.
        """
        hang_recoveries = 0
        step_at_last_hang = -1
        while not self._stopped.is_set():
            if self.task_manager.finished():
                logger.info("all dataset tasks completed")
                if self._state_saver is not None:
                    # terminal success: drop the failover state so a
                    # fresh run on this path doesn't resume a done job
                    # (an externally-stopped master keeps its state —
                    # that IS the failover case)
                    self._state_saver.clear()
                return JobExitReason.SUCCEEDED
            if self.job_manager.all_running_node_hanged() and not (
                # data starvation is not a hang: consumers parked on a
                # streaming WAIT make no step progress by design. Bounded:
                # a producer dead past the starvation timeout surfaces as
                # a stall again.
                self.task_manager.waiting_for_data(
                    _ctx.hang_detection_secs,
                    _ctx.data_starvation_timeout_secs,
                )
            ):
                # only *fruitless* restarts count: progress since the last
                # hang resets the budget, so transient hangs days apart on
                # a long job never add up to a kill
                step = self.speed_monitor.completed_global_step
                if step > step_at_last_hang >= 0:
                    hang_recoveries = 0
                step_at_last_hang = step
                if hang_recoveries >= max_hang_recoveries:
                    logger.error(
                        f"job still hanged after {hang_recoveries} "
                        f"restart rounds; stopping"
                    )
                    return JobExitReason.HANG_ERROR
                hang_recoveries += 1
                # hang ATTRIBUTION: each worker's last open span (the
                # SpanHeartbeat channel) turns "no step progress" into
                # "worker 3 stuck in ckpt_commit for 42s"
                logger.error(
                    f"job hanged ({self.telemetry.describe_hang()}); "
                    f"restarting workers (recovery "
                    f"{hang_recoveries}/{max_hang_recoveries})"
                )
                # best-effort forensics: ask every attributed worker
                # for a flight-recorder bundle before the restart kills
                # the evidence (a fully wedged trainer won't poll the
                # command file — its own hang watchdog covers that
                # case; this catches the partially-alive ones). A
                # maintenance window (resize / eviction drain) means
                # the stall is DELIBERATE: dumping "hang" evidence of
                # healthy drains would forge forensics, so the dump
                # round is skipped
                attributed = (
                    []
                    if self.telemetry.in_maintenance()
                    else sorted(self.telemetry.hang_attribution())
                )
                for w in attributed:
                    self.servicer.queue_worker_command(
                        w, "flight_dump", reason="hang"
                    )
                if attributed:
                    # one relay-poll window so partially-alive workers
                    # can actually pull the command, then PURGE what
                    # was never delivered — a dump request for the
                    # dying incarnation executed by its healthy
                    # replacement would forge "hang" evidence of a
                    # fine process
                    time.sleep(
                        float(
                            os.getenv("DLROVER_TPU_HANG_DUMP_GRACE_S", "6")
                        )
                    )
                    self.servicer.clear_worker_commands()
                self.job_manager.restart_all_workers()
            # a stop() (the launcher's SIGTERM at the job's end) ends
            # the wait at once
            self._stopped.wait(2)
        return JobExitReason.SUCCEEDED

    def scale_to(self, count: int):
        """Explicit resize API (operator seam)."""
        return self.auto_scaler.scale_to(count)

    def _on_eviction_notice(
        self, node_type: str, node_id: int, grace_s: float,
        drain_ms: float,
    ):
        """JobManager eviction-listener leg (one notice may re-fire
        with the measured ``drain_ms`` — every step is idempotent)."""
        node = self.job_manager.get_node(node_type, node_id)
        rank = node.rank_index if node is not None else node_id
        ttl = (grace_s or 30.0) + 60.0
        for mgr in self.rdzv_managers.values():
            mgr.exclude_node(rank, ttl_s=ttl)
        self.auto_scaler.note_eviction(node_id, grace_s=grace_s)

    def _on_relaunch_clear_exclusion(self, old, new):
        """A relaunched/replaced rank sheds its eviction exclusion —
        but never an SDC quarantine (same rank after a relaunch means
        the same convicted chip)."""
        quarantined_ranks = set()
        for nt, nid in self.job_manager.quarantined_nodes():
            n = self.job_manager.get_node(nt, nid)
            quarantined_ranks.add(
                n.rank_index if n is not None else nid
            )
        # the replacement carries a fresh node id but the SAME rank —
        # rank is what rendezvous excludes, so rank is what must hold
        if new.rank_index in quarantined_ranks:
            return
        for mgr in self.rdzv_managers.values():
            mgr.clear_exclusion(new.rank_index)

    def _on_sdc_conviction(
        self, node_type: str, node_id: int, detail: str
    ):
        """JobManager SDC-listener leg: quarantine the convicted rank
        out of every rendezvous plane permanently, hand the scheduler
        the host as anti-affinity (absent capacity), and open a
        telemetry maintenance window over the fleet's rollback-replay
        so the straggler/hang detectors don't mint alarms against a
        deliberately-replaying world (PR-19 interop)."""
        node = self.job_manager.get_node(node_type, node_id)
        rank = node.rank_index if node is not None else node_id
        for mgr in self.rdzv_managers.values():
            mgr.quarantine_node(rank)
        self.telemetry.note_maintenance(120.0)
        if node is not None and node.hostname:
            try:
                self.auto_scaler.set_exclude_hosts([node.hostname])
            except Exception as e:
                logger.warning(
                    f"sdc anti-affinity for {node.hostname} failed: {e!r}"
                )

    def evict_worker(
        self, node_id: int, grace_s: float = 0.0, reason: str = "operator"
    ):
        """Master-initiated eviction (operator drain, platform
        preemption watcher): queue the ``evict`` worker command — the
        trainer enters its grace-window drain — and book the departure
        as scheduled on this side immediately. The command arg is an
        int: fractional windows round UP (``int()`` would turn a 0.9 s
        window into arg=0 = "use the 30 s default" while the platform
        kills in under a second); 0 still means the trainer default."""
        import math

        self.servicer.queue_worker_command(
            node_id,
            "evict",
            arg=(int(math.ceil(grace_s)) if grace_s > 0 else 0),
            reason=reason,
        )
        self.job_manager.handle_eviction_notice(
            "worker", node_id, grace_s=grace_s, reason=reason
        )

    def stop(self, final_snapshot: bool = True):
        """``final_snapshot=False`` simulates a crash for failover tests:
        the successor restores the last AUTOSAVE (up to one interval
        stale), the case a real master death produces."""
        self._stopped.set()
        self.auto_scaler.stop()
        self.metric_collector.stop()
        if self._state_saver is not None:
            self._state_saver.stop(final_snapshot=final_snapshot)
        if self._server is not None:
            # wait for termination: a failover successor may bind this
            # port immediately after stop() returns
            self._server.stop(timeout=5)
            self._server = None


def start_local_master(
    node_num: int = 1, port: int = 0
) -> LocalJobMaster:
    """Test/CLI helper: start a serving master (parity: the
    ``start_local_master`` fixture in dlrover test_utils.py)."""
    master = LocalJobMaster(port=port, node_num=node_num)
    master.prepare()
    return master
