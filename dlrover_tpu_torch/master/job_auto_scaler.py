"""Auto-scaler: closes the loop from monitoring to ScalePlans.

Parity: dlrover/python/master/node/job_auto_scaler.py —
``new_job_auto_scaler:40`` picks the variant,
``AllreduceTrainingAutoScaler:254`` periodically counts alive workers
and replaces dead ones, ``PSTrainingAutoScaler:98`` additionally
consumes resource-optimizer plans. The TPU job is the allreduce shape
(one SPMD world over ICI/DCN): the scaler's duties are

- replace nodes that died unrecoverably (exhausted relaunch budget,
  heartbeat-timeout) so the world can return to target size;
- honor node-unit granularity (whole TPU slices, SURVEY §5: slice-level
  failure means all hosts of the slice restart together);
- expose ``scale_to`` for explicit resizes (API / operator / Brain), the
  seam the resource optimizer plugs into.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.daemon import PollingDaemon
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.scaler import ScalePlan, Scaler


class JobAutoScaler(PollingDaemon):
    def __init__(
        self,
        job_manager: JobManager,
        speed_monitor=None,
        scaler: Optional[Scaler] = None,
        node_type: str = NodeType.WORKER,
        target_nodes: int = 0,
        node_unit: int = 1,
        interval: float = 15.0,
        resource_optimizer=None,
        optimize_every_ticks: int = 20,
        paral_config_service=None,
        candidate_k: int = 3,
        telemetry=None,
    ):
        super().__init__("job-auto-scaler", interval)
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._scaler = scaler
        self._node_type = node_type
        self._target = target_nodes or len(
            job_manager.get_nodes(node_type)
        )
        self._node_unit = max(1, node_unit)
        self._optimizer = resource_optimizer
        self._optimize_every = max(1, optimize_every_ticks)
        self._ticks = 0
        self._opt_thread: Optional[threading.Thread] = None
        # speculative-compile feed: predicted next worker counts are
        # published through the paral-config channel so workers can
        # pre-lower the train step for the likely next mesh
        self._paral_config_service = paral_config_service
        self._candidate_k = max(1, candidate_k)
        self._last_recommendation: Optional[int] = None
        # obs/aggregate.TelemetryAggregator: the scaler runs the
        # straggler detection pass on its cadence and keeps the verdict
        # on `stragglers` — the signal a future straggler-aware scale
        # policy (and today's operators, via the log) act on
        self._telemetry = telemetry
        self._straggler_ranks: list = []
        # eviction pre-arm: (count, expiry) published FIRST in the
        # speculative-compile candidate list — an eviction notice makes
        # n - node_unit the single most likely next world size, and the
        # survivors should hold its executable before the death lands
        self._prearm: Optional[tuple] = None

    @property
    def has_scaler(self) -> bool:
        return self._scaler is not None

    @property
    def target(self) -> int:
        """Current target worker count (the size ``scale_to`` last
        converged on) — read by the Brain plan executor and stats."""
        return self._target

    def set_exclude_hosts(self, hosts) -> None:
        """Public seam onto the platform scaler's anti-affinity list
        (Brain bad-node exclusion riding a cluster plan slice)."""
        if self._scaler is not None:
            self._scaler.set_exclude_hosts(tuple(hosts))

    @property
    def stragglers(self) -> list:
        """Worker ids flagged by the last straggler-detection pass."""
        return list(self._straggler_ranks)

    def check_stragglers(self) -> list:
        """One detection pass over the telemetry aggregator (newly
        flagged workers reach the Brain inside detect_stragglers)."""
        if self._telemetry is None:
            return []
        flagged = self._telemetry.detect_stragglers()
        if flagged != self._straggler_ranks:
            logger.warning(
                f"straggler set changed: {self._straggler_ranks} -> "
                f"{flagged}"
            )
            self._straggler_ranks = flagged
        return flagged

    def _tick(self):
        self.check_and_scale()
        self.check_stragglers()
        self._ticks += 1
        if self._optimizer and self._ticks % self._optimize_every == 0:
            # off-tick thread: the Brain optimize RPC retries with
            # backoff on outage (~30s+) and must not stall the next
            # check_and_scale (dead-node replacement)
            if self._opt_thread is None or not self._opt_thread.is_alive():
                self._opt_thread = threading.Thread(
                    target=self.run_optimization_pass,
                    name="optimization-pass",
                    daemon=True,
                )
                self._opt_thread.start()

    def stop(self):
        super().stop()
        # an in-flight optimization pass must not emit plans mid-teardown
        if self._opt_thread is not None:
            self._opt_thread.join(timeout=5)
            self._opt_thread = None

    def run_optimization_pass(self):
        """Consult the resource optimizer (parity: PSTrainingAutoScaler
        executing optimizer plans, job_auto_scaler.py:98). Only the
        worker-count recommendation is acted on here (scale_to does its
        mutations under the job manager's scale_lock — the `want !=
        _target` pre-check is advisory, worst case a redundant
        idempotent plan); memory changes apply at the next relaunch
        through node config_resource."""
        plan = self._optimizer.generate_plan()
        if self._stopped.is_set():
            return  # shutdown raced the (possibly slow) optimize RPC
        if self._scaler is not None and plan.exclude_nodes is not None:
            # authoritative statements only: a Brain outage falls back
            # to the local optimizer whose plan carries None ("no
            # statement") — standing exclusions must survive it. An
            # EMPTY tuple from the Brain means condemnation decayed and
            # clears stale anti-affinity.
            self._scaler.set_exclude_hosts(plan.exclude_nodes)
        if plan.empty():
            return
        logger.info(f"resource plan: {plan}")
        if plan.worker_count:
            # compare unit-rounded: a recommendation that rounds back to
            # the current target is a no-op and must not emit a fresh
            # ScalePlan every pass
            want = plan.worker_count
            if want % self._node_unit:
                want += self._node_unit - want % self._node_unit
            # even a not-yet-acted-on recommendation is the strongest
            # scale signal there is: surface it to the workers'
            # speculative compilers before any plan executes
            self._last_recommendation = want
            self.publish_scale_candidates()
            if want != self._target:
                self.scale_to(want)
        if plan.worker_memory_mb:
            with self._job_manager.scale_lock:
                for node in self.alive_nodes():
                    # grow only: the OOM-doubled bump from the relaunch
                    # path must never be trimmed back by a headroom
                    # estimate computed from pre-OOM samples
                    if plan.worker_memory_mb > node.config_resource.memory_mb:
                        node.config_resource.memory_mb = (
                            plan.worker_memory_mb
                        )

    def execute_plan(self, plan: ScalePlan):
        """Public seam: hand a plan to the platform scaler (keeps other
        components off the private _scaler)."""
        if self._scaler is not None:
            self._scaler.scale(plan)

    # -- eviction pre-arming --------------------------------------------
    def note_eviction(self, node_id: int, grace_s: float = 0.0):
        """An eviction notice arrived for ``node_id``: treat the coming
        death as a SCHEDULED departure. Pre-arm the warm resize — the
        shrunken world (target − unit) jumps to the head of the
        speculative-compile candidates, published immediately instead
        of on the next tick — and open a telemetry maintenance window
        so the drain's deliberate stall is not attributed as a
        straggler/hang."""
        node = next(
            (
                n
                for n in self._job_manager.get_nodes(self._node_type)
                if n.id == node_id
            ),
            None,
        )
        if node is not None:
            node.evicting = True
        shrunk = max(self._node_unit, self._target - self._node_unit)
        if shrunk != self._target:
            # pre-arm outlives the grace window by one poll cycle;
            # after that the normal predictions take back over
            self._prearm = (
                shrunk,
                time.monotonic() + (grace_s or 30.0) + 60.0,
            )
        self.publish_scale_candidates()
        if self._telemetry is not None and hasattr(
            self._telemetry, "note_maintenance"
        ):
            self._telemetry.note_maintenance((grace_s or 30.0) + 30.0)
        logger.info(
            f"eviction pre-arm: node {node_id} draining "
            f"(grace {grace_s:.0f}s); candidate world {shrunk} "
            f"published ahead of the death"
        )

    # -- speculative-compile feed ---------------------------------------
    def predicted_scale_candidates(self) -> list:
        """Top-k worker counts the next resize is likely to land on,
        most likely first: an eviction pre-arm (a death that WILL
        happen), the optimizer's standing recommendation (a plan that
        WILL execute), then one node-unit in each direction of the
        current target (failure shrink / headroom growth — the
        unit-quantized moves ``scale_to`` can actually make). The
        current target itself is excluded: workers already hold its
        executable."""
        prearm = None
        if self._prearm is not None:
            count, expiry = self._prearm
            if time.monotonic() < expiry:
                prearm = count
            else:
                self._prearm = None
        out = []
        for want in (
            prearm,
            self._last_recommendation,
            self._target + self._node_unit,
            self._target - self._node_unit,
        ):
            if (
                want
                and want > 0
                and want != self._target
                and want not in out
            ):
                out.append(want)
        return out[: self._candidate_k]

    def publish_scale_candidates(self):
        """Push the current prediction through the paral-config channel
        (agents mirror it to the file workers poll)."""
        if self._paral_config_service is None:
            return
        cands = self.predicted_scale_candidates()
        if self._paral_config_service.set_candidate_worker_counts(cands):
            logger.info(
                f"published scale candidates {cands} "
                f"(target {self._target})"
            )

    # -- core -----------------------------------------------------------
    def alive_nodes(self):
        return [
            n
            for n in self._job_manager.get_nodes(self._node_type)
            if not n.is_released
            and n.status
            in (
                NodeStatus.INITIAL,
                NodeStatus.PENDING,
                NodeStatus.RUNNING,
            )
        ]

    def check_and_scale(self) -> ScalePlan:
        """One pass (parity: AllreduceTrainingAutoScaler
        ``_periodic_adjust_worker`` job_auto_scaler.py:254): release
        heartbeat-dead nodes, then top the group back up to target.
        Runs under the job manager's scale lock so it cannot race the
        servicer's failure-relaunch path into duplicate ranks."""
        plan = ScalePlan()
        with self._job_manager.scale_lock:
            for node in self._job_manager.get_heartbeat_timeout_nodes():
                if node.evicting:
                    # the announced death arrived: a scheduled
                    # departure, not a crash — the replacement keeps
                    # its relaunch budget (_create_replacement reads
                    # this reason)
                    node.exit_reason = NodeExitReason.PREEMPTED
                    logger.info(
                        f"{node.name}: evicted as announced; replacing"
                    )
                else:
                    logger.warning(
                        f"{node.name}: no heartbeat; marking failed "
                        f"for replacement"
                    )
                node.is_released = True
                node.update_status(NodeStatus.FAILED)
                plan.remove_nodes.append(node)
                if self._speed_monitor:
                    self._speed_monitor.remove_running_worker(node.id)

            # the target is already node-unit aligned, so restoring it
            # keeps whole slices (unit rounding applies to scale_to
            # targets, not to replacement). Ranks out of relaunch budget
            # are skipped individually — one poisoned rank must not starve
            # replacement of the others.
            used = {n.rank_index for n in self.alive_nodes()}
            missing_ranks = [
                r for r in range(self._target) if r not in used
            ]
            for rank in missing_ranks:
                new_node = self._create_replacement(rank)
                if new_node is not None:
                    plan.launch_nodes.append(new_node)
        if not plan.empty():
            plan.node_group[self._node_type] = self._target
            logger.info(
                f"auto-scale plan: +{len(plan.launch_nodes)} "
                f"-{len(plan.remove_nodes)} (target {self._target})"
            )
            if self._scaler is not None:
                self._scaler.scale(plan)
        return plan

    def _create_replacement(self, rank: int) -> Optional[Node]:
        """Replacement node for ``rank``. Inherits the dead node's
        resources and relaunch budget (the OOM memory bump from
        _handle_node_failure must survive this path too); a rank whose
        budget is exhausted is not replaced."""
        prior = [
            n
            for n in self._job_manager.get_nodes(self._node_type)
            if n.rank_index == rank
        ]
        new_id = self._job_manager.allocate_node_id(self._node_type)
        last = max(prior, key=lambda n: n.id) if prior else None
        if last is not None and last.exit_reason in (
            NodeExitReason.SCALED_DOWN,
            NodeExitReason.PREEMPTED,
        ):
            # deliberate removal / platform eviction: come back with a
            # fresh budget — scheduled departures are not crash loops
            last = None
        if last is not None:
            if (
                not last.relaunchable
                or last.relaunch_count >= last.max_relaunch_count
            ):
                logger.warning(
                    f"rank {rank} is out of relaunch budget "
                    f"({last.relaunch_count}); not replacing"
                )
                return None
            node = last.get_relaunch_node_info(new_id)
        else:
            node = Node(
                node_type=self._node_type,
                node_id=new_id,
                rank_index=rank,
                group=rank // self._node_unit,
                group_size=self._node_unit,
            )
        self._job_manager.add_node(node)
        # a replacement IS a relaunch for the listeners' purposes —
        # e.g. the master clears the dead rank's rendezvous exclusion
        # so the healthy replacement isn't parked for the full TTL
        self._job_manager.notify_relaunch(
            max(prior, key=lambda n: n.id) if prior else None, node
        )
        return node

    def scale_to(self, count: int) -> ScalePlan:
        """Explicit resize (operator / Brain / API seam). Parity:
        job_auto_scaler.py ``execute_job_optimization_plan``. Non-unit
        counts round UP to a whole node unit (a partial slice cannot
        join, and rounding down could silently scale to zero)."""
        if count < 0:
            raise ValueError(f"cannot scale to {count}")
        if count % self._node_unit:
            count += self._node_unit - count % self._node_unit
        # a resize is deliberate maintenance: the fleet-wide pause
        # while workers drain/reshard must not mint stragglers or aim
        # forensics dumps at healthy workers (obs/aggregate window)
        if self._telemetry is not None and hasattr(
            self._telemetry, "note_maintenance"
        ):
            self._telemetry.note_maintenance(60.0)
        plan = ScalePlan()
        plan.node_group[self._node_type] = count
        with self._job_manager.scale_lock:
            alive = sorted(self.alive_nodes(), key=lambda n: n.rank_index)
            if count < len(alive):
                for node in alive[count:]:
                    node.is_released = True
                    node.relaunchable = False
                    node.exit_reason = NodeExitReason.SCALED_DOWN
                    plan.remove_nodes.append(node)
            self._target = count
        # the target moved: the likely-next-counts move with it
        self.publish_scale_candidates()
        if not plan.empty() and self._scaler is not None:
            self._scaler.scale(plan)
        if count > len(alive):
            # top-up handled by the same path as failure replacement
            plan2 = self.check_and_scale()
            plan.launch_nodes.extend(plan2.launch_nodes)
        return plan
