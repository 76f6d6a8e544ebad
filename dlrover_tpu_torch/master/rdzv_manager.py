"""Master-side rendezvous: elastic-training world assembly and the
paired network-check rendezvous that bisects faulty/straggling hosts (a
copy of ``dlrover_tpu/master/rdzv_manager.py``).

Parity: dlrover/python/master/elastic_training/rdzv_manager.py:52,254,300
(RendezvousManager / ElasticTrainingRendezvousManager /
NetworkCheckRendezvousManager with ``_group_nodes:353``,
``check_fault_node:451``, ``_detect_stragglers:494``).

TPU re-design:
- ``node_unit`` is the number of hosts per TPU slice: a world must be a
  multiple of it because a slice only works with all of its hosts (the
  reference uses node-unit for superpods the same way, rdzv_manager.py:129).
- The comm world carries a ``coordinator_addr`` (host:port on the
  lowest-rank node): in the port it is the ``tcp://`` rendezvous of
  ``torch.distributed.init_process_group``, whose store rank 0 binds
  (``trainer/elastic/distributed.py``).
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger

_ctx = Context.singleton_instance()


class RendezvousParameters:
    def __init__(
        self,
        min_nodes: int = 1,
        max_nodes: int = 1,
        waiting_timeout: float = 30.0,
        node_unit: int = 1,
        rdzv_timeout: float = 0.0,
    ):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        # seconds to keep waiting for more nodes once min is reached
        self.waiting_timeout = waiting_timeout
        self.node_unit = max(1, node_unit)
        self.rdzv_timeout = rdzv_timeout or _ctx.rdzv_timeout_secs


class _WaitingNode:
    def __init__(self, node_rank: int, local_world_size: int, addr: str):
        self.node_rank = node_rank
        self.local_world_size = local_world_size
        self.addr = addr
        self.join_time = time.time()


class RendezvousManager:
    """Accumulates waiting nodes, freezes them into a comm world."""

    def __init__(self, name: str = "elastic-training"):
        self.name = name
        self._lock = threading.Lock()
        self._params = RendezvousParameters()
        self._waiting_nodes: Dict[int, _WaitingNode] = {}
        self._latest_rdzv_nodes: Dict[int, _WaitingNode] = {}
        self._rdzv_round = 0
        self._latest_log_time = 0.0
        self._start_rdzv_time = 0.0
        self._lastcall_time = 0.0
        self._coordinator_addr = ""
        self._node_groups: Dict[int, int] = {}
        # doomed ranks (eviction notice received): excluded from world
        # assembly until the expiry — an evicting node re-joining the
        # next round would hand the fresh world a member that dies
        # seconds later. TTL-bounded so the rank's healthy REPLACEMENT
        # is never locked out.
        self._excluded_until: Dict[int, float] = {}

    # -- configuration -------------------------------------------------
    def update_rdzv_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = 30.0,
        node_unit: int = 1,
    ):
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes, max_nodes, waiting_timeout, node_unit
            )

    @property
    def rdzv_round(self) -> int:
        return self._rdzv_round

    def restore_round(self, rdzv_round: int):
        """Failover restore: a relaunched master must not replay round
        numbers agents have already trained under."""
        with self._lock:
            if rdzv_round > self._rdzv_round:
                self._rdzv_round = rdzv_round

    # -- joining -------------------------------------------------------
    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int,
        addr: str = "",
        node_group: int = -1,
    ) -> int:
        """Node announces readiness; returns the round it will join.

        A node re-joining after a restart leaves the frozen world — the old
        world is defunct for it; it waits for the next round with everyone
        else. ``waiting_timeout`` is a *lastcall* window counted from the
        most recent join, giving laggard agents time to notice the
        membership change and re-join before the world freezes.
        """
        with self._lock:
            now = time.time()
            if self._excluded(node_rank):
                # draining under an eviction notice: answer the round
                # (the agent's poll loop stays happy) but never enter
                # the waiting set — the next frozen world must not
                # contain a member already scheduled to die
                logger.info(
                    f"rdzv[{self.name}]: rank {node_rank} join parked "
                    f"(eviction exclusion)"
                )
                return self._rdzv_round
            if not self._waiting_nodes:
                self._start_rdzv_time = now
            self._lastcall_time = now
            self._waiting_nodes[node_rank] = _WaitingNode(
                node_rank, local_world_size, addr
            )
            self._latest_rdzv_nodes.pop(node_rank, None)
            if node_group >= 0:
                self._node_groups[node_rank] = node_group
            return self._rdzv_round

    def remove_node(self, node_rank: int):
        """Drop a dead node from the waiting list."""
        with self._lock:
            self._waiting_nodes.pop(node_rank, None)

    # -- eviction exclusion --------------------------------------------
    def exclude_node(self, node_rank: int, ttl_s: float = 60.0):
        """Keep ``node_rank`` out of world assembly for ``ttl_s``
        seconds (an eviction notice arrived: the node is draining and
        must not be frozen into the next world). Already-waiting
        entries are dropped; joins during the window are accepted but
        parked (the node keeps its round answer, it just never makes a
        world)."""
        with self._lock:
            self._excluded_until[node_rank] = time.time() + ttl_s
            self._waiting_nodes.pop(node_rank, None)
        logger.info(
            f"rdzv[{self.name}]: rank {node_rank} excluded for "
            f"{ttl_s:.0f}s (eviction drain)"
        )

    def quarantine_node(self, node_rank: int):
        """Permanent exclusion (no TTL): the rank's chip was convicted
        of silent data corruption — hardware that LIES must never
        rejoin a world, however long it waits. ``clear_exclusion``
        still lifts it: that is the hardware-replacement path (the
        replaced rank is new silicon, not the convicted chip)."""
        with self._lock:
            self._excluded_until[node_rank] = float("inf")
            self._waiting_nodes.pop(node_rank, None)
        logger.warning(
            f"rdzv[{self.name}]: rank {node_rank} quarantined "
            f"permanently (sdc conviction)"
        )

    def clear_exclusion(self, node_rank: int):
        with self._lock:
            self._excluded_until.pop(node_rank, None)

    def _excluded(self, node_rank: int) -> bool:
        """Lock held by caller. Expired entries are pruned lazily."""
        until = self._excluded_until.get(node_rank)
        if until is None:
            return False
        if time.time() >= until:
            del self._excluded_until[node_rank]
            return False
        return True

    def excluded_ranks(self):
        with self._lock:
            now = time.time()
            return sorted(
                r for r, t in self._excluded_until.items() if t > now
            )

    def num_nodes_waiting(self) -> int:
        """Nonzero ⇒ agents should restart workers to admit new members.

        Parity: rdzv_manager num_nodes_waiting used at training.py:665.
        Counts every waiting node once a first world has formed (so agents
        of the running world notice both new joiners AND peers that already
        re-joined); always 0 during the initial rendezvous.
        """
        with self._lock:
            if self._rdzv_round == 0:
                return 0
            return len(self._waiting_nodes)

    # -- world assembly ------------------------------------------------
    def _ready(self) -> bool:
        n = len(self._waiting_nodes)
        p = self._params
        if n >= p.max_nodes:
            return True
        if n >= p.min_nodes:
            waited = time.time() - self._lastcall_time
            return waited >= p.waiting_timeout
        return False

    def _fix_world(self) -> Dict[int, _WaitingNode]:
        """Freeze a world that is a multiple of node_unit, preferring the
        lowest node ranks; leftovers stay waiting for the next round."""
        p = self._params
        # defensive re-purge: an exclusion armed between join and
        # freeze must still keep the doomed rank out (and a stale
        # entry must not inflate the readiness count next round)
        for r in [r for r in self._waiting_nodes if self._excluded(r)]:
            del self._waiting_nodes[r]
        ranks = sorted(self._waiting_nodes)
        # cap at max_nodes first, THEN round down to a node_unit multiple —
        # a world must never contain a torn slice
        usable = min(len(ranks), p.max_nodes)
        usable = (usable // p.node_unit) * p.node_unit
        chosen = ranks[:usable]
        world = {r: self._waiting_nodes[r] for r in chosen}
        for r in chosen:
            self._waiting_nodes.pop(r)
        return world

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], str]:
        """Poll for this node's world.

        Returns ``(round, group, {node_rank: local_world_size},
        coordinator_addr)``; empty world dict means "keep polling".
        """
        with self._lock:
            if (
                self._latest_rdzv_nodes
                and node_rank in self._latest_rdzv_nodes
            ):
                world = {
                    r: w.local_world_size
                    for r, w in self._latest_rdzv_nodes.items()
                }
                return (
                    self._rdzv_round - 1,
                    0,
                    world,
                    self._coordinator_addr,
                )
            if self._ready():
                fixed = self._fix_world()
                if fixed:
                    self._latest_rdzv_nodes = fixed
                    first = min(fixed)
                    self._coordinator_addr = fixed[first].addr
                    self._rdzv_round += 1
                    logger.info(
                        f"rdzv[{self.name}] round {self._rdzv_round - 1}: "
                        f"world={sorted(fixed)} "
                        f"coordinator={self._coordinator_addr}"
                    )
                    if node_rank in fixed:
                        world = {
                            r: w.local_world_size for r, w in fixed.items()
                        }
                        return (
                            self._rdzv_round - 1,
                            0,
                            world,
                            self._coordinator_addr,
                        )
            self._log_waiting()
            return self._rdzv_round, 0, {}, ""

    def _log_waiting(self):
        now = time.time()
        if now - self._latest_log_time > 30:
            self._latest_log_time = now
            logger.info(
                f"rdzv[{self.name}]: waiting nodes = "
                f"{sorted(self._waiting_nodes)}"
            )

    def clear_waiting_nodes(self):
        with self._lock:
            self._waiting_nodes.clear()
            self._latest_rdzv_nodes.clear()

    def timed_out(self) -> bool:
        with self._lock:
            if not self._waiting_nodes:
                return False
            n = len(self._waiting_nodes)
            # a world is only formable from >= min_nodes AND at least one
            # whole node_unit (slice); fewer than that forever = timeout
            formable = (
                n >= self._params.min_nodes
                and n >= self._params.node_unit
            )
            if formable:
                return False
            return (
                time.time() - self._start_rdzv_time
                > self._params.rdzv_timeout
            )


class ElasticTrainingRendezvousManager(RendezvousManager):
    """The main training rendezvous (parity: rdzv_manager.py:254)."""

    def __init__(self):
        super().__init__("elastic-training")


class NetworkCheckRendezvousManager(RendezvousManager):
    """Paired rendezvous to bisect faulty/straggler hosts.

    Two check rounds with different pairings: a host whose group fails
    twice (with two different partners) is the faulty one; a host whose
    check time exceeds ``straggler_ratio`` x median in both rounds is a
    straggler. Parity: rdzv_manager.py:300-509.
    """

    GROUP_SIZE = 2

    def __init__(self):
        super().__init__("network-check")
        self._node_times: Dict[int, Dict[int, float]] = {}  # round->node->t
        self._node_status: Dict[int, Dict[int, bool]] = {}  # round->node->ok
        self._node_groups_by_round: Dict[int, Dict[int, int]] = {}
        self._check_round = 0
        self._fault_nodes: List[int] = []
        self._straggler_nodes: List[int] = []

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], str]:
        rnd, _, world, coord = super().get_comm_world(node_rank)
        if not world:
            return rnd, 0, world, coord
        groups = self._group_nodes(rnd, sorted(world))
        my_group = groups.get(node_rank, 0)
        with self._lock:
            self._node_groups_by_round[rnd] = groups
        group_world = {
            r: world[r] for r, g in groups.items() if g == my_group
        }
        # coordinator per group = lowest-rank member's addr
        first = min(group_world)
        coord_addr = (
            self._latest_rdzv_nodes[first].addr
            if first in self._latest_rdzv_nodes
            else coord
        )
        return rnd, my_group, group_world, coord_addr

    def _group_nodes(self, rnd: int, ranks: List[int]) -> Dict[int, int]:
        """Pair nodes; odd rounds shift the pairing by one so every node
        gets a different partner (parity: _group_nodes:353)."""
        groups: Dict[int, int] = {}
        n = len(ranks)
        if rnd % 2 == 0:
            for i, r in enumerate(ranks):
                groups[r] = i // self.GROUP_SIZE
        else:
            # rotate by one: [last, 0, 1, ...] then pair adjacent
            rotated = [ranks[-1]] + ranks[:-1]
            for i, r in enumerate(rotated):
                groups[r] = i // self.GROUP_SIZE
        return groups

    def report_network_check_result(
        self, node_rank: int, succeeded: bool, elapsed: float
    ):
        with self._lock:
            rnd = self._rdzv_round - 1 if self._rdzv_round else 0
            self._node_status.setdefault(rnd, {})[node_rank] = succeeded
            self._node_times.setdefault(rnd, {})[node_rank] = elapsed

    def _round_complete(self, rnd: int) -> bool:
        expected = set(self._node_groups_by_round.get(rnd, {}))
        return bool(expected) and expected.issubset(
            set(self._node_status.get(rnd, {}))
        )

    def check_fault_node(self) -> Tuple[List[int], str]:
        """Nodes faulty after the two-round bisect (parity: :451)."""
        with self._lock:
            rnd = self._rdzv_round - 1 if self._rdzv_round else 0
            if not self._round_complete(rnd):
                return [], "not_all_reported"
            status = self._node_status[rnd]
            groups = self._node_groups_by_round.get(rnd, {})
            # a group fails if any member reports failure
            failed_groups = {
                groups[r]
                for r, ok in status.items()
                if not ok and r in groups
            }
            suspect = [
                r for r, g in groups.items() if g in failed_groups
            ]
            if rnd == 0 or (rnd - 1) not in self._node_status:
                # first round: every member of a failed group is suspect
                self._fault_nodes = sorted(suspect)
                return self._fault_nodes, ""
            prev_status = self._node_status[rnd - 1]
            prev_groups = self._node_groups_by_round.get(rnd - 1, {})
            prev_failed_groups = {
                prev_groups[r]
                for r, ok in prev_status.items()
                if not ok and r in prev_groups
            }
            prev_suspect = {
                r for r, g in prev_groups.items() if g in prev_failed_groups
            }
            # faulty = suspect with two different partners
            self._fault_nodes = sorted(set(suspect) & prev_suspect)
            return self._fault_nodes, ""

    def _detect_stragglers(self, rnd: int) -> List[int]:
        """Hosts slower than ratio x median (parity: :494)."""
        times = self._node_times.get(rnd, {})
        if len(times) < 2:
            return []
        med = statistics.median(times.values())
        if med <= 0:
            return []
        ratio = _ctx.straggler_time_ratio
        return sorted(r for r, t in times.items() if t > ratio * med)

    def get_stragglers(self) -> Tuple[List[int], str]:
        with self._lock:
            rnd = self._rdzv_round - 1 if self._rdzv_round else 0
            if not self._round_complete(rnd):
                return [], "not_all_reported"
            cur = set(self._detect_stragglers(rnd))
            if rnd >= 1 and (rnd - 1) in self._node_times:
                prev = set(self._detect_stragglers(rnd - 1))
                cur &= prev
            self._straggler_nodes = sorted(cur)
            return self._straggler_nodes, ""

    def network_check_success(self) -> Tuple[bool, str]:
        """True once every node of the round reported success."""
        with self._lock:
            rnd = self._rdzv_round - 1 if self._rdzv_round else 0
            if not self._round_complete(rnd):
                return False, "not_all_reported"
            ok = all(self._node_status[rnd].values())
            return ok, "" if ok else "node_failure"
