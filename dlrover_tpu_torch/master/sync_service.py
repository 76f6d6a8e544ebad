"""Named join-sync / barrier service across workers.

Parity: dlrover/python/master/elastic_training/sync_service.py:119 — used by
elastic PS failover and anywhere workers need a master-arbitrated barrier.
"""

from __future__ import annotations

import threading
from typing import Dict, Set, Tuple


class SyncService:
    def __init__(self, job_manager=None):
        self._job_manager = job_manager
        self._lock = threading.Lock()
        # sync_name -> set of (node_type, node_id) that still must join
        self._syncs: Dict[str, Set[Tuple[str, int]]] = {}
        self._finished_syncs: Set[str] = set()
        self._barriers: Set[str] = set()

    def _expected_members(self) -> Set[Tuple[str, int]]:
        if self._job_manager is None:
            return set()
        return {
            (n.type, n.id)
            for n in self._job_manager.get_running_nodes()
        }

    def join_sync(self, sync_name: str, node_type: str, node_id: int) -> bool:
        with self._lock:
            if sync_name in self._finished_syncs:
                return True
            if sync_name not in self._syncs:
                self._syncs[sync_name] = self._expected_members()
            self._syncs[sync_name].discard((node_type, node_id))
            if not self._syncs[sync_name]:
                self._finished_syncs.add(sync_name)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished_syncs

    def finish_sync(self, sync_name: str):
        """Force-finish a sync regardless of missing members (parity: the
        reference's sync-finish RPC used when a member is known dead)."""
        with self._lock:
            self._syncs.pop(sync_name, None)
            self._finished_syncs.add(sync_name)

    def barrier(self, barrier_name: str) -> bool:
        with self._lock:
            return barrier_name in self._barriers

    def notify_barrier(self, barrier_name: str) -> bool:
        with self._lock:
            self._barriers.add(barrier_name)
            return True
