"""Elastic PS cluster-version service (TF-PS parity layer).

Parity: dlrover/python/master/elastic_training/elastic_ps.py — tracks
global/local/restored cluster versions so PS-style sparse jobs (our
KvStore embedding service) can detect resharding events.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class ElasticPsService:
    def __init__(self):
        self._lock = threading.Lock()
        self._global_version = 0
        self._node_versions: Dict[Tuple[str, int, str], int] = {}

    def get_version(
        self, version_type: str, node_type: str, node_id: int
    ) -> int:
        with self._lock:
            if version_type == "global":
                return self._global_version
            return self._node_versions.get(
                (node_type, node_id, version_type), 0
            )

    def update_version(
        self, version_type: str, node_type: str, node_id: int, version: int
    ):
        with self._lock:
            if version_type == "global":
                self._global_version = version
            else:
                self._node_versions[(node_type, node_id, version_type)] = (
                    version
                )

    def inc_global_version(self) -> int:
        with self._lock:
            self._global_version += 1
            return self._global_version

    # -- failover snapshot (master/state.py) ---------------------------
    def export_state(self) -> dict:
        with self._lock:
            return {
                "global": self._global_version,
                "nodes": [
                    [t, i, vt, v]
                    for (t, i, vt), v in self._node_versions.items()
                ],
            }

    def import_state(self, state: dict):
        if not state:
            return
        with self._lock:
            self._global_version = int(state.get("global", 0))
            for t, i, vt, v in state.get("nodes", []):
                self._node_versions[(t, int(i), vt)] = int(v)
