"""Master-side KV store service.

Parity: the kv-store RPCs inside dlrover/python/master/servicer.py (backing
``MasterKVStore`` master_kv_store.py:150) — the rendezvous store the agents
use for barriers and small blobs. On TPU this also carries the JAX
coordinator bootstrap handshake artifacts.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List


class KVStoreService:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def set(self, key: str, value: bytes):
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def add(self, key: str, amount: int) -> int:
        """Atomic counter add; value stored as decimal bytes."""
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += amount
            self._store[key] = str(current).encode()
            self._cond.notify_all()
            return current

    def wait(self, keys: List[str], timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        with self._cond:
            while not all(k in self._store for k in keys):
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def delete(self, key: str):
        with self._lock:
            self._store.pop(key, None)

    # -- failover snapshot (master/state.py) ---------------------------
    def export_store(self) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._store)

    def import_store(self, data: Dict[str, bytes]):
        with self._cond:
            self._store.update(data)
            self._cond.notify_all()

    def clear(self):
        with self._lock:
            self._store.clear()
