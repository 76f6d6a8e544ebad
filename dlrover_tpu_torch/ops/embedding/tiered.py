"""Tiered (hybrid) embedding storage: hot rows in memory, cold on disk
(counterpart of ``dlrover_tpu/ops/embedding/tiered.py``).

Parity: TFPlus hybrid embedding storage
(tfplus/kv_variable/kernels/hybrid_embedding/{table_manager.h:547,
storage_table.h:199, embedding_context.h:177}) — recommender vocabularies
outgrow host RAM, but access frequency is zipfian, so rarely-touched
rows live in a disk tier and fault back into the native hash table on
access. The C++ store is the hot tier; the cold tier is a stdlib sqlite
file (:class:`TieredKvEmbedding`) or the native spill logs of
``csrc/kv_store.cc`` (:class:`NativeTieredKvEmbedding`). Policy lives in
Python because eviction runs at checkpoint cadence, not per step.
:func:`three_tier_embedding` puts the device tier
(``device_tier.DeviceSparseEmbedding``, the card) on top.

Semantics:
- ``gather``: keys absent from memory but present on disk are faulted
  in first (values AND optimizer slots travel); untouched keys follow
  the base store's init/zero rules. A row lives in exactly one tier,
  and the move happens atomically under the cold-tier lock.
- ``import_rows`` / ``import_state`` write the hot tier and drop the
  keys' cold copies: a row written hot (a device tier's spill, a
  restore) is newer than its cold record, and the hot row wins. The
  native fault-in keeps the same rule for a key that is already hot.
  (The reference's native fault-in assigns the cold row over a hot
  one, and its imports leave the cold record alive; the port copies
  neither.)
- ``evict_cold(ts_limit)``: rows last touched before ``ts_limit`` move
  to disk and leave memory.
- ``export_state``: merges BOTH tiers — checkpoints must not silently
  drop evicted rows. Delta exports include cold rows evicted since the
  last PUBLISHED delta: the cursor moves when the checkpoint manager
  publishes the delta that carried them (``publish_delta_export``), so
  an aborted or failed save leaves it where it was. (The reference
  moves it at the export, and a delta saved after an aborted one then
  misses the rows evicted in between.)
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ops.embedding.store import (
    KvEmbeddingStore,
    ShardedKvEmbedding,
    _load_library,
)

_IN_CHUNK = 500  # sqlite host-parameter limit safety (999 on old builds)


class _RWLock:
    """Readers-writer lock: gathers run concurrently (the hot path, the
    C++ store handles its own per-shard locking); a tier move (eviction)
    excludes them so no gather can probe the hot tier before a row is
    evicted and re-insert it after (a TOCTOU that would shadow the cold
    copy with a freshly initialized row, losing trained values).

    Writer-preferring: new readers also wait while a writer is *queued*,
    otherwise continuously-overlapping gather traffic would starve
    eviction forever (and unbounded hot-tier growth is the exact failure
    the tier exists to prevent).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class _TierBase:
    """What both tier managers share: the hot-store passthrough, the
    imports that drop stale cold copies, the delta cursor and the
    merged export. Subclasses supply ``_fault_in``, ``_drop_cold``,
    ``_cold_export`` (a list of ``(keys, rows, freq, ts)`` arrays) and
    ``cold_rows``."""

    def _init_tier(self, hot: ShardedKvEmbedding):
        self.hot = hot
        self._tier_lock = _RWLock()  # gathers read / eviction writes
        self.dim = hot.dim
        self.row_floats = hot.dim * (1 + hot.num_slots)
        # cold rows with a seq above the published cursor are new to a
        # delta; the staged value becomes the cursor when the delta that
        # carried them is published
        self._exported_seq = 0
        self._staged_seq: Optional[int] = None
        # rows moved disk -> memory by gathers (the tier's own count)
        self.faulted_rows = 0

    # -- introspection --------------------------------------------------
    def hot_rows(self) -> int:
        return len(self.hot)

    def __len__(self) -> int:
        # a row lives in exactly one tier, so the total is the sum
        # (dunders bypass __getattr__, so the passthrough can't serve
        # len())
        return self.hot_rows() + self.cold_rows()

    # -- public surface (hot-store API + fault-in) ---------------------
    def gather(self, keys, insert_missing: bool = True) -> np.ndarray:
        k = KvEmbeddingStore._keys(keys)
        # read-side of the tier lock: without it a gather could probe the
        # hot tier just before eviction moves a row out and then
        # re-initialize it (insert_missing) just after — shadowing the
        # cold copy with a fresh row and losing the trained values
        self._tier_lock.acquire_read()
        try:
            self._fault_in(k)
            return self.hot.gather(k, insert_missing)
        finally:
            self._tier_lock.release_read()

    def import_rows(self, keys, rows, freq=None, ts=None):
        """Write full rows hot (a device tier's spill or flush) and drop
        the keys' cold copies: the written row is the newer one. Under
        the tier read lock, so no eviction runs between the two legs."""
        k = KvEmbeddingStore._keys(keys)
        self._tier_lock.acquire_read()
        try:
            self.hot.import_rows(k, rows, freq, ts)
            self._drop_cold(k)
        finally:
            self._tier_lock.release_read()

    def import_state(self, state: Dict[str, np.ndarray]) -> None:
        """Restore rows hot (a checkpoint chain's file) and drop their
        cold copies, as :meth:`import_rows` does."""
        self._tier_lock.acquire_read()
        try:
            self.hot.import_state(state)
            self._drop_cold(KvEmbeddingStore._keys(state["keys"]))
        finally:
            self._tier_lock.release_read()

    def __getattr__(self, name):
        # sparse_* updates / scatter pass through to the hot tier —
        # callers gather() first (which faults in), the same contract
        # the training loop already follows
        return getattr(self.hot, name)

    # -- checkpoint (both tiers!) ---------------------------------------
    def export_state(
        self, since_versions: Optional[List[int]] = None
    ) -> Dict[str, np.ndarray]:
        """Hot export (full or delta) merged with the cold tier: full
        export carries every cold row; delta export carries cold rows
        evicted since the last published delta — a checkpoint of a
        tiered store must never silently drop evicted rows.

        Full exports never move the cursor, so unrelated full exports
        (e.g. SparseTrainer's own save over the same store) cannot
        consume rows out of a checkpoint manager's delta stream. One
        delta consumer per store is the supported shape. Cold rows come
        FIRST so that when a key transiently has copies in both tiers
        the fresher hot row wins the last-wins import.

        The tier read lock is held across the cold+hot pair: it
        excludes eviction (hot→cold) mid-export, which with any
        ordering could move a row between the two snapshots so it lands
        in neither. Fault-in (cold→hot) runs under the same read side
        and stays legal because cold is exported BEFORE hot — a row
        that moves mid-export was already captured cold (and the hot
        copy, if also captured, wins the merge).
        """
        self._tier_lock.acquire_read()
        try:
            if since_versions:
                cold = self._cold_export(self._exported_seq)
                self._staged_seq = self._evict_seq
            else:
                cold = self._cold_export(0)
            state = self.hot.export_state(since_versions)
        finally:
            self._tier_lock.release_read()
        if cold:
            state = {
                "keys": np.concatenate(
                    [c[0] for c in cold] + [state["keys"]]
                ).astype(np.int64),
                "rows": np.concatenate(
                    [c[1] for c in cold]
                    + [state["rows"].reshape(-1, self.row_floats)]
                ),
                "freq": np.concatenate(
                    [c[2] for c in cold] + [state["freq"]]
                ).astype(np.int64),
                "ts": np.concatenate(
                    [c[3] for c in cold] + [state["ts"]]
                ).astype(np.int64),
            }
        return state

    def publish_delta_export(self):
        """The delta exported last was published: the cold rows it
        carried leave the next delta. Called by the checkpoint manager
        at publish, never at export, so an aborted save keeps them."""
        if self._staged_seq is not None:
            self._exported_seq = self._staged_seq
            self._staged_seq = None


class TieredKvEmbedding(_TierBase):
    """The hot C++ store over a sqlite cold tier (one table keyed by
    row key, so cold rows survive any hot shard-count change)."""

    def __init__(self, hot: ShardedKvEmbedding, cold_path: str):
        self._init_tier(hot)
        self._conn = sqlite3.connect(cold_path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS rows ("
            "key INTEGER PRIMARY KEY, row BLOB, freq INTEGER, "
            "ts INTEGER, evict_seq INTEGER)"
        )
        self._lock = threading.Lock()
        with self._lock:
            (mx,) = self._conn.execute(
                "SELECT COALESCE(MAX(evict_seq), 0) FROM rows"
            ).fetchone()
            (cnt,) = self._conn.execute(
                "SELECT COUNT(*) FROM rows"
            ).fetchone()
        self._evict_seq = mx
        # maintained counter: gather's fault-in probe short-circuits
        # while the cold tier is empty (the common pre-eviction state)
        self._cold_count = cnt

    def cold_rows(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM rows"
            ).fetchone()
        return n

    # -- fault-in -------------------------------------------------------
    def _fault_in(self, keys: np.ndarray) -> int:
        """Move any cold ``keys`` into the hot tier. Import-then-delete
        under the lock: a concurrent gather of the same key either waits
        here or finds the row already hot — never in neither tier."""
        if self._cold_count == 0:
            return 0  # nothing evicted: skip the extra meta probe
        f, _ = self.hot.meta(keys)  # reads only, no freq/ts bump
        missing = np.unique(keys[f < 0])
        if len(missing) == 0:
            return 0
        moved = 0
        with self._lock:
            for start in range(0, len(missing), _IN_CHUNK):
                chunk = [
                    int(k) for k in missing[start : start + _IN_CHUNK]
                ]
                qmarks = ",".join("?" * len(chunk))
                rows = self._conn.execute(
                    f"SELECT key, row, freq, ts FROM rows "
                    f"WHERE key IN ({qmarks})",
                    chunk,
                ).fetchall()
                if not rows:
                    continue
                k = np.array([r[0] for r in rows], np.int64)
                data = np.stack(
                    [np.frombuffer(r[1], np.float32) for r in rows]
                ).reshape(len(rows), self.row_floats)
                self.hot.import_state(
                    {
                        "keys": k,
                        "rows": data,
                        "freq": np.array([r[2] for r in rows], np.int64),
                        "ts": np.array([r[3] for r in rows], np.int64),
                    }
                )
                self._conn.execute(
                    f"DELETE FROM rows WHERE key IN "
                    f"({','.join('?' * len(rows))})",
                    [r[0] for r in rows],
                )
                moved += len(rows)
            self._conn.commit()
            self._cold_count -= moved
            self.faulted_rows += moved
        return moved

    def _delete_cold(self, keys) -> int:
        """Delete ``keys``' cold records; the count deleted. Caller
        holds ``self._lock``."""
        deleted = 0
        for start in range(0, len(keys), _IN_CHUNK):
            chunk = [int(k) for k in keys[start : start + _IN_CHUNK]]
            cur = self._conn.execute(
                f"DELETE FROM rows WHERE key IN "
                f"({','.join('?' * len(chunk))})",
                chunk,
            )
            deleted += cur.rowcount
        self._conn.commit()
        return deleted

    def _drop_cold(self, keys: np.ndarray):
        if self._cold_count == 0 or len(keys) == 0:
            return
        with self._lock:
            self._cold_count -= self._delete_cold(np.unique(keys))

    # -- checkpoint (both tiers!) ---------------------------------------
    def _cold_export(self, min_seq: int = 0):
        with self._lock:
            cold = self._conn.execute(
                "SELECT key, row, freq, ts FROM rows WHERE evict_seq > ?",
                (min_seq,),
            ).fetchall()
        if not cold:
            return []
        return [(
            np.array([r[0] for r in cold], np.int64),
            np.stack([np.frombuffer(r[1], np.float32) for r in cold]),
            np.array([r[2] for r in cold], np.int64),
            np.array([r[3] for r in cold], np.int64),
        )]

    def warm_reshard(self, new_num_shards: int):
        """Move-only reshard of the hot store under the tier write
        lock. The sqlite cold tier is keyed by row key (not by shard),
        so cold rows stay valid across any hot shard-count change."""
        self._tier_lock.acquire_write()
        try:
            return self.hot.warm_reshard(new_num_shards)
        finally:
            self._tier_lock.release_write()

    # -- eviction -------------------------------------------------------
    def evict_cold(self, ts_limit: int) -> int:
        """Move rows last touched before ``ts_limit`` to disk.

        Processed one hot shard at a time (peak host memory = largest
        shard, not the whole table — the tier exists because RAM is
        short). A row touched between the snapshot and the in-memory
        eviction survives hot; its just-written stale disk copy is
        removed afterwards so no key ever has copies in both tiers.
        """
        total = 0
        self._evict_seq += 1
        for shard in self.hot.shards:
            # writer side of the tier lock, per shard (gathers of other
            # shards' keys proceed between shards): the snapshot →
            # insert → evict → stale-delete sequence must not interleave
            # with a gather's probe-then-insert of the same keys
            self._tier_lock.acquire_write()
            try:
                total += self._evict_shard(shard, ts_limit)
            finally:
                self._tier_lock.release_write()
        # settle the maintained counter to the exact value (it may have
        # overshot when INSERT OR REPLACE overwrote existing rows)
        with self._lock:
            (self._cold_count,) = self._conn.execute(
                "SELECT COUNT(*) FROM rows"
            ).fetchone()
        if total:
            logger.info(f"evicted {total} cold embedding rows to disk")
        return total

    def _evict_shard(self, shard, ts_limit: int) -> int:
        keys, rows, freq, ts = shard.export()
        cold = ts < ts_limit
        n = int(cold.sum())
        if n:
            idx = np.nonzero(cold)[0]
            with self._lock:
                self._conn.executemany(
                    "INSERT OR REPLACE INTO rows VALUES (?,?,?,?,?)",
                    [
                        (
                            int(keys[i]),
                            rows[i].tobytes(),
                            int(freq[i]),
                            int(ts[i]),
                            self._evict_seq,
                        )
                        for i in idx
                    ],
                )
                self._conn.commit()
                # keep the maintained counter >= the true cold count at
                # every point a gather can run (between per-shard write
                # sections): a false zero would short-circuit fault-in
                # for rows this shard just evicted. Transient overshoot
                # is safe; evict_cold settles the exact value at the end
                self._cold_count += n
            shard.evict_older_than(ts_limit)
            # rows touched in the snapshot→evict window stayed hot: drop
            # their (stale) disk copies before anything can re-export them
            survivors_f, _ = shard.meta(keys[idx])
            still_hot = keys[idx][survivors_f >= 0]
            if len(still_hot):
                with self._lock:
                    self._cold_count -= self._delete_cold(still_hot)
                n -= len(still_hot)
        return n

    def close(self):
        with self._lock:
            self._conn.close()


class NativeTieredKvEmbedding(_TierBase):
    """Hybrid embedding storage with the tier manager NATIVE (parity:
    tfplus hybrid_embedding table_manager.h:547, storage_table.h:199):
    hot→cold eviction and cold→hot fault-in move rows entirely inside
    the C++ layer (one pass over the hash buckets into an append-only
    spill log per shard), so recommender-scale gathers with faulting
    never marshal rows through Python/sqlite.

    Same public surface and semantics as :class:`TieredKvEmbedding`
    (a row lives in exactly one tier; gathers fault in; ``export_state``
    merges both tiers, cold rows first so hot wins last-wins imports;
    delta exports carry cold rows evicted since the last published
    delta). The spill logs keep the reference's format and survive
    restarts — reopen with the same ``cold_path`` and the per-shard
    indices rebuild by one scan. An IO error of the logs raises
    ``OSError``.
    """

    def __init__(self, hot: ShardedKvEmbedding, cold_path: str):
        self._init_tier(hot)
        self._lib = _load_library()
        self._cold_path = cold_path
        self._count_lock = threading.Lock()  # faulted_rows across gathers
        self._cold = []
        self._open_cold_logs()
        # spill logs are keyed BY SHARD (fault-in routes by shard): a
        # reopen with fewer shards would silently strand the extra
        # logs' rows — refuse instead
        i = hot.num_shards
        while os.path.exists(f"{cold_path}.shard{i}"):
            extra = self._lib.cold_open(
                f"{cold_path}.shard{i}".encode(), self.row_floats
            )
            live = self._lib.cold_count(extra) if extra else 0
            if extra:
                self._lib.cold_close(extra)
            if live:
                self.close()
                raise ValueError(
                    f"spill log {cold_path}.shard{i} holds {live} live "
                    f"rows but the store has only {hot.num_shards} "
                    f"shards — reopen with the original shard count "
                    f"(or reshard() through a live store)"
                )
            i += 1
        self._evict_seq = max(
            (self._lib.cold_max_seq(h) for h in self._cold), default=0
        )

    def _open_cold_logs(self):
        for i in range(self.hot.num_shards):
            h = self._lib.cold_open(
                f"{self._cold_path}.shard{i}".encode(), self.row_floats
            )
            if not h:
                raise OSError(
                    f"cannot open cold spill log "
                    f"{self._cold_path}.shard{i}"
                )
            self._cold.append(h)

    def _drain_cold_to_hot(self):
        """Fault every cold row back hot and retire the spill logs —
        the shared prelude of both reshard flavors (per-shard logs
        cannot survive a shard-count change). A key that is hot keeps
        its hot row. Caller holds the tier write lock."""
        for shard, cold in zip(self.hot.shards, self._cold):
            n = self._lib.cold_count(cold)
            if n:
                keys = np.empty(n, np.int64)
                rows = np.empty((n, self.row_floats), np.float32)
                freq = np.empty(n, np.int64)
                ts = np.empty(n, np.int64)
                got = self._lib.cold_export(
                    cold, 0, keys, rows, freq, ts, n
                )
                if got < 0:
                    raise OSError("cold-tier read failed in reshard")
                moved = self._lib.kv_fault_from_cold(
                    shard._h, cold, keys[:got], got
                )
                if moved < 0:
                    raise OSError(
                        "cold-tier fault-in failed in reshard"
                    )
        old_n = len(self._cold)
        for h in self._cold:
            self._lib.cold_close(h)
        self._cold = []
        for i in range(old_n):
            os.unlink(f"{self._cold_path}.shard{i}")

    def reshard(self, new_num_shards: int):
        """Elastic reshard of a tiered store: every cold row faults back
        hot first (key→shard routing changes with the shard count, so
        per-shard spill logs cannot survive a reshard), the hot store
        reshards, and fresh empty logs are opened for the new layout."""
        self._tier_lock.acquire_write()
        try:
            self._drain_cold_to_hot()
            self.hot.reshard(new_num_shards)
            self._open_cold_logs()
        finally:
            self._tier_lock.release_write()

    def warm_reshard(self, new_num_shards: int):
        """Move-only reshard. Spill logs are keyed BY SHARD here, so
        cold rows fault back hot first (same rule as :meth:`reshard`),
        then the hot store moves only re-routed rows and fresh logs
        open for the new layout."""
        self._tier_lock.acquire_write()
        try:
            self._drain_cold_to_hot()
            report = self.hot.warm_reshard(new_num_shards)
            self._open_cold_logs()
            return report
        finally:
            self._tier_lock.release_write()

    # -- introspection --------------------------------------------------
    def cold_rows(self) -> int:
        return sum(self._lib.cold_count(h) for h in self._cold)

    # -- fault-in -------------------------------------------------------
    def _fault_from_cold(self, keys: np.ndarray) -> int:
        """``kv_fault_from_cold`` for ``keys``, shard by shard: cold
        rows of absent keys move hot, cold records of hot keys are
        tombstoned. Returns the rows moved."""
        moved = 0
        route = self.hot._route(keys)
        for i, (shard, cold) in enumerate(zip(self.hot.shards, self._cold)):
            if not self._lib.cold_count(cold):
                continue
            sk = np.ascontiguousarray(keys[route == i])
            if not len(sk):
                continue
            n = self._lib.kv_fault_from_cold(shard._h, cold, sk, len(sk))
            if n < 0:
                raise OSError("cold-tier fault-in failed (IO error)")
            moved += n
        return moved

    def _fault_in(self, keys: np.ndarray) -> int:
        moved = self._fault_from_cold(keys)
        if moved:
            with self._count_lock:
                self.faulted_rows += moved
        return moved

    def _drop_cold(self, keys: np.ndarray):
        # every key is hot here, so the native fault-in only tombstones
        self._fault_from_cold(keys)

    # -- eviction -------------------------------------------------------
    def evict_cold(self, ts_limit: int) -> int:
        """Move rows last touched before ``ts_limit`` to the spill logs.
        The move is atomic per shard inside the native layer (bucket
        mutexes held across copy+erase), so no key ever has live copies
        in both tiers and no stale-copy cleanup pass is needed."""
        total = 0
        self._evict_seq += 1
        for shard, cold in zip(self.hot.shards, self._cold):
            self._tier_lock.acquire_write()
            try:
                n = self._lib.kv_evict_to_cold(
                    shard._h, cold, ts_limit, self._evict_seq
                )
                if n < 0:
                    raise OSError("cold-tier eviction failed (IO error)")
                total += n
            finally:
                self._tier_lock.release_write()
        if total:
            logger.info(
                f"evicted {total} cold embedding rows to spill logs"
            )
        return total

    # -- checkpoint (both tiers!) ---------------------------------------
    def _cold_export(self, since_seq: int):
        out = []
        for cold in self._cold:
            # buffers sized to the DELTA, not the whole tier (a 50M-row
            # cold tier must not allocate gigabytes for a 1k-row delta)
            while True:
                cap = self._lib.cold_export_count(cold, since_seq)
                if not cap:
                    break
                keys = np.empty(cap, np.int64)
                rows = np.empty((cap, self.row_floats), np.float32)
                freq = np.empty(cap, np.int64)
                ts = np.empty(cap, np.int64)
                n = self._lib.cold_export(
                    cold, since_seq, keys, rows, freq, ts, cap
                )
                if n == -1:
                    continue  # an eviction raced the count: retry
                if n < 0:
                    raise OSError("cold-tier export failed (IO error)")
                if n:
                    out.append((keys[:n], rows[:n], freq[:n], ts[:n]))
                break
        return out

    def close(self):
        for h in self._cold:
            self._lib.cold_close(h)
        self._cold = []


def three_tier_embedding(
    num_shards: int,
    dim: int,
    cold_path: str,
    num_slots: int = 1,
    seed: int = 0,
    init_scale: float = 0.05,
    hbm_budget_bytes: Optional[int] = None,
    native_cold: bool = True,
    version_service=None,
    devices=None,
    **device_kwargs,
):
    """The full hierarchy in one call: the device tier (rows on the card,
    the ``emb_gather`` / ``emb_scatter`` kernels, bounded by
    ``hbm_budget_bytes``) over a host C++ store over a disk cold tier.
    The card→host boundary mirrors the host→disk one: bounded by a byte
    budget, spilled at checkpoint cadence
    (``DeviceSparseEmbedding.evict_to_host`` ≙ ``evict_cold``), rows
    fault back in on access with optimizer slots travelling. The device
    tier is on the card unless ``devices="cpu"``. Returns a
    :class:`~dlrover_tpu_torch.ops.embedding.device_tier.
    DeviceSparseEmbedding` whose ``host`` is the two-host-tier store.
    """
    from dlrover_tpu_torch.ops.embedding.device_tier import (
        _DEF_HBM_BUDGET,
        DeviceSparseEmbedding,
    )

    hot = ShardedKvEmbedding(
        num_shards, dim, num_slots=num_slots, seed=seed,
        init_scale=init_scale, version_service=version_service,
    )
    tier_cls = (
        NativeTieredKvEmbedding if native_cold else TieredKvEmbedding
    )
    host = tier_cls(hot, cold_path)
    return DeviceSparseEmbedding(
        host,
        hbm_budget_bytes=(
            hbm_budget_bytes
            if hbm_budget_bytes is not None
            else _DEF_HBM_BUDGET
        ),
        devices=devices,
        **device_kwargs,
    )
