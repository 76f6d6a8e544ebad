"""ctypes binding + sharded wrapper for the native KvEmbeddingStore
(counterpart of ``dlrover_tpu/ops/embedding/store.py``).

The python face of a TFPlus KvVariable: gather/insert, scatter math
ops, fused sparse optimizers, frequency/timestamp metadata, full/delta
export-import, plus elastic resharding. The port keeps its own copy of
the C++ source (``csrc/kv_store.cc``, byte for byte the JAX package's
up to the cold tier, so both stores give the same rows from the same
seed; the cold tier's spill log keeps the reference's format, with the
port's repairs of failed writes and of a fault-in over a hot row) and
compiles it with g++ at first use; there is no pybind11. The cold
tier's entries are bound here and driven by ``tiered.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "kv_store.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _build_library() -> str:
    """The shared library of ``csrc/kv_store.cc``, compiled with g++ at
    first use into ``_build/`` and named by the source's hash, so an
    unchanged source is built once per checkout. Concurrent builders
    (test workers) each compile into a private file and rename it into
    place; a failing compile raises with g++'s output."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f"libdlrover_kv_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, _SRC,
    ]
    logger.info(f"building kv embedding library: {' '.join(cmd)}")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on kv_store.cc:\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load_library() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build_library())
        i64, u64, f32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_float
        p = ctypes.c_void_p
        I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.kv_create.restype = p
        lib.kv_create.argtypes = [i64, ctypes.c_int, u64, f32]
        lib.kv_free.argtypes = [p]
        lib.kv_size.restype = i64
        lib.kv_size.argtypes = [p]
        lib.kv_version.restype = u64
        lib.kv_version.argtypes = [p]
        lib.kv_gather.argtypes = [p, I64P, i64, F32P, ctypes.c_int, i64]
        lib.kv_scatter.argtypes = [p, I64P, i64, F32P, ctypes.c_int, i64]
        lib.kv_sparse_adagrad.argtypes = [p, I64P, i64, F32P, f32, f32, i64]
        lib.kv_sparse_momentum.argtypes = [p, I64P, i64, F32P, f32, f32, i64]
        lib.kv_sparse_adam.argtypes = [
            p, I64P, i64, F32P, f32, f32, f32, f32, i64, i64,
        ]
        lib.kv_sparse_group_ftrl.argtypes = [
            p, I64P, i64, F32P, f32, f32, f32, f32, i64,
        ]
        lib.kv_sparse_group_adam.argtypes = [
            p, I64P, i64, F32P, f32, f32, f32, f32, f32, f32, f32,
            i64, i64,
        ]
        lib.kv_sparse_lamb.argtypes = [
            p, I64P, i64, F32P, f32, f32, f32, f32, f32, i64, i64,
        ]
        lib.kv_sparse_adabelief.argtypes = [
            p, I64P, i64, F32P, f32, f32, f32, f32, i64, i64,
        ]
        lib.kv_sparse_amsgrad.argtypes = [
            p, I64P, i64, F32P, f32, f32, f32, f32, i64, i64,
        ]
        lib.kv_export_count.restype = i64
        lib.kv_export_count.argtypes = [p, u64]
        lib.kv_export.restype = i64
        lib.kv_export.argtypes = [p, u64, I64P, F32P, I64P, I64P, i64]
        lib.kv_import.argtypes = [p, I64P, i64, F32P, I64P, I64P]
        lib.kv_delete_before_timestamp.restype = i64
        lib.kv_delete_before_timestamp.argtypes = [p, i64]
        # warm-reshard / device-tier primitives
        lib.kv_export_keys.restype = i64
        lib.kv_export_keys.argtypes = [p, I64P, i64]
        lib.kv_export_rows.restype = i64
        lib.kv_export_rows.argtypes = [p, I64P, i64, F32P, I64P, I64P]
        lib.kv_delete_keys.restype = i64
        lib.kv_delete_keys.argtypes = [p, I64P, i64]
        lib.kv_meta.argtypes = [p, I64P, i64, I64P, I64P]
        # the native cold tier (tiered.NativeTieredKvEmbedding)
        lib.cold_open.restype = p
        lib.cold_open.argtypes = [ctypes.c_char_p, i64]
        lib.cold_close.argtypes = [p]
        lib.cold_count.restype = i64
        lib.cold_count.argtypes = [p]
        lib.cold_max_seq.restype = i64
        lib.cold_max_seq.argtypes = [p]
        lib.cold_export.restype = i64
        lib.cold_export.argtypes = [p, i64, I64P, F32P, I64P, I64P, i64]
        lib.cold_export_count.restype = i64
        lib.cold_export_count.argtypes = [p, i64]
        lib.kv_evict_to_cold.restype = i64
        lib.kv_evict_to_cold.argtypes = [p, p, i64, i64]
        lib.kv_fault_from_cold.restype = i64
        lib.kv_fault_from_cold.argtypes = [p, p, I64P, i64]
        _LIB = lib
        return lib


_SCATTER_OPS = {
    "update": 0, "add": 1, "sub": 2, "mul": 3, "div": 4,
    "min": 5, "max": 6,
}


@dataclass
class WarmReshardReport:
    """What a warm reshard moved (mirrors ckpt.reshard.ReshardReport:
    the per-axis story for embedding shards is old→new shard count and
    the mover fraction)."""

    old_shards: int
    new_shards: int
    total_rows: int
    moved_rows: int
    bytes_moved: int
    elapsed_s: float

    @property
    def moved_fraction(self) -> float:
        return self.moved_rows / self.total_rows if self.total_rows else 0.0

    def describe(self) -> str:
        return (
            f"shards {self.old_shards}->{self.new_shards}: "
            f"{self.moved_rows}/{self.total_rows} rows moved "
            f"({100.0 * self.moved_fraction:.1f}%, "
            f"{self.bytes_moved / 1e6:.2f} MB) in "
            f"{self.elapsed_s * 1e3:.1f} ms"
        )


def _now() -> int:
    return int(time.time())


class KvEmbeddingStore:
    """One native hash-table shard: key (int64) → row
    [value(dim) | slots(num_slots × dim)]."""

    def __init__(
        self,
        dim: int,
        num_slots: int = 1,
        seed: int = 0,
        init_scale: float = 0.05,
    ):
        self.dim = dim
        self.num_slots = num_slots
        self.seed = seed
        self.init_scale = init_scale
        self._lib = _load_library()
        self._h = self._lib.kv_create(dim, num_slots, seed, init_scale)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.kv_free(h)

    # -- core ----------------------------------------------------------
    def __len__(self) -> int:
        return self._lib.kv_size(self._h)

    @property
    def version(self) -> int:
        return self._lib.kv_version(self._h)

    @property
    def row_floats(self) -> int:
        return self.dim * (1 + self.num_slots)

    @staticmethod
    def _keys(keys) -> np.ndarray:
        return np.ascontiguousarray(keys, dtype=np.int64).ravel()

    def gather(self, keys, insert_missing: bool = True) -> np.ndarray:
        """Lookup rows' values [n, dim]; missing keys are initialized
        (GatherOrInsert) or read as zeros. Bumps freq/timestamp."""
        k = self._keys(keys)
        out = np.empty((len(k), self.dim), np.float32)
        self._lib.kv_gather(
            self._h, k, len(k), out, int(insert_missing), _now()
        )
        return out

    def scatter(self, keys, values, op: str = "update"):
        k = self._keys(keys)
        self._lib.kv_scatter(
            self._h, k, len(k), self._grads(k, values),
            _SCATTER_OPS[op], _now(),
        )

    def sparse_adagrad(self, keys, grads, lr: float, eps: float = 1e-8):
        k = self._keys(keys)
        self._lib.kv_sparse_adagrad(
            self._h, k, len(k), self._grads(k, grads), lr, eps, _now()
        )

    def sparse_momentum(self, keys, grads, lr: float, momentum: float = 0.9):
        k = self._keys(keys)
        self._lib.kv_sparse_momentum(
            self._h, k, len(k), self._grads(k, grads), lr, momentum, _now()
        )

    def sparse_adam(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
    ):
        """Fused sparse Adam (slots: m, v; needs num_slots >= 2).
        ``step`` is the 1-based update count for bias correction."""
        if self.num_slots < 2:
            raise ValueError("sparse_adam needs num_slots >= 2 (m, v)")
        self._check_step(step)
        k = self._keys(keys)
        self._lib.kv_sparse_adam(
            self._h, k, len(k), self._grads(k, grads), lr, beta1,
            beta2, eps, step, _now(),
        )

    def sparse_group_ftrl(
        self,
        keys,
        grads,
        alpha: float = 0.05,
        beta: float = 1.0,
        l1: float = 0.0,
        l21: float = 0.0,
    ):
        """Fused group-lasso FTRL (slots: n, z; needs num_slots >= 2).
        ``l21`` zeroes whole rows whose thresholded signal is weak —
        the group sparsity of the reference's recommender optimizers."""
        if self.num_slots < 2:
            raise ValueError("sparse_group_ftrl needs num_slots >= 2")
        k = self._keys(keys)
        self._lib.kv_sparse_group_ftrl(
            self._h, k, len(k), self._grads(k, grads), alpha, beta,
            l1, l21, _now(),
        )

    def _grads(self, k, grads) -> np.ndarray:
        return np.ascontiguousarray(grads, dtype=np.float32).reshape(
            len(k), self.dim
        )

    @staticmethod
    def _check_step(step: int):
        if step < 1:
            raise ValueError(f"step must be >= 1 (got {step})")

    def sparse_group_adam(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
        l1: float = 0.0,
        l2: float = 0.0,
        l21: float = 0.0,
    ):
        """Fused Group Adam (slots: linear, m, v; needs num_slots >= 3)
        — Adam moments feeding an FTRL-style linear accumulator with a
        closed-form L1/L2/L2,1 proximal solve; ``l21 > 0`` zeroes whole
        rows (parity: training_ops.cc GroupSparseApplyAdamNewV2,
        group_adam.py:272)."""
        if self.num_slots < 3:
            raise ValueError(
                "sparse_group_adam needs num_slots >= 3 (linear, m, v)"
            )
        self._check_step(step)
        k = self._keys(keys)
        self._lib.kv_sparse_group_adam(
            self._h, k, len(k), self._grads(k, grads), lr, beta1,
            beta2, eps, l1, l2, l21, step, _now(),
        )

    def sparse_lamb(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.0,
    ):
        """Fused sparse LAMB (slots: m, v; needs num_slots >= 2): Adam
        direction + decoupled decay, rescaled per embedding row by the
        trust ratio ||w||/||update||."""
        if self.num_slots < 2:
            raise ValueError("sparse_lamb needs num_slots >= 2 (m, v)")
        self._check_step(step)
        k = self._keys(keys)
        self._lib.kv_sparse_lamb(
            self._h, k, len(k), self._grads(k, grads), lr, beta1,
            beta2, eps, weight_decay, step, _now(),
        )

    def sparse_adabelief(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-12,
    ):
        """Fused sparse AdaBelief (slots: m, s; needs num_slots >= 2):
        the second moment tracks (g - m)^2 — gradient variance around
        its EMA — instead of g^2."""
        if self.num_slots < 2:
            raise ValueError("sparse_adabelief needs num_slots >= 2")
        self._check_step(step)
        k = self._keys(keys)
        self._lib.kv_sparse_adabelief(
            self._h, k, len(k), self._grads(k, grads), lr, beta1,
            beta2, eps, step, _now(),
        )

    def sparse_amsgrad(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
    ):
        """Fused sparse AMSGrad (slots: m, v, vmax; needs
        num_slots >= 3): Adam with a monotone max on the second moment."""
        if self.num_slots < 3:
            raise ValueError(
                "sparse_amsgrad needs num_slots >= 3 (m, v, vmax)"
            )
        self._check_step(step)
        k = self._keys(keys)
        self._lib.kv_sparse_amsgrad(
            self._h, k, len(k), self._grads(k, grads), lr, beta1,
            beta2, eps, step, _now(),
        )

    def meta(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """(frequency, last_access_ts) per key; -1 for absent keys."""
        k = self._keys(keys)
        freq = np.empty(len(k), np.int64)
        ts = np.empty(len(k), np.int64)
        self._lib.kv_meta(self._h, k, len(k), freq, ts)
        return freq, ts

    def export_keys(self) -> np.ndarray:
        """Every live key — 8 bytes per row, no values, no freq/ts
        bump: the cheap ownership pass of a warm reshard."""
        while True:
            cap = len(self) + 64  # headroom vs concurrent inserts
            keys = np.empty(cap, np.int64)
            n = self._lib.kv_export_keys(self._h, keys, cap)
            if n >= 0:  # -1 = an insert raced the sizing; retry
                return keys[:n]

    def export_rows(
        self, keys
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Full rows (values + slots), freq, ts and a presence mask for
        exactly ``keys``. Unlike gather this is a STATE read: absent
        keys are NOT created, freq/ts are NOT bumped, and optimizer
        slots travel — the move leg of a warm reshard and the device
        hot tier's fault-in."""
        k = self._keys(keys)
        rows = np.empty((len(k), self.row_floats), np.float32)
        freq = np.empty(len(k), np.int64)
        ts = np.empty(len(k), np.int64)
        self._lib.kv_export_rows(self._h, k, len(k), rows, freq, ts)
        return rows, freq, ts, freq >= 0

    def delete_keys(self, keys) -> int:
        """Remove exactly ``keys``; returns the number removed."""
        k = self._keys(keys)
        return self._lib.kv_delete_keys(self._h, k, len(k))

    def evict_older_than(self, ts_limit: int) -> int:
        return self._lib.kv_delete_before_timestamp(self._h, ts_limit)

    # -- export / import (elastic resharding + incremental ckpt) -------
    def export(self, since_version: int = 0):
        """(keys, rows[n, row_floats], freq, ts) for rows modified after
        ``since_version`` (0 = everything)."""
        while True:
            cap = self._lib.kv_export_count(self._h, since_version)
            keys = np.empty(cap, np.int64)
            rows = np.empty((cap, self.row_floats), np.float32)
            freq = np.empty(cap, np.int64)
            ts = np.empty(cap, np.int64)
            n = self._lib.kv_export(
                self._h, since_version, keys, rows, freq, ts, cap
            )
            if n >= 0:  # -1 = writer raced the count; retry
                return keys[:n], rows[:n], freq[:n], ts[:n]

    def import_rows(self, keys, rows, freq=None, ts=None):
        k = self._keys(keys)
        r = np.ascontiguousarray(rows, dtype=np.float32).reshape(
            len(k), self.row_floats
        )
        f = (
            np.ascontiguousarray(freq, dtype=np.int64)
            if freq is not None
            else np.zeros(len(k), np.int64)
        )
        t = (
            np.ascontiguousarray(ts, dtype=np.int64)
            if ts is not None
            else np.zeros(len(k), np.int64)
        )
        self._lib.kv_import(self._h, k, len(k), r, f, t)


class ShardedKvEmbedding:
    """Key-hash-routed shard set with elastic resharding.

    Parity: the reference reshards PS embedding tables through
    KvVariable full/delta export-import driven by cluster-version bumps
    (elastic_ps.py + checkpoint_manager.py). ``reshard(new_num)``
    re-routes every row to its new home with no loss/duplication; an
    ``ElasticPsService``-compatible ``version_service`` is bumped on
    every reshard so trainers can detect the topology change.
    """

    def __init__(
        self,
        num_shards: int,
        dim: int,
        num_slots: int = 1,
        seed: int = 0,
        init_scale: float = 0.05,
        version_service=None,
    ):
        self.dim = dim
        self.num_slots = num_slots
        self.seed = seed
        self.init_scale = init_scale
        self._version_service = version_service
        self.shards: List[KvEmbeddingStore] = [
            KvEmbeddingStore(dim, num_slots, seed, init_scale)
            for _ in range(num_shards)
        ]

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def _route(self, keys: np.ndarray) -> np.ndarray:
        return self._route_n(keys, self.num_shards)

    @staticmethod
    def _route_n(keys: np.ndarray, num_shards: int) -> np.ndarray:
        # same mix as the native bucket router, mod num_shards
        h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return ((h >> np.uint64(17)) % np.uint64(num_shards)).astype(
            np.int64
        )

    def gather(self, keys, insert_missing: bool = True) -> np.ndarray:
        k = KvEmbeddingStore._keys(keys)
        out = np.empty((len(k), self.dim), np.float32)
        route = self._route(k)
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                out[mask] = self.shards[sid].gather(
                    k[mask], insert_missing
                )
        return out

    def _per_shard(self, fn_name: str, keys, values, *args):
        k = KvEmbeddingStore._keys(keys)
        v = np.ascontiguousarray(values, dtype=np.float32).reshape(
            len(k), self.dim
        )
        route = self._route(k)
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                getattr(self.shards[sid], fn_name)(k[mask], v[mask], *args)

    def scatter(self, keys, values, op: str = "update"):
        self._per_shard("scatter", keys, values, op)

    def sparse_adagrad(self, keys, grads, lr: float, eps: float = 1e-8):
        self._per_shard("sparse_adagrad", keys, grads, lr, eps)

    def sparse_momentum(self, keys, grads, lr: float, momentum: float = 0.9):
        self._per_shard("sparse_momentum", keys, grads, lr, momentum)

    def sparse_adam(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
    ):
        self._per_shard(
            "sparse_adam", keys, grads, lr, step, beta1, beta2, eps
        )

    def sparse_group_ftrl(
        self,
        keys,
        grads,
        alpha: float = 0.05,
        beta: float = 1.0,
        l1: float = 0.0,
        l21: float = 0.0,
    ):
        self._per_shard(
            "sparse_group_ftrl", keys, grads, alpha, beta, l1, l21
        )

    def sparse_group_adam(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
        l1: float = 0.0,
        l2: float = 0.0,
        l21: float = 0.0,
    ):
        self._per_shard(
            "sparse_group_adam", keys, grads, lr, step, beta1, beta2,
            eps, l1, l2, l21,
        )

    def sparse_lamb(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.0,
    ):
        self._per_shard(
            "sparse_lamb", keys, grads, lr, step, beta1, beta2, eps,
            weight_decay,
        )

    def sparse_adabelief(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-12,
    ):
        self._per_shard(
            "sparse_adabelief", keys, grads, lr, step, beta1, beta2, eps
        )

    def sparse_amsgrad(
        self,
        keys,
        grads,
        lr: float,
        step: int,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
    ):
        self._per_shard(
            "sparse_amsgrad", keys, grads, lr, step, beta1, beta2, eps
        )

    def meta(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """(frequency, last_access_ts) per key; -1 for absent keys.
        Reads only — never bumps freq/ts."""
        k = KvEmbeddingStore._keys(keys)
        freqs = np.empty(len(k), np.int64)
        tss = np.empty(len(k), np.int64)
        route = self._route(k)
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                f, t = self.shards[sid].meta(k[mask])
                freqs[mask] = f
                tss[mask] = t
        return freqs, tss

    def export_keys(self) -> np.ndarray:
        """Every live key across all shards (no values, no bumps)."""
        parts = [s.export_keys() for s in self.shards]
        return (
            np.concatenate(parts) if parts else np.empty(0, np.int64)
        )

    def import_rows(self, keys, rows, freq=None, ts=None):
        """Route-and-import full rows (values + slots) — the write leg
        of device-tier spills and warm-reshard moves."""
        k = KvEmbeddingStore._keys(keys)
        if len(k) == 0:
            return
        r = np.ascontiguousarray(rows, dtype=np.float32).reshape(
            len(k), self.dim * (1 + self.num_slots)
        )
        f = (
            np.ascontiguousarray(freq, dtype=np.int64)
            if freq is not None
            else np.zeros(len(k), np.int64)
        )
        t = (
            np.ascontiguousarray(ts, dtype=np.int64)
            if ts is not None
            else np.zeros(len(k), np.int64)
        )
        route = self._route(k)
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                self.shards[sid].import_rows(
                    k[mask], r[mask], f[mask], t[mask]
                )

    def export_rows(
        self, keys
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Full rows/freq/ts/presence for exactly ``keys`` (state
        read: nothing created, freq/ts untouched, slots travel)."""
        k = KvEmbeddingStore._keys(keys)
        rows = np.zeros((len(k), self.dim * (1 + self.num_slots)), np.float32)
        freq = np.full(len(k), -1, np.int64)
        ts = np.full(len(k), -1, np.int64)
        present = np.zeros(len(k), bool)
        route = self._route(k)
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                r, f, t, p = self.shards[sid].export_rows(k[mask])
                rows[mask], freq[mask], ts[mask] = r, f, t
                present[mask] = p
        return rows, freq, ts, present

    def delete_keys(self, keys) -> int:
        k = KvEmbeddingStore._keys(keys)
        route = self._route(k)
        removed = 0
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                removed += self.shards[sid].delete_keys(k[mask])
        return removed

    # -- elastic resharding --------------------------------------------
    def warm_reshard(self, new_num_shards: int) -> "WarmReshardReport":
        """N → M shards moving ONLY rows whose route changes.

        The cold :meth:`reshard` exports every row once and re-imports
        the whole table into fresh stores; under a resize that is the
        embedding analogue of a full checkpoint restore. The warm path
        is the ElasWave-style per-dimension reconfiguration: existing
        shard objects with index < M are kept in place, each old shard
        lists its keys (8 bytes/row), recomputes ownership under M, and
        exports/deletes only the movers — rows whose home is unchanged
        never leave their store. Bumps the PS cluster version exactly
        like :meth:`reshard` so consumers detect the topology change.
        """
        old_n = self.num_shards
        t0 = time.perf_counter()
        total = len(self)
        moved = 0
        bytes_moved = 0
        rf = self.dim * (1 + self.num_slots)
        if new_num_shards == old_n:
            return WarmReshardReport(
                old_shards=old_n, new_shards=new_num_shards,
                total_rows=total, moved_rows=0, bytes_moved=0,
                elapsed_s=time.perf_counter() - t0,
            )
        for _ in range(old_n, new_num_shards):
            self.shards.append(
                KvEmbeddingStore(
                    self.dim, self.num_slots, self.seed, self.init_scale
                )
            )
        # movers are computed against the OLD shard list: shards past M
        # dissolve entirely, kept shards surrender only re-routed keys
        for sid in range(old_n):
            shard = self.shards[sid]
            keys = shard.export_keys()
            if len(keys) == 0:
                continue
            dest = self._route_n(keys, new_num_shards)
            mover_mask = dest != sid
            movers = keys[mover_mask]
            if len(movers) == 0:
                continue
            rows, freq, ts, _present = shard.export_rows(movers)
            mover_dest = dest[mover_mask]
            for did in np.unique(mover_dest):
                m = mover_dest == did
                self.shards[int(did)].import_rows(
                    movers[m], rows[m], freq[m], ts[m]
                )
            shard.delete_keys(movers)
            moved += len(movers)
            bytes_moved += len(movers) * (rf * 4 + 3 * 8)
        if new_num_shards < old_n:
            self.shards = self.shards[:new_num_shards]
        if self._version_service is not None:
            self._version_service.inc_global_version()
        report = WarmReshardReport(
            old_shards=old_n, new_shards=new_num_shards,
            total_rows=total, moved_rows=moved,
            bytes_moved=bytes_moved,
            elapsed_s=time.perf_counter() - t0,
        )
        logger.info(f"warm embedding reshard: {report.describe()}")
        return report

    def reshard(self, new_num_shards: int) -> None:
        """N → M shards: export every row once, re-route, import. Bumps
        the PS cluster version so consumers refresh their topology."""
        old = self.shards
        self.shards = [
            KvEmbeddingStore(
                self.dim, self.num_slots, self.seed, self.init_scale
            )
            for _ in range(new_num_shards)
        ]
        for shard in old:
            keys, rows, freq, ts = shard.export()
            if len(keys) == 0:
                continue
            route = self._route(keys)
            for sid in range(new_num_shards):
                mask = route == sid
                if mask.any():
                    self.shards[sid].import_rows(
                        keys[mask], rows[mask], freq[mask], ts[mask]
                    )
        if self._version_service is not None:
            self._version_service.inc_global_version()
        logger.info(
            f"resharded kv embedding {len(old)} -> {new_num_shards} "
            f"shards ({len(self)} rows)"
        )

    # -- checkpoint ----------------------------------------------------
    def export_state(
        self, since_versions: Optional[List[int]] = None
    ) -> Dict[str, np.ndarray]:
        """Full export, or a delta (rows newer than the per-shard
        versions) when ``since_versions`` is given."""
        since = since_versions or [0] * len(self.shards)
        parts = [
            s.export(since_version=v)
            for s, v in zip(self.shards, since)
        ]
        return {
            "keys": np.concatenate([p[0] for p in parts]),
            "rows": np.concatenate([p[1] for p in parts]),
            "freq": np.concatenate([p[2] for p in parts]),
            "ts": np.concatenate([p[3] for p in parts]),
        }

    def shard_versions(self) -> List[int]:
        return [s.version for s in self.shards]

    def import_state(self, state: Dict[str, np.ndarray]) -> None:
        keys = state["keys"]
        if len(keys) == 0:
            return
        route = self._route(np.asarray(keys, np.int64))
        for sid in range(self.num_shards):
            mask = route == sid
            if mask.any():
                self.shards[sid].import_rows(
                    keys[mask],
                    state["rows"][mask],
                    state["freq"][mask],
                    state["ts"][mask],
                )
