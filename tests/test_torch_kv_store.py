"""Port parity: the port's own build of ``kv_store.cc`` and its ctypes
binding (``dlrover_tpu_torch.ops.embedding.store``) against the JAX
package's store, from the same seed and the same operations.

The two stores run the same C++ source, so every row must agree BITWISE:
the deterministic init on ``gather(insert_missing=True)``, the fused
host optimizers, the ``export_rows`` / ``import_rows`` legs and the warm
reshard's choice of movers."""

import hashlib

import numpy as np
import pytest

from dlrover_tpu.ops.embedding import store as jstore
from dlrover_tpu_torch.ops.embedding import store as tstore

DIM = 8


def _pair(num_shards=2, num_slots=2, seed=3):
    return (
        jstore.ShardedKvEmbedding(num_shards, DIM, num_slots=num_slots, seed=seed),
        tstore.ShardedKvEmbedding(num_shards, DIM, num_slots=num_slots, seed=seed),
    )


def _state(s):
    """(keys, rows, freq) sorted by key: export order follows hash
    buckets, which the comparison must not depend on."""
    st = s.export_state()
    order = np.argsort(st["keys"])
    return st["keys"][order], st["rows"][order], st["freq"][order]


def _assert_same_state(a, b):
    for x, y in zip(_state(a), _state(b)):
        np.testing.assert_array_equal(x, y)


def test_the_cc_source_is_the_jax_packages():
    """Byte for byte the JAX package's source up to its cold tier (less
    the one include the repair needs); the cold tier is the port's
    repair of the reference's failed-write faults (the tests below)."""
    cut = "// Native cold tier"
    with open(jstore._SRC) as f:
        j = f.read()
    with open(tstore._SRC) as f:
        t = f.read()
    t_hot = t[:t.index(cut)].replace("#include <unistd.h>  // ftruncate, fileno\n", "")
    assert hashlib.sha256(t_hot.encode()).hexdigest() == hashlib.sha256(
        j[:j.index(cut)].encode()).hexdigest()
    assert "cold_truncate" in t and "cold_truncate" not in j
    assert "dlrover_tpu_torch" in tstore._build_library()


@pytest.mark.parametrize("seed", [0, 7])
def test_gather_insert_is_bitwise(seed):
    j, t = _pair(seed=seed)
    keys = np.array([3, 99, 12345678901, 3, -5, 0], np.int64)
    np.testing.assert_array_equal(t.gather(keys), j.gather(keys))
    np.testing.assert_array_equal(
        t.gather([42, 3], insert_missing=False), j.gather([42, 3], insert_missing=False)
    )
    assert len(t) == len(j) == 5
    _assert_same_state(j, t)


@pytest.mark.parametrize("opt", ["sparse_adagrad", "sparse_adam", "sparse_momentum"])
def test_fused_host_optimizers_are_bitwise(opt):
    j, t = _pair()
    rng = np.random.default_rng(1)
    for step in range(1, 5):
        keys = rng.integers(0, 30, 40).astype(np.int64)
        g = rng.normal(size=(40, DIM)).astype(np.float32)
        args = (keys, g, 0.1) + ((step,) if opt == "sparse_adam" else ())
        getattr(j, opt)(*args)
        getattr(t, opt)(*args)
    keys = np.arange(30, dtype=np.int64)
    np.testing.assert_array_equal(t.export_rows(keys)[0], j.export_rows(keys)[0])
    _assert_same_state(j, t)


def test_export_rows_and_import_rows_are_bitwise():
    j, t = _pair()
    keys = np.arange(0, 50, 3, dtype=np.int64)
    j.gather(keys)
    t.gather(keys)
    probe = np.array([0, 3, 4, 48, 1000], np.int64)  # 4 and 1000 are absent
    jr, jf, _jt, jp = j.export_rows(probe)
    tr, tf, _tt, tp = t.export_rows(probe)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tp, jp)
    assert list(tp) == [True, True, False, True, False]
    assert len(t) == len(j) == len(keys)  # a state read creates nothing
    rows = np.random.default_rng(2).normal(size=(3, DIM * 3)).astype(np.float32)
    new = np.array([7, 8, 3], np.int64)
    j.import_rows(new, rows, freq=np.array([1, 2, 3]))
    t.import_rows(new, rows, freq=np.array([1, 2, 3]))
    np.testing.assert_array_equal(t.export_rows(new)[0], rows)
    _assert_same_state(j, t)


@pytest.mark.parametrize("old,new", [(2, 3), (4, 2)])
def test_warm_reshard_moves_the_same_rows(old, new):
    j, t = _pair(num_shards=old)
    keys = np.arange(200, dtype=np.int64) * 7919
    j.gather(keys)
    t.gather(keys)
    jrep = j.warm_reshard(new)
    trep = t.warm_reshard(new)
    assert isinstance(trep, tstore.WarmReshardReport)
    assert (trep.old_shards, trep.new_shards, trep.total_rows, trep.moved_rows, trep.bytes_moved) == (
        jrep.old_shards, jrep.new_shards, jrep.total_rows, jrep.moved_rows, jrep.bytes_moved
    )
    assert 0 < trep.moved_rows < trep.total_rows
    for js, ts in zip(j.shards, t.shards):
        assert set(ts.export_keys().tolist()) == set(js.export_keys().tolist())
    _assert_same_state(j, t)


def test_full_state_import_roundtrip():
    t = tstore.ShardedKvEmbedding(2, DIM, num_slots=2, seed=3)
    keys = np.arange(64, dtype=np.int64)
    t.gather(keys)
    t.sparse_adagrad(keys, np.ones((64, DIM), np.float32), lr=0.5)
    other = tstore.ShardedKvEmbedding(3, DIM, num_slots=2, seed=99)
    other.import_state(t.export_state())
    np.testing.assert_array_equal(other.export_rows(keys)[0], t.export_rows(keys)[0])


# -- the cold log under failed writes (the port's repair; the reference's
# copy keeps both faults) ---------------------------------------------------
_COLD_SCRIPT = r"""
import ctypes, json, os, resource, signal, sys
import numpy as np
from dlrover_tpu_torch.ops.embedding import store

lib = store._load_library()  # the cold entries' signatures are the store's binding

DIM, path = 1024, sys.argv[1]
REC = 40 + 4 * DIM  # header + payload
signal.signal(signal.SIGXFSZ, signal.SIG_IGN)  # a write past the limit fails instead
soft, hard = resource.getrlimit(resource.RLIMIT_FSIZE)
hot = lib.kv_create(DIM, 0, 7, 0.1)
rows = np.random.default_rng(0).standard_normal((30, DIM)).astype(np.float32)
keys = np.arange(30, dtype=np.int64)
lib.kv_scatter(hot, keys[:10], 10, rows[:10], 0, 1)
lib.kv_scatter(hot, keys[10:], 20, rows[10:], 0, 5)
cold = lib.cold_open(path.encode(), DIM)
out = {"first": lib.kv_evict_to_cold(hot, cold, 2, 1), "size1": os.path.getsize(path)}
# a limit in the 4th record's payload: the 2nd eviction fails in a later bucket
resource.setrlimit(resource.RLIMIT_FSIZE, (10 * REC + 3 * REC + 1000, hard))
out["second"] = lib.kv_evict_to_cold(hot, cold, 6, 2)
out["size2"] = os.path.getsize(path)
out["max_seq2"] = lib.cold_max_seq(cold)
out["hot2"] = lib.kv_size(hot)
got = np.zeros((20, DIM), np.float32)
lib.kv_gather(hot, keys[10:], 20, got, 0, 5)
out["hot_rows_equal"] = bool((got == rows[10:]).all())
# a tombstone cut short: the fault-in's write fails, the log keeps no torn bytes
resource.setrlimit(resource.RLIMIT_FSIZE, (10 * REC + 20, hard))
out["fault"] = lib.kv_fault_from_cold(hot, cold, keys[:1], 1)
out["size3"] = os.path.getsize(path)
lib.cold_close(cold)
resource.setrlimit(resource.RLIMIT_FSIZE, (soft, hard))

def rebuilt():
    c = lib.cold_open(path.encode(), DIM)
    n = lib.cold_count(c)
    k = np.zeros(max(n, 1), np.int64)
    r = np.zeros((max(n, 1), DIM), np.float32)
    f, t = np.zeros_like(k), np.zeros_like(k)
    got = lib.cold_export(c, 0, k, r, f, t, n)
    order = np.argsort(k[:got])
    return c, n, k[:got][order], r[:got][order]

c, n, k, r = rebuilt()
out["reopen_count"], out["reopen_keys"] = n, k.tolist()
out["reopen_rows_equal"] = bool((r == rows[: len(k)]).all())
out["reopen_max_seq"] = lib.cold_max_seq(c)
# the same seq runs again
out["again"] = lib.kv_evict_to_cold(hot, c, 6, 2)
lib.cold_close(c)
c, n, k, r = rebuilt()
out["final_count"], out["final_max_seq"] = n, lib.cold_max_seq(c)
out["final_rows_equal"] = bool((r == rows[k]).all())
print(json.dumps(out))
"""


def test_cold_log_survives_failed_writes(tmp_path):
    """Writes cut short by a file-size limit (SIGXFSZ ignored, so the
    write fails as on a full disk), in a process of its own: an eviction
    whose 4th record's payload is cut returns -1 with every row of the
    call still hot and readable, the log cut back to the last whole
    record, the max seq unchanged; a tombstone cut short leaves no bytes;
    the log reopened rebuilds exactly the rows of the eviction that
    completed, bit for bit; the same seq then runs again."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _COLD_SCRIPT, str(tmp_path / "cold.log")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": repo},
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    rec = 40 + 4 * 1024
    assert out["first"] == 10 and out["size1"] == 10 * rec
    assert out["second"] == -1 and out["size2"] == 10 * rec
    assert out["max_seq2"] == 1 and out["hot2"] == 20 and out["hot_rows_equal"]
    assert out["fault"] == -1 and out["size3"] == 10 * rec
    assert out["reopen_count"] == 10 and out["reopen_keys"] == list(range(10))
    assert out["reopen_rows_equal"] and out["reopen_max_seq"] == 1
    # the same seq again: the 20 rows, and key 0, which the failed
    # fault-in had brought back hot before its tombstone's write failed
    assert out["again"] == 21 and out["final_count"] == 30 and out["final_max_seq"] == 2
    assert out["final_rows_equal"]
