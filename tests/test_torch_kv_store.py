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
    with open(jstore._SRC, "rb") as f:
        j = hashlib.sha256(f.read()).hexdigest()
    with open(tstore._SRC, "rb") as f:
        t = hashlib.sha256(f.read()).hexdigest()
    assert j == t
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
