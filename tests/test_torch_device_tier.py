"""Port parity: the device hot tier (``dlrover_tpu_torch.ops.embedding.
device_tier``) and the plain versions of its kernels against the JAX
package, on the CPU.

- ``emb_gather`` / ``emb_scatter``'s plain versions against the JAX
  ``_Kernels`` in both its modes (the Pallas kernels in interpret mode,
  n ≤ 64, and the jnp twin), scratch-padded calls included: BITWISE,
  since both only move f32 rows.
- ``DeviceSparseEmbedding`` against the JAX one in ``jnp`` mode on one
  id stream that forces spills, for adagrad, momentum and adam: the LRU
  bookkeeping (which id sits in which slot, recency) must be EQUAL
  after every step, the per-occurrence rows and the flushed host state
  within 1e-6 (f32; the two frameworks round the optimizer's last ops
  alike but may contract or order them differently).
- The tier's own contracts, as the JAX package's tests state them:
  stale preps, pins, spill lifetime and the read-only probe."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.embedding import ShardedKvEmbedding as JaxHost
from dlrover_tpu.ops.embedding.device_tier import (
    DeviceSparseEmbedding as JaxEmb,
)
from dlrover_tpu.ops.embedding.device_tier import _Kernels as JaxKernels
from dlrover_tpu_torch.data.sparse_prefetch import SparseRowPipeline
from dlrover_tpu_torch.ops import embedding_rows
from dlrover_tpu_torch.ops.embedding import ShardedKvEmbedding
from dlrover_tpu_torch.ops.embedding.device_tier import (
    DeviceHotTier,
    DeviceSparseEmbedding,
    _bucket,
)

DIM = 8
RF = DIM * 2  # dim * (1 + num_slots)
STATE_TOL = 1e-6


def _host(num_shards=2, seed=0, num_slots=1, dim=DIM):
    return ShardedKvEmbedding(num_shards, dim, num_slots=num_slots, seed=seed)


def _emb(capacity=64, opt="adagrad", lr=0.5, host=None, **kw):
    return DeviceSparseEmbedding(
        host if host is not None else _host(),
        capacity=capacity, sparse_optimizer=opt, lr=lr, devices="cpu", **kw,
    )


def _sorted_state(host):
    st = host.export_state()
    order = np.argsort(st["keys"])
    return st["keys"][order], st["rows"][order]


# ---------------------------------------------------------------------------
# B8 / B9 plain versions against the JAX kernels
# ---------------------------------------------------------------------------
def _padded_slots(capacity, n_real, n, seed):
    """n_real sorted unique slots in [0, capacity), padded to n with the
    scratch slot (index ``capacity``) as the tier pads them."""
    rng = np.random.default_rng(seed)
    s = np.full(n, capacity, np.int32)
    s[:n_real] = np.sort(rng.choice(capacity, n_real, replace=False))
    return s


@pytest.mark.parametrize("mode", ["pallas", "jnp"])
@pytest.mark.parametrize("n_real", [64, 21])
def test_gather_plain_matches_jax_kernels(mode, n_real):
    cap = 96
    table = np.random.default_rng(0).normal(size=(cap + 1, RF)).astype(np.float32)
    slots = _padded_slots(cap, n_real, 64, seed=n_real)
    ref = np.asarray(JaxKernels(mode).gather(jnp.asarray(table), slots))
    embedding_rows.reset_launch_counts()
    got = embedding_rows.emb_gather(torch.from_numpy(table), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert embedding_rows.launch_counts == {"emb_gather": 0, "emb_scatter": 0}


@pytest.mark.parametrize("mode", ["pallas", "jnp"])
@pytest.mark.parametrize("n_real", [64, 21])
def test_scatter_plain_matches_jax_kernels(mode, n_real):
    """Real slots unique; the padding names the scratch row many times,
    always with the same (zero) row, as the tier pads ragged rows."""
    cap = 96
    rng = np.random.default_rng(1)
    base = rng.normal(size=(cap + 1, RF)).astype(np.float32)
    slots = _padded_slots(cap, n_real, 64, seed=n_real + 1)
    rows = np.zeros((64, RF), np.float32)
    rows[:n_real] = rng.normal(size=(n_real, RF))
    ref = np.asarray(JaxKernels(mode).scatter(jnp.asarray(base), slots, jnp.asarray(rows)))
    table = torch.from_numpy(base.copy())
    out = embedding_rows.emb_scatter_(table, torch.from_numpy(slots), torch.from_numpy(rows))
    assert out is table  # in place
    np.testing.assert_array_equal(table.numpy(), ref)


def test_kernel_modes_are_refused():
    with pytest.raises(ValueError, match="one mode"):
        _emb(kernel_mode="jnp")
    emb = _emb(kernel_mode="auto")
    assert emb.hot.kernel_mode == "plain"
    emb.close()


def test_unported_options_raise():
    """The tier has no unported option left: spill striping is accepted
    (the host-link arbiter is ported), and ``export_metrics`` publishes
    its gauges into the registry it is given, the arbiter's host-leg
    price (``emb_host_leg_ms``) among them, as the JAX tier does."""
    from dlrover_tpu_torch.obs.metrics import MetricsRegistry

    _emb(spill_stripe_min_bytes=1 << 20).close()
    emb = _emb()
    reg = MetricsRegistry()
    scalars = emb.export_metrics(registry=reg)
    jax_scalars = JaxEmb(JaxHost(2, DIM, num_slots=1, seed=0), capacity=64,
                         kernel_mode="jnp").export_metrics(registry=MetricsRegistry())
    assert set(scalars) == set(jax_scalars)
    assert scalars["emb_host_leg_ms"] == 0.0
    assert reg.scalars()['dlrover_embedding_hot_rows{table="t0"}'] == scalars["emb_hot_rows"]
    emb.close()


def test_bucket():
    assert [_bucket(1), _bucket(64), _bucket(65), _bucket(4097)] == [64, 64, 128, 8192]


# ---------------------------------------------------------------------------
# DeviceSparseEmbedding against the JAX one (jnp mode)
# ---------------------------------------------------------------------------
def _stream(steps=10, bs=48, seed=5):
    """A sliding window of 16 ids, 8 new a step, drawn with repeats: a
    32-row tier spills from step 5 on, and every victim is older than
    the batch's own hits (the JAX tier would evict a batch's own hits
    if they were the coldest rows; ROADMAP C)."""
    rng = np.random.default_rng(seed)
    for s in range(steps):
        ids = (8 * s + rng.integers(0, 16, bs)).astype(np.int64)
        yield ids, rng.normal(size=(bs, DIM)).astype(np.float32)


@pytest.mark.parametrize("opt,slots", [("adagrad", 1), ("momentum", 1), ("adam", 2)])
def test_tier_matches_jax_under_spill(opt, slots):
    jhost = JaxHost(2, DIM, num_slots=slots, seed=0)
    thost = ShardedKvEmbedding(2, DIM, num_slots=slots, seed=0)
    kw = dict(capacity=32, sparse_optimizer=opt, lr=0.1)
    j = JaxEmb(jhost, kernel_mode="jnp", **kw)
    t = DeviceSparseEmbedding(thost, devices="cpu", **kw)
    for step, (ids, grads) in enumerate(_stream(), start=1):
        jp, tp = j.prepare(ids), t.prepare(ids)
        np.testing.assert_array_equal(tp.slots, jp.slots)
        np.testing.assert_array_equal(tp.inverse, jp.inverse)
        np.testing.assert_allclose(
            t.gather_for(tp).numpy(), np.asarray(j.gather_for(jp)), rtol=0, atol=STATE_TOL
        )
        j.apply_grads(jp, grads, step=step)
        t.apply_grads(tp, grads, step=step)
        # the same ids in the same slots with the same recency: equal LRU
        # decisions, so the same victims spill in the same order
        np.testing.assert_array_equal(t.hot._id_of, j.hot._id_of)
        np.testing.assert_array_equal(t.hot._last_used, j.hot._last_used)
        np.testing.assert_array_equal(t.hot._dirty, j.hot._dirty)
    assert t.stats.faults == j.stats.faults and t.stats.hits == j.stats.hits
    j.flush()
    t.flush()
    assert t.stats.spill_rows == j.stats.spill_rows > 0
    (jk, jr), (tk, tr) = _sorted_state(jhost), _sorted_state(thost)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tr, jr, rtol=STATE_TOL, atol=STATE_TOL)
    j.close()
    t.close()


def test_probe_matches_jax_and_leaves_recency_untouched():
    jhost, thost = JaxHost(2, DIM, seed=0), _host()
    j = JaxEmb(jhost, capacity=64, lr=1.0, kernel_mode="jnp")
    t = _emb(host=thost, lr=1.0)
    ids = np.arange(8, dtype=np.int64)
    for e in (j, t):
        e.apply_grads(e.prepare(ids), np.ones((8, DIM), np.float32), step=1)
    thost.gather(np.arange(10, 13, dtype=np.int64))  # host-only rows
    jhost.gather(np.arange(10, 13, dtype=np.int64))
    live = t.prepare(np.array([2, 5], np.int64))  # pins must survive
    before = t.hot.recency_snapshot()
    probe = np.array([0, 2, 5, 7, 11, 4242, 9999], np.int64)
    for _ in range(3):
        got = t.gather(probe, insert_missing=False)
    after = t.hot.recency_snapshot()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j.gather(probe, insert_missing=False)), rtol=0, atol=STATE_TOL
    )
    assert after["tick"] == before["tick"] and after["resident"] == before["resident"]
    np.testing.assert_array_equal(after["last_used"], before["last_used"])
    np.testing.assert_array_equal(after["pins"], before["pins"])
    assert 4242 not in t.hot._slot_of and 11 not in t.hot._slot_of
    assert len(t) == len(thost) == 11  # nothing created
    t.release(live)
    j.close()
    t.close()


# ---------------------------------------------------------------------------
# the tier's own contracts (as the JAX package's tests state them)
# ---------------------------------------------------------------------------
def test_capacity_from_budget():
    tier = DeviceHotTier(DIM, 1, hbm_budget_bytes=RF * 4 * 100, devices="cpu")
    assert tier.capacity == 100 and tier.hbm_bytes == RF * 4 * 100
    assert tuple(tier.table.shape) == (101, RF)  # + the scratch row


def test_lru_evicts_coldest_unpinned():
    tier = DeviceHotTier(DIM, 1, capacity=4, devices="cpu")
    for i in range(4):
        s, _v, _vi = tier._allocate(1)
        tier.bind(np.array([i], np.int64), s)
    tier.touch(np.array([tier._slot_of[0]]))  # 0 is now hottest
    tier.pin(np.array([tier._slot_of[1]]))  # 1 may not be evicted
    _slots, _victims, victim_ids = tier._allocate(2)
    assert {int(k) for k in victim_ids} == {2, 3}


def test_batch_hits_are_never_its_own_victims():
    """The batch's resident ids are pinned while its misses allocate:
    with 4 slots, ids 0-3 resident and 0, 1 the coldest, a batch of
    {0, 1, 8, 9} must evict 2 and 3, not its own 0 and 1."""
    emb = _emb(capacity=4, lr=1.0)
    for ids in ([0, 1], [2, 3]):
        emb.release(emb.prepare(np.array(ids, np.int64)))
    prep = emb.prepare(np.array([0, 1, 8, 9], np.int64))
    assert (prep.slots[: prep.n_unique] < emb.hot.capacity).all()
    assert sorted(emb.hot._slot_of) == [0, 1, 8, 9]
    rows = emb.gather_for(prep).numpy()
    np.testing.assert_array_equal(rows[:2], emb.host.gather([0, 1], insert_missing=False))
    emb.release(prep)
    emb.close()


def test_capacity_too_small_for_batch_raises():
    emb = _emb(capacity=4)
    with pytest.raises(ValueError, match="cannot hold"):
        emb.prepare(np.arange(10, dtype=np.int64))
    emb.close()


def test_stale_prep_rejected_and_pins_reset():
    emb = _emb(capacity=64)
    done = emb.prepare(np.arange(100, 108, dtype=np.int64))
    emb.release(done)
    prep = emb.prepare(np.arange(8, dtype=np.int64))
    assert emb.hot._pins.sum() == 8
    emb.evict_to_host(keep_rows=0)  # evicts the unpinned, bumps gen
    assert emb.hot._pins.sum() == 0
    with pytest.raises(RuntimeError, match="stale"):
        emb.gather_for(prep)
    emb.release(prep)  # stale: a no-op
    assert (emb.hot._pins >= 0).all()
    emb.release(emb.prepare(np.arange(200, 264, dtype=np.int64)))  # full capacity fits
    emb.close()


def test_pipeline_close_releases_undelivered_pins():
    emb = _emb(capacity=256)

    def stream():
        r = np.random.default_rng(3)
        while True:
            ids = r.integers(0, 120, 16).astype(np.int64)
            yield ids, (ids % 2).astype(np.float32)

    pipe = SparseRowPipeline(stream(), emb, depth=2)
    _ids, _batch, prep = next(pipe)
    emb.release(prep)
    deadline = time.monotonic() + 5.0
    while pipe.buffered_steps() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.close()
    deadline = time.monotonic() + 2.0
    while emb.hot._pins.sum() != 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert emb.hot._pins.sum() == 0
    emb.close()


def test_pipeline_error_propagates_after_good_steps():
    def bad_stream():
        yield np.arange(4, dtype=np.int64), np.zeros(4, np.float32)
        raise OSError("source died")

    emb = _emb()
    pipe = SparseRowPipeline(bad_stream(), emb)
    emb.release(next(pipe)[2])
    for _ in range(2):  # terminal: the same error on every retry
        with pytest.raises(OSError, match="source died"):
            next(pipe)
    pipe.close()
    emb.close()


class _SlowImportHost:
    """Host wrapper whose import_rows sleeps: widens the spill window."""

    def __init__(self, host, delay=0.15):
        self._host, self._delay = host, delay

    def import_rows(self, *a, **kw):
        time.sleep(self._delay)
        return self._host.import_rows(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._host, name)


@pytest.mark.parametrize("async_spill", [True, False])
def test_fault_in_waits_for_inflight_spill(async_spill):
    base = _host()
    emb = _emb(host=base, lr=1.0, async_spill=async_spill)
    emb.host = _SlowImportHost(base)
    ids = np.arange(8, dtype=np.int64)
    emb.apply_grads(emb.prepare(ids), np.ones((8, DIM), np.float32), step=1)
    trained = emb.gather(ids).numpy().copy()
    emb.evict_to_host(keep_rows=0)  # spill queued, import is slow
    np.testing.assert_array_equal(emb.gather(ids).numpy(), trained)
    state = emb.export_state()  # flush → join_spills barrier
    rows = dict(zip(state["keys"].tolist(), state["rows"]))
    for i, k in enumerate(ids):
        np.testing.assert_array_equal(rows[int(k)][:DIM], trained[i])
    emb.close()


def test_import_state_and_warm_reshard():
    host = _host()
    emb = _emb(host=host, lr=1.0)
    ids = np.arange(20, dtype=np.int64)
    emb.apply_grads(emb.prepare(ids), np.ones((20, DIM), np.float32), step=1)
    state = emb.export_state()
    emb.apply_grads(emb.prepare(ids), np.ones((20, DIM), np.float32), step=2)
    moved = emb.gather(ids).numpy().copy()
    emb.import_state(state)
    back = emb.gather(ids).numpy()
    assert not np.allclose(moved, back)
    np.testing.assert_array_equal(back, host.gather(ids, insert_missing=False))
    report = emb.warm_reshard(3)
    assert host.num_shards == 3 and report.moved_rows < report.total_rows
    np.testing.assert_array_equal(emb.gather(ids).numpy(), back)
    emb.close()
