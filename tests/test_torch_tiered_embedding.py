"""Port parity: the disk cold tier (``dlrover_tpu_torch.ops.embedding.
tiered``) and the three-tier store against the JAX package, on the CPU.

- Every scenario of ``tests/test_tiered_embedding.py`` runs as a case of
  one parametrised test, over the sqlite and the native tier (the
  native-only ones over the native tier): the JAX objects and the port's
  get the same operations, under one fake clock, and their
  ``export_state`` (keys sorted), ``hot_rows``, ``cold_rows``, ``len``
  and gathered rows must be EQUAL, bitwise.
- A spill log written by either package's native tier reopens in the
  other's.
- The concurrent scenarios (the tier lock under a gather storm, export
  beside fault-ins) run on both packages with every thread joined under
  a time limit.
- ``three_tier_embedding(devices="cpu")`` against the JAX one in ``jnp``
  mode on a spilling stream with the checkpoint cadence (flush, spill to
  the host, evict to disk, save): the LRU bookkeeping equal after every
  step, the flushed state within 1e-6 (the JAX state's duplicate keys
  merged last-wins, as its importer merges them), the port's restored
  chain equal to its live state bitwise.
- The reference's fault of the native fault-in (a stale cold record
  assigned over a hot row), shown on the JAX package and absent in the
  port; and its device tier's write-backs with freq and ts 0, which
  send every row the card wrote back to disk at the next
  ``evict_cold``."""

import threading
import time
import types

import numpy as np
import pytest

import dlrover_tpu.ops.embedding as J
import dlrover_tpu.ops.embedding.store as jstore
import dlrover_tpu.ops.embedding.tiered as jtiered
import dlrover_tpu_torch.ops.embedding as T
import dlrover_tpu_torch.ops.embedding.store as tstore
import dlrover_tpu_torch.ops.embedding.tiered as ttiered

DIM = 8
STATE_TOL = 1e-6
JAX = types.SimpleNamespace(name="jax", emb=J, tiered=jtiered)
PORT = types.SimpleNamespace(name="port", emb=T, tiered=ttiered)


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both packages' stores (the rows' ``ts``):
    ``clock[0]`` is the second every gather and update stamps."""
    now = [1000]
    monkeypatch.setattr(jstore, "_now", lambda: now[0])
    monkeypatch.setattr(tstore, "_now", lambda: now[0])
    return now


def _make(pkg, kind, path, num_shards=2, seed=0):
    hot = pkg.emb.ShardedKvEmbedding(num_shards, DIM, seed=seed)
    cls = (pkg.emb.NativeTieredKvEmbedding if kind == "native"
           else pkg.emb.TieredKvEmbedding)
    return cls(hot, str(path))


def _state(t):
    st = t.export_state()
    order = np.argsort(st["keys"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in st.items()}


def _snap(t):
    return {"state": _state(t), "hot": t.hot_rows(), "cold": t.cold_rows(), "len": len(t)}


def _assert_equal(a, b, path="obs"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _ones(n):
    return np.ones((n, DIM), np.float32)


# ---------------------------------------------------------------------------
# the reference's scenarios, each on both packages
# ---------------------------------------------------------------------------
def sc_evict_and_fault_in_roundtrip(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(100, dtype=np.int64)
    obs["before"] = t.gather(keys).copy()
    t.sparse_adagrad(keys, _ones(100), lr=0.1)
    obs["trained"] = t.gather(keys, insert_missing=False).copy()
    obs["evicted"] = t.evict_cold(ts_limit=2**62)
    obs["after_evict"] = _snap(t)
    obs["back"] = t.gather(keys, insert_missing=False)
    obs["after_fault"] = _snap(t)
    t.sparse_adagrad(keys, np.full((100, DIM), 0.5, np.float32), lr=0.1)
    obs["second_update"] = t.gather(keys, insert_missing=False)
    obs["faulted_rows"] = t.faulted_rows if pkg is PORT else 100
    np.testing.assert_array_equal(obs["back"], obs["trained"])
    assert obs["after_evict"]["hot"] == 0 and obs["after_fault"]["cold"] == 0
    return t


def sc_partial_eviction_keeps_hot_rows(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    cold_keys = np.arange(50, dtype=np.int64)
    t.gather(cold_keys)
    for s in t.hot.shards:  # backdate: make them look old
        k, rows, f, ts = s.export()
        s.import_rows(k, rows, f, np.ones_like(ts))
    hot_keys = np.arange(100, 120, dtype=np.int64)
    t.gather(hot_keys)
    obs["evicted"] = t.evict_cold(ts_limit=100)
    obs["after_evict"] = _snap(t)
    mixed = np.concatenate([cold_keys[:30], hot_keys, [500, 501, 502, 503, 504]])
    obs["mixed"] = t.gather(mixed)
    obs["after"] = _snap(t)
    assert obs["evicted"] == 50 and obs["after"]["cold"] == 20
    return t


def sc_export_state_includes_cold_tier(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(60, dtype=np.int64)
    t.gather(keys)
    t.evict_cold(ts_limit=2**62)
    obs["snap"] = _snap(t)
    fresh = pkg.emb.ShardedKvEmbedding(2, DIM, seed=7)
    fresh.import_state(t.export_state())
    obs["restored"] = fresh.gather(keys, insert_missing=False)
    assert len(obs["snap"]["state"]["keys"]) == 60
    return t


def sc_incremental_ckpt_over_tiered_store(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(40, dtype=np.int64)
    t.gather(keys)
    mgr = pkg.emb.IncrementalCheckpointManager(t, str(d / "ckpt"), full_every=10)
    mgr.save(step=1)
    t.evict_cold(ts_limit=2**62)
    mgr.save(step=2)  # the delta carries the newly evicted rows
    obs["manifest"] = [(e["kind"], e["rows"]) for e in mgr._read_manifest()]
    live = t.gather(keys, insert_missing=False).copy()
    fresh = _make(pkg, kind, d / "cold2", seed=9)
    obs["step"] = pkg.emb.IncrementalCheckpointManager(fresh, str(d / "ckpt")).restore()
    obs["restored"] = fresh.gather(keys, insert_missing=False)
    np.testing.assert_array_equal(obs["restored"], live)
    fresh.close()
    return t


def sc_unknown_keys_follow_base_rules(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    obs["out"] = t.gather([9999], insert_missing=False)
    obs["snap"] = _snap(t)
    return t


def sc_warm_reshard_preserves_both_tiers(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(120, dtype=np.int64)
    t.gather(keys)
    t.sparse_adagrad(keys, _ones(120), lr=0.2)
    trained = t.gather(keys, insert_missing=False).copy()
    t.evict_cold(ts_limit=2**62)
    report = t.warm_reshard(3)
    obs["report"] = (report.old_shards, report.new_shards, report.total_rows,
                     report.moved_rows, report.bytes_moved)
    obs["shards"] = t.hot.num_shards
    obs["after"] = _snap(t)
    obs["gathered"] = t.gather(keys, insert_missing=False)
    np.testing.assert_array_equal(obs["gathered"], trained)
    return t


def sc_spill_log_survives_restart(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(80, dtype=np.int64)
    t.gather(keys)
    t.sparse_adagrad(keys, _ones(80), lr=0.1)
    obs["evicted"] = t.evict_cold(ts_limit=2**62)
    t.close()
    t2 = _make(pkg, kind, d / "cold")
    obs["reopened"] = _snap(t2)
    obs["back"] = t2.gather(keys, insert_missing=False)
    obs["after"] = _snap(t2)
    return t2


def sc_tombstones_survive_restart(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(20, dtype=np.int64)
    t.gather(keys)
    t.evict_cold(ts_limit=2**62)
    t.gather(keys[:10], insert_missing=False)
    t.close()
    t2 = _make(pkg, kind, d / "cold")
    obs["reopened"] = _snap(t2)
    obs["out"] = t2.gather(keys[10:], insert_missing=False)
    assert obs["reopened"]["cold"] == 10
    return t2


def sc_delta_export_seq_survives_restart(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(30, dtype=np.int64)
    t.gather(keys)
    t.evict_cold(ts_limit=2**62)
    obs["seq"] = t._evict_seq
    t.close()
    t2 = _make(pkg, kind, d / "cold")
    obs["reopened_seq"] = t2._evict_seq
    t2.gather(keys)
    t2.evict_cold(ts_limit=2**62)
    obs["next_seq"] = t2._evict_seq
    assert obs["next_seq"] == obs["seq"] + 1 == obs["reopened_seq"] + 1
    return t2


def sc_reshard_preserves_cold_rows(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold")
    keys = np.arange(200, dtype=np.int64)
    t.gather(keys)
    t.sparse_adagrad(keys, _ones(200), lr=0.1)
    t.evict_cold(ts_limit=2**62)
    t.reshard(4)
    obs["after_reshard"] = _snap(t)
    obs["gathered"] = t.gather(keys, insert_missing=False)
    t.evict_cold(ts_limit=2**62)
    obs["evicted_again"] = _snap(t)
    obs["gathered_again"] = t.gather(keys, insert_missing=False)
    return t


def sc_reopen_with_fewer_shards_refused(pkg, kind, d, obs):
    t = _make(pkg, kind, d / "cold", num_shards=4)
    t.gather(np.arange(100, dtype=np.int64))
    t.evict_cold(ts_limit=2**62)
    t.close()
    with pytest.raises(ValueError, match="live rows") as err:
        _make(pkg, kind, d / "cold", num_shards=2)
    obs["message"] = str(err.value).replace(str(d), "<dir>")
    return _make(pkg, kind, d / "cold", num_shards=4)


def sc_torn_tail_record_is_dropped_on_open(pkg, kind, d, obs):
    import os

    t = _make(pkg, kind, d / "cold", num_shards=1)
    keys = np.arange(50, dtype=np.int64)
    t.gather(keys)
    t.evict_cold(ts_limit=2**62)
    t.close()
    log = f"{d / 'cold'}.shard0"
    with open(log, "r+b") as f:  # tear the last record's payload
        f.truncate(os.path.getsize(log) - 17)
    t2 = _make(pkg, kind, d / "cold", num_shards=1)
    obs["reopened"] = _snap(t2)
    obs["back"] = t2.gather(keys, insert_missing=False)
    assert obs["reopened"]["cold"] == 49
    return t2


BOTH = ("sqlite", "native")
SCENARIOS = [
    (sc_evict_and_fault_in_roundtrip, BOTH),
    (sc_partial_eviction_keeps_hot_rows, BOTH),
    (sc_export_state_includes_cold_tier, BOTH),
    (sc_incremental_ckpt_over_tiered_store, BOTH),
    (sc_unknown_keys_follow_base_rules, BOTH),
    (sc_warm_reshard_preserves_both_tiers, BOTH),
    (sc_spill_log_survives_restart, ("native",)),
    (sc_tombstones_survive_restart, ("native",)),
    (sc_delta_export_seq_survives_restart, ("native",)),
    (sc_reshard_preserves_cold_rows, ("native",)),
    (sc_reopen_with_fewer_shards_refused, ("native",)),
    (sc_torn_tail_record_is_dropped_on_open, ("native",)),
]
CASES = [
    pytest.param(fn, kind, id=f"{fn.__name__[3:]}-{kind}")
    for fn, kinds in SCENARIOS for kind in kinds
]


@pytest.mark.parametrize("scenario,kind", CASES)
def test_tier_scenario_matches_jax(scenario, kind, tmp_path, clock):
    result = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        obs = {}
        t = scenario(pkg, kind, d, obs)
        obs["final"] = _snap(t)
        t.close()
        result[pkg.name] = obs
    _assert_equal(result["port"], result["jax"])


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_spill_log_reopens_across_packages(writer, reader, tmp_path, clock):
    """The spill log's format is the reference's: a log written by one
    package's native tier reopens in the other's, rows, slots,
    tombstones and the eviction seq included."""
    keys = np.arange(90, dtype=np.int64)
    t = _make(writer, "native", tmp_path / "cold", num_shards=3)
    t.gather(keys)
    t.sparse_adagrad(keys, _ones(90), lr=0.1)
    trained = t.gather(keys, insert_missing=False).copy()
    t.evict_cold(ts_limit=2**62)
    t.gather(keys[:30], insert_missing=False)  # tombstones in the log
    t.evict_cold(ts_limit=2**62)
    written = _snap(t)
    t.close()
    r = _make(reader, "native", tmp_path / "cold", num_shards=3)
    _assert_equal(_snap(r), written)
    assert r._evict_seq == 2
    np.testing.assert_array_equal(r.gather(keys, insert_missing=False), trained)
    r.close()


def test_native_and_sqlite_agree_and_time_faulting_gathers(tmp_path, clock):
    """The reason the tier manager is native is gather-with-fault
    throughput. Its timing is only printed here (a wall-clock race on a
    shared host is no test); the two tiers must return equal rows."""
    n, batch = 4000, 256
    keys = np.arange(n, dtype=np.int64)
    out, times = {}, {}
    for kind in BOTH:
        t = _make(PORT, kind, tmp_path / f"perf.{kind}")
        t.gather(keys)
        t.evict_cold(ts_limit=2**62)
        t0 = time.perf_counter()
        out[kind] = np.concatenate([
            t.gather(keys[i:i + batch], insert_missing=False) for i in range(0, n, batch)])
        times[kind] = time.perf_counter() - t0
        assert t.cold_rows() == 0 and t.faulted_rows == n
        t.close()
    np.testing.assert_array_equal(out["native"], out["sqlite"])
    print(f"faulting gathers of {n} rows: native {times['native']:.4f} s, "
          f"sqlite {times['sqlite']:.4f} s")


# ---------------------------------------------------------------------------
# the tier lock and concurrent fault-ins (both packages)
# ---------------------------------------------------------------------------
JOIN_S = 10.0


def _join(threads):
    for th in threads:
        th.join(timeout=JOIN_S)
    assert not any(th.is_alive() for th in threads), "a thread did not finish"


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_writer_not_starved_by_gather_storm(pkg):
    lock = pkg.tiered._RWLock()
    stop, acquired = threading.Event(), threading.Event()

    def reader():
        while not stop.is_set():
            lock.acquire_read()
            time.sleep(0.001)
            lock.release_read()

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(6)]
    for r in readers:
        r.start()
    time.sleep(0.05)

    def writer():
        lock.acquire_write()
        acquired.set()
        lock.release_write()

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    ok = acquired.wait(timeout=5.0)
    stop.set()
    _join([w] + readers)
    assert ok, "writer starved by overlapping readers"


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_new_readers_wait_behind_queued_writer(pkg):
    lock = pkg.tiered._RWLock()
    lock.acquire_read()
    order = []

    def writer():
        lock.acquire_write()
        order.append("w")
        lock.release_write()

    def late_reader():
        lock.acquire_read()
        order.append("r")
        lock.release_read()

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    time.sleep(0.05)
    r = threading.Thread(target=late_reader, daemon=True)
    r.start()
    time.sleep(0.05)
    assert order == []
    lock.release_read()
    _join([w, r])
    assert order == ["w", "r"]


def _trained_tier(pkg, kind, path, n=200):
    t = _make(pkg, kind, path)
    keys = np.arange(n, dtype=np.int64)
    t.gather(keys)
    t.sparse_adagrad(keys, _ones(n), lr=0.1)
    return t, keys, t.gather(keys, insert_missing=False).copy()


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
@pytest.mark.parametrize("kind", BOTH)
def test_export_never_drops_rows_during_gathers(pkg, kind, tmp_path):
    """A fault-in between the export's cold and hot legs must not drop
    a trained row from the checkpoint."""
    t, keys, trained = _trained_tier(pkg, kind, tmp_path / "cold")
    assert t.evict_cold(ts_limit=2**62) == len(keys)
    stop, errors = threading.Event(), []

    def hammer():
        rng = np.random.default_rng(1)
        try:
            while not stop.is_set():
                t.gather(rng.choice(keys, size=32, replace=False), insert_missing=False)
        except Exception as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    try:
        for _ in range(5):
            state = t.export_state()
            assert set(int(k) for k in state["keys"]) == set(int(k) for k in keys)
    finally:
        stop.set()
        _join([th])
    assert not errors, errors
    np.testing.assert_array_equal(t.gather(keys, insert_missing=False), trained)
    t.close()


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
@pytest.mark.parametrize("kind", BOTH)
def test_gather_storm_vs_eviction_no_row_resurrection(pkg, kind, tmp_path):
    """A gather probing the hot tier just before eviction moves a row
    out must not re-initialize it just after: under a gather storm and
    an eviction loop every row keeps its trained value."""
    t, keys, trained = _trained_tier(pkg, kind, tmp_path / "cold")
    stop, errs = threading.Event(), []

    def storm(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            sub = rng.choice(keys, 32, replace=False)
            if not np.array_equal(t.gather(sub), trained[sub]):
                errs.append(seed)
                return

    threads = [threading.Thread(target=storm, args=(i,), daemon=True) for i in range(4)]
    for th in threads:
        th.start()
    deadline, evictions = time.monotonic() + 0.5, 0
    try:
        while time.monotonic() < deadline and not errs:
            evictions += 1
            t.evict_cold(ts_limit=2**62)
    finally:
        stop.set()
        _join(threads)
    assert not errs and evictions > 3
    np.testing.assert_array_equal(t.gather(keys, insert_missing=False), trained)
    t.close()


# ---------------------------------------------------------------------------
# the reference's fault: a stale cold record assigned over a hot row
# ---------------------------------------------------------------------------
def _card_trained_over_stale_cold(pkg, path):
    """The sequence a device tier makes: the card copies rows out with
    ``export_rows`` (the host keeps its copy), the host copies sit
    untouched and go to the spill log, the card spills its trained rows
    back through ``import_rows``."""
    t = _make(pkg, "native", path)
    keys = np.arange(4, dtype=np.int64)
    t.gather(keys)
    rows = t.export_rows(keys)[0]
    t.evict_cold(ts_limit=2**62)
    rows[:, :DIM] = 9.0
    t.import_rows(keys, rows)
    return t, keys


def test_stale_cold_record_never_overwrites_a_hot_row(tmp_path, clock):
    """The reference counts each key twice and its fault-in gives back
    the pre-training rows; a reshard keeps them. The port drops the stale
    record at the import: each key counts once, the trained rows come
    back, and a reshard keeps them."""
    jt, keys = _card_trained_over_stale_cold(JAX, tmp_path / "jax")
    assert len(jt) == 8
    assert not (jt.gather(keys, insert_missing=False) == 9.0).any()
    jt.close()
    jt, _ = _card_trained_over_stale_cold(JAX, tmp_path / "jax2")
    jt.reshard(4)
    assert not (jt.gather(keys, insert_missing=False) == 9.0).any()
    jt.close()

    pt, keys = _card_trained_over_stale_cold(PORT, tmp_path / "port")
    assert (len(pt), pt.hot_rows(), pt.cold_rows()) == (4, 4, 0)
    np.testing.assert_array_equal(pt.gather(keys, insert_missing=False), np.full((4, DIM), 9.0))
    pt.reshard(4)
    np.testing.assert_array_equal(pt.gather(keys, insert_missing=False), np.full((4, DIM), 9.0))
    assert pt.faulted_rows == 0
    pt.close()


def test_fault_in_keeps_a_hot_row_and_tombstones_its_cold_record(tmp_path, clock):
    """The native fault-in itself, below the imports: a key written hot
    behind the tier's back while its record is in the log keeps the hot
    row, and the record is tombstoned (on reopen too)."""
    pt = _make(PORT, "native", tmp_path / "cold", num_shards=1)
    keys = np.arange(6, dtype=np.int64)
    pt.gather(keys)
    rows = pt.export_rows(keys)[0]
    pt.evict_cold(ts_limit=2**62)
    rows[:, :DIM] = 9.0
    pt.hot.import_rows(keys[:3], rows[:3])  # the hot store alone: no drop
    assert (pt.hot_rows(), pt.cold_rows()) == (3, 6)
    got = pt.gather(keys, insert_missing=False)
    np.testing.assert_array_equal(got[:3], np.full((3, DIM), 9.0))
    assert not (got[3:] == 9.0).any()
    assert (pt.hot_rows(), pt.cold_rows(), pt.faulted_rows) == (6, 0, 3)
    pt.close()
    again = _make(PORT, "native", tmp_path / "cold", num_shards=1)
    assert again.cold_rows() == 0
    again.close()


def test_device_tier_read_keeps_card_trained_rows(tmp_path, clock):
    """The same fault through the three-tier store: rows trained on the
    device tier, spilled back after their host copies went to disk, then
    read through ``gather(insert_missing=False)``. The JAX store returns
    the rows from before training; the port the trained ones."""
    ids = np.arange(6, dtype=np.int64)
    got = {}
    for pkg in (JAX, PORT):
        kw = dict(kernel_mode="jnp") if pkg is JAX else dict(devices="cpu")
        emb = pkg.emb.three_tier_embedding(
            2, DIM, str(tmp_path / f"{pkg.name}.cold"), capacity=16, lr=1.0, **kw)
        prep = emb.prepare(ids)
        emb.apply_grads(prep, _ones(len(ids)), step=1)
        live = np.asarray(emb.gather(ids, insert_missing=False)).copy()
        emb.host.evict_cold(ts_limit=2**62)  # the host copies go to disk
        emb.evict_to_host(keep_rows=0)  # the trained rows spill back
        emb.join_spills()
        n_host = len(emb.host)
        got[pkg.name] = (live, np.asarray(emb.gather(ids, insert_missing=False)), n_host)
        emb.close()
        emb.host.close()
    jlive, jread, jlen = got["jax"]
    plive, pread, plen = got["port"]
    np.testing.assert_allclose(plive, jlive, rtol=0, atol=STATE_TOL)
    assert not np.allclose(jread, jlive) and jlen == 2 * len(ids)
    np.testing.assert_array_equal(pread, plive)
    assert plen == len(ids)


def _card_trained_rows(pkg, path, clock):
    """Rows trained on the device tier in two steps, one second apart:
    every row written back by a flush, then the second step's rows
    written back again by a spill (``evict_to_host(keep_rows=0)``)."""
    kw = dict(kernel_mode="jnp") if pkg is JAX else dict(devices="cpu")
    emb = pkg.emb.three_tier_embedding(2, DIM, str(path), capacity=16, lr=0.1, **kw)
    for ids in STEPS_TWICE:
        clock[0] += 1
        prep = emb.prepare(ids)
        emb.apply_grads(prep, _ones(len(ids)), step=1)
        if ids is STEPS_TWICE[0]:
            emb.flush()
    emb.evict_to_host(keep_rows=0)
    emb.join_spills()
    return emb


STEPS_TWICE = (np.array([0, 1, 1, 2, 2, 2, 3, 4, 4, 5], np.int64),
               np.array([3, 4, 4, 5], np.int64))


def test_card_write_backs_keep_freq_and_ts(tmp_path, clock):
    """The reference's device tier writes its rows back with freq and
    ts 0, so the next ``evict_cold`` sends every row the card trained
    to disk, however recently. The port's write-backs (a flush, a spill)
    carry the count and the stamp the host store itself would have
    recorded for the same lookups: ``evict_cold`` moves only the rows
    the card last touched before the limit."""
    t0 = clock[0]
    jemb = _card_trained_rows(JAX, tmp_path / "jax.cold", clock)
    jstate = _state(jemb.host)
    assert (jstate["freq"] == 0).all() and (jstate["ts"] == 0).all()
    assert jemb.host.evict_cold(ts_limit=t0 + 1) == 6  # all of them
    jemb.close()
    jemb.host.close()

    clock[0] = t0
    plain = PORT.emb.ShardedKvEmbedding(2, DIM, seed=0)
    for ids in STEPS_TWICE:
        clock[0] += 1
        plain.gather(ids)
    clock[0] = t0
    pemb = _card_trained_rows(PORT, tmp_path / "port.cold", clock)
    pstate = _state(pemb.host)
    np.testing.assert_array_equal(pstate["keys"], np.arange(6))
    want_freq, want_ts = plain.meta(pstate["keys"])
    np.testing.assert_array_equal(pstate["freq"], want_freq)
    np.testing.assert_array_equal(pstate["ts"], want_ts)
    assert pemb.host.evict_cold(ts_limit=t0 + 1) == 0  # every row touched since
    assert pemb.host.evict_cold(ts_limit=t0 + 2) == 3  # keys 0-2: the first step's alone
    assert pemb.host.cold_rows() == 3 and len(pemb.host) == 6
    pemb.close()
    pemb.host.close()


# ---------------------------------------------------------------------------
# the three-tier store against the JAX one, with the checkpoint cadence
# ---------------------------------------------------------------------------
def _three_tier_stream(steps=20, bs=48, seed=3):
    """A sliding window of 16 ids, 8 new a step, plus one id from a set
    of ten that each come back every ten steps: a 32-row device tier
    spills from step 5 on, each victim is older than the batch's own hits
    (the JAX tier would evict a batch's own hits if they were the coldest
    rows), and the returning ids fault back from the disk tier."""
    rng = np.random.default_rng(seed)
    for s in range(steps):
        ids = np.concatenate([8 * s + rng.integers(0, 16, bs - 2), [10_000 + s % 10] * 2])
        yield ids.astype(np.int64), rng.normal(size=(bs, DIM)).astype(np.float32)


def _merged(state):
    """An export's rows merged last-wins by key, keys sorted (what an
    importer holds)."""
    last = {int(k): i for i, k in enumerate(state["keys"])}
    keys = np.array(sorted(last), np.int64)
    return keys, np.asarray(state["rows"])[[last[int(k)] for k in keys]]


@pytest.mark.parametrize("native", [True, False], ids=["native", "sqlite"])
def test_three_tier_matches_jax_under_the_cadence(native, tmp_path, clock):
    embs, mgrs = {}, {}
    for pkg in (JAX, PORT):
        kw = dict(kernel_mode="jnp") if pkg is JAX else dict(devices="cpu")
        embs[pkg.name] = pkg.emb.three_tier_embedding(
            2, DIM, str(tmp_path / f"{pkg.name}.cold"), native_cold=native,
            capacity=32, lr=0.1, **kw)
        mgrs[pkg.name] = pkg.emb.IncrementalCheckpointManager(
            embs[pkg.name].host, str(tmp_path / f"{pkg.name}.ckpt"), full_every=2)
    j, t = embs["jax"], embs["port"]
    ts_limit, seen, evicted = clock[0], set(), 0
    for step, (ids, grads) in enumerate(_three_tier_stream(), start=1):
        clock[0] += 1
        seen.update(int(k) for k in ids)
        jp, tp = j.prepare(ids), t.prepare(ids)
        np.testing.assert_array_equal(tp.slots, jp.slots)
        np.testing.assert_allclose(t.gather_for(tp).numpy(), np.asarray(j.gather_for(jp)),
                                   rtol=0, atol=STATE_TOL)
        j.apply_grads(jp, grads, step=step)
        t.apply_grads(tp, grads, step=step)
        np.testing.assert_array_equal(t.hot._id_of, j.hot._id_of)
        np.testing.assert_array_equal(t.hot._last_used, j.hot._last_used)
        np.testing.assert_array_equal(t.hot._dirty, j.hot._dirty)
        if step % 5:
            continue
        for name, e in embs.items():
            e.flush()
            e.evict_to_host()
            e.join_spills()
            n = e.host.evict_cold(ts_limit)
            if name == "port":
                evicted += n
                if step == 10:  # a delta begun and aborted before the save
                    st = mgrs[name].begin_chunked_save(step=step)
                    st.advance(budget_s=0.0)
                    st.abort()
            mgrs[name].save(step=step)
        ts_limit = clock[0]
        assert len(t.host) == len(seen)  # each key once, over both host tiers
        jk, jr = _merged(j.host.export_state())
        pstate = t.host.export_state()
        pk, pr = _merged(pstate)
        assert len(pk) == len(pstate["keys"])  # no key twice in the port's export
        np.testing.assert_array_equal(pk, jk)
        np.testing.assert_allclose(pr, jr, rtol=STATE_TOL, atol=STATE_TOL)
        # the port's chain restores its live state, bitwise
        fresh = PORT.emb.three_tier_embedding(
            2, DIM, str(tmp_path / f"fresh{step}.cold"), native_cold=native,
            capacity=32, devices="cpu")
        assert PORT.emb.IncrementalCheckpointManager(
            fresh.host, str(tmp_path / "port.ckpt")).restore() == step
        rk, rr = _merged(fresh.host.export_state())
        np.testing.assert_array_equal(rk, pk)
        np.testing.assert_array_equal(rr, pr)
        fresh.close()
        fresh.host.close()
    assert t.stats.spill_rows == j.stats.spill_rows > 0
    assert t.stats.faults == j.stats.faults
    assert evicted > 0 and t.host.faulted_rows > 0
    for e in embs.values():
        e.close()
        e.host.close()
