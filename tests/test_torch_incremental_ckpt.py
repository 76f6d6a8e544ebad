"""Port parity: the incremental embedding checkpoint
(``dlrover_tpu_torch.ops.embedding.ckpt``) and its int8 wire
(``dlrover_tpu_torch.parallel.wire_format``) against the JAX package, on
the CPU.

- Every scenario of ``tests/test_incremental_ckpt.py`` runs as a case
  of one parametrised test, over a plain store and both tiers, and
  (where the reference's scenario does not fix it) over
  ``wire_format`` none and int8: the JAX objects and the port's get the
  same operations, under one fake clock, and the manifests (crc32,
  nbytes and the decoded crc32 included), the files on disk, the
  restored steps and the restored stores' states must be EQUAL, bitwise.
- The wire's encode / decode / digest against the JAX module's, bitwise.
- A chain written by either package's manager restores in the other's:
  bitwise for ``none``, for int8 equal to the writer's own restore and
  within the reference's bound of the live state (one quantization step
  of the export's widest float).
- The reference's fault of the tiers' delta cursor (moved at the export,
  so a delta saved after an aborted one misses the rows evicted in
  between), shown on the JAX package and absent in the port."""

import os
import types

import numpy as np
import pytest

import dlrover_tpu.common.faults as jfaults
import dlrover_tpu.ops.embedding as J
import dlrover_tpu.ops.embedding.store as jstore
import dlrover_tpu.parallel.wire_format as jwire
import dlrover_tpu_torch.common.faults as tfaults
import dlrover_tpu_torch.ops.embedding as T
import dlrover_tpu_torch.ops.embedding.store as tstore
import dlrover_tpu_torch.parallel.wire_format as twire

DIM = 8


def _port_triggered() -> int:
    """The port's faults count into the metrics registry, not the module."""
    from dlrover_tpu_torch.obs.metrics import default_registry

    return int(sum(v for k, v in default_registry().scalars().items()
                   if k.startswith("dlrover_faults_triggered_total")))


JAX = types.SimpleNamespace(name="jax", emb=J, faults=jfaults, wire=jwire,
                            triggered=jfaults.triggered_total)
PORT = types.SimpleNamespace(name="port", emb=T, faults=tfaults, wire=twire,
                             triggered=_port_triggered)


@pytest.fixture
def clock(monkeypatch):
    now = [1000]
    monkeypatch.setattr(jstore, "_now", lambda: now[0])
    monkeypatch.setattr(tstore, "_now", lambda: now[0])
    return now


class Ctx:
    """One package's run of a scenario: its stores (plain, or a tier over
    a cold file of its own) and managers, all in the run's directory."""

    def __init__(self, pkg, kind, wire, d):
        self.pkg, self.kind, self.wire, self.d = pkg, kind, wire, d
        self._open = []

    def store(self, num_shards=2, seed=0):
        hot = self.pkg.emb.ShardedKvEmbedding(num_shards, DIM, seed=seed)
        if self.kind == "plain":
            return hot
        cls = (self.pkg.emb.NativeTieredKvEmbedding if self.kind == "native"
               else self.pkg.emb.TieredKvEmbedding)
        t = cls(hot, str(self.d / f"cold{len(self._open)}"))
        self._open.append(t)
        return t

    def mgr(self, emb, sub="ckpt", **kw):
        kw.setdefault("wire_format", self.wire)
        return self.pkg.emb.IncrementalCheckpointManager(emb, str(self.d / sub), **kw)

    def close(self):
        for t in self._open:
            t.close()


def _touch(emb, keys):
    keys = np.asarray(keys, np.int64)
    emb.sparse_adagrad(keys, np.ones((len(keys), DIM), np.float32), lr=0.1)


def _state(emb):
    st = emb.export_state()
    order = np.argsort(st["keys"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in st.items()}


def _files(path):
    return sorted(os.listdir(path))


def _assert_equal(a, b, path="obs"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
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


# ---------------------------------------------------------------------------
# the reference's scenarios, each on both packages
# ---------------------------------------------------------------------------
def sc_delta_saves_only_touched_rows(c, obs):
    emb = c.store()
    mgr = c.mgr(emb, full_every=10)
    emb.gather(np.arange(1000))
    mgr.save(step=1)
    _touch(emb, [3, 7])
    mgr.save(step=2)
    obs["manifest"] = mgr._read_manifest()
    assert [e["rows"] for e in obs["manifest"]] == [1000, 2]


def sc_restore_equals_live_state(c, obs):
    emb = c.store()
    mgr = c.mgr(emb, full_every=3)
    keys = np.arange(200)
    emb.gather(keys)
    mgr.save(step=1)
    for s in range(2, 6):
        _touch(emb, np.arange(s * 10, s * 10 + 5))
        mgr.save(step=s)
    emb2 = c.store(seed=123)
    mgr2 = c.mgr(emb2)
    obs["step"] = mgr2.restore()
    obs["restored"] = emb2.gather(keys, insert_missing=False)
    obs["live"] = emb.gather(keys, insert_missing=False)
    _touch(emb2, [1])
    mgr2.save(step=6)
    obs["manifest"] = mgr2._read_manifest()


def sc_reshard_forces_full(c, obs):
    emb = c.store()
    mgr = c.mgr(emb, full_every=100)
    emb.gather(np.arange(50))
    mgr.save(step=1)
    emb.reshard(4)
    mgr.save(step=2)
    obs["manifest"] = mgr._read_manifest()
    assert [e["kind"] for e in obs["manifest"]] == ["full", "full"]


def sc_restore_then_save_never_collides_with_live_files(c, obs):
    emb = c.store(num_shards=1)
    mgr = c.mgr(emb, full_every=2, keep_history=2)
    emb.gather(np.arange(20))
    for s in range(7):
        _touch(emb, [s])
        mgr.save(step=s)
    emb2 = c.store(num_shards=1, seed=1)
    mgr2 = c.mgr(emb2, full_every=2, keep_history=2)
    obs["step"] = mgr2.restore()
    for s in range(7, 12):
        _touch(emb2, [s])
        mgr2.save(step=s)
    obs["manifest"] = mgr2._read_manifest()
    emb3 = c.store(num_shards=1, seed=2)
    obs["step3"] = c.mgr(emb3).restore()
    obs["restored"] = emb3.gather(np.arange(20), insert_missing=False)
    if c.wire == "none":
        np.testing.assert_array_equal(
            obs["restored"], emb2.gather(np.arange(20), insert_missing=False))


def sc_gc_drops_old_chains(c, obs):
    emb = c.store(num_shards=1)
    mgr = c.mgr(emb, full_every=2, keep_history=2)
    emb.gather(np.arange(10))
    for s in range(7):
        _touch(emb, [s])
        mgr.save(step=s)
    obs["manifest"] = mgr._read_manifest()
    obs["files"] = _files(c.d / "ckpt")
    emb2 = c.store(num_shards=1, seed=9)
    obs["step"] = c.mgr(emb2).restore()
    obs["restored"] = emb2.gather(np.arange(10), insert_missing=False)


def _chain(c, steps=3):
    emb = c.store()
    mgr = c.mgr(emb, full_every=10)
    emb.gather(np.arange(100))
    mgr.save(step=1)
    for s in range(2, steps + 1):
        _touch(emb, list(range(10 * s, 10 * s + 5)))
        mgr.save(step=s)
    return emb, mgr


def sc_manifest_carries_crc_and_nbytes(c, obs):
    import zlib

    _, mgr = _chain(c)
    obs["manifest"] = mgr._read_manifest()
    for e in obs["manifest"]:
        blob = (c.d / "ckpt" / e["file"]).read_bytes()
        assert len(blob) == e["nbytes"] and zlib.crc32(blob) == e["crc32"]


def sc_corrupt_delta_truncates_chain_to_good_prefix(c, obs):
    _chain(c, steps=3)
    mgr = c.mgr(c.store())
    bad = c.d / "ckpt" / mgr._read_manifest()[-1]["file"]
    bad.write_bytes(bad.read_bytes()[:-30])
    emb2 = c.store(seed=5)
    mgr2 = c.mgr(emb2)
    obs["step"] = mgr2.restore()
    obs["manifest"] = mgr2._read_manifest()
    obs["files"] = _files(c.d / "ckpt")
    obs["restored"] = _state(emb2)
    assert obs["step"] == 2


def sc_corrupt_full_falls_back_to_previous_chain(c, obs):
    emb = c.store()
    mgr = c.mgr(emb, full_every=1, keep_history=2)
    emb.gather(np.arange(50))
    mgr.save(step=1)
    _touch(emb, [1, 2])
    mgr.save(step=2)
    (c.d / "ckpt" / mgr._read_manifest()[-1]["file"]).write_bytes(b"x" * 100)
    emb2 = c.store(seed=9)
    mgr2 = c.mgr(emb2)
    obs["step"] = mgr2.restore()
    obs["manifest"] = mgr2._read_manifest()
    obs["restored"] = _state(emb2)
    assert obs["step"] == 1


def sc_all_chains_corrupt_restores_none(c, obs):
    _, mgr = _chain(c, steps=1)
    for e in mgr._read_manifest():
        (c.d / "ckpt" / e["file"]).write_bytes(b"junk")
    obs["step"] = c.mgr(c.store(seed=1)).restore()
    obs["files"] = _files(c.d / "ckpt")
    assert obs["step"] is None


def sc_fault_site_chaos_matrix(c, obs):
    faults = c.pkg.faults
    for kind in ("torn_write", "bit_flip"):
        emb = c.store()
        mgr = c.mgr(emb, sub=kind)
        emb.gather(np.arange(60))
        mgr.save(step=1)
        faults.reset()
        before = c.pkg.triggered()
        try:
            faults.configure(f"embedding.export:{kind}:1.0:7")
            _touch(emb, [5])
            mgr.save(step=2)
            obs[f"{kind}_triggered"] = c.pkg.triggered() > before
        finally:
            faults.reset()
        emb2 = c.store(seed=4)
        mgr2 = c.mgr(emb2, sub=kind)
        obs[f"{kind}_step"] = mgr2.restore()
        obs[f"{kind}_restored"] = _state(emb2)
        obs[f"{kind}_files"] = _files(c.d / kind)
        assert obs[f"{kind}_step"] == 1 and obs[f"{kind}_triggered"]


def sc_advance_is_budgeted_and_crc_matches(c, obs):
    import zlib

    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(2000))
    st = mgr.begin_chunked_save(step=1, chunk_bytes=8 << 10)
    obs["first"] = st.advance(budget_s=0.0)
    obs["backlog"] = st.backlog_bytes
    path = st.commit()
    obs["manifest"] = mgr._read_manifest()
    obs["crc_ok"] = zlib.crc32(open(path, "rb").read()) == obs["manifest"][-1]["crc32"]
    obs["chunks"] = st.chunks_written
    assert 0 < obs["first"] <= 8 << 10 and obs["crc_ok"] and obs["chunks"] >= 2


def sc_snapshot_is_point_in_time(c, obs):
    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(100))
    snap = emb.gather(np.arange(100), insert_missing=False).copy()
    st = mgr.begin_chunked_save(step=1)
    _touch(emb, list(range(100)))
    st.commit()
    emb2 = c.store(seed=3)
    obs["step"] = c.mgr(emb2).restore()
    obs["restored"] = emb2.gather(np.arange(100), insert_missing=False)
    if c.wire == "none":
        np.testing.assert_array_equal(obs["restored"], snap)


def sc_abort_leaves_previous_chain_and_next_delta_complete(c, obs):
    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(50))
    mgr.save(step=1)
    _touch(emb, [7])
    st = mgr.begin_chunked_save(step=2)
    st.advance(budget_s=0.0)
    st.abort()
    obs["files_after_abort"] = _files(c.d / "ckpt")
    path = mgr.save(step=3)
    obs["delta_keys"] = np.sort(dict(np.load(path))["keys"])
    emb2 = c.store(seed=8)
    obs["step"] = c.mgr(emb2).restore()
    obs["restored"] = _state(emb2)
    assert 7 in set(int(k) for k in obs["delta_keys"])


def sc_crash_mid_drain_previous_chain_restorable(c, obs):
    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(50))
    mgr.save(step=1)
    _touch(emb, [3])
    st = mgr.begin_chunked_save(step=2)
    st.advance(budget_s=0.0)
    emb2 = c.store(seed=6)
    obs["step"] = c.mgr(emb2).restore()
    obs["restored"] = _state(emb2)
    st.abort()
    assert obs["step"] == 1


def sc_second_inflight_stager_rejected(c, obs):
    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(20))
    st = mgr.begin_chunked_save(step=1)
    with pytest.raises(RuntimeError, match="already in flight"):
        mgr.begin_chunked_save(step=2)
    st.commit()
    mgr.begin_chunked_save(step=2).abort()
    mgr.begin_chunked_save(step=3).commit()
    obs["manifest"] = mgr._read_manifest()


def _int8_chain(c):
    emb = c.store()
    mgr = c.mgr(emb, full_every=10)
    emb.gather(np.arange(100))
    mgr.save(step=1)
    _touch(emb, [3, 7])
    mgr.save(step=2)
    return emb, mgr


def sc_manifest_carries_wire_and_decoded_crc(c, obs):
    _, mgr = _int8_chain(c)
    obs["manifest"] = mgr._read_manifest()
    assert all(e["wire"] == "int8" and isinstance(e["decoded_crc32"], int)
               for e in obs["manifest"])


def sc_restore_bounded_error(c, obs):
    emb, _ = _int8_chain(c)
    keys = np.arange(100)
    live = emb.gather(keys, insert_missing=False)
    emb2 = c.store(seed=9)
    obs["step"] = c.mgr(emb2).restore()
    got = emb2.gather(keys, insert_missing=False)
    obs["restored"] = got
    err = np.max(np.abs(got - live))
    widest = max(float(np.max(np.abs(a))) for a in emb.export_state().values()
                 if a.dtype.kind == "f")
    assert 0 < err <= widest / 127 * 1.01


def sc_tampered_decoded_crc_quarantines(c, obs):
    _, mgr = _int8_chain(c)
    entries = mgr._read_manifest()
    entries[-1]["decoded_crc32"] ^= 0x1
    mgr._write_manifest(entries)
    obs["step"] = c.mgr(c.store(seed=4)).restore()
    obs["files"] = _files(c.d / "ckpt")
    assert obs["step"] == 1


def sc_chunked_stager_carries_wire(c, obs):
    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(60))
    st = mgr.begin_chunked_save(step=1)
    while not st.done:
        st.advance(budget_s=0.001)
    st.commit()
    obs["manifest"] = mgr._read_manifest()
    emb2 = c.store(seed=2)
    obs["step"] = c.mgr(emb2).restore()
    obs["restored"] = _state(emb2)


def sc_default_none_stays_bitwise(c, obs):
    emb = c.store()
    mgr = c.mgr(emb)
    emb.gather(np.arange(40))
    mgr.save(step=1)
    obs["manifest"] = mgr._read_manifest()
    emb2 = c.store(seed=3)
    obs["step"] = c.mgr(emb2).restore()
    obs["restored"] = emb2.gather(np.arange(40), insert_missing=False)
    np.testing.assert_array_equal(obs["restored"], emb.gather(np.arange(40), insert_missing=False))
    assert "wire" not in obs["manifest"][-1]


def sc_unknown_wire_format_rejected(c, obs):
    with pytest.raises(ValueError, match="wire_format") as err:
        c.mgr(c.store(), wire_format="fp4")
    obs["message"] = str(err.value)


KINDS = ("plain", "sqlite", "native")
WIRES = ("none", "int8")
SCENARIOS = [
    (sc_delta_saves_only_touched_rows, WIRES),
    (sc_restore_equals_live_state, WIRES),
    (sc_reshard_forces_full, WIRES),
    (sc_restore_then_save_never_collides_with_live_files, WIRES),
    (sc_gc_drops_old_chains, WIRES),
    (sc_manifest_carries_crc_and_nbytes, WIRES),
    (sc_corrupt_delta_truncates_chain_to_good_prefix, WIRES),
    (sc_corrupt_full_falls_back_to_previous_chain, WIRES),
    (sc_all_chains_corrupt_restores_none, WIRES),
    (sc_fault_site_chaos_matrix, WIRES),
    (sc_advance_is_budgeted_and_crc_matches, WIRES),
    (sc_snapshot_is_point_in_time, WIRES),
    (sc_abort_leaves_previous_chain_and_next_delta_complete, WIRES),
    (sc_crash_mid_drain_previous_chain_restorable, WIRES),
    (sc_second_inflight_stager_rejected, WIRES),
    (sc_manifest_carries_wire_and_decoded_crc, ("int8",)),
    (sc_restore_bounded_error, ("int8",)),
    (sc_tampered_decoded_crc_quarantines, ("int8",)),
    (sc_chunked_stager_carries_wire, ("int8",)),
    (sc_default_none_stays_bitwise, ("none",)),
    (sc_unknown_wire_format_rejected, ("none",)),
]
CASES = [
    pytest.param(fn, kind, wire, id=f"{fn.__name__[3:]}-{kind}-{wire}")
    for fn, wires in SCENARIOS for kind in KINDS for wire in wires
]


@pytest.mark.parametrize("scenario,kind,wire", CASES)
def test_ckpt_scenario_matches_jax(scenario, kind, wire, tmp_path, clock):
    result = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        c = Ctx(pkg, kind, wire, d)
        obs = {}
        try:
            scenario(c, obs)
        finally:
            c.close()
        result[pkg.name] = obs
    _assert_equal(result["port"], result["jax"])


# ---------------------------------------------------------------------------
# the wire and the chains across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("chunk_bytes", [64, 256 << 10])
def test_wire_matches_jax(dtype, chunk_bytes):
    x = np.random.default_rng(0).normal(size=(37, 19)).astype(dtype)
    x[3, 4] = 40.0  # an outlier costs only its own chunk
    x[10:12] = 0.0
    q, s = twire.encode_int8(x, chunk_bytes)
    jq, js = jwire.encode_int8(x, chunk_bytes)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    dec = twire.decode_int8(q, s, x.dtype, chunk_bytes)
    np.testing.assert_array_equal(dec, jwire.decode_int8(jq, js, x.dtype, chunk_bytes))
    # idempotent: the decoded payload encodes to the same wire bytes
    np.testing.assert_array_equal(twire.encode_int8(dec, chunk_bytes)[0], q)
    np.testing.assert_array_equal(twire.roundtrip_int8(x, chunk_bytes), dec)
    arrays = {"b": dec, "a": np.arange(5)}
    assert twire.decoded_crc32(arrays) == jwire.decoded_crc32(arrays)
    assert twire.WIRE_FORMATS == jwire.WIRE_FORMATS
    assert twire.quantizable(x) and not twire.quantizable(np.arange(3))
    with pytest.raises(TypeError):
        twire.encode_int8(np.arange(3))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_chain_restores_across_packages(writer, reader, wire, tmp_path, clock):
    """A chain (full, deltas, a delta over evicted rows) written by one
    package's manager over its native tier restores in the other's."""
    w = Ctx(writer, "native", wire, tmp_path / "w")
    (tmp_path / "w").mkdir()
    emb = w.store()
    mgr = w.mgr(emb, full_every=10)
    keys = np.arange(300, dtype=np.int64)
    emb.gather(keys)
    mgr.save(step=1)
    _touch(emb, keys[:40])
    mgr.save(step=2)
    emb.evict_cold(ts_limit=2**62)
    emb.gather(keys[100:120])  # faulted back, then changed
    _touch(emb, keys[100:120])
    mgr.save(step=3)
    live = emb.gather(keys, insert_missing=False)
    widest = max(float(np.max(np.abs(a))) for a in emb.export_state().values()
                 if a.dtype.kind == "f")
    got = {}
    for pkg in (writer, reader):
        r = Ctx(pkg, "native", wire, tmp_path / "w")
        fresh = r.store(seed=5)
        assert r.mgr(fresh).restore() == 3
        got[pkg.name] = fresh.gather(keys, insert_missing=False)
        r.close()
    w.close()
    np.testing.assert_array_equal(got[reader.name], got[writer.name])
    if wire == "none":
        np.testing.assert_array_equal(got[reader.name], live)
    else:
        assert np.max(np.abs(got[reader.name] - live)) <= widest / 127 * 1.01


# ---------------------------------------------------------------------------
# the reference's fault: the tiers' delta cursor moved at the export
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_aborted_delta_keeps_the_evicted_rows_for_the_next(kind, tmp_path, clock):
    """A full save, rows updated, every row evicted to disk, a chunked
    delta begun and aborted, a second delta saved: the JAX chain restores
    the rows from before the update (its tier moved the cold cursor at
    the aborted export); the port's restores the live rows, as the same
    sequence without the abort does in both."""
    keys = np.arange(64, dtype=np.int64)
    restored, live = {}, {}
    for pkg in (JAX, PORT):
        for abort in (True, False):
            d = tmp_path / f"{pkg.name}{abort}"
            d.mkdir()
            c = Ctx(pkg, kind, "none", d)
            emb = c.store()
            mgr = c.mgr(emb, full_every=10)
            emb.gather(keys)
            mgr.save(step=1)
            _touch(emb, keys)
            emb.evict_cold(ts_limit=2**62)
            if abort:
                st = mgr.begin_chunked_save(step=2)
                st.advance(budget_s=0.0)
                st.abort()
            mgr.save(step=3)
            live[pkg.name, abort] = emb.gather(keys, insert_missing=False)
            fresh = c.store(seed=5)
            assert c.mgr(fresh).restore() == 3
            restored[pkg.name, abort] = fresh.gather(keys, insert_missing=False)
            c.close()
    for pkg in ("jax", "port"):
        np.testing.assert_array_equal(restored[pkg, False], live[pkg, False])
    assert not np.array_equal(restored["jax", True], live["jax", True])
    np.testing.assert_array_equal(restored["port", True], live["port", True])
