"""The host-link arbiter's users in the port, on the CPU: the chunked
checkpoint stager (classes, the striped write group, the stage's standing
demand), the sparse tier's two host legs (their streams, the backlog
escalation, the synchronous spill under the tier's lock, a striped
spill), the trainer's compute-window marks driven by the card's events
(stub events here), the eviction drain's EMERGENCY save, and the host
term of the dry runner's ``est_step_s`` and of the auditor's budget.

Every test installs an arbiter of its own (``set_arbiter``) and points
the calibration cache at its tmp dir; threads and waits are bounded."""

import collections
import threading
import time
import types
import uuid
import shutil
import tempfile

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.parallel import transfer_sched as ts
from dlrover_tpu_torch.parallel.transfer_sched import Priority, TransferArbiter


@pytest.fixture(autouse=True)
def arb(monkeypatch, tmp_path):
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path / "topo"))
    ts.reset_calibration()
    a = TransferArbiter(aging_s=0.2, enabled=True)
    ts.set_arbiter(a)
    yield a
    a.shutdown()
    ts.set_arbiter(None)
    ts.reset_calibration()
    faults.reset()


@pytest.fixture
def saver(monkeypatch):
    sock = tempfile.mkdtemp(prefix="dlr")
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"a{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    AsyncCheckpointSaver.reset()
    yield AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    AsyncCheckpointSaver.reset()
    shutil.rmtree(sock, ignore_errors=True)


def _state(seed=0, big=1 << 16):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 8, generator=g),
        "big": torch.randn(big, generator=g),
        "codes": torch.randint(-127, 128, (4, 128), generator=g, dtype=torch.int8),
        "step": 7,
    }


def _wait_lock_free(engine, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not engine._lock.acquire(blocking=False):
        assert time.monotonic() < deadline, "saver kept the shard lock"
        time.sleep(0.02)
    engine._lock.force_release()


def _stage(engine, step, state, d, **kw):
    st = engine.begin_chunked_save(step, state, d, **kw)
    assert st is not None
    assert st.commit()
    _, recs, _ = engine._shm.load_records(copy=True, verify=True)
    metas = {m["path"]: m.get("crc32") for m in engine._shm.metadata()["records"]}
    _wait_lock_free(engine)
    return st, {r.path: r.data.tobytes() for r in recs}, metas


# -- the chunked stager ---------------------------------------------------------


@pytest.mark.parametrize("priority", [None, Priority.EMERGENCY, Priority.BACKPRESSURE])
def test_stage_takes_its_class_and_restores_bitwise(saver, tmp_path, arb, priority):
    engine = CheckpointEngine()
    state = _state()
    st, got, _ = _stage(engine, 3, state, str(tmp_path), chunk_bytes=4096, priority=priority)
    assert st.priority == (Priority.BACKGROUND if priority is None else priority)
    stream = arb.register("ckpt_stage")
    assert stream.direction == "d2h" and stream.grants >= 2  # one grant a write group
    assert stream.bytes_total >= st.total_bytes - 64
    assert stream.demand_bytes_per_step == 0  # the stage is no longer live
    target = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0) for k, v in state.items()}
    step, restored = engine.load(target, str(tmp_path))
    assert step == 3 and engine.last_load_source == "memory"
    for k in ("w", "big", "codes"):
        assert torch.equal(restored[k], state[k])
    engine.close()


def test_stage_demand_is_live_until_commit(saver, tmp_path, arb):
    engine = CheckpointEngine()
    st = engine.begin_chunked_save(1, _state(), str(tmp_path), chunk_bytes=8192)
    assert arb.register("ckpt_stage").demand_bytes_per_step == 8192
    assert "ckpt_stage" in arb.demand()
    assert ts.aggregate_host_exposed_s(arbiter=arb) > 0.0
    assert st.commit()
    assert "ckpt_stage" not in arb.demand()
    _wait_lock_free(engine)
    st2 = engine.begin_chunked_save(2, _state(), str(tmp_path), chunk_bytes=8192)
    st2.abort()
    assert "ckpt_stage" not in arb.demand()
    engine.close()


def test_striped_stage_over_two_rails_is_bitwise_the_single_rail_one(saver, tmp_path, arb):
    """A second card-to-host rail registered (test rails, priced 3:1):
    every window of the big record stripes across both, the record's crc
    (folded through crc32_combine) equals the single-rail stage's, the
    segment verifies, and the restore is bitwise."""
    engine = CheckpointEngine()
    state = _state(big=1 << 18)  # 1 MiB: four 256 KiB windows
    single, bytes1, crc1 = _stage(engine, 1, state, str(tmp_path / "a"),
                                  chunk_bytes=256 << 10, stripe_min_bytes=64 << 10)
    assert single.stripes == 0
    arb.register_rail("host_d2h", gbps=3.0)
    arb.register_rail("host_d2h_1", direction="d2h", gbps=1.0)
    striped, bytes2, crc2 = _stage(engine, 2, state, str(tmp_path / "b"),
                                   chunk_bytes=256 << 10, stripe_min_bytes=64 << 10)
    assert striped.stripes == 4
    assert bytes2 == bytes1 and crc2 == crc1 and None not in crc1.values()
    rails = {r.name: r for r in arb.rails()}
    assert rails["host_d2h"].stripe_chunks > 0 and rails["host_d2h_1"].stripe_chunks > 0
    assert rails["dcn"].stripe_chunks == 0  # the peer rail carries no local copy
    target = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0) for k, v in state.items()}
    _, restored = engine.load(target, str(tmp_path / "b"))
    assert torch.equal(restored["big"], state["big"])
    engine.close()


def test_striped_stage_resends_a_failed_chunk_and_stays_bitwise(saver, tmp_path, arb):
    faults.configure("transfer.stripe:io_error:@2")
    arb.register_rail("host_d2h_1", direction="d2h", gbps=1.0)
    engine = CheckpointEngine()
    state = _state(big=1 << 17)
    st, got, _ = _stage(engine, 4, state, str(tmp_path), chunk_bytes=256 << 10,
                        stripe_min_bytes=64 << 10)
    assert st.stripes >= 1
    assert got["big"] == state["big"].numpy().tobytes()
    engine.close()


def test_emergency_stage_preempts_a_background_holder(saver, tmp_path, arb):
    """A BACKGROUND stream holds the card-to-host rail, moving chunks:
    the EMERGENCY stage flags it, it yields at its next chunk boundary,
    and the stage's grant wait is about one chunk, not the holder's
    whole transfer."""
    bg = arb.register("spill_like", Priority.BACKGROUND, "d2h")
    started, stop, yields = threading.Event(), threading.Event(), []

    def holder():
        while not stop.is_set():
            g = bg.acquire(1 << 20, ignore_window=True)
            started.set()
            for _ in range(200):  # a 2 s transfer in 10 ms chunks
                time.sleep(0.01)
                if stop.is_set():
                    break
                if g.should_yield():
                    yields.append(1)
                    break
            g.release()
            time.sleep(0.001)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert started.wait(5.0)
    engine = CheckpointEngine()
    st = engine.begin_chunked_save(5, _state(), str(tmp_path), priority=Priority.EMERGENCY)
    assert st.commit()
    stop.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert yields and arb.preemptions >= 1
    assert 0.0 < st.grant_wait_s < 1.0
    engine.close()


# -- the sparse tier's host legs -------------------------------------------------


def _tier(**kw):
    from dlrover_tpu_torch.ops.embedding import ShardedKvEmbedding
    from dlrover_tpu_torch.ops.embedding.device_tier import DeviceSparseEmbedding

    kw.setdefault("capacity", 16)
    return DeviceSparseEmbedding(
        ShardedKvEmbedding(2, 8, num_slots=1, seed=0), sparse_optimizer="adagrad",
        devices="cpu", **kw,
    )


def test_tier_registers_its_two_streams_and_prices_its_host_leg(arb):
    emb = _tier(table_name="arb_t")
    prep = emb.prepare(np.arange(12, dtype=np.int64))
    emb.release(prep)
    fault = arb.register("emb_fault:arb_t")
    spill = arb.register("emb_spill:arb_t")
    assert (fault.priority, fault.direction) == (Priority.BACKPRESSURE, "h2d")
    assert (spill.priority, spill.direction) == (Priority.BACKGROUND, "d2h")
    assert fault.grants == 1 and fault.bytes_total == 12 * 16 * 4  # full rows
    scalars = emb.export_metrics()
    assert scalars["emb_host_leg_ms"] > 0.0
    assert fault.demand_bytes_per_step > 0  # export_metrics refreshed it
    assert ts.aggregate_host_exposed_s(arbiter=arb) > 0.0
    emb.close()


def test_spill_backlog_escalates_to_backpressure(arb):
    """The drain's first spill waits behind a held rail at BACKGROUND;
    while it waits three more are queued, so the next one it takes sees
    a backlog of two and asks for BACKPRESSURE."""
    emb = _tier(capacity=64, table_name="arb_e")
    ids = np.arange(32, dtype=np.int64)
    emb.release(emb.prepare(ids))
    slots = emb.hot.lookup(ids)
    emb.hot._dirty[slots] = True
    asked = []
    real = emb._spill_stream.transfer

    def spy(nbytes, priority=None, **kw):
        asked.append(priority)
        return real(nbytes, priority=priority, **kw)

    emb._spill_stream.transfer = spy
    g = arb.register("blocker", Priority.BACKGROUND, "d2h").acquire(1)
    with emb._lock:
        emb._spill(slots[:8])
    deadline = time.monotonic() + 5.0
    while not asked:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    with emb._lock:
        for lo in (8, 16, 24):
            emb._spill(slots[lo:lo + 8])
    g.release()
    emb.join_spills(timeout=10.0)
    assert asked[0] == Priority.BACKGROUND
    assert asked[1] == Priority.BACKPRESSURE
    assert len(asked) == 4 and emb.stats.spill_rows == 32
    emb.close()


def test_sync_spill_under_the_lock_never_waits_on_a_held_link(arb):
    emb = _tier(capacity=8, table_name="arb_s", async_spill=False)
    ids = np.arange(8, dtype=np.int64)
    emb.release(emb.prepare(ids))
    slots = emb.hot.lookup(ids)
    emb.hot._dirty[slots] = True
    g = arb.register("blocker", Priority.EMERGENCY).acquire(1)
    t0 = time.perf_counter()
    with emb._lock:
        emb._spill(slots)
    assert time.perf_counter() - t0 < 2.0
    assert arb.forced_grants == 0
    g.release()
    assert emb.stats.spill_rows == 8
    assert arb.register("emb_spill:arb_s").grants == 0
    emb.close()


def test_large_spill_stripes_its_copy_over_two_rails(arb):
    arb.register_rail("host_d2h_1", direction="d2h", gbps=1.0)
    emb = _tier(capacity=64, table_name="arb_x", spill_stripe_min_bytes=1024)
    ids = np.arange(40, dtype=np.int64)
    emb.release(emb.prepare(ids))
    slots = emb.hot.lookup(ids)
    emb.hot._dirty[slots] = True
    want = emb.hot.table[torch.as_tensor(slots)].numpy().copy()
    with emb._lock:
        emb._spill(slots)
    emb.join_spills(timeout=10.0)
    # one row range here (a range is 8 MiB of rows), on one of the rails
    chunks = {r.name: r.stripe_chunks for r in arb.rails()}
    assert chunks["host_d2h"] + chunks["host_d2h_1"] == 1 and chunks["dcn"] == 0
    rows, _f, _t, present = emb.host.export_rows(ids)
    assert present.all()
    np.testing.assert_array_equal(rows, want)
    emb.close()


# -- the trainer --------------------------------------------------------------------


class _StubEvent:
    """A CUDA event stand-in: the step's end has passed once ``passed``."""

    passed = False

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        pass

    def query(self):
        return _StubEvent.passed

    def synchronize(self):
        _StubEvent.passed = True

    def elapsed_time(self, other):
        return 1.5


def test_window_marks_follow_the_card_not_the_host(arb, monkeypatch):
    """On the card ``_run_step`` returns at enqueue: the window stays
    open while the step's end event is pending, however long the host
    takes, and closes when ``_book_compute`` finds it passed."""
    from dlrover_tpu_torch.trainer.elastic import trainer as tr

    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    _StubEvent.passed = False
    fake = types.SimpleNamespace(
        device=torch.device("cuda"), state="s", _pending_compute=collections.deque(),
        _device_free_ns=0, _step_fn=lambda state, x, y: (state, {"loss": 0.0}),
    )
    fake._book_compute = types.MethodType(tr.ElasticTrainer._book_compute, fake)
    tr.ElasticTrainer._run_step(fake, None, None, 1)
    assert arb.in_compute_window()  # dispatched, pending on the card
    time.sleep(0.02)
    fake._book_compute()
    assert arb.in_compute_window() and len(fake._pending_compute) == 1
    _StubEvent.passed = True
    fake._book_compute()
    assert not arb.in_compute_window() and not fake._pending_compute
    # a second step, booked by waiting (the log-cadence sync)
    _StubEvent.passed = False
    tr.ElasticTrainer._run_step(fake, None, None, 1)
    assert arb.in_compute_window()
    fake._book_compute(wait=True)
    assert not arb.in_compute_window()


def test_cpu_step_marks_the_window_around_the_call(arb):
    from dlrover_tpu_torch.trainer.elastic import trainer as tr

    seen = []

    def step_fn(state, x, y):
        seen.append(arb.in_compute_window())
        return state, {}

    fake = types.SimpleNamespace(device=torch.device("cpu"), state="s", _step_fn=step_fn)
    tr.ElasticTrainer._run_step(fake, None, None, 1)
    assert seen == [True] and not arb.in_compute_window()


def test_eviction_drain_saves_at_emergency(arb):
    from dlrover_tpu_torch.trainer.elastic import trainer as tr

    asked = {}

    class Stager:
        done = True
        priority = Priority.EMERGENCY
        grant_wait_s = 0.012

        def commit(self, stats=None):
            return True

    def begin(step, state, chunk_bytes, priority=None):
        asked.update(step=step, priority=priority)
        return Stager()

    fake = types.SimpleNamespace(
        _abort_stager=lambda: None,
        _ckptr=types.SimpleNamespace(
            engine=types.SimpleNamespace(wait_saver_idle=lambda t: True),
            begin_chunked_save=begin,
        ),
        _ckpt_state=lambda: {},
        tcfg=types.SimpleNamespace(stage_chunk_mb=64),
        pipeline_stats=None,
        _note_save=lambda *a, **k: None,
        eviction_report={},
    )
    assert tr.ElasticTrainer._emergency_save(fake, 9, time.monotonic() + 30.0)
    assert asked == {"step": 9, "priority": Priority.EMERGENCY}
    assert fake.eviction_report["priority"] == "EMERGENCY"
    assert fake.eviction_report["grant_wait_ms"] == pytest.approx(12.0)


def test_audit_budget_prices_host_xfer_from_the_arbiter(arb):
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.obs.audit import StepAuditor
    from dlrover_tpu_torch.trainer.elastic import trainer as tr

    fake = types.SimpleNamespace(
        _audit_cal_loaded=True, _link_fp="", strategy=Strategy(), _grad_sync_plan=None,
        state=types.SimpleNamespace(
            params=types.SimpleNamespace(jax_ordered_parameters=lambda: [torch.zeros(4)])
        ),
        pipeline_stats=types.SimpleNamespace(grad_sync_ici_ms=0.0, grad_sync_dcn_ms=0.0),
        _auditor=StepAuditor(),
    )
    tr.ElasticTrainer._setup_audit_budget(fake)
    assert fake._auditor.budget().host_xfer_s == 0.0
    arb.set_demand("ckpt_stage", 64 << 20, direction="d2h")
    tr.ElasticTrainer._setup_audit_budget(fake)
    b = fake._auditor.budget()
    assert b.host_xfer_s == pytest.approx(ts.aggregate_host_exposed_s()) and b.host_xfer_s > 0.0
    assert b.source["host_xfer"] == "priced"


# -- the dry runner ---------------------------------------------------------------


def test_est_step_s_moves_with_registered_demand_and_the_calibration(arb):
    from dlrover_tpu_torch.accel import dry_runner as dr
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import config
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    cfg, tx = config.tiny(num_layers=1), build_optimizer("sgd", lr=1e-2)
    r0 = dr.compiled_cost(Strategy(), cfg, tx, 2, 16, 1)
    assert r0.ok, r0.error
    assert (r0.host_exposed_s, r0.host_hidden_measured) == (0.0, False)
    arb.set_demand("ckpt_stage", 256 << 20, direction="d2h")
    r1 = dr.compiled_cost(Strategy(), cfg, tx, 2, 16, 1)
    assert r1.host_exposed_s > 0.0 and not r1.host_hidden_measured
    assert r1.est_step_s == pytest.approx(r0.est_step_s + r1.host_exposed_s)
    # the reprice's host factor now moves the estimate
    assert dr.reprice_report(r1, {"host_xfer": 3.0}) == pytest.approx(
        r1.est_step_s + 2.0 * r1.host_exposed_s
    )
    ts.set_calibration(ts.ArbiterCalibration(
        fingerprint=ts._current_fingerprint(), hidden_fraction={"host_d2h": 0.9, "host_h2d": 0.9}
    ))
    r2 = dr.compiled_cost(Strategy(), cfg, tx, 2, 16, 1)
    assert r2.host_hidden_measured and r2.host_exposed_s < r1.host_exposed_s
    arb.shutdown()  # serialized: all of it exposed
    r3 = dr.compiled_cost(Strategy(), cfg, tx, 2, 16, 1)
    assert r3.host_exposed_s > r1.host_exposed_s


def test_trainer_calibrates_at_link_probe_time_and_survives_a_failure(arb, monkeypatch):
    from dlrover_tpu_torch.parallel import topology
    from dlrover_tpu_torch.trainer.elastic import trainer as tr

    fake = types.SimpleNamespace(device=torch.device("cpu"), mesh=None, _link_fp="",
                                 _registry=None)
    monkeypatch.setattr(topology, "probe_link_model",
                        lambda devices=None, mesh=None: topology.fallback_link_model("x"))
    monkeypatch.setattr(topology, "export_link_metrics", lambda m, r=None: None)
    calls = []
    monkeypatch.setattr(ts, "ensure_calibrated", lambda: calls.append(1))
    tr.ElasticTrainer._setup_link_model(fake)
    assert calls == [1] and fake._link_fp
    fake._link_fp = ""

    def boom():
        raise RuntimeError("probe died")

    monkeypatch.setattr(ts, "ensure_calibrated", boom)
    tr.ElasticTrainer._setup_link_model(fake)  # logged, never raised
