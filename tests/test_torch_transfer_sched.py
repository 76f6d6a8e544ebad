"""The port's host-link arbiter (``dlrover_tpu_torch.parallel.
transfer_sched``) against the JAX package's (``dlrover_tpu.parallel.
transfer_sched``), on the CPU.

Every scenario below is scripted once and run through both modules; each
returns what it observed (grant orders, counts, flags, plans, digests,
prices), and the two results must be EQUAL, besides meeting the
scenario's own expectation. Threads are bounded: every join and wait
has a timeout, and the assertions are on orders and counts, never on
tight wall times (the suite runs six workers on a shared box)."""

import logging
import os
import threading
import time
import zlib

import numpy as np
import pytest

import dlrover_tpu.parallel.transfer_sched as jts
import dlrover_tpu_torch.parallel.transfer_sched as pts

MODULES = {"jax": jts, "port": pts}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """A topology cache of the test's own, no inherited calibration,
    faults or process arbiter, in either package."""
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path / "topo"))
    monkeypatch.delenv("DLROVER_TPU_TRANSFER_ARBITER", raising=False)
    for ts in MODULES.values():
        ts.reset_calibration()
        ts.faults.reset()
    yield
    for ts in MODULES.values():
        ts.reset_calibration()
        ts.faults.reset()
        ts.set_arbiter(None)


def _arb(ts, **kw):
    kw.setdefault("aging_s", 0.2)
    kw.setdefault("enabled", True)
    return ts.TransferArbiter(**kw)


def _join(*threads):
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive(), f"{t.name} wedged"


# -- scripted scenarios: each takes a transfer_sched module --------------------


def grant_order_under_contention(ts):
    """With the rail held, waiters are granted by class (EMERGENCY, then
    BACKPRESSURE, then BACKGROUND), whatever order they came in."""
    a = _arb(ts, aging_s=30.0)
    holder = a.register("holder")
    g = holder.acquire(1)
    order, threads = [], []
    for name, prio in (("bg", ts.Priority.BACKGROUND), ("bp", ts.Priority.BACKPRESSURE),
                       ("em", ts.Priority.EMERGENCY)):
        st = a.register(name, prio)

        def run(st=st, name=name):
            with st.transfer(1):
                order.append(name)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        threads.append(t)
        time.sleep(0.03)
    g.release()
    _join(*threads)
    a.shutdown()
    return {"order": order, "preemptions": a.preemptions}


def emergency_preempts_at_chunk_boundary(ts):
    """A BACKGROUND holder moving 20 chunks is flagged by an EMERGENCY
    waiter, yields at its next chunk boundary, and regains the rail only
    after the emergency transfer is done."""
    a = _arb(ts)
    bg = a.register("stage", ts.Priority.BACKGROUND)
    em = a.register("drain", ts.Priority.EMERGENCY)
    order, started = [], threading.Event()

    def holder():
        left = 20
        while left:
            g = bg.acquire(1 << 20, ignore_window=True)
            order.append("bg_granted")
            started.set()
            while left:
                time.sleep(0.004)
                left -= 1
                if g.should_yield():
                    order.append("bg_yield")
                    break
            g.release()

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert started.wait(5.0)
    with em.transfer(1 << 20):
        order.append("em_granted")
    order.append("em_done")
    _join(t)
    a.shutdown()
    i_done = order.index("em_done")
    regrants = [i for i, o in enumerate(order) if o == "bg_granted" and i > order.index("bg_yield")]
    return {
        "yielded": "bg_yield" in order,
        "regrant_after_emergency": bool(regrants) and min(regrants) > i_done,
        "preemptions": a.preemptions,
        "bg_yields": bg.yields,
        "bg_grants_ge_2": bg.grants >= 2,
    }


def aging_bounds_starvation(ts):
    """A BACKGROUND waiter under a constant BACKPRESSURE storm is granted
    within about two aging periods (a generous 1.5 s here, aging 0.2 s)."""
    a = _arb(ts)
    storm = a.register("storm", ts.Priority.BACKPRESSURE)
    bg = a.register("starved", ts.Priority.BACKGROUND)
    stop = threading.Event()

    def stormer():
        while not stop.is_set():
            with storm.transfer(1):
                time.sleep(0.01)

    t = threading.Thread(target=stormer, daemon=True)
    t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    with bg.transfer(1):
        waited = time.perf_counter() - t0
    stop.set()
    _join(t)
    a.shutdown()
    return {"granted": True, "within_bound": waited < 1.5, "storm_ran": storm.grants > 1}


def window_defers_background(ts):
    """Outside a fresh compute window a BACKGROUND grant waits (a
    BACKPRESSURE one does not, nor one that ignores the window); opening
    the window releases it."""
    a = _arb(ts, aging_s=30.0)
    a.note_compute(False)
    bp = a.register("bp", ts.Priority.BACKPRESSURE)
    with bp.transfer(1) as g_bp:
        bp_passed = not g_bp.passthrough
    st = a.register("stage", ts.Priority.BACKGROUND)
    with st.transfer(1, ignore_window=True) as g_st:
        ignore_passed = not g_st.passthrough
    bg = a.register("bg", ts.Priority.BACKGROUND)
    got = {}

    def take():
        with bg.transfer(1):
            got["t"] = time.perf_counter()

    t = threading.Thread(target=take, daemon=True)
    t.start()
    time.sleep(0.1)
    deferred = "t" not in got
    t_open = time.perf_counter()
    a.note_compute(True)
    _join(t)
    in_window = a.in_compute_window()
    a.shutdown()
    return {
        "bp_immediate": bp_passed,
        "ignore_window_immediate": ignore_passed,
        "bg_deferred": deferred,
        "bg_after_open": got["t"] >= t_open,
        "in_window": in_window,
    }


def window_marks_expire(ts):
    """Marks older than WINDOW_TTL_S stop gating: an arbiter whose
    trainer went away is a pass-through for BACKGROUND grants."""
    a = _arb(ts, aging_s=30.0)
    a.note_compute(False)
    a._last_mark -= ts.WINDOW_TTL_S + 1.0
    bg = a.register("bg", ts.Priority.BACKGROUND)
    done = threading.Event()

    def take():
        with bg.transfer(1):
            done.set()

    t = threading.Thread(target=take, daemon=True)
    t.start()
    ok = done.wait(2.0)
    _join(t)
    a.shutdown()
    return {"granted": ok, "in_window": a.in_compute_window(), "ttl": ts.WINDOW_TTL_S}


def disabled_is_passthrough(ts):
    a = ts.TransferArbiter(enabled=False)
    st = a.register("x")
    g1, g2 = st.acquire(10), st.acquire(10)
    out = {"g1": g1.passthrough, "g2": g2.passthrough, "scheduling": a.scheduling_active}
    g1.release()
    g2.release()
    out["bytes"] = st.bytes_total
    return out


def env_switch_disables(ts):
    old = os.environ.get(ts.ENV_ARBITER)
    os.environ[ts.ENV_ARBITER] = "off"
    try:
        off = ts.TransferArbiter().enabled
    finally:
        if old is None:
            os.environ.pop(ts.ENV_ARBITER)
        else:
            os.environ[ts.ENV_ARBITER] = old
    return {"off": off, "on": ts.TransferArbiter().enabled, "name": ts.ENV_ARBITER}


def shutdown_releases_waiters(ts):
    """Shutdown while a wedged holder owns the rail: the waiter wakes
    with a pass-through grant, later acquires never block, and the
    holder's late release is a no-op."""
    a = _arb(ts)
    g = a.register("wedged").acquire(1)
    waiter = a.register("waiter")
    got = {}

    def blocked():
        got["g"] = waiter.acquire(1)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.05)
    blocked_before = "g" not in got
    a.shutdown()
    _join(t)
    with waiter.transfer(1) as g2:
        later = g2.passthrough
    g.release()
    return {
        "blocked_before": blocked_before,
        "woke_passthrough": got["g"].passthrough,
        "later_passthrough": later,
        "scheduling": a.scheduling_active,
    }


def forced_grant_on_wedged_holder(ts):
    a = _arb(ts)
    a.register("wedge").acquire(1)  # never released
    t0 = time.perf_counter()
    g = a.register("w").acquire(1, timeout=0.2)
    waited = time.perf_counter() - t0
    a.shutdown()
    return {
        "passthrough": g.passthrough,
        "forced": a.forced_grants,
        "bounded": 0.15 < waited < 2.0,
        "default_timeout": ts.TransferArbiter.DEFAULT_TIMEOUT_S,
    }


def rails_and_routing(ts):
    """Default rails, routing by direction, the peer rail in
    ``rails_for``, admission, and concurrent grants on two rails."""
    a = _arb(ts)
    a.register_rail("railX", direction="d2h", gbps=5.0, admit=[ts.Priority.EMERGENCY])
    d2h = a.register("out", direction="d2h")
    h2d = a.register("in", direction="h2d")
    g1 = d2h.acquire(1)
    g2 = h2d.acquire(1)  # another rail: not blocked by g1
    out = {
        "rails": sorted(r.name for r in a.rails()),
        "g1": g1.rail,
        "g2": g2.rail,
        "bg_d2h": [r.name for r in a.rails_for("d2h")],
        "em_d2h": [r.name for r in a.rails_for("d2h", ts.Priority.EMERGENCY)],
        "h2d": [r.name for r in a.rails_for("h2d")],
        "gbps": a.rail_gbps("railX"),
    }
    g1.release()
    g2.release()
    a.shutdown()
    return out


def crc32_combine_is_bitwise(ts):
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, size=300_001, dtype=np.uint8).tobytes()
    cuts = [0, 1, 4096, 70_000, 299_999, len(payload)]
    folded = 0
    for lo, hi in zip(cuts, cuts[1:]):
        folded = ts.crc32_combine(folded, zlib.crc32(payload[lo:hi]), hi - lo)
    return {
        "folded": folded,
        "whole": zlib.crc32(payload),
        "seed_zero": ts.crc32_combine(0, 123456, 10),
        "empty_tail": ts.crc32_combine(987654, 0, 0),
    }


def stripe_plan_shares(ts):
    a = _arb(ts)
    a.register_rail("railA", direction="d2h", gbps=3.0)
    a.register_rail("railB", direction="d2h", gbps=1.0)
    st = ts.StripedTransfer(a, direction="d2h", chunk_bytes=1 << 20, rails=["railA", "railB"])
    plan = st.plan((64 << 20) + 12345)
    per = {}
    for rail, _off, ln in plan:
        per[rail] = per.get(rail, 0) + ln
    a.shutdown()
    return {"plan": plan, "per": per, "n": len(plan)}


def stripe_run_bitwise(ts):
    a = _arb(ts)
    a.register_rail("railA", direction="d2h", gbps=2.0)
    a.register_rail("railB", direction="d2h", gbps=1.0)
    st = ts.StripedTransfer(a, name="t", direction="d2h", chunk_bytes=64 << 10,
                            rails=["railA", "railB"], ignore_window=True)
    payload = np.random.default_rng(0).integers(0, 256, size=1 << 20, dtype=np.uint8)
    dest = np.zeros_like(payload)

    def mover(rail, off, ln):
        dest[off:off + ln] = payload[off:off + ln]

    rep = st.run(mover, payload=payload)
    a.shutdown()
    return {
        "bitwise": dest.tobytes() == payload.tobytes(),
        "crc": rep.crc32,
        "crc_ok": rep.crc32 == zlib.crc32(payload.tobytes()),
        "rail_bytes": dict(sorted(rep.rail_bytes.items())),
        "chunks": rep.chunks,
        "stripe_chunks": {r.name: r.stripe_chunks for r in a.rails()},
    }


def stripe_items_lpt(ts):
    a = _arb(ts)
    a.register_rail("railA", direction="d2h", gbps=1.0)
    a.register_rail("railB", direction="d2h", gbps=1.0)
    st = ts.StripedTransfer(a, direction="d2h", rails=["railA", "railB"], ignore_window=True)
    moved, lock = {}, threading.Lock()

    def mover(rail, key):
        with lock:
            moved[key] = rail

    rep = st.run_items([(f"k{i}", (i + 1) << 16) for i in range(8)], mover)
    a.shutdown()
    return {"moved": sorted(moved), "chunks": dict(sorted(rep.rail_chunks.items())),
            "bytes": dict(sorted(rep.rail_bytes.items()))}


def stripe_resend_on_fault_site(ts):
    """``transfer.stripe:io_error:@2`` kills exactly the second chunk
    evaluation: that rail's chunks are re-sent on the survivor and the
    folded crc is still the payload's."""
    ts.faults.configure("transfer.stripe:io_error:@2")
    a = _arb(ts)
    a.register_rail("railA", direction="d2h", gbps=1.0)
    a.register_rail("dcn", gbps=1.0)
    st = ts.StripedTransfer(a, direction="d2h", chunk_bytes=64 << 10,
                            rails=["railA", "dcn"], ignore_window=True)
    payload = np.random.default_rng(2).integers(0, 256, size=1 << 20, dtype=np.uint8)
    dest = np.zeros_like(payload)

    def mover(rail, off, ln):
        dest[off:off + ln] = payload[off:off + ln]

    rep = st.run(mover, payload=payload)
    a.shutdown()
    return {
        "bitwise": dest.tobytes() == payload.tobytes(),
        "crc_ok": rep.crc32 == zlib.crc32(payload.tobytes()),
        "failed": len(rep.failed_rails),
        "requeued": rep.requeued_chunks >= 1,
        "chunks": rep.chunks,
    }


def stripe_all_rails_fail(ts):
    a = _arb(ts)
    a.register_rail("railA", direction="d2h", gbps=1.0)
    a.register_rail("railB", direction="d2h", gbps=1.0)
    st = ts.StripedTransfer(a, direction="d2h", chunk_bytes=64 << 10,
                            rails=["railA", "railB"], ignore_window=True)

    def mover(rail, off, ln):
        raise OSError(f"{rail} down")

    try:
        st.run(mover, nbytes=1 << 20)
        raised = None
    except OSError as e:
        raised = "down" in str(e)
    try:
        ts.StripedTransfer(a, direction="d2h", rails=[]).plan(1 << 20)
        no_rails = None
    except RuntimeError as e:
        no_rails = str(e)
    a.shutdown()
    return {"raised": raised, "no_rails": no_rails}


def aggregate_exposed_for_demand(ts):
    """The same demand and calibration price the same exposed seconds:
    the busier direction's remainder when scheduling, the serialized sum
    when shut down. Each package prices through its own ``LinkModel``,
    built here from one JSON."""
    topo = pts_topology() if ts is pts else jts_topology()
    model = topo.LinkModel.from_json(_MODEL_JSON)
    a = _arb(ts)
    a.set_demand("ckpt_stage", 64 << 20, direction="d2h")
    a.set_demand("emb_fault:t0", 8 << 20, ts.Priority.BACKPRESSURE, direction="h2d")
    a.set_demand("idle", 0)
    cal = ts.ArbiterCalibration(fingerprint="fp", hidden_fraction={"host_d2h": 0.9, "host_h2d": 0.2})
    out = {
        "measured": ts.aggregate_host_exposed_s(model=model, arbiter=a, calibration=cal),
        "constant": ts.aggregate_host_exposed_s(model=model, arbiter=a),
        "demand": sorted(a.demand()),
    }
    a.shutdown()
    out["serialized"] = ts.aggregate_host_exposed_s(model=model, arbiter=a)
    out["none"] = ts.aggregate_host_exposed_s(model=model, arbiter=_arb(ts))
    return out


def hidden_fraction_lookup(ts):
    cal = ts.ArbiterCalibration(fingerprint="fp", hidden_fraction={"host_d2h": 1.7, "host_h2d": -0.3})
    return {
        "clamped_hi": ts.hidden_fraction_for("host_d2h", cal),
        "clamped_lo": ts.hidden_fraction_for("host_h2d", cal),
        "fallback": ts.hidden_fraction_for("dcn", cal),
        "constant": ts.HOST_HIDDEN_FRACTION,
    }


def calibration_measures_and_caches(ts, tmp):
    """A cold A/B measures both host rails, persists under the
    fingerprint and installs itself; a warm call returns the cached
    reading; the switch turns calibration off."""
    cache = os.path.join(tmp, ts.__name__.split(".")[0])
    kw = dict(steps=1, compute_s=0.004, chunks=2, chunk_s=0.002)
    cold = ts.calibrate_hidden_fraction(cache_dir=cache, force=True, **kw)
    ts.reset_calibration()
    warm = ts.calibrate_hidden_fraction(cache_dir=cache, **kw)
    os.environ[ts.ENV_CALIBRATE] = "0"
    try:
        off = ts.ensure_calibrated(cache_dir=cache)
    finally:
        os.environ.pop(ts.ENV_CALIBRATE)
    return {
        "rails": sorted(cold.hidden_fraction),
        "in_range": all(0.0 <= v <= 0.95 for v in cold.hidden_fraction.values()),
        "warm_is_cached": warm.measured_at == cold.measured_at,
        "current_is_warm": ts.get_calibration() is warm,
        "file": os.path.basename(ts.calibration_path(cold.fingerprint, cache)).split("-")[0],
        "off": off,
    }


def calibration_cache_degrades(ts, tmp):
    """A stale (another world's) or corrupt cache file reads as no
    calibration; an unwritable cache dir makes the save a logged no-op
    and pricing falls back to the constant, logged once."""
    cache = os.path.join(tmp, "c-" + ts.__name__.split(".")[0])
    os.makedirs(cache, exist_ok=True)
    stale = ts.ArbiterCalibration(fingerprint="other-world", hidden_fraction={"host_d2h": 0.1})
    with open(ts.calibration_path("this-world", cache), "w") as f:
        f.write(stale.to_json())
    stale_read = ts.load_calibration("this-world", cache)
    with open(ts.calibration_path("corrupt", cache), "w") as f:
        f.write("{not json")
    corrupt_read = ts.load_calibration("corrupt", cache)
    broken = os.path.join(tmp, "not-a-dir-" + ts.__name__.split(".")[0])
    with open(broken, "w") as f:
        f.write("occupied")
    saved = ts.save_calibration(stale, broken)
    logs = []
    h = _Capture(logs)
    ts.logger.addHandler(h)
    try:
        ts.reset_calibration()
        hf = [ts.hidden_fraction_for("host_d2h"), ts.hidden_fraction_for("host_h2d")]
    finally:
        ts.logger.removeHandler(h)
    return {
        "stale": stale_read,
        "corrupt": corrupt_read,
        "saved": saved,
        "fallback": hf,
        "fallback_logs": sum("HOST_HIDDEN_FRACTION" in m for m in logs),
    }


SCENARIOS = {
    f.__name__: f
    for f in (
        grant_order_under_contention,
        emergency_preempts_at_chunk_boundary,
        aging_bounds_starvation,
        window_defers_background,
        window_marks_expire,
        disabled_is_passthrough,
        env_switch_disables,
        shutdown_releases_waiters,
        forced_grant_on_wedged_holder,
        rails_and_routing,
        crc32_combine_is_bitwise,
        stripe_plan_shares,
        stripe_run_bitwise,
        stripe_items_lpt,
        stripe_resend_on_fault_site,
        stripe_all_rails_fail,
        aggregate_exposed_for_demand,
        hidden_fraction_lookup,
    )
}

# what each scenario must show (beyond agreeing across the packages)
EXPECT = {
    "grant_order_under_contention": lambda r: r["order"] == ["em", "bp", "bg"],
    "emergency_preempts_at_chunk_boundary": lambda r: r["yielded"] and r["regrant_after_emergency"]
    and r["preemptions"] == 1 and r["bg_yields"] == 1,
    "aging_bounds_starvation": lambda r: r["within_bound"] and r["storm_ran"],
    "window_defers_background": lambda r: all(r.values()),
    "window_marks_expire": lambda r: r["granted"] and not r["in_window"],
    "disabled_is_passthrough": lambda r: r["g1"] and r["g2"] and not r["scheduling"] and r["bytes"] == 20,
    "env_switch_disables": lambda r: r["off"] is False and r["on"] is True,
    "shutdown_releases_waiters": lambda r: r["blocked_before"] and r["woke_passthrough"]
    and r["later_passthrough"] and not r["scheduling"],
    "forced_grant_on_wedged_holder": lambda r: r["passthrough"] and r["forced"] == 1 and r["bounded"],
    "rails_and_routing": lambda r: r["g1"] == "host_d2h" and r["g2"] == "host_h2d"
    and r["bg_d2h"] == ["host_d2h", "dcn"] and r["em_d2h"] == ["host_d2h", "railX", "dcn"],
    "crc32_combine_is_bitwise": lambda r: r["folded"] == r["whole"] and r["seed_zero"] == 123456
    and r["empty_tail"] == 987654,
    "stripe_plan_shares": lambda r: sum(r["per"].values()) == (64 << 20) + 12345
    and abs(r["per"]["railA"] - 3 * r["per"]["railB"]) <= 4,
    "stripe_run_bitwise": lambda r: r["bitwise"] and r["crc_ok"] and len(r["rail_bytes"]) == 2,
    "stripe_items_lpt": lambda r: len(r["moved"]) == 8 and sum(r["chunks"].values()) == 8,
    "stripe_resend_on_fault_site": lambda r: r["bitwise"] and r["crc_ok"] and r["failed"] == 1
    and r["requeued"] and r["chunks"] == 16,
    "stripe_all_rails_fail": lambda r: r["raised"] is True and "no admitted rails" in r["no_rails"],
    "aggregate_exposed_for_demand": lambda r: 0.0 < r["measured"] < r["constant"] < r["serialized"]
    and r["none"] == 0.0,
    "hidden_fraction_lookup": lambda r: r["clamped_hi"] == 0.95 and r["clamped_lo"] == 0.0
    and r["fallback"] == r["constant"],
}

class _Capture(logging.Handler):
    """Collects messages (the repo's loggers do not propagate, so caplog
    sees nothing)."""

    def __init__(self, out):
        super().__init__()
        self._out = out

    def emit(self, record):
        self._out.append(record.getMessage())


_MODEL_JSON = None


def pts_topology():
    from dlrover_tpu_torch.parallel import topology

    return topology


def jts_topology():
    from dlrover_tpu.parallel import topology

    return topology


@pytest.fixture(scope="module", autouse=True)
def _model_json():
    """One link model both packages read (their JSON formats agree)."""
    global _MODEL_JSON
    m = pts_topology().fallback_link_model("fp", source="measured")
    _MODEL_JSON = m.to_json()
    yield


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_the_jax_arbiter(name):
    got = {pkg: SCENARIOS[name](ts) for pkg, ts in MODULES.items()}
    assert got["port"] == got["jax"], got
    assert EXPECT[name](got["port"]), got["port"]


@pytest.mark.parametrize("name", ["calibration_measures_and_caches", "calibration_cache_degrades"])
def test_calibration_scenario_agrees_with_the_jax_arbiter(name, tmp_path):
    fn = globals()[name]
    got = {pkg: fn(ts, str(tmp_path)) for pkg, ts in MODULES.items()}
    assert got["port"] == got["jax"], got
    if name == "calibration_measures_and_caches":
        r = got["port"]
        assert r["rails"] == ["host_d2h", "host_h2d"] and r["in_range"]
        assert r["warm_is_cached"] and r["current_is_warm"] and r["file"] == "arbcal"
        assert r["off"] is None
    else:
        r = got["port"]
        assert r["stale"] is None and r["corrupt"] is None and r["saved"] is None
        assert r["fallback"] == [pts.HOST_HIDDEN_FRACTION] * 2 and r["fallback_logs"] == 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_calibration_file_written_by_one_reads_in_the_other(writer, reader, tmp_path):
    w, r = MODULES[writer], MODULES[reader]
    cal = w.ArbiterCalibration(
        fingerprint="fp-shared", hidden_fraction={"host_d2h": 0.625, "host_h2d": 0.125},
        measured_at=12.5,
    )
    path = w.save_calibration(cal, str(tmp_path))
    assert path == r.calibration_path("fp-shared", str(tmp_path))
    back = r.load_calibration("fp-shared", str(tmp_path))
    assert back is not None
    assert (back.fingerprint, back.hidden_fraction, back.measured_at, back.source) == (
        cal.fingerprint, cal.hidden_fraction, cal.measured_at, cal.source
    )
    assert r.load_calibration("fp-other", str(tmp_path)) is None


def test_same_public_surface_as_the_jax_module():
    names = [
        "Priority", "Rail", "Grant", "TransferStream", "TransferArbiter", "StripedTransfer",
        "StripeReport", "crc32_combine", "get_arbiter", "set_arbiter", "note_compute",
        "ArbiterCalibration", "calibrate_hidden_fraction", "ensure_calibrated",
        "load_calibration", "save_calibration", "get_calibration", "set_calibration",
        "reset_calibration", "hidden_fraction_for", "aggregate_host_exposed_s",
        "WINDOW_TTL_S", "DEFAULT_STRIPE_MIN_BYTES", "HOST_HIDDEN_FRACTION",
        "ENV_ARBITER", "ENV_CALIBRATE",
    ]
    for n in names:
        assert hasattr(pts, n), n
    assert [(p.name, int(p)) for p in pts.Priority] == [(p.name, int(p)) for p in jts.Priority]
    for n in ("WINDOW_TTL_S", "DEFAULT_STRIPE_MIN_BYTES", "HOST_HIDDEN_FRACTION",
              "ENV_ARBITER", "ENV_CALIBRATE"):
        assert getattr(pts, n) == getattr(jts, n), n
    assert pts.ENV_ARBITER == "DLROVER_TPU_TRANSFER_ARBITER"
    assert pts.ENV_CALIBRATE == "DLROVER_TPU_ARBITER_CALIBRATE"
    assert "transfer.stripe" in pts.faults.FAULT_SITES


def test_process_arbiter_and_module_note_compute():
    a = pts.get_arbiter()
    assert pts.get_arbiter() is a
    assert a.register("x") is a.register("x")
    pts.note_compute(True)
    assert a.in_compute_window()
    pts.note_compute(False)
    assert not a.in_compute_window()
    mine = _arb(pts)
    pts.set_arbiter(mine)
    assert pts.get_arbiter() is mine
    pts.set_arbiter(None)
    assert pts.get_arbiter() is not mine


def test_local_rails_leave_out_the_peer_rail():
    """A copy between this host and its own card rides only the rails of
    its direction: one host has one each way, so it never stripes until
    a second rail of that direction is registered."""
    a = _arb(pts)
    assert pts.local_rails("d2h", arbiter=a) == ["host_d2h"]
    assert pts.local_rails("h2d", arbiter=a) == ["host_h2d"]
    a.register_rail("host_d2h_1", direction="d2h", gbps=8.0)
    a.register_rail("em_only", direction="d2h", admit=[pts.Priority.EMERGENCY])
    assert pts.local_rails("d2h", arbiter=a) == ["host_d2h", "host_d2h_1"]
    assert pts.local_rails("d2h", pts.Priority.EMERGENCY, a) == ["host_d2h", "host_d2h_1", "em_only"]


@pytest.mark.parametrize("extra", ["defaults", "second_d2h_rail", "emergency_only_rails"])
def test_local_rails_depart_from_the_jax_stagers_rails_by_the_peer_rails_only(extra):
    """The JAX stager stripes over every admitted rail of its direction
    and the peer (DCN) rails (``StripedTransfer`` with no ``rails=``);
    the port's stager and spill stripe over ``local_rails``. Under the
    same rails and class the two sets differ by the peer rails alone, so
    with the default rails the JAX stager stripes on one host and the
    port's does not."""
    arbs = {name: _arb(ts) for name, ts in MODULES.items()}
    for name, ts in MODULES.items():
        if extra == "second_d2h_rail":
            arbs[name].register_rail("host_d2h_1", direction="d2h", gbps=8.0)
        if extra == "emergency_only_rails":
            arbs[name].register_rail("em_d2h", direction="d2h", admit=[ts.Priority.EMERGENCY])
            arbs[name].register_rail("em_dcn", direction="peer", admit=[ts.Priority.EMERGENCY])
    for prio in ("BACKGROUND", "BACKPRESSURE", "EMERGENCY"):
        jax_set = jts.StripedTransfer(
            arbs["jax"], name="ckpt_stage", direction="d2h", priority=jts.Priority[prio]
        ).rails()
        peer = {r.name for r in arbs["jax"].rails() if r.direction == "peer"}
        port_set = pts.local_rails("d2h", pts.Priority[prio], arbs["port"])
        assert port_set == [r for r in jax_set if r not in peer]
        assert "dcn" in jax_set and "dcn" not in port_set
    assert len(pts.local_rails("d2h", arbiter=arbs["port"])) == (2 if extra == "second_d2h_rail" else 1)


def test_stats_report_waits_and_the_disabled_switch():
    a = _arb(pts)
    st = a.register("s", pts.Priority.BACKPRESSURE)
    for _ in range(3):
        with st.transfer(100):
            pass
    s = a.stats()
    assert s["enabled"] and s["scheduling"]
    row = s["streams"]["s"]
    assert row["grants"] == 3 and row["bytes"] == 300 and row["priority"] == "BACKPRESSURE"
    assert 0.0 <= row["wait_ms_median"] <= row["wait_ms_max"]
    assert s["rails"]["host_d2h"]["grants"] == 3
    off = pts.TransferArbiter(enabled=False)
    assert off.stats()["enabled"] is False and off.stats()["scheduling"] is False


def test_gauges_export_into_the_port_registry():
    from dlrover_tpu_torch.obs.metrics import default_registry

    a = _arb(pts)
    a.register_rail("railA", direction="d2h", gbps=1.0)
    with a.register("gauged").transfer(4096, rail="railA"):
        pass
    cal = pts.ArbiterCalibration(fingerprint="fp", hidden_fraction={"host_d2h": 0.5})
    pts.export_calibration_metrics(cal)
    sc = default_registry().scalars()
    assert sc['dlrover_transfer_rail_bytes_total{rail="railA"}'] >= 4096
    assert sc['dlrover_transfer_stream_bytes_total{stream="gauged"}'] >= 4096
    assert sc['dlrover_transfer_rail_hidden_fraction{rail="host_d2h"}'] == 0.5
