"""Port parity for the goodput ledger and the flight recorder, on the
CPU: the same span records and episodes, at fixed nanosecond
timestamps, into the port's ledger (``dlrover_tpu_torch/obs/goodput``)
and the JAX package's give the same ``GoodputReport.as_dict()``,
exactly, across the drain and wraparound cases of
``tests/test_goodput.py``; a flight bundle has the JAX one's schema;
and ``ProfilerCapture``, rebuilt on torch.profiler, runs its N-step
lifecycle, refuses during its cooldown and aborts (CPU activity here;
the card's capture is checked by ``chip_smoke.py``)."""

import json
import os

import pytest

from dlrover_tpu.obs import flight_recorder as jflight
from dlrover_tpu.obs import goodput as jgoodput
from dlrover_tpu.obs import metrics as jmetrics
from dlrover_tpu.obs import trace as jtrace
from dlrover_tpu_torch.obs import flight_recorder as tflight
from dlrover_tpu_torch.obs import goodput as tgoodput
from dlrover_tpu_torch.obs import metrics as tmetrics
from dlrover_tpu_torch.obs import trace as ttrace

MS = 1_000_000  # ns
T0 = 5_000 * MS


def _put(tracer, name, start_ns, dur_ns, tid=1):
    """One completed record in the ring, as the hot path appends it."""
    tracer._buf.append((name, tid, start_ns, dur_ns, 0, None, next(tracer._seq)))
    tracer._appended += 1


def _basic(tr, led):
    _put(tr, "compute", T0 + 10 * MS, 100 * MS)
    _put(tr, "data_wait", T0 + 120 * MS, 50 * MS)
    _put(tr, "ckpt_commit", T0 + 180 * MS, 40 * MS)
    _put(tr, "eval", T0 + 230 * MS, 20 * MS)
    return [led.snapshot(now_ns=T0 + 300 * MS)]


def _priority(tr, led):
    _put(tr, "compute", T0, 100 * MS)
    _put(tr, "ckpt_stage", T0 + 50 * MS, 100 * MS)
    _put(tr, "grad_sync_ici", T0 + 140 * MS, 30 * MS)
    _put(tr, "resize_compile", T0 + 160 * MS, 30 * MS)
    return [led.snapshot(now_ns=T0 + 200 * MS)]


def _tid_filter(tr, led):
    _put(tr, "compute", T0, 50 * MS, tid=1)
    _put(tr, "compute", T0, 80 * MS, tid=2)  # the producer thread
    _put(tr, "h2d", T0 + 60 * MS, 10 * MS, tid=2)
    return [led.snapshot(now_ns=T0 + 100 * MS)]


def _drain_chain(tr, led):
    """Records across three collects, one straddling a window's end, and
    a collect that finds nothing new."""
    out = []
    _put(tr, "compute", T0, 40 * MS)
    led.collect(now_ns=T0 + 50 * MS)
    led.collect(now_ns=T0 + 60 * MS)  # the same records still in the ring
    out.append(led.snapshot(now_ns=T0 + 70 * MS))
    _put(tr, "compute", T0 + 65 * MS, 30 * MS)  # straddles 70
    _put(tr, "data_wait", T0 + 95 * MS, 5 * MS)
    out.append(led.snapshot(now_ns=T0 + 120 * MS))
    out.append(led.snapshot(now_ns=T0 + 120 * MS))  # nothing new
    return out


def _wraparound(tr, led):
    """The ring (16 slots) lapped between two collects: the lost records'
    time falls to ``other``, and the ledger counts them."""
    for i in range(4):
        _put(tr, "compute", T0 + i * 10 * MS, 5 * MS)
    out = [led.snapshot(now_ns=T0 + 50 * MS)]
    for i in range(40):
        _put(tr, "compute", T0 + 50 * MS + i * 2 * MS, MS)
    out.append(led.snapshot(now_ns=T0 + 200 * MS))
    assert led.dropped_records == 24
    return out


def _episodes(tr, led):
    """Every event-derived category by explicit interval, overlapping
    spans and each other (the priorities decide), one of them reaching
    past the collect."""
    _put(tr, "compute", T0, 100 * MS)
    _put(tr, "ckpt_persist", T0 + 100 * MS, 50 * MS)
    led.mark_interval("eviction", T0 + 80 * MS, T0 + 120 * MS)
    led.mark_interval("restart_replay", T0 + 60 * MS, T0 + 90 * MS)
    led.mark_interval("degraded", T0 + 140 * MS, T0 + 260 * MS)
    led.mark_interval("serving_soak", T0 + 150 * MS, T0 + 300 * MS)
    out = [led.snapshot(now_ns=T0 + 200 * MS)]
    out.append(led.snapshot(now_ns=T0 + 400 * MS))
    return out


def _open_span(tr, led):
    """A span still open at collect time is claimed up to the collect;
    its record, once closed, only adds the rest."""
    tr._stacks[1] = [_Open("ckpt_commit", T0 + 20 * MS)]
    out = [led.snapshot(now_ns=T0 + 100 * MS)]
    tr._stacks[1] = []
    _put(tr, "ckpt_commit", T0 + 20 * MS, 150 * MS)
    out.append(led.snapshot(now_ns=T0 + 200 * MS))
    return out


class _Open:
    """An open span as the tracers' stacks hold it."""

    def __init__(self, name, start_ns):
        self.name, self.start_ns, self.depth = name, start_ns, 0


CASES = {
    "basic": (_basic, {}),
    "priority": (_priority, {}),
    "tid_filter": (_tid_filter, {"tid": 1}),
    "drain_chain": (_drain_chain, {}),
    "wraparound": (_wraparound, {"capacity": 16}),
    "episodes": (_episodes, {}),
    "open_span": (_open_span, {"tid": 1}),
}


def _run(trace_mod, goodput_mod, case):
    fn, kw = CASES[case]
    tr = trace_mod.SpanTracer(enabled=True, capacity=kw.get("capacity", 65536))
    tid = kw.get("tid")
    led = goodput_mod.GoodputLedger(tracer=tr, tid_fn=(lambda: tid) if tid else None)
    led._t0_ns = led._last_ns = T0
    return [rep.as_dict() for rep in fn(tr, led)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_reports_match_jax(case):
    j = _run(jtrace, jgoodput, case)
    t = _run(ttrace, tgoodput, case)
    assert t == j
    for rep in t:
        assert rep["closure_error_pct"] == 0.0
        assert set(rep) == {"wall_s", "goodput_pct", "closure_error_pct", *tgoodput.CATEGORIES}


def test_export_publishes_the_jax_gauges():
    out = {}
    for key, (trm, gm, mm) in {"j": (jtrace, jgoodput, jmetrics),
                               "t": (ttrace, tgoodput, tmetrics)}.items():
        tr = trm.SpanTracer(enabled=True)
        led = gm.GoodputLedger(tracer=tr)
        led._t0_ns = led._last_ns = T0
        _put(tr, "compute", T0, 30 * MS)
        reg = mm.MetricsRegistry()
        led.collect(now_ns=T0 + 60 * MS)
        led.export(reg)
        out[key] = set(reg.scalars())
    assert out["t"] == out["j"]
    assert 'dlrover_goodput_seconds_total{category="productive_compute"}' in out["t"]


def test_default_ledger_seams():
    assert tgoodput.default_ledger() is None or isinstance(
        tgoodput.default_ledger(), tgoodput.GoodputLedger)
    prev = tgoodput.default_ledger()
    led = tgoodput.install_default_ledger(tgoodput.GoodputLedger(tracer=ttrace.SpanTracer()))
    try:
        tgoodput.note_degraded(True)
        tgoodput.note_serving(True)
        assert led._degraded_since is not None and led._serving_since is not None
        tgoodput.note_degraded(False)
        tgoodput.note_serving(False)
        assert led._degraded_since is None and led._serving_since is None
    finally:
        tgoodput.install_default_ledger(prev)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def _bundle(trace_mod, metrics_mod, flight_mod, base):
    tr = trace_mod.SpanTracer(enabled=True)
    with tr.span("compute"):
        pass
    open_sp = tr.span("ckpt_commit")
    reg = metrics_mod.MetricsRegistry()
    reg.gauge("dlrover_test_gauge", "g").set(1.0)
    rec = flight_mod.FlightRecorder(base_dir=str(base), tracer=tr, registry=reg,
                                    identity={"node_id": 3})
    rec.note_event("fault", "injected enospc")
    path = rec.dump("crash", exc=ValueError("boom"), extra={"step": 7})
    assert rec.dump("again") is None  # rate-limited: one incident
    assert rec.dump("request_smoke", force=True) is not None
    open_sp.end()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return path, manifest


def test_flight_bundle_has_the_jax_schema(tmp_path, monkeypatch):
    # the same process-default ledger state in both (another test's
    # trainer may have installed one)
    for mod in (jgoodput, tgoodput):
        monkeypatch.setattr(mod, "_default", mod.GoodputLedger(tracer=mod.SpanTracer()))
    jpath, jm = _bundle(jtrace, jmetrics, jflight, tmp_path / "j")
    tpath, tm = _bundle(ttrace, tmetrics, tflight, tmp_path / "t")
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath))
    assert set(tm) == set(jm)
    assert set(tm["exception"]) == set(jm["exception"])
    assert (tm["reason"], tm["identity"], tm["extra"]) == ("crash", {"node_id": 3}, {"step": 7})
    assert [s["name"] for s in tm["open_spans"]] == ["ckpt_commit"]
    for name in ("trace.json",):
        with open(os.path.join(tpath, name)) as f:
            assert ttrace.validate_chrome_trace(json.load(f)) == (True, "ok")
    with open(os.path.join(tpath, "metrics.prom")) as f:
        assert "dlrover_test_gauge 1" in f.read()
    with open(os.path.join(tpath, "events.json")) as f:
        assert json.load(f)[-1]["kind"] == "fault"


def test_watchdog_dumps_a_hang_once_and_respects_suppression(tmp_path):
    tr = ttrace.SpanTracer(enabled=True)
    rec = tflight.FlightRecorder(base_dir=str(tmp_path), tracer=tr,
                                 registry=tmetrics.MetricsRegistry())
    rec.suppress_watchdog(60.0)
    assert rec.watchdog_suppressed()
    rec.clear_suppression()
    sp = tr.span("ckpt_commit")
    rec.start_watchdog(hang_dump_after_s=0.0, interval_s=0.01)
    try:
        for _ in range(500):
            if rec.dumps:
                break
            threading_wait(0.01)
        threading_wait(0.1)
    finally:
        rec.stop_watchdog()
        sp.end()
    assert len(rec.dumps) == 1 and "_hang_" in os.path.basename(rec.dumps[0])


def threading_wait(s):
    import threading

    threading.Event().wait(s)


def test_flight_dir_follows_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "f"))
    assert tflight.flight_dir() == str(tmp_path / "f")
    monkeypatch.delenv("DLROVER_TPU_FLIGHT_DIR")
    assert tflight.flight_dir().endswith(os.path.join("dlrover_tpu", "flight"))


# ---------------------------------------------------------------------------
# ProfilerCapture on torch.profiler
# ---------------------------------------------------------------------------
def _work():
    import torch

    a = torch.ones(64, 64)
    return float((a @ a).sum())


def test_profiler_capture_lifecycle_cooldown_and_abort(tmp_path):
    cap = tflight.ProfilerCapture(out_root=str(tmp_path), cooldown_s=300.0)
    cap.on_step_begin()  # idle: a no-op
    assert not cap.active
    assert not cap.request(0)
    assert cap.request(2, reason="straggler")
    assert not cap.request(2)  # one capture at a time
    for _ in range(2):
        cap.on_step_begin()
        assert cap.active
        _work()
        cap.on_step_end()
    assert not cap.active and len(cap.artifacts) == 1
    out = cap.artifacts[0]
    assert os.path.basename(out).endswith("_straggler")
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    assert ttrace.validate_chrome_trace(trace)[0]
    assert any("aten::mm" in e.get("name", "") for e in trace["traceEvents"])
    assert not cap.request(1)  # cooling down
    cap.on_step_end()  # idle: a no-op

    cap2 = tflight.ProfilerCapture(out_root=str(tmp_path / "b"), cooldown_s=0.0)
    assert cap2.request(5)
    cap2.on_step_begin()
    _work()
    cap2.abort()
    assert not cap2.active and cap2.artifacts == []
    assert cap2.request(1)  # abort leaves no capture pending or live


def test_profiler_capture_that_fails_to_start_is_dropped(tmp_path, monkeypatch):
    cap = tflight.ProfilerCapture(out_root=str(tmp_path))

    def refuse():
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(cap, "_start_profiler", refuse)
    assert cap.request(3)
    cap.on_step_begin()
    assert not cap.active
    cap.on_step_end()
    assert cap.artifacts == [] and cap.request(3)
