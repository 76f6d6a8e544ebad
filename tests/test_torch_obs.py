"""Port parity for the telemetry spine, on the CPU: the port's span
tracer, metrics registry and span heartbeat (``dlrover_tpu_torch/obs``)
against the JAX package's, given the same operations.

The tracers read ``time.monotonic_ns`` / ``time.time``; both are
replaced by one deterministic clock, so the same span sequence gives
the same timestamps in both and their exports can be compared exactly.
"""

import itertools
import json
import threading

import pytest

from dlrover_tpu.obs import metrics as jmetrics
from dlrover_tpu.obs import trace as jtrace
from dlrover_tpu_torch.data.prefetch import PipelineStats
from dlrover_tpu_torch.obs import metrics as tmetrics
from dlrover_tpu_torch.obs import trace as ttrace


@pytest.fixture
def clock(monkeypatch):
    """A fake monotonic clock that advances 1 ms a read, restarted for
    each tracer (``restart()``), and a fixed wall clock."""
    import time

    box = {}

    def restart():
        box["it"] = itertools.count(start=10_000_000, step=1_000_000)

    restart()
    monkeypatch.setattr(time, "monotonic_ns", lambda: next(box["it"]))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    return restart


def _spans(tracer):
    """A step with its phases, a nested save, an open span cancelled, a
    leaked inner span closed by its parent, and a no-op: the hot path's
    shapes."""
    for step in range(3):
        with tracer.span("step", step=step):
            with tracer.span("data_wait"):
                pass
            with tracer.span("compute") as sp:
                sp.set(tokens=512)
            with tracer.span("ckpt_save"):
                with tracer.span("ckpt_stage", step=step):
                    pass
    sp = tracer.span("eval")
    sp.cancel()
    outer = tracer.span("report")
    tracer.span("host_sync")  # leaked open: the parent's end drops it
    outer.end()
    outer.end()  # idempotent


def test_chrome_trace_and_step_coverage_match_jax(clock):
    clock()
    jt = jtrace.SpanTracer(enabled=True)
    _spans(jt)
    clock()
    tt = ttrace.SpanTracer(enabled=True)
    _spans(tt)
    j, t = jt.chrome_trace(), tt.chrome_trace()
    assert t == j
    assert ttrace.validate_chrome_trace(t) == jtrace.validate_chrome_trace(j) == (True, "ok")
    names = [e["name"] for e in t["traceEvents"] if e["ph"] == "X"]
    assert names.count("step") == 3 and "eval" not in names and "host_sync" not in names
    assert ttrace.step_coverage(tt) == jtrace.step_coverage(jt)
    assert 0 < ttrace.step_coverage(t) < 1
    assert len(tt) == len(jt) and tt.dropped == jt.dropped == 0


def test_drain_open_spans_and_last_open_span_match_jax(clock):
    clock()
    jt = jtrace.SpanTracer(enabled=True)
    clock()
    tt = ttrace.SpanTracer(enabled=True)
    out = {}
    for key, tr in (("j", jt), ("t", tt)):
        clock()
        a = tr.span("step")
        b = tr.span("ckpt_commit")
        with tr.span("data_wait"):
            pass
        recs, cur, dropped = tr.drain(0)
        out[key] = (
            [r[:5] + r[6:] for r in recs], cur, dropped,
            [(s["name"], s["depth"], s["elapsed_s"]) for s in tr.open_spans()],
            tr.last_open_span(), [r[0] for r in tr.open_span_records()],
        )
        b.end()
        a.end()
        assert tr.last_open_span() is None
    assert out["t"] == out["j"]


def test_record_appends_a_caller_timed_span():
    """``record`` (the port's addition): a completed span with the
    caller's interval, on the calling thread, outside the open stack."""
    tr = ttrace.SpanTracer(enabled=True)
    tr.record("compute", 5_000, 2_000, depth=1, step=3)
    assert tr.open_spans() == []
    (rec,) = tr.drain(0)[0]
    assert rec[:6] == ("compute", threading.get_ident(), 5_000, 2_000, 1, {"step": 3})
    ev = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert ev[0]["args"] == {"depth": 1, "step": 3}
    ttrace.SpanTracer(enabled=False).record("compute", 0, 1)  # a no-op


def _registry_ops(mod, reg):
    c = reg.counter("dlrover_rpc_total", "rpcs", labelnames=("method",), max_label_sets=2)
    c.labels("get").inc()
    c.labels(method="report").inc(3)
    c.labels("overflow").inc(5)  # past the cap: the detached child
    c.labels("more").inc(7)
    g = reg.gauge("dlrover_train_loss", "training scalar")
    g.set(2.5)
    g.inc(0.25)
    g.dec(1)
    h = reg.histogram("dlrover_step_time_seconds", "step", buckets=(0.05, 0.1, 1.0))
    for v in (0.01, 0.07, 0.5, 3.0):
        h.observe(v)
    reg.gauge("dlrover_goodput_seconds_total", "s", labelnames=("category",)).labels(
        "productive_compute").set(1.5)
    reg.counter("dlrover_faults_triggered_total", labelnames=("site", "kind"))
    with pytest.raises(ValueError):
        reg.gauge("dlrover_rpc_total")  # a kind mismatch is a hard error
    return c, h


def test_registry_exports_match_jax():
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    jc, jh = _registry_ops(jmetrics, jr)
    tc, th = _registry_ops(tmetrics, tr)
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tr.scalars() == jr.scalars()
    assert tc.label_set_count() == jc.label_set_count() == 2
    assert "overflow" not in tr.prometheus_text()
    assert th.quantile(0.5) == jh.quantile(0.5) and th.count == jh.count == 4


def test_fold_pipeline_stats_writes_every_field():
    reg = tmetrics.MetricsRegistry()
    st = PipelineStats(prefetch_hits=3, stage_bytes=1 << 20)
    n = tmetrics.fold_pipeline_stats(st, reg)
    sc = reg.scalars()
    numeric = {k for k, v in st.as_dict().items() if not isinstance(v, (list, tuple, dict, str))}
    assert n == len(numeric)
    assert {tmetrics.PIPELINE_PREFIX + k for k in numeric} <= set(sc)
    assert sc["dlrover_pipeline_prefetch_hits"] == 3.0


def test_span_heartbeat_writes_the_jax_keys(tmp_path):
    files = {}
    for key, mod in (("j", jtrace), ("t", ttrace)):
        tr = mod.SpanTracer(enabled=True)
        path = str(tmp_path / f"{key}.json")
        with open(path, "w") as f:
            json.dump({"global_step": 4, "timestamp": 1.0, "loss": 2.0}, f)
        sp = tr.span("ckpt_commit")
        hb = mod.SpanHeartbeat(tr, path=path, interval=60.0, tid_fn=threading.get_ident)
        hb.publish_once()
        sp.end()
        with open(path) as f:
            files[key] = json.load(f)
    assert set(files["t"]) == set(files["j"])
    for k in ("global_step", "loss", "open_span"):
        assert files["t"][k] == files["j"][k]
    assert files["t"]["open_span"] == "ckpt_commit"


def test_span_heartbeat_thread_starts_and_stops(tmp_path):
    tr = ttrace.SpanTracer(enabled=True)
    path = str(tmp_path / "m.json")
    hb = ttrace.SpanHeartbeat(tr, path=path, interval=0.01)
    hb.start()
    seen = None
    try:
        with tr.span("compute"):
            for _ in range(500):
                try:
                    with open(path) as f:
                        seen = json.load(f).get("open_span")
                    if seen == "compute":
                        break
                except (OSError, ValueError):
                    pass
                threading.Event().wait(0.01)
    finally:
        hb.stop()
    # read while the span was open: after it closes and before stop()
    # joins the thread, a last beat may publish no open span
    assert seen == "compute"
    assert hb._thread is None


def test_heartbeat_and_trainer_reports_publish_the_metrics_file_together(tmp_path):
    """The span heartbeat's thread and the train loop publish the same
    runtime-metrics file; neither write may fail for the other's (a tmp
    file shared by the two once made the loop's rename raise)."""
    from dlrover_tpu_torch.agent.monitor import read_runtime_metrics, report_runtime_metrics

    tr = ttrace.SpanTracer(enabled=True)
    path = str(tmp_path / "m.json")
    hb = ttrace.SpanHeartbeat(tr, path=path, interval=60.0)
    errors = []

    def beats():
        try:
            for _ in range(2000):
                hb.publish_once()
        except Exception as e:  # recorded: the assert below names it
            errors.append(e)

    t = threading.Thread(target=beats)
    t.start()
    try:
        for step in range(2000):
            report_runtime_metrics(step, path=path)
    finally:
        t.join()
    assert errors == []
    assert read_runtime_metrics(path)["global_step"] >= 0


def test_heartbeat_never_writes_back_over_a_later_report(tmp_path, monkeypatch):
    """A heartbeat that read the metrics file before the trainer's last
    report (the eviction drain's) must not write its stale copy over
    it: the report waits for the heartbeat's read-modify-write."""
    import time

    from dlrover_tpu_torch.agent import monitor

    path = str(tmp_path / "m.json")
    monitor.report_runtime_metrics(6, path=path, eviction_pending=1.0)
    hb = ttrace.SpanHeartbeat(ttrace.SpanTracer(enabled=True), path=path, interval=60.0)
    read = monitor.read_runtime_metrics
    got_read = threading.Event()

    def slow_read(p=""):
        out = read(p)
        got_read.set()
        time.sleep(0.3)  # the trainer's last report lands meanwhile
        return out

    monkeypatch.setattr(monitor, "read_runtime_metrics", slow_read)
    t = threading.Thread(target=hb.publish_once)
    t.start()
    assert got_read.wait(10)
    monitor.report_runtime_metrics(7, path=path, eviction_pending=1.0, eviction_drain_ms=2883.9)
    t.join()
    assert read(path)["eviction_drain_ms"] == 2883.9 and read(path)["global_step"] == 7
