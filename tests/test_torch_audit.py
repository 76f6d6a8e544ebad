"""The port's step auditor (``dlrover_tpu_torch/obs/audit.py``) against
the JAX package's, on the CPU: the same span stream (one fake tracer
feeding both auditors the same records) gives the same per-step
observations, residuals and ratios, drift factors, CUSUM alarms, alarm
callbacks, ``dlrover_audit_*`` series and calibration JSON. Compared
exactly: both packages run the same float expressions on the same
inputs."""

import pytest

from dlrover_tpu.obs import audit as jaudit
from dlrover_tpu.obs.metrics import MetricsRegistry as JReg
from dlrover_tpu_torch.obs import audit as taudit
from dlrover_tpu_torch.obs.metrics import MetricsRegistry as TReg

TID = 7
MS = 1_000_000  # ns


class FakeTracer:
    """Serves one list of span records through ``drain(cursor)`` (the
    SpanTracer contract: records after the cursor, the new cursor, the
    dropped count)."""

    def __init__(self):
        self.records = []

    def drain(self, cursor=0):
        return list(self.records[cursor:]), len(self.records), 0


def _step(tracer, t0, seq, compute_ms, data_ms=2.0, host_ms=1.0, straddle=False):
    """One step's records: children first (they end first), then the
    ``step`` span; returns the next start and seq."""
    recs = tracer.records
    t = t0
    for name, ms in (("data_wait", data_ms), ("compute", compute_ms), ("host_sync", host_ms)):
        recs.append((name, TID, t, int(ms * MS), 1, {}, seq))
        seq += 1
        t += int(ms * MS)
    if straddle:  # a span of another thread and a grandchild: never counted
        recs.append(("compute", TID + 1, t0, int(5 * MS), 1, {}, seq))
        recs.append(("compute", TID, t0, int(5 * MS), 2, {}, seq + 1))
        seq += 2
    recs.append(("step", TID, t0, t - t0, 0, {}, seq))
    return t + int(0.5 * MS), seq + 1


def _budget(mod):
    b = mod.StepBudget()
    b.set_component("compute", 0.040, "priced")
    b.set_component("ici_sync", 0.004, "priced")
    b.set_component("dcn_sync", 0.0, "priced")
    b.set_component("host_xfer", 0.0, "priced")
    return b


# compute ms per step: on price at 1.2x (drift), a 3x regression, back
SCENARIOS = {
    "drift_then_regression": [48.0] * 7 + [140.0] * 9 + [48.0] * 8,
    "fast_side": [20.0] * 10 + [44.0] * 6,
    "noisy": [40.0, 75.0, 30.0, 90.0, 41.0, 38.0, 120.0, 130.0, 125.0, 40.0, 39.0, 200.0],
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("chunk", [1, 3])
def test_same_spans_give_the_same_audit(scenario, chunk, tmp_path):
    tracer = FakeTracer()
    fired = {"j": [], "t": []}
    aj = jaudit.StepAuditor(tracer=tracer, tid_fn=lambda: TID,
                            on_alarm=lambda c, r, d: fired["j"].append((c, r, d)))
    at = taudit.StepAuditor(tracer=tracer, tid_fn=lambda: TID,
                            on_alarm=lambda c, r, d: fired["t"].append((c, r, d)))
    aj.set_budget(_budget(jaudit))
    at.set_budget(_budget(taudit))
    for a in (aj, at):
        a.set_measured("ici_sync", 0.005)
        a.seed_drift("compute", 1.1)
    t, seq = 0, 0
    rj, rt = JReg(), TReg()
    for i, ms in enumerate(SCENARIOS[scenario]):
        t, seq = _step(tracer, t, seq, ms, straddle=i % 4 == 1)
        if i % chunk == chunk - 1:
            got, want = at.collect(), aj.collect()
            assert [vars(r) for r in got] == [vars(r) for r in want]
            at.export(rt)
            aj.export(rj)
            assert rt.scalars() == rj.scalars()
    assert [vars(r) for r in at.collect()] == [vars(r) for r in aj.collect()]
    assert at.drift_factors() == aj.drift_factors()
    assert at.alarms_total() == aj.alarms_total()
    assert at.alarm_components() == aj.alarm_components()
    assert fired["t"] == fired["j"]
    assert at.steps_audited == aj.steps_audited == len(SCENARIOS[scenario])
    assert vars(at.budget()) == vars(aj.budget())
    if scenario == "drift_then_regression":
        assert fired["t"] and fired["t"][0][0] == "compute"
    cj, ct = aj.calibration("fp"), at.calibration("fp")
    pj, pt = cj.to_payload(), ct.to_payload()
    pj.pop("updated_at"), pt.pop("updated_at")
    assert pt == pj
    # the persisted calibration reads back in the other package
    path = taudit.save_audit_calibration(ct, str(tmp_path))
    assert path and jaudit.load_audit_calibration("fp", str(tmp_path)).factors == ct.factors


def test_drift_seeds_and_calibration_reach_the_factors(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path))
    for mod in (jaudit, taudit):
        mod.reset_default_auditor()
    try:
        for mod in (jaudit, taudit):
            mod.seed_default_drift("compute", 2.5)
            mod.seed_default_drift("bogus", 3.0)
            mod.seed_default_drift("ici_sync", -1.0)
        assert taudit.current_drift_factors() == jaudit.current_drift_factors()
        assert taudit.current_drift_factors()["compute"] == 2.5
        a = taudit.install_default_auditor(taudit.StepAuditor(tracer=FakeTracer()))
        assert a.drift_factors()["compute"] == 2.5 and taudit.default_auditor() is a
    finally:
        for mod in (jaudit, taudit):
            mod.reset_default_auditor()


def test_cusum_detectors_agree():
    dj, dt = jaudit.CusumDetector(), taudit.CusumDetector()
    for r in [0.1, 2.0, 1.5, -3.0, 4.0, 4.0, 0.0, 0.2, 3.5, 1.0, -0.5]:
        assert dt.update(r) == dj.update(r)
        assert dt.state() == dj.state()
