"""The port's strategy search (``dlrover_tpu_torch/accel``) against the
JAX package's (``dlrover_tpu/accel``), on the CPU: the same candidates,
optimizations, profile, analytic and comm terms, rebalance prices,
memory gate and TPE proposals from the same inputs, and the
``auto_accelerate`` cases of ``tests/test_accel.py`` that do not depend
on timing, on one process and on four gloo ranks in one spawn.

Tolerances: candidates, optimizations, the profile, the features and
the proposals are compared exactly; the priced terms (flops, bytes,
exposed comm seconds, rebalance estimates) within ``PRICE_RTOL``
relative. Terms that embed the roofline weights are compared with the
port's weights set to the JAX package's (the same function), and
``est_step_s`` is rebuilt from the shared terms with each package's own
weights.
"""

import dataclasses
import math

import jax
import numpy as np
import optax
import pytest

from dlrover_tpu.accel import accelerate as jacc
from dlrover_tpu.accel import bayes as jbayes
from dlrover_tpu.accel import candidates as jcand
from dlrover_tpu.accel import dry_runner as jdr
from dlrover_tpu.accel import opt_lib as jopt
from dlrover_tpu.accel import profiler as jprof
from dlrover_tpu.accel.strategy import Strategy as JStrategy
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.parallel import topology as jtop
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dlrover_tpu_torch.accel import accelerate as tacc
from dlrover_tpu_torch.accel import bayes as tbayes
from dlrover_tpu_torch.accel import candidates as tcand
from dlrover_tpu_torch.accel import dry_runner as tdr
from dlrover_tpu_torch.accel import opt_lib as topt
from dlrover_tpu_torch.accel import profiler as tprof
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.parallel import topology as ttop
from dlrover_tpu_torch.parallel import transfer_sched as tts
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

import torch_dist_worker as tdw

PRICE_RTOL = 1e-12
LINK = dict(ici_gbps=90.0, dcn_gbps=12.5, host_d2h_gbps=8.0, host_h2d_gbps=8.0, ici_lat_s=1e-6,
            dcn_lat_s=5e-5, host_lat_s=1e-5, ici_axis_gbps=(("fsdp", 45.0),), source="measured",
            fingerprint="fixed")


@pytest.fixture
def links(monkeypatch, tmp_path):
    """One LinkModel installed in both packages, the drift caches in a
    tmp dir and no auditor: every price reads the same inputs."""
    from dlrover_tpu.obs import audit as jaudit
    from dlrover_tpu_torch.obs import audit as taudit

    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path))
    # a model an earlier test of this process probed for the device's
    # fingerprint (or rail rates it observed) would win over the
    # installed one
    for top in (jtop, ttop):
        top.reset_link_model()
        top.reset_rail_rates()
    jtop.set_link_model(jtop.LinkModel(**LINK))
    ttop.set_link_model(ttop.LinkModel(**LINK))
    jaudit.reset_default_auditor()
    taudit.reset_default_auditor()
    # no host-link demand or arbiter calibration left by an earlier test
    # of this process: the host term prices what this test registers
    tts.reset_calibration()
    tts.set_arbiter(tts.TransferArbiter())
    yield
    jtop.reset_link_model()
    ttop.reset_link_model()
    jaudit.reset_default_auditor()
    taudit.reset_default_auditor()
    tts.reset_calibration()
    tts.set_arbiter(None)


def _both(name, **kw):
    """The JAX and the port's config of one name with the same overrides."""
    return getattr(jcfg, name)(**kw), getattr(tcfg, name)(**kw)


GRID = [
    # (config, overrides, devices, batch, seq, grad_accum)
    ("tiny", {}, 1, 8, 64, 1), ("tiny", {}, 2, 8, 64, 1), ("tiny", {}, 4, 8, 64, 1),
    ("tiny", {}, 8, 8, 64, 1), ("tiny", dict(num_experts=4), 8, 8, 64, 1),
    ("tiny", dict(num_layers=8, num_experts=0), 8, 8, 64, 1),
    ("tiny", dict(num_layers=8), 8, 8, 4096, 1), ("tiny", {}, 8, 16, 64, 2),
    ("tiny", dict(num_layers=8, num_experts=0), 8, 8, 64, 4), ("gpt2_small", {}, 2, 8, 1024, 1),
    ("llama2_7b", {}, 1, 1, 4096, 1), ("llama2_7b", {}, 8, 16, 4096, 2),
]


@pytest.mark.parametrize("name,kw,n,batch,seq,ga", GRID)
def test_candidates_match(name, kw, n, batch, seq, ga):
    j, t = _both(name, **kw)
    for mc in (32, 3):
        want = [s.to_json() for s in jcand.candidate_strategies(j, n, batch, seq, mc, grad_accum=ga)]
        got = [s.to_json() for s in tcand.candidate_strategies(t, n, batch, seq, mc, grad_accum=ga)]
        assert got == want and got


def test_registered_optimizations_apply_the_same():
    assert topt.registered_optimizations() == jopt.registered_optimizations()
    j, t = _both("tiny", num_layers=4)
    for mesh in (dict(dp=2), dict(pp=2, dp=2)):
        for name in jopt.registered_optimizations():
            jc, js = jopt.apply_optimizations(j, JStrategy(mesh=JMeshConfig(**mesh)), (name, name))
            tc, ts = topt.apply_optimizations(t, Strategy(mesh=MeshConfig(**mesh)), (name, name))
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
            assert ts.to_json() == js.to_json(), name
    # sp_auto on an sp axis reads the port's sp scheme table (measured
    # on the H100, not the JAX package's)
    from dlrover_tpu_torch.parallel.sp_select import pick_sp_scheme

    tc, _ = topt.apply_optimizations(t, Strategy(mesh=MeshConfig(dp=2, sp=2)), ("sp_auto",))
    assert tc.sp_scheme == pick_sp_scheme(t.max_seq_len)


@pytest.mark.parametrize("name,kw", [
    ("gpt2_small", {}), ("gpt2_xl", {}), ("llama2_7b", {}), ("tiny", dict(num_experts=4)),
    ("tiny", dict(rope=False, tie_embeddings=True, swiglu=False)),
])
@pytest.mark.parametrize("act_bytes", [2, 4])
def test_profile_model_matches_exactly(name, kw, act_bytes):
    j, t = _both(name, **kw)
    pj, pt = jprof.profile_model(j, 4, 256, act_bytes), tprof.profile_model(t, 4, 256, act_bytes)
    assert [dataclasses.astuple(m) for m in pt.modules] == [dataclasses.astuple(m) for m in pj.modules]
    assert (pt.total_params, pt.fwd_flops, pt.step_flops, pt.activation_bytes) == (
        pj.total_params, pj.fwd_flops, pj.step_flops, pj.activation_bytes)
    assert pt.report() == pj.report()


def test_the_card_peak_table_names_the_h100_and_no_tpu():
    assert tprof.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tprof.chip_peak_tflops("cpu") is None and tprof.chip_peak_tflops("TPU v5p") is None
    assert not set(tprof.PEAK_TFLOPS) & set(jprof.PEAK_TFLOPS)
    assert tdr._SEC_PER_FLOP == 1 / 989e12 and tdr._SEC_PER_BYTE == 1 / 3.35e12


MESHES = [dict(), dict(dp=4), dict(dp=2, fsdp=2), dict(fsdp=4), dict(dp=2, tp=2), dict(pp=2, dp=2),
          dict(dp=2, ep=2), dict(dp=4, dcn_axes=("dp",), slices=2), dict(dp=2, fsdp=2, tp=2)]


def _report_terms(r):
    return np.array([r.flops_per_device, r.bytes_per_device, r.comm_bytes_per_device,
                     r.comm_exposed_s, r.comm_ici_s, r.comm_dcn_s])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()
                                                                if k not in ("dcn_axes",)) or "one")
@pytest.mark.parametrize("name,kw", [("tiny", {}), ("tiny", dict(num_experts=4)), ("gpt2_small", {})])
def test_analytic_and_comm_terms_match(links, monkeypatch, mesh, name, kw):
    """``_analytic_estimate`` and ``_comm_estimate`` equal the JAX
    package's (the port's roofline weights set to the JAX package's:
    the pp bubble's credit reads them); ``est_step_s`` from those terms
    with each package's own weights, and on a tp mesh the port's tp
    collectives (``_tp_comm_estimate``) on top."""
    j, t = _both(name, **kw)
    n = MeshConfig(**mesh).num_devices
    for strat_kw in (dict(), dict(comm_overlap=True), dict(comm_overlap=True, grad_compress="int8"),
                     dict(grad_accum=2), dict(opts=("remat",), remat=True),
                     dict(num_microbatches=4, pp_schedule="interleaved")):
        for c_j, c_t in ((j, t), (dataclasses.replace(j, remat=True), dataclasses.replace(t, remat=True))):
            rj = jdr.DryRunReport(strategy=JStrategy(mesh=JMeshConfig(**mesh), **strat_kw), ok=True)
            rt = tdr.DryRunReport(strategy=Strategy(mesh=MeshConfig(**mesh), **strat_kw), ok=True)
            jdr._analytic_estimate(rj, c_j, 8, 64, list(jax.devices())[:1] * n)
            tdr._analytic_estimate(rt, c_t, 8, 64, n)
            with monkeypatch.context() as m:
                m.setattr(tdr, "_SEC_PER_FLOP", jdr._SEC_PER_FLOP)
                m.setattr(tdr, "_SEC_PER_BYTE", jdr._SEC_PER_BYTE)
                jdr._comm_estimate(rj, c_j, 8, 64, None)
                tdr._comm_estimate(rt, c_t, 8, 64, n)
            np.testing.assert_allclose(_report_terms(rt), _report_terms(rj), rtol=PRICE_RTOL)
            assert rt.est_source == rj.est_source == "analytic"
            if rt.strategy.mesh.pp > 1:
                continue  # the bubble's credit reads each package's own weights
            rf = tdr.DryRunReport(strategy=rt.strategy, ok=True)
            tdr._finalize_estimate(rf, c_t, 8, 64, n)
            # the port prices the tp collectives on top (the JAX package's
            # GSPMD fuses them and prices none): zero off a tp mesh
            tp_terms = tdr.DryRunReport(strategy=rt.strategy, ok=True)
            tdr._tp_comm_estimate(tp_terms, c_t, 8, 64)
            assert (tp_terms.comm_exposed_s > 0) == (rt.strategy.mesh.tp > 1)
            for k in ("comm_bytes_per_device", "comm_exposed_s", "comm_ici_s"):
                setattr(rj, k, getattr(rj, k) + getattr(tp_terms, k))
            np.testing.assert_allclose(_report_terms(rf), _report_terms(rj), rtol=PRICE_RTOL)
            own = max(rj.flops_per_device * tdr._SEC_PER_FLOP, rj.bytes_per_device * tdr._SEC_PER_BYTE)
            np.testing.assert_allclose(rf.est_step_s, own + rj.comm_exposed_s, rtol=PRICE_RTOL)
            assert (rf.host_exposed_s, rf.host_hidden_measured) == (0.0, False)
            factors = {"compute": 1.7, "ici_sync": 0.5, "dcn_sync": 3.0, "host_xfer": 2.0}
            rj.est_step_s = rf.est_step_s
            np.testing.assert_allclose(tdr.reprice_report(rf, factors),
                                       jdr.reprice_report(rj, factors), rtol=PRICE_RTOL)


@pytest.mark.parametrize("measured", [None, 0.5])
def test_rebalance_prices_match(links, monkeypatch, measured):
    monkeypatch.setattr(tdr, "_SEC_PER_FLOP", jdr._SEC_PER_FLOP)
    monkeypatch.setattr(tdr, "_SEC_PER_BYTE", jdr._SEC_PER_BYTE)
    j, t = _both("gpt2_small")
    for idle, reb, cur in ((dict(dp=3), dict(dp=4), dict(dp=4)), (dict(dp=6), dict(dp=8), dict(dp=8)),
                           (dict(dp=2, fsdp=2), dict(dp=3, fsdp=2), dict(dp=4, fsdp=2))):
        got = tdr.price_rebalance_options(
            t, 12, 1024, Strategy(mesh=MeshConfig(**idle)),
            Strategy(mesh=MeshConfig(**reb), batch_pad=4, comm_overlap=True), measured,
            Strategy(mesh=MeshConfig(**cur)))
        want = jdr.price_rebalance_options(
            j, 12, 1024, JStrategy(mesh=JMeshConfig(**idle)),
            JStrategy(mesh=JMeshConfig(**reb), batch_pad=4, comm_overlap=True), measured,
            JStrategy(mesh=JMeshConfig(**cur)))
        np.testing.assert_allclose(got, want, rtol=PRICE_RTOL)


def test_hbm_gate_is_the_same_tri_state():
    for mem, budget in ((0.0, 1e9), (2e9, 1e9), (5e8, 1e9), (0.0, None), (5e9, None), (1e9, 1e9)):
        assert tdr.hbm_fits(mem, budget) is jdr.hbm_fits(mem, budget)
    assert tbayes.hbm_fits is tdr.hbm_fits


def test_tpe_features_and_proposals_match():
    j, t = _both("tiny", num_layers=8, num_experts=0)
    jp = jcand.candidate_strategies(j, 8, 16, 64, 32)
    tp = tcand.candidate_strategies(t, 8, 16, 64, 32)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(tbayes.strategy_features(b), jbayes.strategy_features(a))
    rng = np.random.default_rng(0)
    for trial in range(6):
        k = 2 + trial
        idx = rng.permutation(len(jp))
        tried, pool = idx[:k], idx[k:]
        scores = [None if rng.random() < 0.2 else float(rng.random()) for _ in tried]
        pj = jbayes.tpe_propose([jp[i] for i in tried], scores, [jp[i] for i in pool])
        pt = tbayes.tpe_propose([tp[i] for i in tried], scores, [tp[i] for i in pool])
        assert pt.to_json() == pj.to_json()


# ---------------------------------------------------------------------------
# auto_accelerate: the cases of tests/test_accel.py that do not depend on
# timing, on one process (here) and on four gloo ranks (one spawn)
# ---------------------------------------------------------------------------
def _cases(n: int, port_budget: float) -> dict:
    pinned = Strategy(mesh=MeshConfig(dp=n), dtype="float32").to_json()
    return {
        "pinned": dict(model=dict(num_layers=2), batch=8, seq=16, strategy=pinned, step=True),
        "opts_once": dict(model=dict(num_layers=2), batch=8, seq=16, register_add_layers=True,
                          optimizations=("test_add_layers",), max_candidates=1, max_timed=1),
        "int8_mlp": dict(model=dict(num_layers=2), batch=8, seq=16, strategy=pinned,
                         optimizations=("int8_mlp",)),
        "grad_accum": dict(model=dict(num_layers=2), batch=16, seq=32, strategy=pinned,
                           grad_accum=2, step=True),
        "reject_pp": dict(model=dict(num_layers=4), batch=8, seq=32, grad_accum=2,
                          strategy=Strategy(mesh=MeshConfig(pp=2, dp=2), num_microbatches=4).to_json()),
        "reject_batch": dict(model=dict(num_layers=4), batch=6, seq=32, grad_accum=4),
        "remat_retry": dict(model=dict(num_layers=4), batch=16, seq=64, hbm_budget=port_budget,
                            max_candidates=4, max_timed=1),
        "budget_error": dict(model=dict(num_layers=2), batch=8, seq=16, hbm_budget=1.0,
                             max_candidates=1),
    }


def _jax_case(c: dict, n: int, hbm_budget=None) -> dict:
    """``accel_case``'s JAX twin on ``n`` virtual devices (``hbm_budget``
    in place of the case's)."""
    if c.get("register_add_layers"):
        jopt.register_optimization(
            "test_add_layers",
            lambda cf, s: (dataclasses.replace(cf, num_layers=cf.num_layers + 2), s))
    try:
        res = jacc.auto_accelerate(
            jcfg.tiny(**c.get("model", {})), optax.adamw(1e-3), c["batch"], c["seq"],
            devices=jax.devices()[:n],
            strategy=JStrategy.from_json(c["strategy"]) if c.get("strategy") else None,
            optimizations=tuple(c.get("optimizations", ())), grad_accum=c.get("grad_accum", 1),
            hbm_budget=hbm_budget or c.get("hbm_budget"),
            max_candidates=c.get("max_candidates", 16), max_timed=c.get("max_timed", 3),
        )
    except Exception as e:
        return dict(error=type(e).__name__, msg=str(e))
    return dict(strategy=res.strategy.to_json(), describe=res.strategy.describe(),
                num_layers=res.cfg.num_layers, remat=res.cfg.remat, int8_mlp=res.cfg.int8_mlp)


def _midpoint_budget(plain, remat) -> float:
    """A budget between a package's remat and plain figures (the search
    must refuse every plain candidate and fit a remat one)."""
    lo = min(r.mem_bytes for r in remat if r.ok)
    hi = min(r.mem_bytes for r in plain if r.ok)
    assert lo < hi
    return math.sqrt(lo * hi)


def _port_budget(n):
    cfg, tx = tcfg.tiny(num_layers=4), ttrainer.build_optimizer("adamw", lr=1e-3)
    cands = tcand.candidate_strategies(cfg, n, 16, 64, 4)
    plain = [tdr.compiled_cost(s, cfg, tx, 16, 64, n) for s in cands]
    remat = [tdr.compiled_cost(dataclasses.replace(s, opts=s.opts + ("remat",)), cfg, tx, 16, 64, n)
             for s in cands]
    return _midpoint_budget(plain, remat)


def _jax_budget(n):
    cfg, tx = jcfg.tiny(num_layers=4), optax.adamw(1e-3)
    devs = jax.devices()[:n]
    cands = jcand.candidate_strategies(cfg, n, 16, 64, 4)
    plain = [jdr.compiled_cost(s, cfg, tx, 16, 64, devs) for s in cands]
    remat = [jdr.compiled_cost(dataclasses.replace(s, opts=s.opts + ("remat",)), cfg, tx, 16, 64, devs)
             for s in cands]
    return _midpoint_budget(plain, remat)


@pytest.fixture(scope="module")
def accel_runs(tmp_path_factory):
    """The port's cases on one process and on four gloo ranks; the JAX
    package's on 1 and 4 of its virtual devices."""
    import os

    d = tmp_path_factory.mktemp("accel")
    old = os.environ.get("DLROVER_TPU_TOPOLOGY_CACHE")
    os.environ["DLROVER_TPU_TOPOLOGY_CACHE"] = str(d / "cache")
    try:
        return _accel_runs(d)
    finally:
        if old is None:
            os.environ.pop("DLROVER_TPU_TOPOLOGY_CACHE", None)
        else:
            os.environ["DLROVER_TPU_TOPOLOGY_CACHE"] = old


def _accel_runs(d):
    out = {}
    for n in (1, 4):
        cases = _cases(n, _port_budget(n))
        if n == 1:
            port = {k: tdw.accel_case(c) for k, c in cases.items()}
        else:
            ranks = tdw.run_ranks("accel", 4, cases, str(d / "w4"))
            # every rank builds rank 0's winner
            for r in ranks[1:]:
                assert {k: v.get("strategy") for k, v in r.items()} == {
                    k: v.get("strategy") for k, v in ranks[0].items()}
            port = ranks[0]
        # the JAX package's searches compile every candidate: its
        # remat retry and optimizations-once cases run on 1 device only
        want = {k: _jax_case(c, n, _jax_budget(1) if k == "remat_retry" else None)
                for k, c in cases.items()
                if not (k in ("remat_retry", "opts_once") and n > 1)}
        out[n] = (port, want)
    return out


@pytest.mark.parametrize("n", [1, 4])
def test_auto_accelerate_pinned_and_grad_accum(accel_runs, n):
    port, want = accel_runs[n]
    assert port["pinned"]["strategy"] == want["pinned"]["strategy"]
    assert math.isfinite(port["pinned"]["loss"])
    g = port["grad_accum"]
    assert g["strategy"] == want["grad_accum"]["strategy"]
    assert Strategy.from_json(g["strategy"]).grad_accum == 2 and "ga2" in g["describe"]
    assert math.isfinite(g["loss"])


@pytest.mark.parametrize("n", [1, 4])
def test_auto_accelerate_applies_optimizations_once(accel_runs, n):
    port, want = accel_runs[n]
    assert port["opts_once"]["num_layers"] == accel_runs[1][1]["opts_once"]["num_layers"] == 4
    assert Strategy.from_json(port["opts_once"]["strategy"]).opts == ("test_add_layers",)
    # int8_mlp applies in the JAX package; the port's build names its item
    assert want["int8_mlp"]["int8_mlp"]
    assert port["int8_mlp"]["error"] == "NotImplementedError" and "A12" in port["int8_mlp"]["msg"]


@pytest.mark.parametrize("n", [1, 4])
def test_auto_accelerate_rejections_and_budget_error(accel_runs, n):
    port, want = accel_runs[n]
    for case, match in (("reject_pp", "num_microbatches"), ("reject_batch", "divide")):
        assert port[case]["error"] == want[case]["error"] == "ValueError"
        assert match in port[case]["msg"] and port[case]["msg"] == want[case]["msg"]
    for r in (port, want):
        assert r["budget_error"]["error"] == "RuntimeError"
        assert r["budget_error"]["msg"].startswith(
            "no candidate strategy compiled within budget; smallest candidate needs")


@pytest.mark.parametrize("n", [1, 4])
def test_auto_accelerate_retries_with_remat(accel_runs, n):
    """Each package with a budget between its own remat and plain
    figures (the JAX package's XLA analysis and the port's static
    estimate differ; on the CPU remat trims the JAX figure by ~4 %):
    no plain candidate fits, the retry's winner has remat."""
    port, want = accel_runs[n]
    assert port["remat_retry"]["remat"] and "remat" in Strategy.from_json(
        port["remat_retry"]["strategy"]).opts
    fits = [f for _, ok, f, _, _ in port["remat_retry"]["reports"] if ok]
    assert True in fits
    if n == 1:
        assert want["remat_retry"]["remat"]


def test_tpe_search_keeps_unknown_memory_viable():
    """On the CPU a timed run has no memory figure (``mem_bytes`` 0): the
    TPE path classifies it ``fits=None``, viable, as the combination
    path does (``tests/test_accel.py``'s tri-state case), and
    ``auto_accelerate(search="bayes")`` returns its measured winner."""
    cfg, tx = tcfg.tiny(num_layers=1), ttrainer.build_optimizer("adamw", lr=1e-3)
    reports = tbayes.tpe_search([Strategy(dtype="float32")], cfg, tx, 2, 16, "cpu", budget=1,
                                n_init=1, timed_steps=1, hbm_budget=1e9)
    assert reports[0].step_s is not None and reports[0].fits is None
    res = tacc.auto_accelerate(cfg, tx, 2, 16, device="cpu", search="bayes", max_timed=1)
    assert res.reports[0].step_s is not None and res.strategy == res.reports[0].strategy
    with pytest.raises(ValueError, match="unknown search"):
        tacc.auto_accelerate(cfg, tx, 2, 16, device="cpu", search="grid")


def test_profiler_measures_and_traces_on_the_cpu(tmp_path):
    """``measure_step`` / ``module_breakdown`` time on the host clock on
    the CPU (CUDA events on the card) and report no MFU there (no card
    peak); ``trace_steps`` writes a Chrome trace through the port's
    ``ProfilerCapture``."""
    import json

    import torch

    cfg, tx = tcfg.tiny(num_layers=1), ttrainer.build_optimizer("sgd", lr=1e-2)
    _, _, step_fn, init_fn, make_batch, _ = tdr._build(Strategy(), cfg, tx, "cpu")
    state = init_fn(0)
    x, y = make_batch(4, 16)
    flops = tprof.profile_model(cfg, 4, 16).step_flops
    m = tprof.measure_step(step_fn, state, (x, y), flops, iters=2)
    assert m.step_seconds > 0 and m.mfu_pct is None and m.device_kind == "cpu"
    rows = tprof.module_breakdown(cfg, tx, 2, 16, iters=1, device="cpu")
    assert [r.name for r in rows] == ["embed", "block_fwd", "block_fwd_bwd", "lm_head_fwd_bwd",
                                      "optimizer_update"]
    assert all(r.ms > 0 for r in rows) and rows[1].tflops_per_s is not None
    out = tprof.trace_steps(step_fn, state, (x, y), str(tmp_path), steps=1)
    with open(f"{out}/trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert torch.isfinite(torch.tensor(m.achieved_tflops))
