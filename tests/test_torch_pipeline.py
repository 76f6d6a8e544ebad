"""Pipeline parallelism in the port (``dlrover_tpu_torch/parallel/
pipeline.py``) against the JAX package's ``parallel/pipeline.py``.

Without processes: the stacked layout (``stack_pipeline_params`` /
``unstack_pipeline_params``) equal to the JAX functions on numpy, at
virtual 1 and 2; ``schedule_occupancy`` equal to the reference over a
grid of (pp, M, v) with partial last lane groups; the tick clock's hops
landing one tick later on the neighbour; the config refusals with the
JAX package's messages, pp x sp refused as the JAX package refuses it; the
``PPSyncPlan``'s buckets and bytes equal to the JAX ``plan_for_pipeline``'s;
the dry runner's pp report (the bubble term, the stage's static peak).

In gloo rank processes (``tests/torch_dist_worker.py`` job ``pp``): the
port's pipeline step from the JAX stacked weights (numpy-seeded), the
same global batches, against the JAX ``build_pipeline_train_step`` on
the CPU mesh of the same shape, for GPipe, 1F1B and interleaved 1F1B at
pp = 2 and pp = 4, tied (GPT-2-like: learned positions, LayerNorm,
GELU) and untied (RoPE, RMSNorm, SwiGLU), and pp 2 x dp 2 with and
without ``comm_overlap``: losses at the reference's rtol 1e-5 / atol
1e-6, the first step's gradients at rtol 2e-4 / atol 2e-5 (the JAX
step's from its SGD update), the grad norms, and the params after 3
steps. The JAX references run in threads while the ranks run."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlrover_tpu.accel import dry_runner as jdr
from dlrover_tpu.accel.strategy import Strategy as JStrategy
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.parallel import grad_sync as jgs
from dlrover_tpu.parallel import pipeline as jpl
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer

from dlrover_tpu_torch.accel import dry_runner as tdr
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models.convert import params_to_numpy
from dlrover_tpu_torch.models.transformer import Transformer, check_supported
from dlrover_tpu_torch.parallel import grad_sync as tgs
from dlrover_tpu_torch.parallel import pipeline as tpl
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as tt

import torch_dist_worker as tdw

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_pipeline.py's
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 1e-5  # f32 params after 3 SGD steps
LR = 0.1
STEPS = 3
UNTIED = dict(num_layers=4)
TIED = dict(num_layers=4, tie_embeddings=True, rope=False, rmsnorm=False, swiglu=False)


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _by_path(tree, prefix=""):
    """``{path: array}`` of a nested dict / list tree (numpy or JAX)."""
    out = {}
    for kp, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join([prefix] * bool(prefix) + [_key(k) for k in kp])] = np.asarray(a)
    return out


def _seeded_tree(model, seed=0):
    """A list-layout param tree of ``tiny(**model)`` drawn with numpy:
    norm scales ``1 + 0.1 n``, every other leaf ``0.1 n``."""
    rng = np.random.default_rng(seed)
    tree = params_to_numpy(Transformer(tcfg.tiny(**model)))

    def fill(node):
        if isinstance(node, dict):
            return {k: (fill(v) if isinstance(v, (dict, list)) else
                        ((1.0 if k == "scale" else 0.0)
                         + 0.1 * rng.standard_normal(v.shape)).astype(np.float32))
                    for k, v in node.items()}
        return [fill(v) for v in node]

    return fill(tree)


def _batches(vocab, rows, n=STEPS, T=16, seed=3):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, vocab, (n, rows, T + 1)).astype(np.int32)
    return [(d[:, :-1], d[:, 1:]) for d in data]


# name: (model, pp, dp, schedule, virtual, M, rows, comm_overlap)
STEP_CASES = {}
for _tie, _model in (("untied", UNTIED), ("tied", TIED)):
    for _pp in (2, 4):
        for _sched, _v in (("gpipe", 1), ("1f1b", 1), ("interleaved", 2)):
            # interleaved at pp = 2: M = 3, a partial last lane group; at
            # pp = 4 the model needs pp x v = 8 layers
            m = dict(_model, num_layers=8) if _pp * _v > 4 else _model
            M, rows = (3, 6) if (_sched, _pp) == ("interleaved", 2) else (4, 8)
            STEP_CASES[f"{_sched}_pp{_pp}_{_tie}"] = (m, _pp, 1, _sched, _v, M, rows, False)
STEP_CASES.update({
    "gpipe_pp2_dp2_overlap": (UNTIED, 2, 2, "gpipe", 1, 4, 8, True),
    "1f1b_pp2_dp2_overlap": (TIED, 2, 2, "1f1b", 1, 2, 8, True),
    "interleaved_pp2_dp2_default": (UNTIED, 2, 2, "interleaved", 2, 2, 8, False),
})
# the per-leaf 8-bit AdamW: the JAX pipeline's whole state after one step
# carried into the ranks (``load_jax_train_state``), one more step in both
# packages, the port's whole state carried back (``jax_train_state``). A
# second step would let f32 rounding move a few codes (0.7 % of wq's after
# two carried steps on this CPU, none after one)
ADAM8 = dict(optimizer="adamw_8bit", lr=1e-3, opt_kw=dict(min_quantized_size=512))
STATE_CASES = {"adam8_1f1b_pp2_untied": (UNTIED, 2, 1, "1f1b", 1, 4, 8, False)}
CODE_FLIP_SHARE = 5e-3  # 8-bit codes one step apart, at most this share


def _jax_leaves(jstate):
    """A JAX TrainState by leaf path (its checkpoint records' paths)."""
    from dlrover_tpu.ckpt.sharding import host_shard_records

    return {r.path: r.data for r in host_shard_records(jax.device_get(jstate))}


def _jax_run(model, pp, dp, sched, v, M, tree, batches, comm_overlap, opt=None, warm=0):
    """The JAX pipeline step over ``batches`` from ``tree``: each step's
    loss and grad norm, the first step's gradients (from its SGD update),
    the params and the whole state at the end; with ``warm``, its whole
    state after that many steps (``start``) and the metrics after it."""
    jc = jcfg.tiny(**model)
    mesh = build_mesh(JMeshConfig(pp=pp, dp=dp), devices=jax.devices()[:pp * dp])
    opt = opt or dict(optimizer="sgd", lr=LR)
    tx = jtrainer.build_optimizer(opt["optimizer"], lr=opt["lr"], **opt.get("opt_kw", {}))
    sh = jpl.pipeline_state_shardings(jc, mesh, tx, virtual=v)
    params = jax.device_put(jpl.stack_pipeline_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                                      pp, v), sh.params)
    state = jtrain.TrainState(step=jax.device_put(jnp.zeros((), jnp.int32), sh.step),
                              params=params, opt_state=jax.device_put(tx.init(params), sh.opt_state))
    step = jpl.build_pipeline_train_step(jc, mesh, tx, M, donate=False, schedule=sched,
                                         virtual_stages=v if v > 1 else 2,
                                         comm_overlap=comm_overlap, grad_bucket_mb=1)
    before = _by_path(jax.device_get(params))
    metrics, grads, start = [], None, None
    for i, (x, y) in enumerate(batches):
        if i == warm:
            start = _jax_leaves(state)
        state, m = step(state, x, y)
        if i >= warm:
            metrics.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
        if grads is None:
            after = _by_path(jax.device_get(state.params))
            grads = {k: (before[k] - after[k]) / LR for k in before}
    return dict(metrics=metrics, grads=grads, params=_by_path(jax.device_get(state.params)),
                start=start, state=_jax_leaves(state))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Worlds 2 and 4 of rank processes start first; the JAX references
    run in threads while they do."""
    trees = {}

    def tree_of(model):
        key = tuple(sorted(model.items()))
        if key not in trees:
            trees[key] = _seeded_tree(model)
        return trees[key]

    cases = {2: {}, 4: {}}
    for name, (model, pp, dp, sched, v, M, rows, overlap) in STEP_CASES.items():
        stacked = tpl.stack_pipeline_params(tree_of(model), pp, v)
        cases[pp * dp][name] = dict(kind="step", model=model, mesh=dict(pp=pp, dp=dp),
                                    schedule=sched, virtual=v, microbatches=M, params=stacked,
                                    batches=_batches(256, rows), optimizer="sgd", lr=LR,
                                    comm_overlap=overlap)
    wait_two = tdw.start_ranks("pp", 2, cases[2], str(tmp_path_factory.mktemp("pp_two")))
    wait_four = tdw.start_ranks("pp", 4, cases[4], str(tmp_path_factory.mktemp("pp_four")))
    ref = {}
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = {name: ex.submit(_jax_run, model, pp, dp, sched, v, M, tree_of(model),
                                    _batches(256, rows), overlap)
                    for name, (model, pp, dp, sched, v, M, rows, overlap) in STEP_CASES.items()}
            futs.update({name: ex.submit(_jax_run, model, pp, dp, sched, v, M, tree_of(model),
                                         _batches(256, rows, n=2), overlap, ADAM8, 1)
                         for name, (model, pp, dp, sched, v, M, rows, overlap)
                         in STATE_CASES.items()})
            ref = {name: f.result() for name, f in futs.items()}
    finally:
        two, four = wait_two(), wait_four()
    got = {name: [r[name] for r in (two if STEP_CASES[name][1] * STEP_CASES[name][2] == 2
                                    else four)]
           for name in STEP_CASES}
    # the 8-bit runs start from the JAX state after its first step
    carry = {}
    for name, (model, pp, dp, sched, v, M, rows, overlap) in STATE_CASES.items():
        carry[name] = dict(kind="step", model=model, mesh=dict(pp=pp, dp=dp), schedule=sched,
                           virtual=v, microbatches=M,
                           params=tpl.stack_pipeline_params(tree_of(model), pp, v),
                           jax_state=ref[name]["start"], batches=_batches(256, rows, n=2)[1:],
                           comm_overlap=overlap, **ADAM8)
    res = tdw.run_ranks("pp", 2, carry, str(tmp_path_factory.mktemp("pp_carry")))
    got.update({name: [r[name] for r in res] for name in STATE_CASES})
    return ref, got


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_pipeline_steps_match_the_jax_package(runs, name):
    ref, got = runs
    want = ref[name]
    model, pp, dp, sched, v, M, rows, overlap = STEP_CASES[name]
    for r in got[name]:
        assert len(r["metrics"]) == STEPS
        for g, w in zip(r["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], **LOSS_TOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], **GRAD_TOL)
        assert r["grads"].keys() == want["grads"].keys()
        for path, w in want["grads"].items():
            np.testing.assert_allclose(r["grads"][path], w, err_msg=path, **GRAD_TOL)
        have = _by_path(r["params"])
        assert have.keys() == want["params"].keys()
        for path, w in want["params"].items():
            np.testing.assert_allclose(have[path], w, atol=PARAM_ATOL, err_msg=path)
    # every microbatch crosses each of the P v - 1 chunk boundaries once
    # forward and once back, in each data coordinate
    for k in range(STEPS):
        assert sum(r["metrics"][k]["hops"] for r in got[name]) == 2 * M * (pp * v - 1) * dp
    assert sorted(r["stage"] for r in got[name]) == sorted(list(range(pp)) * dp)
    if overlap:
        plan = got[name][0]["plan"]
        assert plan["kind"] == "pp"
        for r in got[name]:
            for m in r["metrics"]:
                # one reduce-scatter and one all-gather a bucket over dp,
                # each bucket's flat in f32
                assert m["issued"]["reduce_scatter"] == m["issued"]["all_gather"] == plan["buckets"]
                assert m["issued_bytes"]["reduce_scatter"] == 4 * sum(plan["padded"])
                assert m["issued_bytes"]["all_gather"] == 4 * sum(plan["padded"]) // dp
    else:
        assert all(m["issued"]["reduce_scatter"] == 0 for r in got[name] for m in r["metrics"])


# -- no processes --------------------------------------------------------------
@pytest.mark.parametrize("v", [1, 2])
def test_stacking_round_trips_as_the_jax_package_does(v):
    tree = _seeded_tree(dict(UNTIED, num_layers=8))
    want = jpl.stack_pipeline_params(jax.tree_util.tree_map(jnp.asarray, tree), 2, v)
    got = tpl.stack_pipeline_params(tree, 2, v)
    w, g = _by_path(want), _by_path(got)
    assert w.keys() == g.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    cfg = tcfg.tiny(**dict(UNTIED, num_layers=8))
    back = tpl.unstack_pipeline_params(got, cfg, v)
    for k, a in _by_path(tree).items():
        np.testing.assert_array_equal(_by_path(back)[k], a, err_msg=k)
    # the torch leaves stack alike
    import torch

    tt_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    for k, a in _by_path(jax.tree_util.tree_map(np.asarray,
                                                 tpl.stack_pipeline_params(tt_tree, 2, v))).items():
        np.testing.assert_array_equal(a, g[k], err_msg=k)
    assert tpl.pipeline_logical_axes(cfg, 2, v) == jpl.pipeline_logical_axes(
        jcfg.tiny(**dict(UNTIED, num_layers=8)), 2, v)
    assert tpl.pipeline_rules().rules == jpl.pipeline_rules().rules


def test_schedule_occupancy_is_the_jax_package_s():
    for pp in (1, 2, 3, 4):
        for M in range(1, 10):
            for v in (1, 2, 3):
                assert tpl.schedule_occupancy(pp, M, v) == jpl.schedule_occupancy(pp, M, v), \
                    (pp, M, v)


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1), ("interleaved", 2),
                                        ("interleaved", 3)])
def test_the_clock_runs_every_slot_once_and_hops_one_tick(schedule, v):
    """Each (microbatch, chunk) runs forward and backward once on its
    device, the backward after the forward; a forward's output is the
    next chunk's input on the next device one tick later, a cotangent
    the previous chunk's one tick later (the pairing the exchange of a
    tick boundary relies on), and the busy slots are
    ``schedule_occupancy``'s on the 1F1B clocks."""
    for P in (2, 3, 4):
        for M in (1, 2, 3, 5, 8):
            n, fwd, bwd = tpl._slots(schedule, P, M, v)
            seen_f, seen_b = {}, {}
            for d in range(P):
                for t in range(n):
                    for slots, seen in ((fwd, seen_f), (bwd, seen_b)):
                        s = slots(d, t)
                        if s is not None:
                            assert (s, d) not in seen
                            seen[(s, d)] = t
            want = {((j, q), d) for j in range(M) for q in range(v) for d in range(P)}
            assert set(seen_f) == set(seen_b) == want
            for ((j, q), d), t in seen_f.items():
                assert seen_b[((j, q), d)] >= t
                g = q * P + d  # the global chunk
                if g < v * P - 1:
                    nxt = ((j, (g + 1) // P), (g + 1) % P)
                    assert seen_f[nxt] == t + 1, (P, M, j, q, d)
                if g > 0:
                    prv = ((j, (g - 1) // P), (g - 1) % P)
                    assert seen_b[prv] == seen_b[((j, q), d)] + 1
            if schedule != "gpipe":
                assert (n, 2 * v * M * P) == tpl.schedule_occupancy(P, M, v)[:2]
            # the inputs a device keeps at once: GPipe's M graphs at the
            # turn, 1F1B's 2(P-1-d)+1, interleaved at most 2vP-1 (the JAX
            # ring buffers)
            for d in range(P):
                kept = max(sum(1 for (jq, dd), t in seen_f.items()
                               if dd == d and t <= s <= seen_b[(jq, dd)])
                           for s in range(n))
                want = {"gpipe": M, "1f1b": min(M, 2 * (P - 1 - d) + 1)}.get(schedule)
                assert kept == want if want else kept <= 2 * v * P - 1, (schedule, P, M, d)


def test_bad_configs_raise_the_jax_package_s_errors():
    for kw, pp, v in ((dict(num_layers=3), 2, 1), (dict(num_layers=4, num_experts=2), 2, 1),
                      (dict(num_layers=4, scan_layers=True), 2, 1), (dict(num_layers=4), 2, 3)):
        with pytest.raises(ValueError) as je:
            jpl._check_pipeline_cfg(jcfg.tiny(**kw), pp, v)
        with pytest.raises(ValueError) as te:
            tpl._check_pipeline_cfg(tcfg.tiny(**kw), pp, v)
        assert str(te.value) == str(je.value)
    cfg = tcfg.tiny(num_layers=4)
    check_supported(cfg, MeshConfig(pp=2, dp=2))
    # pp composes with fsdp and tp; sp inside the stages is the JAX
    # package's refusal
    for sizes in (dict(pp=2, fsdp=2), dict(pp=2, tp=2), dict(pp=2, dp=2, tp=2)):
        check_supported(cfg, MeshConfig(**sizes))
    with pytest.raises(ValueError, match="sp \\(ring attention\\) inside pp stages"):
        check_supported(cfg, MeshConfig(pp=2, sp=2))
    with pytest.raises(ValueError, match="pp=2 x ep=2"):
        check_supported(tcfg.tiny(num_layers=4, num_experts=4), MeshConfig(pp=2, ep=2))
    with pytest.raises(ValueError, match="num_layers=3"):
        check_supported(tcfg.tiny(num_layers=3), MeshConfig(pp=2))
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tpl.build_pipeline_train_step(cfg, None, None, 2, schedule="zb")
    with pytest.raises(ValueError, match="virtual_stages >= 2"):
        tpl.build_pipeline_train_step(cfg, None, None, 2, schedule="interleaved", virtual_stages=1)


@pytest.mark.parametrize("sizes,sched,v", [
    (dict(pp=2, dp=2), "gpipe", 1), (dict(pp=2, dp=4), "1f1b", 1),
    (dict(pp=2, dp=2), "interleaved", 2), (dict(pp=4, dp=2), "gpipe", 1),
])
@pytest.mark.parametrize("model", [UNTIED, TIED], ids=["untied", "tied"])
def test_the_pp_plan_is_the_jax_package_s(sizes, sched, v, model):
    model = dict(model, num_layers=8)
    want = jgs.plan_for_pipeline(jcfg.tiny(**model), sizes, grad_bucket_mb=1, schedule=sched,
                                 virtual=v)
    got = tgs.plan_for_pipeline(tcfg.tiny(**model), sizes, grad_bucket_mb=1, schedule=sched,
                                virtual=v)
    for part in ("stage_plan", "shared_plan"):
        w, g = getattr(want, part), getattr(got, part)
        assert _rows(g.buckets) == _rows(w.buckets) and g.leaf_shapes == w.leaf_shapes
        assert g.leaf_dtypes == w.leaf_dtypes and g.kind == w.kind == "pp"
    for attr in ("num_buckets", "raw_bytes", "wire_bytes", "pp", "dp", "schedule", "compress"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.explicit_wire_bytes() == want.explicit_wire_bytes()
    assert got.gspmd_allreduce_bytes() == want.gspmd_allreduce_bytes()
    assert got.describe().split(":")[0] == want.describe().split(":")[0]
    s = Strategy(mesh=MeshConfig(**sizes), comm_overlap=True, grad_bucket_mb=1,
                 pp_schedule=sched, num_microbatches=4)
    assert _rows(tgs.resolve_plan(tcfg.tiny(**model), s).buckets) == _rows(got.buckets)
    # the non-pipeline step has no stage structure to plan on
    assert tgs.plan_for_mesh(tcfg.tiny(**model), _FakeMesh(sizes)) is None
    # the model cannot pipeline at this degree: no plan
    assert tgs.plan_for_pipeline(tcfg.tiny(num_layers=3), sizes) is None
    assert tgs.plan_for_pipeline(tcfg.tiny(num_layers=4), dict(pp=2)) is None


def _rows(buckets):
    return [tuple(vars(b).values()) for b in buckets]


class _FakeMesh:
    def __init__(self, sizes):
        self.config = MeshConfig(**sizes)

    def axis_sizes(self):
        return self.config.axis_sizes()


@pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
def test_the_dry_runner_prices_a_stage(sched):
    """The pp strategy builds statically (``compiled_cost``), its flops
    carry the JAX package's bubble factor, and the static peak is the
    largest stage's, each stage's with the inputs its clock keeps."""
    cfg = tcfg.tiny(num_layers=8)
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=512)
    s = Strategy(mesh=MeshConfig(pp=2, dp=2), num_microbatches=4, pp_schedule=sched)
    r = tdr.compiled_cost(s, cfg, tx, 8, 16, 4)
    assert r.ok, r.error
    rj = jdr.DryRunReport(strategy=JStrategy(mesh=JMeshConfig(pp=2, dp=2), num_microbatches=4,
                                             pp_schedule=sched), ok=True)
    jdr._analytic_estimate(rj, jcfg.tiny(num_layers=8), 8, 16, list(jax.devices())[:4])
    np.testing.assert_allclose(r.flops_per_device, rj.flops_per_device, rtol=1e-12)
    v = s.resolved_virtual()
    plain = tdr.DryRunReport(strategy=Strategy(mesh=MeshConfig(dp=4)), ok=True)
    tdr._analytic_estimate(plain, cfg, 8, 16, 4)
    np.testing.assert_allclose(r.flops_per_device / plain.flops_per_device, 1 + 1 / (4 * v))
    peaks = [tdr.static_peak_bytes(cfg, s, tx, 8, 16, stage=k) for k in (0, 1)]
    assert r.mem_bytes == max(peaks) == tdr.static_peak_bytes(cfg, s, tx, 8, 16)
    # the flat optimizer and grad_accum stay refused on pp
    flat = tt.build_optimizer("adamw_8bit_flat")
    assert "adamw_8bit_flat" in tdr.compiled_cost(s, cfg, flat, 8, 16, 4).error


@pytest.mark.parametrize("name", list(STATE_CASES))
def test_the_jax_pipeline_state_carries_both_ways(runs, name):
    """The JAX pipeline's train state after one step (stage-stacked params
    and per-leaf 8-bit codes and scales) loaded into each stage rank, one
    more step in both packages, and the port's state gathered back into
    the JAX stacked layout: the loss at the reference's tolerance, the
    params to ``PARAM_ATOL`` but where a moment's code flipped, a code at
    most one step off (a value on a rounding boundary), the scales and
    counts the JAX package's."""
    ref, got = runs
    want = ref[name]
    for r in got[name]:
        for g, w in zip(r["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], **LOSS_TOL)
        assert r["state"].pop("grad_residual") is None  # pp plans never compress
        assert set(r["state"]) == set(want["state"])
        for path, b in want["state"].items():
            a, b = np.asarray(r["state"][path]), np.asarray(b)
            assert a.shape == b.shape, path
            if b.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and np.mean(d > 0) <= CODE_FLIP_SHARE, path
            elif path.startswith("params/"):
                # all but CODE_FLIP_SHARE of the elements to PARAM_ATOL;
                # one whose moment's code sits a step apart moves by less
                # than the step's lr (one element of w_gate's 8192 here,
                # by 0.29 lr)
                np.testing.assert_allclose(a, b, rtol=0, atol=ADAM8["lr"], err_msg=path)
                assert np.mean(np.abs(a - b) > PARAM_ATOL) <= CODE_FLIP_SHARE, path
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * max(np.abs(b).max(), 1e-30),
                                           err_msg=path)
