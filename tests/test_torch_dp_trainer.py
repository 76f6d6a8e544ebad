"""The port's data-parallel step and trainer on the CPU, over gloo in 2
rank processes (one start for each world size, every case inside):

- ``ElasticTrainer`` at dp=2 trains one model on halves of the global
  batch: its losses equal a world-size-1 run on the same global batches
  within 1e-6, on the default path and on the explicit one (``none``);
- ``grad_accum=2`` issues exactly one bucketed sync a step on the
  explicit path (and one all-reduce a microbatch on the default one),
  counted by the collective wrappers every collective goes through;
- ``comm_overlap`` with ``int8`` at dp=2 against the JAX package's
  ``build_train_step`` on a 2-device CPU mesh over 3 steps, weights
  carried across by ``models/convert.py`` (the whole JAX state after
  one step, the residual included, into each rank; three more steps;
  the port's whole state back): losses and grad norms to 1e-5; params
  to 1e-6 and the residual to 1e-5 of the quantized values, but for a
  few elements whose int8 code flipped by one (``_mostly_close``);
- ZeRO (dp=1 x fsdp=2) with the per-leaf ``adamw_8bit`` against the JAX
  dp x fsdp step, the same way (each rank takes its block rows of the
  params and of the 8-bit codes and scales, and hands them back): the
  losses to 1e-5, the params to the per-leaf 8-bit AdamW's tolerances
  of ``tests/test_torch_train.py``, codes within one step, scales and
  counts to 1e-4;
- a flash checkpoint at world 2 (dp, and ZeRO with its shards), each a
  job of its own whose saver this process hosts, is restored from the
  saver's shm and resumes bitwise: the resumed losses and params equal
  the uninterrupted run's; the ZeRO records are the JAX leaves' blocks,
  which the JAX package's reader assembles into the whole state;
- ``sdc_detect=True`` raises, naming ROADMAP A15.
"""

import jax
import numpy as np
import pytest

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.parallel import grad_sync as jgs
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

import torch_dist_worker as tdw

LOSS_TOL = 1e-6  # dp=2 against world size 1, the same global batches
JAX_LOSS_RTOL = 1e-5
# the per-leaf 8-bit AdamW against the JAX one (tests/test_torch_train.py)
PARAM_ATOL = 1e-4
PARAM_CLOSE_ATOL = 1e-6
PARAM_FLIP_SHARE = 5e-3
STEPS = 6
SDC_SPEC = "device.sdc:scale:@2:1"


def _run(name, strategy=None, **kw):
    r = {"steps": STEPS, **kw}
    if strategy is not None:
        strategy = dict(strategy)
        r["mesh"] = strategy.pop("mesh")
        r["strategy"] = strategy
    return name, r


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    one = dict([_run("ga1"), _run("ga2", trainer=dict(grad_accum=2))])
    ck = dict(save_memory_interval=2, save_storage_interval=4)
    zero = dict(strategy=dict(mesh=dict(fsdp=2), comm_overlap=True), optimizer="adamw_8bit",
                lr=1e-3, opt_kw=dict(min_quantized_size=512))
    two = dict([
        _run("default"), _run("explicit", trainer=dict(comm_overlap=True)),
        _run("default_ga2", trainer=dict(grad_accum=2)),
        _run("explicit_ga2", trainer=dict(comm_overlap=True, grad_accum=2)),
        # the checkpoint drill: 4 steps saved, then a fresh trainer
        _run("ckpt_first", steps=4, trainer=dict(comm_overlap=True, ckpt_dir=str(d / "ck"), **ck)),
        _run("ckpt_resume", trainer=dict(comm_overlap=True, ckpt_dir=str(d / "ck"), **ck)),
        _run("zero", eval=True, **zero),
    ])
    # the ZeRO drill is a job of its own: a saver serves one job, whose
    # steps only go up
    zk = dict([
        _run("zero_first", steps=4, trainer=dict(ckpt_dir=str(d / "zk"), **ck), **zero),
        _run("zero_resume", trainer=dict(ckpt_dir=str(d / "zk"), **ck), **zero),
    ])
    w1 = tdw.run_ranks("train", 1, one, str(d / "w1"))[0]
    # this process hosts the saver of each drill, as the agent would
    with tdw.hosted_saver(2) as env:
        w2 = tdw.run_ranks("train", 2, two, str(d / "w2"), env=env)
    with tdw.hosted_saver(2) as env:
        for r, z in zip(w2, tdw.run_ranks("train", 2, zk, str(d / "zk_ranks"), env=env)):
            r.update(z)
    return w1, w2


@pytest.mark.parametrize("run", ["default", "explicit"])
def test_dp2_losses_equal_world_size_one(train_runs, run):
    one, two = train_runs
    ref = one["ga1"]["losses"]
    for r in two:
        assert len(r[run]["losses"]) == STEPS
        np.testing.assert_allclose(r[run]["losses"], ref, rtol=0, atol=LOSS_TOL * max(ref))
    # both ranks hold the same model
    for a, b in zip(_leaves(two[0][run]["params"]), _leaves(two[1][run]["params"])):
        np.testing.assert_array_equal(a, b)
    assert two[0]["explicit"]["stats"]["grad_sync_path"] == "explicit"
    # the sync starts after the backward and is waited for: none hidden
    assert two[0]["explicit"]["stats"]["comm_overlap_pct"] == 0.0
    assert two[0]["default"]["stats"]["grad_sync_path"] == "gspmd"


def test_grad_accum_issues_one_sync_a_step(train_runs):
    one, two = train_runs
    np.testing.assert_allclose(two[0]["explicit_ga2"]["losses"], one["ga2"]["losses"], rtol=0,
                               atol=LOSS_TOL * max(one["ga2"]["losses"]))
    nb = two[0]["explicit_ga2"]["plan"]
    for step in two[0]["explicit_ga2"]["issued"]:
        # the buckets' reduce-scatter + all-gather once, and the loss mean
        assert step == dict(reduce_scatter=nb, all_to_all=0, all_gather=nb, all_reduce=1)
    for step in two[0]["default_ga2"]["issued"]:
        # the default path: the whole tree a microbatch, and the loss mean
        assert step == dict(reduce_scatter=0, all_to_all=0, all_gather=0, all_reduce=3)


def _leaves(tree):
    return jax.tree.leaves(tree)


def _mostly_close(a, b, close, most):
    """Every element within ``most``, and all but ``PARAM_FLIP_SHARE``
    of them within ``close``: the weights agree to ~1e-7 relative after
    a step, not bitwise, so now and then a value that lands on a
    rounding boundary of an 8-bit code takes the neighbouring code, and
    that element moves by up to one code step."""
    np.testing.assert_allclose(a, b, rtol=0, atol=most)
    assert np.mean(np.abs(a - b) > close) <= PARAM_FLIP_SHARE


@pytest.mark.parametrize("run,first,resume", [("explicit", "ckpt_first", "ckpt_resume"),
                                              ("zero", "zero_first", "zero_resume")])
def test_flash_checkpoint_at_world_two_resumes_bitwise(train_runs, run, first, resume):
    _, two = train_runs
    for r in two:
        assert r[first]["losses"] == r[run]["losses"][:4]
        # restored from the saver's shm, not from disk
        assert (r[resume]["restored"], r[resume]["source"]) == (4, "memory")
        assert r[resume]["losses"] == r[run]["losses"][4:]
        for a, b in zip(_leaves(r[resume]["params"]), _leaves(r[run]["params"])):
            np.testing.assert_array_equal(a, b)


def test_zero_holds_only_shards_between_steps(train_runs):
    """Under ZeRO the full params are freed after the backward and
    gathered for the forward: after training, and after an eval (which
    gathers them for its forward), each rank holds only its shards; the
    eval's loss is that of the trained params on the eval rows."""
    import torch

    from dlrover_tpu_torch.models.convert import params_from_jax
    from dlrover_tpu_torch.models.transformer import forward, token_nll

    _, two = train_runs
    cfg = tcfg.tiny()
    model = params_from_jax(two[0]["zero"]["params"], cfg)
    rows = tdw.Tokens(n=16, seed=5).data
    with torch.no_grad():
        want = np.mean([float(token_nll(forward(model, torch.from_numpy(b[:, :-1]).long(), cfg)[0],
                                        torch.from_numpy(b[:, 1:]).long()))
                        for b in (rows[:8], rows[8:])])
    for r in two:
        assert r["zero"]["params_freed"]
        np.testing.assert_allclose(r["zero"]["eval_loss"], want, rtol=1e-6)


def _jax_batches(cfg, n=3, B=8, T=16, seed=3):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, cfg.vocab_size, (n, B, T + 1)).astype(np.int32)
    return [(d[:, :-1], d[:, 1:]) for d in data]


def _jax_leaves(jstate):
    """A JAX TrainState by leaf path (its checkpoint records' paths),
    the residual list under ``grad_residual``."""
    from dlrover_tpu.ckpt.sharding import host_shard_records

    out = {r.path: r.data for r in host_shard_records(jax.device_get(jgs.strip_residual(jstate)))}
    out["grad_residual"] = None if jstate.grad_residual is None else [
        np.asarray(r) for r in jstate.grad_residual]
    return out


def _jax_run(jc, mesh_cfg, optimizer, lr, opt_kw, compress, batches, sdc_spec="", warm=1):
    """The JAX step over ``batches``: its whole state after ``warm``
    steps (where the port takes over), its metrics after that, and its
    whole state at the end."""
    from dlrover_tpu.common import faults as jfaults
    from dlrover_tpu.parallel import sdc as jsdc

    mesh = build_mesh(mesh_cfg, devices=jax.devices()[:2])
    jtx = jtrainer.build_optimizer(optimizer, lr=lr, **opt_kw)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    jsdc.set_enabled(bool(sdc_spec))
    if sdc_spec:
        jfaults.configure(sdc_spec)
    try:
        jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False, comm_overlap=True,
                                        grad_compress=compress, grad_bucket_mb=1)
        plan = jgs.plan_for_mesh(jc, mesh, compress, 1)
        jstate = jgs.ensure_residual(jstate, plan, mesh)
        metrics, lanes, start = [], [], None
        for i, (x, y) in enumerate(batches):
            if i == warm:
                start = _jax_leaves(jstate)
            b = jtrain.shard_batch({"x": x, "y": y}, mesh)
            jstate, m = jstep(jstate, b["x"], b["y"])
            if i >= warm:
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                if "sdc_device_norms" in m:
                    lanes.append(np.asarray(m["sdc_device_norms"]))
    finally:
        jsdc._enabled_override = None
        jfaults.reset()
    return start, metrics, _jax_leaves(jstate), plan, lanes


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    jc = jcfg.tiny()
    batches = _jax_batches(jc, n=4)
    runs, ref = {}, {}
    for name, mesh, opt, lr, kw, comp, sdc, warm in (
        ("dp_int8", dict(dp=2), "sgd", 0.1, {}, "int8", "", 1),
        ("zero_adam8", dict(fsdp=2), "adamw_8bit", 1e-3,
         dict(min_quantized_size=512, weight_decay=0.01), "none", "", 1),
        # lane 1 computes wrong-but-finite grads from step 2 on
        ("dp_sdc", dict(dp=2), "sgd", 0.1, {}, "none", SDC_SPEC, 0),
    ):
        start, jm, end, plan, jl = _jax_run(jc, JMeshConfig(**mesh), opt, lr, kw, comp, batches,
                                            sdc, warm)
        ref[name] = dict(metrics=jm, state=end, plan=plan, lanes=jl)
        params = jax.tree.map(np.asarray, _nest_params(start))
        runs[name] = dict(mesh=mesh, compress=comp, optimizer=opt, lr=lr, opt_kw=kw,
                          params=params, jax_state=start, batches=batches[warm:], sdc=sdc)
    got = tdw.run_ranks("step", 2, runs, str(tmp_path_factory.mktemp("step")))
    return ref, got


def _nest_params(leaves):
    """The ``params/...`` leaves as the JAX param tree (layers a list)."""
    tree = {}
    for path, a in leaves.items():
        if not path.startswith("params/"):
            continue
        node, parts = tree, path.split("/")[1:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    if "layers" in tree:
        tree["layers"] = [tree["layers"][str(i)] for i in range(len(tree["layers"]))]
    return tree


def _params(state):
    return [v for k, v in sorted(state.items()) if k.startswith("params/")]


def test_int8_dp2_matches_the_jax_step(step_runs):
    """The JAX state after one step (params, momentum-free SGD, the
    residual) carried into each rank, three more steps in both
    packages, and the port's whole state carried back."""
    ref, got = step_runs
    j = ref["dp_int8"]
    for r in got:
        t = r["dp_int8"]
        np.testing.assert_allclose(np.array(t["metrics"]), np.array(j["metrics"]), rtol=JAX_LOSS_RTOL)
        # a flipped code moves its element's synced grad by up to one
        # code step (the scale: twice the largest residual), and the
        # param by lr times that
        scale = 2 * max(np.abs(b).max() for b in j["state"]["grad_residual"])
        for a, b in zip(_params(t["state"]), _params(j["state"])):
            _mostly_close(a, b, PARAM_CLOSE_ATOL, 1.01 * 0.1 * scale)
        assert int(t["state"]["step"]) == int(j["state"]["step"]) == 4
        assert t["buckets"] == j["plan"].num_buckets
        for a, b in zip(t["state"]["grad_residual"], j["state"]["grad_residual"]):
            # the residual after three steps of error feedback from the
            # carried one: to 1e-5 of the quantized values (127 code
            # steps; the grads they come from drift apart by ~1e-6 a
            # step with the params), up to one code step (the shared
            # scale, twice the largest residual) where a code flipped
            scale = np.abs(b).max() * 2
            assert a.shape == b.shape and np.abs(b).max() > 0
            _mostly_close(a, b, 1e-5 * 127 * scale, 1.01 * scale)


def test_zero_per_leaf_adamw_8bit_matches_the_jax_step(step_runs):
    """ZeRO (dp=1 x fsdp=2) from the JAX dp x fsdp state after one step:
    each rank takes its block rows of the params and of the per-leaf
    8-bit codes and scales; after three more steps the port's state,
    gathered back, is the JAX package's."""
    ref, got = step_runs
    j = ref["zero_adam8"]
    assert j["plan"].kind == "zero"
    for r in got:
        t = r["zero_adam8"]
        assert t["kind"] == "zero"
        np.testing.assert_allclose([m[0] for m in t["metrics"]], [m[0] for m in j["metrics"]],
                                   rtol=JAX_LOSS_RTOL)
        assert set(t["state"]) == set(j["state"])
        for path, b in j["state"].items():
            a = t["state"][path]
            if b is None:
                assert a is None
                continue
            b = np.asarray(b)
            assert a.shape == b.shape, path
            if b.dtype == np.int8:  # codes: a value on a rounding boundary may flip by one
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and np.mean(d > 0) <= PARAM_FLIP_SHARE, path
            elif path.startswith("params/"):
                _mostly_close(a, b, PARAM_CLOSE_ATOL, PARAM_ATOL)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * max(np.abs(b).max(), 1e-30),
                                           err_msg=path)


def test_zero_records_are_blocks_of_the_jax_leaves(step_runs):
    """What a ZeRO rank stages for a checkpoint: records under the JAX
    leaves' paths, shapes and dtypes, each a block of the leaf (the
    rank's run of its row-major flatten, the padding left out). The JAX
    package's reader assembles every leaf from both ranks' records, and
    the result is the port's whole state."""
    from dlrover_tpu.ckpt.sharding import ShardRecord, assemble_leaf

    ref, got = step_runs
    j = ref["zero_adam8"]["state"]
    whole = got[0]["zero_adam8"]["state"]
    by_path = {}
    for r in got:
        for path, shape, dtype, index, data in r["zero_adam8"]["records"]:
            by_path.setdefault(path, []).append(ShardRecord(path, tuple(shape), dtype, index, data))
    assert set(by_path) == set(j) - {"grad_residual"}
    for path, recs in by_path.items():
        b = np.asarray(j[path])
        assert {(r.global_shape, r.dtype) for r in recs} == {(b.shape, str(b.dtype))}, path
        full = assemble_leaf(b.shape, str(b.dtype), tuple((0, d) for d in b.shape), recs)
        np.testing.assert_array_equal(full, whole[path], err_msg=path)


@pytest.mark.parametrize("shape", [(7,), (5, 6), (3, 4, 5), (2, 3, 2, 3), (4, 1), ()])
def test_flat_boxes_tile_every_run_of_the_flatten(shape):
    """A ZeRO shard's blocks: for every run ``[lo, hi)`` of a leaf's
    row-major flatten, the blocks read in order are exactly that run."""
    from dlrover_tpu_torch.ckpt.sharding import flat_boxes

    n = int(np.prod(shape))
    a = np.arange(n).reshape(shape)
    for lo in range(n + 1):
        for hi in range(lo, n + 1):
            parts = [a[tuple(slice(b, e) for b, e in box)].reshape(-1)
                     for box in flat_boxes(shape, lo, hi)]
            got = np.concatenate(parts) if parts else np.zeros(0, int)
            np.testing.assert_array_equal(got, np.arange(lo, hi))


def test_sdc_injection_and_lane_norms_match_the_jax_step(step_runs):
    """With the SDC switch on, the ``device.sdc`` fault's lane scales its
    local grads before the sync and the step reports every lane's
    pre-sync norm, as the JAX step does."""
    ref, got = step_runs
    j = ref["dp_sdc"]
    assert len(j["lanes"]) == 4
    for r in got:
        t = r["dp_sdc"]
        np.testing.assert_allclose(np.array(t["lanes"]), np.array(j["lanes"]), rtol=JAX_LOSS_RTOL)
        np.testing.assert_allclose(np.array(t["metrics"]), np.array(j["metrics"]), rtol=JAX_LOSS_RTOL)
    lanes = np.array(got[0]["dp_sdc"]["lanes"])
    # the injected lane (seed 1 % 2 lanes) is 32x from step 2 on
    assert lanes[0, 1] / lanes[0, 0] < 2 and lanes[1, 1] / lanes[1, 0] > 8


def test_sdc_detect_raises_naming_a15():
    tc = ttrainer.TrainerConfig(sdc_detect=True)
    with pytest.raises(NotImplementedError, match="A15"):
        ttrainer.ElasticTrainer(tcfg.tiny(), ttrainer.build_optimizer("sgd"), tdw.Tokens(), tc,
                                devices="cpu")


def test_adamw_8bit_flat_on_a_sharded_mesh_is_a_value_error():
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.parallel.mesh import MeshConfig

    # one process: a dp=1 mesh with fsdp=1 passes the guard ...
    tr = ttrainer.ElasticTrainer(tcfg.tiny(), ttrainer.build_optimizer("adamw_8bit_flat"),
                                 tdw.Tokens(), ttrainer.TrainerConfig(report_metrics=False),
                                 strategy=Strategy(mesh=MeshConfig()), devices="cpu")
    tr.close()
    # ... a pinned fsdp=2 strategy is carried to the one rank there is
    # (the resize's derivation), so it trains unsharded ...
    tr = ttrainer.ElasticTrainer(tcfg.tiny(), ttrainer.build_optimizer("adamw_8bit_flat"),
                                 tdw.Tokens(), ttrainer.TrainerConfig(report_metrics=False),
                                 strategy=Strategy(mesh=MeshConfig(fsdp=2)), devices="cpu")
    assert tr.strategy.mesh.fsdp == 1
    tr.close()
    # ... and the flat optimizer on a model-sharded mesh is refused
    # where such a mesh is built
    from dlrover_tpu_torch.accel.dry_runner import _check_unported

    with pytest.raises(ValueError, match="adamw_8bit_flat is for replicated"):
        _check_unported(Strategy(mesh=MeshConfig(fsdp=2)), tcfg.tiny(),
                        ttrainer.build_optimizer("adamw_8bit_flat"))
