"""MoE and expert parallelism composed with tp, fsdp and sp in the port
against the JAX package on the same mesh of the 8-device CPU mesh.

In gloo rank processes (``tests/torch_dist_worker.py`` job ``ep``; one
start for each world size, every case inside):

- the port's step from the JAX weights against the JAX GSPMD step
  (``build_train_step`` without ``comm_overlap``: the JAX gate gives
  these meshes no plan) over the same global batches, tiny MoE models (4
  experts, every second block, top-2), f32, SGD: ep 2 x tp 2 (and at
  capacity 0.5, so that tokens drop), ep 2 x fsdp 2 (and with
  ``grad_accum=2``), ep 2 x sp 2, and MoE at ep = 1 under dp 2 x tp 2 and
  dp 2 x sp 2: losses, grad norms, the balance and z losses and the
  routing stats (load per expert, drop rate) within ``STEP_RTOL``, the
  params after the steps within ``PARAM_ATOL``; the ep all-to-alls and
  the tp all-reduces a step as reckoned. Under fsdp and sp each data
  shard and sequence block gates its own tokens: the JAX step does, and
  its numbers differ from a one-device run's by the routing, not by a
  fault;
- the wrong variant: ep 2 x tp 2 with the balance and z losses carrying
  their gradient on both tp ranks (their cotangent enters the tp sums of
  the tokens' and the gate's gradients twice) fails that gate;
- ``ElasticTrainer`` (with ``comm_overlap``, which builds no plan on
  these meshes) stages a checkpoint at ep 2 x tp 2 (AdamW) and at ep
  2 x fsdp 2 (the per-leaf 8-bit AdamW on ZeRO shards of the ep boxes); a
  fresh trainer on the same mesh restores each bitwise, and one process
  at ep = 1, tp = 1 restores each leaf for leaf (an expert leaf recorded
  as its ep x tp box of the whole leaf; under ZeRO the 8-bit codes and
  scales of an ep box as its rows of the whole leaf's blocks); the ep 2
  x tp 2 trainer's losses and eval loss match one process at ep = 1;
- ``moe_rebalance_interval=1`` at ep 2 x sp 2 re-splits the experts'
  capacity at the steps, and to the splits, at which the JAX trainer's
  ``_maybe_rebalance_experts`` re-splits given the same measured loads
  (averaged over the data axes and sp).

Without processes: ``check_supported`` builds every mesh the JAX
``candidate_strategies`` emits for a MoE config at worlds 4 and 8, the
port's candidate list equals the JAX one, and the dry runner prices each
candidate (``compiled_cost``, ``static_peak_bytes``)."""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

from dlrover_tpu.accel.candidates import candidate_strategies as jax_candidates
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dlrover_tpu.trainer.elastic import trainer as jtrainer

from dlrover_tpu_torch.accel import dry_runner as tdr
from dlrover_tpu_torch.accel.candidates import candidate_strategies
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models.transformer import check_supported
from dlrover_tpu_torch.parallel import grad_sync as tgs
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as tt

import torch_dist_worker as tdw
from test_torch_ep_trainer import MODEL, _batches, _by_path, _jax_params, _jax_run, _param_tree

STEP_RTOL = 1e-5  # f32 step against the JAX package's, losses and stats
PARAM_ATOL = 1e-5  # f32 params after the steps (sgd)
TRAIN_TOL = 1e-6  # ep 2 x tp 2 trainer losses against ep = 1's, relative
STEPS = 2

# name: (model overrides, mesh (the JAX one and the port's), grad_accum)
STEP_CASES = {
    "ep2_tp2": (MODEL, dict(ep=2, tp=2), 1),
    "ep2_tp2_drops": (dict(MODEL, capacity_factor=0.5), dict(ep=2, tp=2), 1),
    "ep2_fsdp2": (MODEL, dict(fsdp=2, ep=2), 1),
    "ep2_fsdp2_accum": (MODEL, dict(fsdp=2, ep=2), 2),
    "ep2_sp2": (MODEL, dict(ep=2, sp=2), 1),
    "moe_dp2_tp2": (MODEL, dict(dp=2, tp=2), 1),
    "moe_dp2_sp2": (MODEL, dict(dp=2, sp=2), 1),
}
TRAIN = dict(model=MODEL, steps=STEPS, optimizer="adamw_8bit",
             opt_kw=dict(min_quantized_size=512), lr=1e-3)
ADAMW = dict(TRAIN, optimizer="adamw", opt_kw={})


def _world(mesh):
    return int(np.prod(list(mesh.values())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 4's rank processes start first (every step case, the
    planted fault, two checkpoints staged and landed on their meshes by
    fresh trainers, the rebalance); the JAX steps run in threads while
    they do; then one process lands the checkpoints at ep = 1."""
    batches = _batches(jcfg.tiny(**MODEL))
    jp = _jax_params(MODEL)
    params = _param_tree(jp)
    cases = {}
    for name, (model, mesh, ga) in STEP_CASES.items():
        cases[name] = dict(kind="step", model=model, mesh=mesh, params=params, batches=batches,
                           optimizer="sgd", lr=0.1, grad_accum=ga)
    cases["ep2_tp2_aux_tp_times"] = dict(cases["ep2_tp2"], fault="aux_tp_times")
    ck_tp = str(tmp_path_factory.mktemp("ep3d_tp") / "ck")
    ck_fsdp = str(tmp_path_factory.mktemp("ep3d_fsdp") / "ck")
    cases.update(
        # comm_overlap asks for the explicit sync, which these meshes do
        # not take (the JAX gate): the default path, no plan
        stage_tp=dict(ADAMW, kind="stage", mesh=dict(ep=2, tp=2), ckpt_dir=ck_tp,
                      trainer=dict(comm_overlap=True)),
        stage_fsdp=dict(TRAIN, kind="stage", mesh=dict(fsdp=2, ep=2), ckpt_dir=ck_fsdp),
        # fresh trainers of the same ranks land what the two staged
        land_tp=dict(ADAMW, kind="land", mesh=dict(ep=2, tp=2), steps=0, ckpt_dir=ck_tp),
        land_fsdp=dict(TRAIN, kind="land", mesh=dict(fsdp=2, ep=2), steps=0, ckpt_dir=ck_fsdp),
        rebalance=dict(TRAIN, kind="run", mesh=dict(ep=2, sp=2), steps=4,
                       trainer=dict(moe_rebalance_interval=1)),
    )
    wait = tdw.start_ranks("ep", 4, cases, str(tmp_path_factory.mktemp("ep3d_four")))
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = {name: ex.submit(_jax_run, model, mesh, _world(mesh), batches, jp,
                                    grad_accum=ga)
                    for name, (model, mesh, ga) in STEP_CASES.items()}
            ref = {name: dict(zip(("metrics", "params"), f.result())) for name, f in futs.items()}
    finally:
        four = wait()
    one = tdw.run_ranks("ep", 1, dict(
        ep1=dict(ADAMW, kind="run", mesh={}),
        land_tp_ep1=dict(ADAMW, kind="land", mesh={}, steps=0, ckpt_dir=ck_tp),
        land_fsdp_ep1=dict(TRAIN, kind="land", mesh={}, steps=0, ckpt_dir=ck_fsdp),
    ), str(tmp_path_factory.mktemp("ep3d_one")))[0]
    return ref, four, one


def _step_gaps(got, want):
    """The largest relative gap of each checked metric over the steps
    (the load vector's elements too), and the largest param gap."""
    gaps = {}
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "balance", "z", "drop", "load"):
            a, b = np.asarray(g[k], np.float64), np.asarray(w[k], np.float64)
            gap = float(np.max(np.abs(a - b) / (np.abs(b) * STEP_RTOL + 1e-7)))
            gaps[k] = max(gaps.get(k, 0.0), gap)
    have = _by_path(got["params"])
    gaps["params"] = max(float(np.max(np.abs(have[p] - w))) / PARAM_ATOL
                         for p, w in want["params"].items())
    return gaps


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_composed_moe_steps_match_the_jax_package(runs, name):
    ref, four, _ = runs
    want = ref[name]
    model, mesh, ga = STEP_CASES[name]
    ep, tp = mesh.get("ep", 1), mesh.get("tp", 1)
    for r in four:
        got = r[name]
        assert len(got["metrics"]) == len(want["metrics"])
        for g, w in zip(got["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm", "balance", "z", "drop"):
                np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL, atol=1e-7, err_msg=k)
            assert g["load"].shape == w["load"].shape == (4,)
            np.testing.assert_allclose(g["load"], w["load"], rtol=STEP_RTOL, atol=1e-7)
            # 2 exchanges forward and their 2 transposes a MoE layer and
            # microbatch; under tp per layer 2 sums forward (the
            # attention's and the MoE layer's or the MLP's) and 2 backward
            # (copy_to_tp's of the attention input and of the MLP's: for a
            # MoE layer the tokens' and the gate's, 3), the vocab split's
            # 2 and 1 more for the vocab-parallel loss's max and sums
            assert g["a2a"] == (4 * ga if ep > 1 else 0)
            if tp > 1:
                assert g["tp_calls"] == ga * (2 * 4 + 1 + 2 + 2)
            else:
                assert g["tp_calls"] == 0
        have = _by_path(got["params"])
        assert have.keys() == want["params"].keys()
        for path, w in want["params"].items():
            np.testing.assert_allclose(have[path], w, atol=PARAM_ATOL, err_msg=path)
        # these meshes take the JAX default schedule: no plan; ep x fsdp
        # keeps ZeRO's shards of the ep boxes
        assert got["kind"] is None
        assert got["zero"] == (ep > 1 and mesh.get("fsdp", 1) > 1)
    if name == "ep2_tp2_drops":
        assert max(g["drop"] for g in four[0][name]["metrics"]) > 0


def test_the_aux_summed_over_tp_twice_fails_the_gate(runs):
    """The balance and z losses computed whole on each tp rank, their
    gradient left on both: the gate refuses the step (the loss and the
    routing of its first step agree; the update does not)."""
    ref, four, _ = runs
    want = ref["ep2_tp2"]
    for r in four:
        gaps = _step_gaps(r["ep2_tp2_aux_tp_times"], want)
        sound = _step_gaps(r["ep2_tp2"], want)
        assert max(sound.values()) <= 1.0
        assert gaps["grad_norm"] > 1.0 or gaps["params"] > 1.0, gaps


def test_ep_x_tp_and_ep_x_fsdp_checkpoints_restore_bitwise_and_at_ep1(runs):
    _, four, one = runs
    for kind in ("tp", "fsdp"):
        for r in four:
            stage, got = r[f"stage_{kind}"], r[f"land_{kind}"]
            assert (got["restored"], got["source"]) == (STEPS, "storage")
            assert got["state"].keys() == stage["state"].keys()
            for path, w in stage["state"].items():
                if w is None:
                    assert got["state"][path] is None
                    continue
                np.testing.assert_array_equal(got["state"][path], w, err_msg=path)
        stage, got = four[0][f"stage_{kind}"], one[f"land_{kind}_ep1"]
        assert (got["restored"], got["source"]) == (STEPS, "storage")
        assert got["state"].keys() == stage["state"].keys()
        for path, w in stage["state"].items():
            if w is not None:
                np.testing.assert_array_equal(got["state"][path], w, err_msg=path)


def test_the_ep2_tp2_trainer_matches_ep1(runs):
    _, four, one = runs
    want = one["ep1"]
    for r in four:
        got = r["stage_tp"]
        assert '"ep": 2' in got["strategy"] and '"tp": 2' in got["strategy"]
        assert got["plan"] is None and got["grad_sync_ms"] == 0.0
        np.testing.assert_allclose([s["loss"] for s in got["steps"]],
                                   [s["loss"] for s in want["steps"]], rtol=TRAIN_TOL)
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=TRAIN_TOL)
        for path, w in _by_path(want["params"]).items():
            np.testing.assert_allclose(_by_path(got["params"])[path], w, atol=PARAM_ATOL,
                                       err_msg=path)


def test_capacity_resplits_at_ep2_sp2_as_the_jax_trainer_does(runs):
    _, four, _ = runs
    got = four[0]["rebalance"]
    assert all(r["rebalance"]["resplits"] == got["resplits"] for r in four)
    jc = jcfg.tiny(**MODEL)
    from dlrover_tpu.parallel.moe import CapacityRebalancer

    # the JAX trainer's own method on a stand-in trainer, its step
    # rebuild stubbed (the port's measured loads fed in order)
    stub = SimpleNamespace(
        _moe_rebalancer=CapacityRebalancer(jc.num_experts, capacity_factor=jc.capacity_factor,
                                           top_k=jc.moe_top_k),
        accel=SimpleNamespace(strategy=SimpleNamespace(mesh=JMeshConfig(ep=2, sp=2))),
        tcfg=jtrainer.TrainerConfig(batch_size=8, seq_len=16, moe_rebalance_interval=1),
        _model_cfg=jc, _tx=None, mesh=SimpleNamespace(devices=np.zeros((1,))),
        pipeline_stats=SimpleNamespace(moe_capacity_resplits=0),
        _registry=SimpleNamespace(gauge=lambda *a, **k: SimpleNamespace(set=lambda v: None)),
    )
    real = jtrainer.auto_accelerate
    jtrainer.auto_accelerate = lambda cfg, *a, **k: SimpleNamespace(
        cfg=cfg, step_fn=None, donating_step_fn=None, strategy=k["strategy"])
    try:
        want, splits = [], []
        for s in got["steps"]:
            applied = jtrainer.ElasticTrainer._maybe_rebalance_experts(stub, s["load"])
            want.append((s["step"], applied))
            splits.append(tuple(stub._model_cfg.capacity_splits))
    finally:
        jtrainer.auto_accelerate = real
    assert got["resplits"] == want and got["splits"] == splits
    assert any(applied for _, applied in want)


@pytest.mark.parametrize("world", [4, 8])
def test_the_search_builds_and_prices_every_moe_candidate(world):
    """The port's candidates for a MoE config equal the JAX package's;
    every mesh among them builds (``check_supported``: no
    ``NotImplementedError``), the gate gives the composed ones no plan
    as the JAX gate does, and the dry runner prices each with its static
    peak."""
    model = dict(MODEL, num_layers=4, vocab_size=256)
    cfg, jc = tcfg.tiny(**model), jcfg.tiny(**model)
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=512)
    got = [c.to_json() for c in candidate_strategies(cfg, world, 8, 256)]
    want = [c.to_json() for c in jax_candidates(jc, world, 8, 256)]
    assert got == want
    meshes = {(c.mesh.dp, c.mesh.fsdp, c.mesh.ep, c.mesh.sp, c.mesh.tp, c.mesh.pp)
              for c in candidate_strategies(cfg, world, 8, 256)}
    # ep composed with tp and fsdp, and MoE at ep = 1 under tp
    assert any(m[2] > 1 and m[4] > 1 for m in meshes)
    assert any(m[2] > 1 and m[1] > 1 for m in meshes)
    assert any(m[2] == 1 and m[4] > 1 for m in meshes)
    for c in candidate_strategies(cfg, world, 8, 256):
        m = c.mesh
        if m.pp > 1 and (m.ep > 1 or m.sp > 1):
            with pytest.raises(ValueError):
                check_supported(cfg, m)
            continue
        check_supported(cfg, m)
        r = tdr.compiled_cost(c, cfg, tx, 8, 256, world)
        assert r.ok, (m, r.error)
        assert r.mem_bytes == tdr.static_peak_bytes(cfg, c, tx, 8, 256) > 0
        if m.ep > 1 and max(m.fsdp, m.tp, m.sp) > 1:
            sizes = m.axis_sizes()
            assert tgs.resolve_sync_mode(sizes) is None
            assert "ep x" in tgs.fallback_reason(sizes)
            assert tgs.resolve_plan(cfg, Strategy(mesh=m, comm_overlap=True)) is None


def test_static_peak_prices_the_composed_expert_boxes():
    """An ep x tp rank holds F/tp columns of its E/ep experts, an ep x
    fsdp rank ZeRO's 1/fsdp shard of its ep boxes: each is priced below
    the ep rank alone, and the tp rank's expert buffers shrink with
    ``F/tp``."""
    cfg = tcfg.tiny(**dict(MODEL, num_layers=4))
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=512)

    def peak(**mesh):
        return tdr.static_peak_bytes(cfg, Strategy(mesh=MeshConfig(**mesh)), tx, 8, 256)

    ep = peak(ep=2)
    assert peak(ep=2, tp=2) < ep and peak(ep=2, fsdp=2) < peak(ep=2, dp=2)
    assert tdr._moe_block_bytes(cfg, 1024, 4, tp=2) < tdr._moe_block_bytes(cfg, 1024, 4)
    assert peak(ep=2, sp=2) < ep
