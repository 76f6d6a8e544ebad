"""Pipeline parallelism composed with tensor parallelism and fsdp in the
port (``dlrover_tpu_torch/parallel/pipeline.py``: a rank holds its
stage row cut to its tp box, under fsdp ZeRO's shard of that box)
against the JAX package's ``parallel/pipeline.py`` on the same mesh of
the 8-device CPU mesh.

In gloo rank processes (``tests/torch_dist_worker.py`` job ``pp``): the
port's pipeline step from the JAX stacked weights (numpy-seeded) over
the same global batches, against the JAX ``build_pipeline_train_step``,
for pp 2 x tp 2 under GPipe, 1F1B and interleaved 1F1B (v = 2; tiny
models whose vocab of 256 splits over tp, and one of 255 it does not),
pp 2 x fsdp 2 under the three schedules (and a microbatch of one row,
which the data axes do not divide: both fsdp ranks read it), and pp 2 x
dp 2 x tp 2 under 1F1B (the mesh of the JAX package's
``test_pipeline_composes_with_tp``): the losses at the reference's rtol
1e-5 / atol 1e-6, the grad norms and the first step's gradients at rtol
2e-4 / atol 2e-5 (the JAX step's from its SGD update), the params after
3 steps; the hops, the tp all-reduces and ZeRO's gathers and
reduce-scatters a step as the schedule reckons them; the copies of a
leaf every tp rank holds whole equal on both tp coordinates after the
steps. Then ``ElasticTrainer`` stages a pp 2 x tp 2 checkpoint (and a pp
2 x fsdp 2 one, 8-bit state on ZeRO shards), a second start at the same
mesh lands each bitwise, and the staged pp x tp state goes through the
JAX stacked tree into a fresh stage and back unchanged; a resize keeps
pp and tp as the JAX trainer's derivation does.

Without processes: ``check_supported``'s verdicts on the 3D meshes (pp x
sp and pp x ep refused with ``ValueError``), and the dry runner pricing
the search's pp x tp and pp x fsdp candidates of a deep tiny model at
world 4."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.parallel import pipeline as jpl
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer

from dlrover_tpu_torch.accel import dry_runner as tdr
from dlrover_tpu_torch.accel.candidates import candidate_strategies
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models.transformer import check_supported
from dlrover_tpu_torch.parallel import grad_sync as tgs
from dlrover_tpu_torch.parallel import pipeline as tpl
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as tt

import torch_dist_worker as tdw
from test_torch_pipeline import _batches, _by_path, _seeded_tree

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_pipeline.py's
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)  # f32 params after 3 SGD steps
LR = 0.1
STEPS = 3
UNTIED = dict(num_layers=4)
TIED = dict(num_layers=4, tie_embeddings=True, rope=False, rmsnorm=False, swiglu=False)
WHOLE_VOCAB = dict(UNTIED, vocab_size=255)  # tp = 2 does not divide it

# name: (model, mesh, schedule, virtual, M, rows)
CASES = {
    "gpipe_pp2_tp2": (UNTIED, dict(pp=2, tp=2), "gpipe", 1, 4, 8),
    "1f1b_pp2_tp2_tied": (TIED, dict(pp=2, tp=2), "1f1b", 1, 4, 8),
    # M = 3: a partial last lane group
    "interleaved_pp2_tp2": (UNTIED, dict(pp=2, tp=2), "interleaved", 2, 3, 6),
    # the JAX package cannot lay a vocab tp does not divide on its tp
    # axis: its reference runs on pp alone (the numbers are the layout's
    # to keep, not to change)
    "1f1b_pp2_tp2_whole_vocab": (WHOLE_VOCAB, dict(pp=2, tp=2), "1f1b", 1, 4, 8),
    "gpipe_pp2_fsdp2": (UNTIED, dict(pp=2, fsdp=2), "gpipe", 1, 4, 8),
    "1f1b_pp2_fsdp2_tied": (TIED, dict(pp=2, fsdp=2), "1f1b", 1, 4, 8),
    "interleaved_pp2_fsdp2": (UNTIED, dict(pp=2, fsdp=2), "interleaved", 2, 2, 8),
    # one row a microbatch: the data axes do not divide it
    "1f1b_pp2_fsdp2_one_row": (UNTIED, dict(pp=2, fsdp=2), "1f1b", 1, 8, 8),
    "1f1b_pp2_dp2_tp2": (UNTIED, dict(pp=2, dp=2, tp=2), "1f1b", 1, 4, 8),
}


def _world(mesh):
    return int(np.prod(list(mesh.values())))


def _jax_run(model, mesh, sched, v, M, tree, batches):
    """The JAX pipeline step over ``batches`` from ``tree`` on ``mesh``:
    each step's loss and grad norm, the first step's gradients (from its
    SGD update) and the params at the end."""
    jc = jcfg.tiny(**model)
    jmesh = build_mesh(JMeshConfig(**mesh), devices=jax.devices()[:_world(mesh)])
    tx = jtrainer.build_optimizer("sgd", lr=LR)
    sh = jpl.pipeline_state_shardings(jc, jmesh, tx, virtual=v)
    params = jax.device_put(jpl.stack_pipeline_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                                      mesh["pp"], v), sh.params)
    state = jtrain.TrainState(step=jax.device_put(jnp.zeros((), jnp.int32), sh.step),
                              params=params, opt_state=jax.device_put(tx.init(params), sh.opt_state))
    step = jpl.build_pipeline_train_step(jc, jmesh, tx, M, donate=False, schedule=sched,
                                         virtual_stages=v if v > 1 else 2)
    before = _by_path(jax.device_get(params))
    metrics, grads = [], None
    for x, y in batches:
        state, m = step(state, x, y)
        metrics.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
        if grads is None:
            after = _by_path(jax.device_get(state.params))
            grads = {k: (before[k] - after[k]) / LR for k in before}
    return dict(metrics=metrics, grads=grads, params=_by_path(jax.device_get(state.params)))


def _ck_strategy(**kw):
    return Strategy(mesh=MeshConfig(pp=2, tp=2), num_microbatches=4, pp_schedule="1f1b",
                    **kw).to_json()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Worlds 4 and 8 of rank processes start first (world 4 also stages
    the trainer's checkpoint); the JAX references run in threads while
    they do; then a second world 4 lands the checkpoint and carries the
    staged state through the JAX tree."""
    trees = {}
    by_world = {4: {}, 8: {}}
    for name, (model, mesh, sched, v, M, rows) in CASES.items():
        key = tuple(sorted(model.items()))
        trees.setdefault(key, _seeded_tree(model))
        by_world[_world(mesh)][name] = dict(
            kind="step", model=model, mesh=mesh, schedule=sched, virtual=v, microbatches=M,
            params=tpl.stack_pipeline_params(trees[key], mesh["pp"], v),
            batches=_batches(model.get("vocab_size", 256), rows), optimizer="sgd", lr=LR)
    ck = str(tmp_path_factory.mktemp("pp3d_ck") / "ck")
    ck_f = str(tmp_path_factory.mktemp("pp3d_ck_fsdp") / "ck")
    by_world[4]["stage"] = dict(kind="stage", model=UNTIED, strategy=_ck_strategy(), steps=2,
                                ckpt_dir=ck, optimizer="adamw", opt_kw={})
    by_world[4]["stage_fsdp"] = dict(kind="stage", model=TIED, steps=2, ckpt_dir=ck_f,
                                     strategy=Strategy(mesh=MeshConfig(pp=2, fsdp=2),
                                                       num_microbatches=4).to_json())
    waits = {w: tdw.start_ranks("pp", w, c, str(tmp_path_factory.mktemp(f"pp3d_{w}")))
             for w, c in by_world.items()}
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = {name: ex.submit(_jax_run, model,
                                    dict(pp=2) if model is WHOLE_VOCAB else mesh, sched, v, M,
                                    trees[tuple(sorted(model.items()))],
                                    _batches(model.get("vocab_size", 256), rows))
                    for name, (model, mesh, sched, v, M, rows) in CASES.items()}
            ref = {name: f.result() for name, f in futs.items()}
    finally:
        got = {w: wait() for w, wait in waits.items()}
    staged = [r["stage"] for r in got[4]]
    staged_fsdp = [r["stage_fsdp"] for r in got[4]]
    # the staged state, whole in the JAX stacked layout, into a fresh
    # stage (``load_jax_train_state``) and back (``jax_train_state``)
    state = staged[0]["state"]
    params = _nest({k[len("params/"):]: a for k, a in state.items() if k.startswith("params/")})
    land = tdw.run_ranks("pp", 4, {
        "land": dict(kind="land", model=UNTIED, steps=1, ckpt_dir=ck, optimizer="adamw",
                     opt_kw={}),
        "land_fsdp": dict(kind="land", model=TIED, steps=1, ckpt_dir=ck_f),
        "carry": dict(kind="step", model=UNTIED, mesh=dict(pp=2, tp=2), schedule="1f1b",
                      microbatches=4, params=params, jax_state=state, batches=[],
                      optimizer="adamw", lr=1e-3)}, str(tmp_path_factory.mktemp("pp3d_land")))
    return ref, got, (staged, staged_fsdp), land


@pytest.mark.parametrize("name", list(CASES))
def test_3d_pipeline_steps_match_the_jax_package(runs, name):
    ref, got, _, _ = runs
    model, mesh, sched, v, M, rows = CASES[name]
    want = ref[name]
    ranks = [r[name] for r in got[_world(mesh)]]
    for r in ranks:
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
            np.testing.assert_allclose(have[path], w, err_msg=path, **PARAM_TOL)
    # every microbatch crosses each of the P v - 1 chunk boundaries once
    # forward and once back, on every pp group (one a dp, fsdp and tp
    # coordinate)
    groups = _world(mesh) // mesh["pp"]
    for k in range(STEPS):
        assert sum(r["metrics"][k]["hops"] for r in ranks) == 2 * M * (2 * v - 1) * groups
    # a microbatch's rows split over the data axes that divide it
    mb = rows // M
    n = mesh.get("dp", 1) * mesh.get("fsdp", 1)
    want_rows = M * (mb // n if mb % n == 0 else mb // mesh.get("dp", 1)
                     if mb % mesh.get("dp", 1) == 0 else mb)
    assert all(m["rows"] == want_rows for r in ranks for m in r["metrics"])
    for r in ranks:
        for m in r["metrics"]:
            assert m["tp_calls"] == _tp_reckoned(model, mesh, sched, v, M, r["stage"])
            assert m["issued"]["reduce_scatter"] == (2 if mesh.get("fsdp", 1) > 1 else 0)
            if mesh.get("fsdp", 1) > 1:
                assert m["issued"]["all_gather"] == _gathers_reckoned(sched, v, M, r["stage"])


def _tp_reckoned(model, mesh, sched, v, M, stage):
    """The tp all-reduces a step of a stage rank: per block and
    microbatch the attention's and the MLP's sums in each forward run
    (1F1B: the forward tick and the backward's recompute; GPipe without
    remat: one) and the two ``copy_to_tp`` sums of the backward; under a
    vocab split the embedding's sum a microbatch on stage 0, and the
    head's ``copy_to_tp`` backward and the loss's max and sums a
    microbatch on the last stage."""
    tp = mesh.get("tp", 1)
    if tp == 1:
        return 0
    cfg = tcfg.tiny(**model)
    blocks = cfg.num_layers // mesh["pp"]
    per = 4 if sched == "gpipe" else 6
    n = blocks * M * per
    if cfg.vocab_size % tp == 0:
        n += M if stage == 0 else 0
        n += 3 * M if stage == mesh["pp"] - 1 else 0
    return n


def _gathers_reckoned(sched, v, M, stage):
    """ZeRO's all-gathers a step of a stage rank: the blocks before each
    chunk forward and before each backward (1F1B's recompute; GPipe's
    saved leaves: all of them in the CPU's f32), the embedding a
    microbatch on stage 0, the head a microbatch on the last stage."""
    return 2 * v * M + M * (stage == 0) + M * (stage == 1)


def test_the_tp_copies_of_a_whole_leaf_agree(runs):
    """A leaf every tp rank holds whole (the norms; the table and the
    head when tp does not divide the vocab) is bitwise the same on both
    tp coordinates of a stage after the steps."""
    _, got, _, _ = runs
    for name, (model, mesh, *_rest) in CASES.items():
        if mesh.get("tp", 1) == 1:
            continue
        ranks = got[_world(mesh)]
        by_place = {}
        for r in ranks:
            c = r[name]["coords"]
            by_place.setdefault((c["pp"], c["dp"]), []).append(r[name]["tp_whole"])
        names = set()
        for copies in by_place.values():
            assert len(copies) == 2
            for leaf, a in copies[0].items():
                np.testing.assert_array_equal(copies[1][leaf], a, err_msg=f"{name} {leaf}")
                names.add(leaf)
        if model.get("vocab_size") == 255:
            assert {"embed.tokens", "lm_head"} <= names
        assert "final_norm.scale" in names


def test_a_pp2_tp2_checkpoint_lands_bitwise_and_carries_through_the_jax_tree(runs):
    _, _, (staged, _), land = runs
    state = staged[0]["state"]
    for r in staged[1:]:
        assert r["losses"] == staged[0]["losses"]
        for k, a in state.items():
            np.testing.assert_array_equal(r["state"][k], a, err_msg=k)
    assert sorted(r["stage"] for r in staged) == [0, 0, 1, 1]
    for r in land:
        got = r["land"]
        assert got["restored"] == 2 and got["source"] == "storage"
        s = Strategy.from_json(got["strategy"])
        assert (s.mesh.pp, s.mesh.tp, s.mesh.dp) == (2, 2, 1)
        assert got["step"] == 3 and np.isfinite(got["losses"]).all()
        assert got["restored_state"].keys() == state.keys()
        for k, a in state.items():
            np.testing.assert_array_equal(got["restored_state"][k], a, err_msg=k)
        carried = r["carry"]["state"]
        assert carried.keys() == state.keys()
        for k, a in state.items():
            np.testing.assert_array_equal(carried[k], a, err_msg=k)


def test_a_pp2_fsdp2_checkpoint_lands_bitwise(runs):
    """pp 2 x fsdp 2 with the per-leaf 8-bit AdamW on its ZeRO shards
    (a tied model): each fsdp rank stages its runs of its stage's
    leaves, a second start lands them bitwise (params, codes, scales),
    and the step after it is finite."""
    _, _, (_, staged), land = runs
    state = staged[0]["state"]
    assert sorted(r["stage"] for r in staged) == [0, 0, 1, 1]
    for r in staged[1:]:
        assert r["losses"] == staged[0]["losses"]
    for r in land:
        got = r["land_fsdp"]
        assert got["restored"] == 2 and got["source"] == "storage"
        s = Strategy.from_json(got["strategy"])
        assert (s.mesh.pp, s.mesh.fsdp) == (2, 2)
        assert got["step"] == 3 and np.isfinite(got["losses"]).all()
        assert got["restored_state"].keys() == state.keys()
        for k, a in state.items():
            np.testing.assert_array_equal(got["restored_state"][k], a, err_msg=k)


def test_check_supported_on_3d_meshes():
    cfg = tcfg.tiny(num_layers=4)
    for sizes in (dict(pp=2, tp=2), dict(pp=2, fsdp=2), dict(pp=2, dp=2, tp=2),
                  dict(pp=2, dp=2, fsdp=2), dict(pp=2, fsdp=2, tp=2)):
        check_supported(cfg, MeshConfig(**sizes))
    for sizes in (dict(pp=2, sp=2), dict(pp=2, tp=2, sp=2)):
        with pytest.raises(ValueError) as te:
            check_supported(cfg, MeshConfig(**sizes))
        assert str(te.value) == "sp (ring attention) inside pp stages not supported"
    with pytest.raises(ValueError, match="pp=2 x ep=2"):
        check_supported(tcfg.tiny(num_layers=4, num_experts=4), MeshConfig(pp=2, ep=2))
    with pytest.raises(ValueError, match="tp=3 does not divide"):
        check_supported(cfg, MeshConfig(pp=2, tp=3))
    # the gate keeps the JAX verdicts: no explicit plan on these meshes
    for sizes in (dict(pp=2, tp=2), dict(pp=2, fsdp=2), dict(pp=2, dp=2, tp=2)):
        assert tgs.resolve_sync_mode(sizes) is None
        assert "pp x" in tgs.fallback_reason(sizes)
        assert tgs.plan_for_pipeline(cfg, sizes) is None
        s = Strategy(mesh=MeshConfig(**sizes), comm_overlap=True, num_microbatches=4)
        assert tgs.resolve_plan(cfg, s) is None


def test_the_search_prices_pp_x_tp_and_pp_x_fsdp_at_world_4():
    """The candidates a deep tiny model gets at world 4 include pp 2 x tp
    2 and pp 2 x fsdp 2; each prices (``report.ok``) with its stage's
    static peak and, under tp, the stage's tp term."""
    cfg = tcfg.tiny(num_layers=8)
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=512)
    cands = [c for c in candidate_strategies(cfg, 4, 8, 16) if c.mesh.pp > 1]
    meshes = {(c.mesh.pp, c.mesh.tp, c.mesh.fsdp, c.mesh.dp) for c in cands}
    assert {(2, 2, 1, 1), (2, 1, 2, 1)} <= meshes
    for c in cands:
        r = tdr.compiled_cost(c, cfg, tx, 8, 16, 4)
        assert r.ok, (c.mesh, r.error)
        peaks = [tdr.static_peak_bytes(cfg, c, tx, 8, 16, stage=k) for k in range(c.mesh.pp)]
        assert r.mem_bytes == max(peaks) > 0
        if c.mesh.tp > 1:
            plain = tdr.DryRunReport(strategy=c, ok=True)
            tdr._tp_comm_estimate(plain, cfg, 8, 16)
            assert plain.comm_bytes_per_device > 0
            assert r.comm_exposed_s >= plain.comm_exposed_s > 0
    # a stage's rank holds its tp boxes: pp 2 x tp 2's stage is priced
    # below pp 2's
    pp = Strategy(mesh=MeshConfig(pp=2, dp=2), num_microbatches=4)
    pptp = Strategy(mesh=MeshConfig(pp=2, tp=2), num_microbatches=4)
    assert tdr.static_peak_bytes(cfg, pptp, tx, 8, 16) < tdr.static_peak_bytes(
        cfg, pp, tx, 8, 16)


@pytest.mark.parametrize("mesh", [dict(pp=2, tp=2), dict(pp=2, fsdp=2), dict(pp=2, dp=2, tp=2)],
                         ids=["pp_tp", "pp_fsdp", "pp_dp_tp"])
def test_a_resize_keeps_pp_and_tp_as_the_jax_package_does(mesh, monkeypatch):
    """``_strategy_for`` (and its exact and rebalanced halves) on a 3D
    strategy at worlds 1-8, against the JAX trainer's methods: where pp
    x tp divides the world, pp and tp keep their sizes and the data axes
    absorb the change (elsewhere both fall back to a candidate without
    pp), and the rebalance keeps refusing pp."""
    from dlrover_tpu.accel import dry_runner as jdry
    from dlrover_tpu.trainer.elastic import trainer as jtrainer_mod

    import test_torch_resize_strategy as trs

    monkeypatch.setattr(jdry, "price_rebalance_options", trs._price)
    monkeypatch.setattr(tdr, "price_rebalance_options", trs._price)
    kept = 0
    for n in range(1, 9):
        for name in ("_strategy_for_exact", "_rebalanced_strategy_for", "_strategy_for"):
            want = trs._call(jtrainer_mod.ElasticTrainer, name, trs._stub("jax", mesh, 8, 1, True), n)
            got = trs._call(tt.ElasticTrainer, name, trs._stub("port", mesh, 8, 1, True), n)
            assert got == want, (n, name, got, want)
            fixed = mesh["pp"] * mesh.get("tp", 1)
            if name == "_strategy_for_exact" and got is not None and n % fixed == 0:
                m = Strategy.from_json(got).mesh
                assert (m.pp, m.tp) == (mesh["pp"], mesh.get("tp", 1))
                kept += 1
            if name == "_rebalanced_strategy_for":
                assert got is None
    assert kept >= 2


def _nest(flat):
    tree = {}
    for path, a in flat.items():
        node, parts = tree, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree
