"""``ElasticTrainer`` on pipeline strategies (``parallel/pipeline.py``),
in gloo rank processes (``tests/torch_dist_worker.py`` job ``pp``), tiny
models with the per-leaf ``adamw_8bit``:

- pp = 2 under GPipe, 1F1B and interleaved 1F1B (v = 2) against one
  process at pp = 1 with ``grad_accum`` = M over the same batches: the
  losses, the eval loss (through the stages) and the params at the end
  within ``TRAIN_TOL`` / ``PARAM_ATOL``;
- pp 2 x dp 2 with ``comm_overlap`` syncs through the ``PPSyncPlan``
  (kind ``pp``), its losses pp = 1's, and stages a disk checkpoint;
- a trainer at world 2 without a strategy lands that checkpoint: it
  derives dp 1 x pp 2 from the staged strategy (pp kept), and its train
  state (params, 8-bit codes and scales, counts) is the staged one bit
  for bit; the first step after it is the stage's next step's loss.

The JAX package's pipeline has no trainer of its own to hold these to
(its ``ElasticTrainer`` steps the same ``build_pipeline_train_step``
that ``tests/test_torch_pipeline.py`` holds the port's step to); the
reference here is the port's pp = 1 path, itself held to the JAX
package's step by ``tests/test_torch_train.py``."""

import numpy as np
import pytest

from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.parallel.mesh import MeshConfig

import torch_dist_worker as tdw

MODEL = dict(num_layers=4)
TIED = dict(num_layers=4, tie_embeddings=True, rope=False, rmsnorm=False, swiglu=False)
M = 4
STEPS = 2
TRAIN_TOL = 1e-5  # pp = 2's losses against pp = 1's (f32: the order of sums differs)
# pp = 2's params after 2 steps of the 8-bit AdamW at lr 1e-3 against pp =
# 1's: where the f32 sums round apart, a moment's code may sit one step
# off (measured: 2.6e-5 at one element of 1024 of a tied LayerNorm model;
# a wrong gradient moves an element by about the lr, 1e-3)
PARAM_ATOL = 5e-5


def _strategy(sched="gpipe", **mesh):
    return Strategy(mesh=MeshConfig(**mesh), num_microbatches=M, pp_schedule=sched).to_json()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1 (the pp = 1 references), world 2 (the schedules) and world 4
    (pp 2 x dp 2, which stages the checkpoint) start together; a second
    world 2 lands the checkpoint."""
    ck = str(tmp_path_factory.mktemp("pp_ck") / "ck")
    run = dict(kind="run", steps=STEPS)
    one = {f"pp1_{t}": dict(run, model=m, strategy=Strategy(mesh=MeshConfig()).to_json(),
                            trainer=dict(grad_accum=M))
           for t, m in (("untied", MODEL), ("tied", TIED))}
    two = {
        "gpipe": dict(run, model=MODEL, strategy=_strategy("gpipe", pp=2)),
        "1f1b": dict(run, model=TIED, strategy=_strategy("1f1b", pp=2)),
        "interleaved": dict(run, model=MODEL, strategy=_strategy("interleaved", pp=2)),
    }
    four = {"stage": dict(run, kind="stage", model=MODEL, strategy=_strategy("gpipe", pp=2, dp=2),
                          trainer=dict(comm_overlap=True), ckpt_dir=ck)}
    waits = [tdw.start_ranks("pp", w, c, str(tmp_path_factory.mktemp(f"pp_tr{w}")))
             for w, c in ((1, one), (2, two), (4, four))]
    res = [w() for w in waits]
    land = tdw.run_ranks("pp", 2, {"land": dict(kind="land", model=MODEL, steps=1, ckpt_dir=ck,
                                                trainer=dict(comm_overlap=True))},
                         str(tmp_path_factory.mktemp("pp_land")))
    return res[0][0], res[1], res[2], land


@pytest.mark.parametrize("name,ref", [("gpipe", "pp1_untied"), ("1f1b", "pp1_tied"),
                                      ("interleaved", "pp1_untied")])
def test_pp2_trainer_matches_pp1_with_grad_accum(runs, name, ref):
    one, two, _, _ = runs
    want = one[ref]
    for r in two:
        got = r[name]
        assert got["strategy"] == two[0][name]["strategy"]
        assert Strategy.from_json(got["strategy"]).mesh.pp == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TRAIN_TOL)
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=TRAIN_TOL)
        assert got["plan"] is None
    # the params, gathered over pp into the JAX stacked layout, are pp =
    # 1's layers stacked
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel.pipeline import stack_pipeline_params, unstack_pipeline_params

    v = Strategy.from_json(two[0][name]["strategy"]).resolved_virtual()
    cfg = tcfg.tiny(**(TIED if name == "1f1b" else MODEL))
    got = {k[len("params/"):]: a for k, a in two[0][name]["state"].items()
           if k.startswith("params/")}
    want_layers = {k[len("params/"):]: a for k, a in want["state"].items() if k.startswith("params/")}
    tree = _nest(got)
    flat = _flatten(unstack_pipeline_params(tree, cfg, v))
    assert flat.keys() == want_layers.keys()
    for k, a in want_layers.items():
        np.testing.assert_allclose(flat[k], a, atol=PARAM_ATOL, err_msg=k)
    assert _flatten(stack_pipeline_params(unstack_pipeline_params(tree, cfg, v), 2, v)).keys() \
        == got.keys()


def test_pp2_dp2_trainer_syncs_through_the_pp_plan_and_stages(runs):
    one, _, four, _ = runs
    ranks = [r["stage"] for r in four]
    assert {r["plan"] for r in ranks} == {"pp"} and all(r["grad_sync_ms"] > 0 for r in ranks)
    assert sorted(r["stage"] for r in ranks) == [0, 0, 1, 1]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], one["pp1_untied"]["losses"], rtol=TRAIN_TOL)
        assert r["step"] == STEPS
    for r in ranks[1:]:
        for k, a in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], a, err_msg=k)


def test_a_dp2_pp2_checkpoint_lands_bitwise_at_dp1_pp2(runs):
    _, _, four, land = runs
    staged = four[0]["stage"]["state"]
    for r in land:
        got = r["land"]
        assert got["restored"] == STEPS and got["source"] == "storage"
        s = Strategy.from_json(got["strategy"])
        assert (s.mesh.pp, s.mesh.dp) == (2, 1) and s.num_microbatches == M
        assert got["plan"] is None  # dp = 1: nothing to sync
        assert got["step"] == STEPS + 1 and len(got["losses"]) == 1
        assert np.isfinite(got["losses"]).all()
        restored = got["restored_state"]
        assert restored.keys() == staged.keys()
        for k, a in staged.items():
            np.testing.assert_array_equal(restored[k], a, err_msg=k)


def _nest(flat):
    tree = {}
    for path, a in flat.items():
        node, parts = tree, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree


def _flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        p = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten(v, p) if isinstance(v, (dict, list)) else {p: np.asarray(v)})
    return out
