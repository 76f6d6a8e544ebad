"""``ElasticTrainer`` on a tensor-parallel strategy, and its checkpoint.

- tp = 2 (two gloo ranks, ``tests/torch_dist_worker.py`` job ``train``)
  against one process: the per-leaf 8-bit AdamW (``adamw_8bit``; each
  tp rank quantizes its boxes in their own blocks, and at this model's
  split dims those are the whole leaf's blocks) on a tiny model, losses
  within 1e-6 of the largest (f32), the same on both ranks;
- a step staged at dp 2 x tp 2 (four ranks; a disk save, every split
  leaf's tensors recorded as their boxes of the whole leaf, the 8-bit
  state as its tp rank's row) lands at two ranks: the trainer derives
  dp 1 x tp 2 from the staged strategy (tp stays, the data axes absorb
  the change, the JAX ``_strategy_for``) and restores every leaf
  bitwise; the leaves every tp rank holds whole were staged by tp
  coordinate 0 alone and reach tp coordinate 1 over the tp group."""

import jax
import numpy as np
import pytest

import torch_dist_worker as tdw

TRAIN_TOL = 1e-6
MODEL = dict(num_heads=4, num_kv_heads=2)
RUN = dict(model=MODEL, steps=3, optimizer="adamw_8bit", opt_kw=dict(min_quantized_size=4096),
           lr=3e-3, batch=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("tp_ck") / "ck")
    one = tdw.run_ranks("train", 1, {"one": dict(RUN)}, str(tmp_path_factory.mktemp("tp_one")))[0]
    staged = tdw.run_ranks("resize", 4, {"stage": dict(kind="stage", mesh=dict(dp=2, tp=2),
                                                       steps=2, ckpt_dir=ck)},
                           str(tmp_path_factory.mktemp("tp_stage")))
    two = tdw.run_ranks("multi", 2, [
        ("train", {"tp2": dict(RUN, mesh=dict(tp=2))}),
        ("resize", {"land": dict(kind="land", mesh=None, more=1, ckpt_dir=ck)}),
    ], str(tmp_path_factory.mktemp("tp_two")))
    return one, staged, two


def test_elastic_trainer_on_a_tp_strategy_matches_one_process(runs):
    one, _, two = runs
    want = one["one"]["losses"]
    for r in two:
        got = r[0]["tp2"]
        np.testing.assert_allclose(got["losses"], want, rtol=0, atol=TRAIN_TOL * max(want))
        assert got["losses"] == two[0][0]["tp2"]["losses"]
        assert '"tp": 2' in got["strategy"]
    # the whole params, gathered over tp, are the same on both ranks
    for a, b in zip(jax.tree_util.tree_leaves(two[0][0]["tp2"]["params"]),
                    jax.tree_util.tree_leaves(two[1][0]["tp2"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_a_dp2_tp2_step_restores_bitwise_at_dp1_tp2(runs):
    _, staged, two = runs
    stage = staged[0]["stage"]
    assert stage["step"] == 2 and stage["shard_num"] == 4
    for r in two:
        land = r[1]["land"]
        assert (land["restored"], land["source"]) == (2, "storage")
        mesh = land["last_resize"]["mesh"]
        assert (mesh["dp"], mesh["tp"], mesh["fsdp"]) == (1, 2, 1)
        assert land["last_resize"]["from_mesh"]["dp"] == 2
        assert land["state"].keys() == stage["state"].keys()
        for path, want in stage["state"].items():
            if want is None:
                assert land["state"][path] is None
                continue
            np.testing.assert_array_equal(land["state"][path], want, err_msg=path)
        assert land["sampler"] == stage["sampler"]
        assert np.isfinite(land["losses"]).all() and len(land["losses"]) == 1
