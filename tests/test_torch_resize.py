"""The port's elastic resize through the restart path, on the CPU over
gloo (``tests/torch_dist_worker.py``'s ``resize`` job): a checkpoint
staged at one world is landed by a trainer built at another.

Six starts of rank processes, alternating worlds 2, 1, 2, 1, 2, then 3;
each start stages the checkpoints the next one lands. The cases:

- dp=2 -> 1, 1 -> dp=2, ZeRO dp=1 x fsdp=2 -> 1 (each landed on the
  strategy derived from the one that staged it, carried in the step's
  metadata) and 1 -> ZeRO fsdp=2 (the caller's pinned strategy);
- each from disk (no saver: synchronous writes) and from a job whose
  saver this process hosts, where the JAX engine's rule picks the
  source: dp=2 -> 1 restores from shm (rank 0 staged every replicated
  leaf there), every other case from storage (a new rank has no
  segment; a ZeRO segment holds half of each leaf; a segment of the
  whole state does not hold a ZeRO rank's blocks);
- the restored state (params, the 8-bit codes and scales, counts, the
  schedule count, the step) equals the staged one bitwise, in the JAX
  layout; the global sampler resumes at the same position, and since
  every rank takes its rows of the same global batch, the same sample
  order; the next losses equal, bitwise, those of a fresh trainer of
  the landed strategy given the staged state;
- world 3 at batch 8 staged at dp=2: with ``mb_rebalance=False`` the
  JAX logic degrades to dp=2 and the third rank idles (no step, no
  shard: the checkpoint has two) while two ranks step bitwise as the
  world-2 run does; with the rebalance forced (its pricing stubbed to
  favor it) three ranks step with ``batch_pad=1``, within
  ``tests/test_torch_batch_pad.py``'s 1e-6 of the world-2 losses;
- ``last_resize`` carries the JAX resize's keys, and ``resize(n)`` at
  another world raises ``NotImplementedError`` naming the restart path.
"""

import numpy as np
import pytest

from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

import torch_dist_worker as tdw

K = 2  # the staged step
MORE = 2  # steps after the landing
PAD_RTOL = 1e-6  # tests/test_torch_batch_pad.py's LOSS_TOL
CASES = {
    # name: (staging world and mesh, landing world and pinned mesh)
    "dp2_to_1": ((2, dict(dp=2)), (1, None)),
    "1_to_dp2": ((1, dict(dp=1)), (2, None)),
    "zero_to_1": ((2, dict(fsdp=2)), (1, None)),
    "1_to_zero": ((1, dict(dp=1)), (2, dict(fsdp=2))),
}
# the landed mesh: the JAX derivation's (dp-only stays dp, fsdp-only
# stays fsdp) or the pinned one
LANDED = {"dp2_to_1": dict(dp=1, fsdp=1), "1_to_dp2": dict(dp=2, fsdp=1),
          "zero_to_1": dict(dp=1, fsdp=1), "1_to_zero": dict(dp=1, fsdp=2)}
# the source the JAX engine's rule gives each case in a saver's job
SHM_SOURCE = {"dp2_to_1": "memory", "1_to_dp2": "storage", "zero_to_1": "storage",
              "1_to_zero": "storage"}
# the starts in order: (world, [(case, source, "stage" | "land")]). A
# saver's steps only go up, and a rank's shm segment holds its newest
# stage: each shm case is staged at a later step, after the landing of
# the one before it
SHM_STEP = {"dp2_to_1": K, "1_to_dp2": K + 1, "zero_to_1": K + 2, "1_to_zero": K + 3}
PLAN = [
    (2, [("dp2_to_1", "disk", "stage"), ("zero_to_1", "disk", "stage"), ("w3", "disk", "stage"),
         ("dp2_to_1", "shm", "stage")]),
    (1, [("dp2_to_1", "disk", "land"), ("zero_to_1", "disk", "land"), ("dp2_to_1", "shm", "land"),
         ("1_to_dp2", "disk", "stage"), ("1_to_zero", "disk", "stage"),
         ("1_to_dp2", "shm", "stage")]),
    (2, [("1_to_dp2", "disk", "land"), ("1_to_zero", "disk", "land"), ("1_to_dp2", "shm", "land"),
         ("zero_to_1", "shm", "stage")]),
    (1, [("zero_to_1", "shm", "land"), ("1_to_zero", "shm", "stage")]),
    (2, [("1_to_zero", "shm", "land")]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("resize")
    staged, landed = {}, {}
    with tdw.hosted_saver(2) as env:
        for i, (world, items) in enumerate(PLAN):
            cases = {}
            for name, src, kind in items:
                c = dict(kind=kind, shm=src == "shm", ckpt_dir=str(d / f"{name}_{src}"))
                if name == "w3":
                    c.update(steps=K, mesh=dict(dp=2), more=MORE)
                elif kind == "stage":
                    c.update(steps=SHM_STEP[name] if src == "shm" else K, mesh=CASES[name][0][1])
                else:
                    st = staged[(name, src)]
                    c.update(mesh=CASES[name][1][1], more=MORE,
                             staged=dict(state=st["state"], sampler=st["sampler"]))
                cases[f"{name}/{src}/{kind}"] = c
            res = tdw.run_ranks("resize", world, cases, str(d / f"start{i}"), env=env)
            for key in cases:
                name, src, kind = key.split("/")
                if kind == "stage":
                    staged[(name, src)] = res[0][key]
                else:
                    landed[(name, src)] = [r[key] for r in res]
    w3 = {name: dict(kind="land", ckpt_dir=str(d / "w3_disk"), more=MORE, force_rebalance=force,
                     trainer=dict(mb_rebalance=force))
          for name, force in (("idle", False), ("rebalance", True))}
    res = tdw.run_ranks("resize", 3, w3, str(d / "start5"))
    for name in w3:
        landed[("w3", name)] = [r[name] for r in res]
    return staged, landed


def _bitwise(a: dict, b: dict):
    assert sorted(k for k in a if k != "grad_residual") == sorted(
        k for k in b if k != "grad_residual")
    for k in a:
        if k == "grad_residual":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("src", ["disk", "shm"])
@pytest.mark.parametrize("case", list(CASES))
def test_restore_at_a_changed_world_is_bitwise(runs, case, src):
    """The landing restores the staged state bitwise from the source the
    JAX rule picks, and trains on exactly as a fresh trainer given that
    state does."""
    staged, landed = runs
    st, ranks = staged[(case, src)], landed[(case, src)]
    (sw, smesh), (lw, lmesh) = CASES[case]
    want_source = "storage" if src == "disk" else SHM_SOURCE[case]
    for r in ranks:
        assert r["restored"] == st["step"]
        assert r["source"] == want_source
        _bitwise(r["state"], st["state"])
        # the sampler's global position: the same sample order
        assert r["sampler"] == st["sampler"]
        assert len(r["losses"]) == MORE and r["losses"] == r["fresh_losses"]
        assert all(np.isfinite(r["losses"]))
    assert ranks[0]["losses"] == ranks[-1]["losses"]
    from dlrover_tpu_torch.accel.strategy import Strategy

    mesh = Strategy.from_json(ranks[0]["strategy"]).mesh
    assert dict(dp=mesh.dp, fsdp=mesh.fsdp) == LANDED[case] and mesh.num_devices == lw
    rep = ranks[0]["last_resize"]
    assert set(rep) >= {"downtime_ms", "compile_cache_hit", "reshard_bytes_device",
                        "reshard_bytes_host", "fallback_paths", "mesh"}
    assert rep["reshard_bytes_device"] == 0 and rep["reshard_bytes_host"] > 0
    assert rep["from_world"] == sw and rep["world"] == lw and rep["source"] == want_source
    assert rep["fallback_paths"] and all(p.startswith(("train/params/", "train/opt_state/"))
                                         for p in rep["fallback_paths"])
    assert ranks[0]["stats"]["resize_count"] == 1


def test_world_three_degrades_and_idles_a_rank(runs):
    """mb_rebalance off: dp=2 over ranks 0-1, rank 2 idle; the two step
    bitwise as the world-2 run, and the checkpoint has two shards."""
    staged, landed = runs
    ranks = landed[("w3", "idle")]
    ref = staged[("w3", "disk")]["losses"]
    assert [r["idle"] for r in ranks] == [False, False, True]
    for r in ranks[:2]:
        assert r["losses"] == ref and r["restored"] == K
        assert r["shard_num"] == 2
        assert r["stats"]["resize_idle_ranks"] == 1 and r["stats"]["resize_mb_pad"] == 0
        assert r["last_resize"]["idle_ranks"] == 1
    assert ranks[2]["losses"] == [] and ranks[2]["last_resize"]["idle"]


def test_world_three_rebalances_with_a_pad(runs):
    """The rebalance forced: dp=3 with batch_pad=1, every rank steps, the
    losses those of the world-2 run within the padded step's tolerance."""
    from dlrover_tpu_torch.accel.strategy import Strategy

    staged, landed = runs
    ranks = landed[("w3", "rebalance")]
    ref = staged[("w3", "disk")]["losses"]
    for r in ranks:
        s = Strategy.from_json(r["strategy"])
        assert s.mesh.dp == 3 and s.batch_pad == 1 and not r["idle"]
        assert r["stats"]["resize_mb_pad"] == 1 and r["stats"]["resize_idle_ranks"] == 0
        np.testing.assert_allclose(r["losses"], ref, rtol=PAD_RTOL)


def test_resize_in_place_raises_naming_the_restart_path():
    tr = ttrainer.ElasticTrainer(tcfg.tiny(), ttrainer.build_optimizer("sgd"), tdw.Tokens(),
                                 ttrainer.TrainerConfig(report_metrics=False), devices="cpu")
    try:
        assert tr.resize() == {} and tr.resize(1) == {}
        with pytest.raises(NotImplementedError, match="restart path"):
            tr.resize(2)
    finally:
        tr.close()
