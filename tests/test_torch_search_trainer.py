"""The trainer's strategy search and optimizer-state offload, on the CPU.

- ``ElasticTrainer`` without a strategy picks one through
  ``auto_accelerate`` (a timed dry run of each candidate), and its
  losses are bitwise those of the explicit strategy it picked and of
  ``dp`` over the world, at world size 1 and at 2 over gloo; the dry run
  moves no global generator;
- the step auditor's ``dlrover_audit_*`` series reach the
  runtime-metrics file;
- ``Strategy(offload_opt=True)``: on a host without a card a numeric
  no-op (``placement_active() is False``) that trains bitwise as the
  resident state; the pipeline path refuses it as the JAX package does
  (the streaming itself runs on the card only:
  ``tests/test_torch_offload_cuda.py``).

Losses and params are compared exactly (the same arithmetic on the same
inputs).
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.accel import dry_runner as tdr
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.ops import host_offload
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as tt

import torch_dist_worker as tdw


@pytest.fixture(autouse=True)
def _cache(monkeypatch, tmp_path):
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path / "topology"))


def _train(strategy=None, steps=4, opt="adamw", **tcfg_kw):
    losses = []
    tr = tt.ElasticTrainer(
        tcfg.tiny(), tt.build_optimizer(opt, lr=1e-2), tdw.Tokens(),
        tt.TrainerConfig(**{"batch_size": 4, "seq_len": 16, "report_metrics": False, "prefetch": 0,
                            **tcfg_kw}),
        strategy=strategy, devices="cpu",
        metrics_hook=lambda s, m: losses.append(float(m["loss"])) if "loss" in m else None,
    )
    tr.train(steps)
    return tr, losses


@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit_flat"])
def test_search_trainer_is_bitwise_the_strategy_it_picked(opt):
    rng_before = torch.get_rng_state()
    np_before = np.random.get_state()[1].copy()
    searched, losses = _train(opt=opt)
    # the dry run draws from generators of its own
    assert torch.equal(torch.get_rng_state(), rng_before)
    assert np.array_equal(np.random.get_state()[1], np_before)
    reports = searched.accel.reports
    assert reports and reports[0].ok and reports[0].step_s is not None
    assert reports[0].strategy == searched.strategy and searched.accel.search_s > 0
    picked = Strategy.from_json(searched.strategy.to_json())
    searched.close()
    for strategy in (picked, Strategy(mesh=MeshConfig(dp=1))):
        tr, again = _train(strategy, opt=opt)
        assert again == losses and tr.accel.reports == []
        tr.close()


def test_search_at_world_two_is_bitwise_dp(tmp_path):
    """Two gloo ranks: the trainer's search, the explicit strategy it
    picked, and dp=2 train to the same losses on both ranks, which built
    rank 0's winner."""
    runs = {
        "search": dict(search=True, steps=4),
        "picked": dict(strategy_of="search", steps=4),
        "dp": dict(steps=4),
    }
    ranks = tdw.run_ranks("train", 2, runs, str(tmp_path))
    for r in ranks:
        assert r["search"]["losses"] == r["picked"]["losses"] == r["dp"]["losses"]
        assert len(r["search"]["losses"]) == 4
        assert r["search"]["strategy"] == ranks[0]["search"]["strategy"]
        assert any(ok and timed for _, ok, timed in r["search"]["searched"])
    assert Strategy.from_json(ranks[0]["search"]["strategy"]).mesh.num_devices == 2


def test_audit_metrics_reach_the_runtime_metrics_file(tmp_path, monkeypatch):
    from dlrover_tpu_torch.agent.monitor import read_runtime_metrics

    path = tmp_path / "metrics.json"
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(path))
    tr, _ = _train(steps=6, report_metrics=True, log_interval=3)
    tr.close()
    metrics = read_runtime_metrics(str(path))
    audit = {k: v for k, v in metrics.items() if k.startswith("dlrover_audit_")}
    assert audit, sorted(metrics)[:20]
    assert any(k.startswith("dlrover_audit_steps_total") for k in audit)
    assert any(k.startswith("dlrover_audit_drift_factor") for k in audit)
    # the report at step 6 runs inside that step's span: 5 were audited
    # by then, the 6th is once its span closed
    assert metrics["dlrover_audit_steps_total"] == 5.0
    tr._auditor.collect()
    assert tr._auditor.steps_audited == 6
    # a healthy run raises no alarm
    assert not any(tr._auditor.alarms_total().values())


@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit_flat"])
def test_offload_on_a_host_without_a_card_is_the_numeric_no_op(opt):
    assert host_offload.placement_active("cpu") is False
    resident, want = _train(opt=opt)
    resident.close()
    off, got = _train(Strategy(mesh=MeshConfig(dp=1), offload_opt=True), opt=opt)
    assert got == want and off.strategy.offload_opt
    # the state stays where the params are, with no streamer
    assert getattr(off.state.opt_state.opt, "offload", None) is None
    off.close()


def test_pipeline_refuses_offload_as_the_jax_package_does():
    from dlrover_tpu.accel import dry_runner as jdr
    from dlrover_tpu.accel.strategy import Strategy as JStrategy
    from dlrover_tpu.models import config as jcfg
    from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig

    import jax
    import optax

    s = Strategy(mesh=MeshConfig(pp=2), offload_opt=True, num_microbatches=2)
    with pytest.raises(ValueError) as port_err:
        tdr._build(s, tcfg.tiny(), tt.build_optimizer("adamw"), "cpu")
    with pytest.raises(ValueError) as jax_err:
        jdr._build(JStrategy(mesh=JMeshConfig(pp=2), offload_opt=True, num_microbatches=2),
                   jcfg.tiny(), optax.adamw(1e-3), jax.devices()[:2])
    assert str(port_err.value) == str(jax_err.value)
    r = tdr.compiled_cost(s, tcfg.tiny(), tt.build_optimizer("adamw"), 8, 16, 2)
    assert not r.ok and "offload_opt is not supported on the pipeline" in r.error
    # without offload the pipeline builds, composed with tp too; with
    # offload it is refused there as well
    s3d = Strategy(mesh=MeshConfig(pp=2, tp=2), num_microbatches=2)
    tdr._build(s3d, tcfg.tiny(), tt.build_optimizer("adamw"), "cpu", abstract=True)
    assert tdr.compiled_cost(s3d, tcfg.tiny(), tt.build_optimizer("adamw"), 8, 16, 4).ok
    with pytest.raises(ValueError, match="offload_opt is not supported on the pipeline"):
        tdr._build(Strategy(mesh=MeshConfig(pp=2, tp=2), offload_opt=True, num_microbatches=2),
                   tcfg.tiny(), tt.build_optimizer("adamw"), "cpu")
