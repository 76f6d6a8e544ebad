"""The port's resize strategy logic against the JAX package's, and its
strategy cache, on the CPU (no processes):

- ``_strategy_for_exact``, ``_rebalanced_strategy_for`` and
  ``_strategy_for`` of both packages, called unbound on stubs holding
  the same ``accel.strategy``, ``tcfg`` and ``_model_cfg``, give the
  same strategy (or both raise) over a grid: worlds 1..8; dp-only,
  fsdp-only and mixed meshes; batch 8 and 16; ``grad_accum`` 1 and 2;
  ``mb_rebalance`` on and off. Both packages price the rebalance with
  the same stub of ``price_rebalance_options``: what is compared is the
  choice logic, not the two roofline tables;
- ``accel/compile_cache.py``: the JAX package's ``TestCompileCache`` and
  ``TestSpeculativeCompiler`` cases (``tests/test_resize.py``) against
  the port's module, the disk layer warm-starting a fresh cache
  included (held to its behavior: the JAX test of it is red here);
- the trainer: a pinned strategy of another world is derived, and a
  second trainer of the same world finds it in the disk layer
  (``compile_cache_hit``); ``update_scale_candidates`` derives a
  predicted world in the background into that cache;
  ``speculative_compile=False`` does nothing;
- ``enable_compile_cache`` points the kernel build directory, Triton's
  cache and the strategy cache at one job-stable directory, and
  ``off`` disables it.
"""

import itertools
import os
import time
from types import SimpleNamespace

import pytest
import torch

from dlrover_tpu.accel import dry_runner as jdry
from dlrover_tpu.accel.strategy import Strategy as JStrategy
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.accel import dry_runner as tdry
from dlrover_tpu_torch.accel.compile_cache import (
    CompileCache,
    CompileTask,
    SpeculativeCompiler,
    fingerprint,
    tree_signature,
)
from dlrover_tpu_torch.accel.profiler import PipelineStats
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

import torch_dist_worker as tdw

MESHES = {"dp": dict(dp=2), "fsdp": dict(fsdp=2), "mixed": dict(dp=2, fsdp=2)}
GRID = list(itertools.product(range(1, 9), MESHES, (8, 16), (1, 2), (True, False)))


def _price(cfg, batch, seq, idle, reb, measured_step_s=None, current_strategy=None):
    """The same pricing for both packages: rows a rank, the padded
    rebalance carrying a fixed cost, so either side can win."""
    rows = lambda s: (batch + s.batch_pad) / (s.mesh.dp * s.mesh.fsdp)  # noqa: E731
    return rows(idle), rows(reb) + 0.5


def _stub(pkg, mesh, batch, ga, reb):
    if pkg == "jax":
        strategy = JStrategy(mesh=JMeshConfig(**mesh), grad_accum=ga)
        tcfg_ = jtrainer.TrainerConfig(batch_size=batch, seq_len=16, grad_accum=ga,
                                       mb_rebalance=reb)
        return SimpleNamespace(accel=SimpleNamespace(strategy=strategy), tcfg=tcfg_,
                               _model_cfg=jcfg.tiny(), _step_time_sum=0.0, _step_time_n=0)
    strategy = Strategy(mesh=MeshConfig(**mesh), grad_accum=ga)
    tcfg_ = ttrainer.TrainerConfig(batch_size=batch, seq_len=16, grad_accum=ga, mb_rebalance=reb)
    return SimpleNamespace(accel=SimpleNamespace(strategy=strategy), tcfg=tcfg_,
                           _model_cfg=tcfg.tiny(), _prev_step_s=None)


def _call(cls, name, stub, n):
    """The method's strategy as JSON, its None, or the error's type."""
    if name == "_strategy_for":
        # the JAX method calls its siblings through ``self``
        stub._strategy_for_exact = lambda k: cls._strategy_for_exact(stub, k)
        stub._rebalanced_strategy_for = lambda k: cls._rebalanced_strategy_for(stub, k)
    try:
        out = getattr(cls, name)(stub, n)
    except ValueError:
        return "ValueError"
    return None if out is None else out.to_json()


@pytest.mark.parametrize("n,mesh,batch,ga,reb", GRID)
def test_strategy_derivation_matches_the_jax_package(n, mesh, batch, ga, reb, monkeypatch):
    monkeypatch.setattr(jdry, "price_rebalance_options", _price)
    monkeypatch.setattr(tdry, "price_rebalance_options", _price)
    for name in ("_strategy_for_exact", "_rebalanced_strategy_for", "_strategy_for"):
        want = _call(jtrainer.ElasticTrainer, name, _stub("jax", MESHES[mesh], batch, ga, reb), n)
        got = _call(ttrainer.ElasticTrainer, name, _stub("port", MESHES[mesh], batch, ga, reb), n)
        assert got == want, (name, got, want)


def test_the_grid_reaches_every_branch(monkeypatch):
    """The grid is not vacuous: it degrades, rebalances, and finds no
    mesh at all."""
    monkeypatch.setattr(tdry, "price_rebalance_options", _price)
    seen = set()
    for n, mesh, batch, ga, reb in GRID:
        stub = _stub("port", MESHES[mesh], batch, ga, reb)
        out = _call(ttrainer.ElasticTrainer, "_strategy_for", stub, n)
        if out == "ValueError":
            seen.add("raise")
            continue
        s = Strategy.from_json(out)
        seen.add("pad" if s.batch_pad else "degrade" if s.mesh.num_devices < n else "exact")
    assert seen >= {"pad", "degrade", "exact"}


# -- the compile cache (tests/test_resize.py's cases) --------------------------
class TestCompileCache:
    def test_get_or_build_memoizes(self):
        cache = CompileCache(capacity=4)
        calls = []

        def build():
            calls.append(1)
            return object()

        a, hit_a = cache.get_or_build("k1", build)
        b, hit_b = cache.get_or_build("k1", build)
        assert a is b and not hit_a and hit_b
        assert len(calls) == 1
        assert cache.hits == 1 and cache.misses == 1
        assert cache.hit_pct == 50.0

    def test_get_or_compile_roundtrip(self):
        cache = CompileCache(capacity=4, cache_dir="")
        key = fingerprint("t", Strategy(mesh=MeshConfig(dp=2)).to_json())
        got, hit = cache.get_or_compile(key, lambda: Strategy(mesh=MeshConfig(dp=2)).to_json())
        assert not hit
        again, hit2 = cache.get_or_compile(
            key, lambda: (_ for _ in ()).throw(AssertionError("rebuilt")))
        assert hit2 and again is got
        assert Strategy.from_json(again).mesh.dp == 2

    def test_lru_eviction(self):
        cache = CompileCache(capacity=2)
        for k in ("a", "b", "c"):
            cache.get_or_build(k, lambda: k)
        assert not cache.peek("a") and cache.peek("b") and cache.peek("c")

    def test_stats_record_attached(self):
        stats = PipelineStats()
        cache = CompileCache(stats=stats)
        cache.get_or_build("x", lambda: 1)
        cache.get_or_build("x", lambda: 1)
        assert stats.compile_cache_misses == 1
        assert stats.compile_cache_hits == 1
        assert stats.compile_cache_hit_pct == 50.0
        d = stats.as_dict()
        assert d["compile_cache_hit_pct"] == 50.0
        assert d["reshard_bytes_device_vs_host"] == [0, 0]

    def test_disk_layer_warm_starts_a_fresh_cache(self, tmp_path):
        """A second cache instance (a relaunched worker) loads the
        artifact instead of rebuilding it; one that is no string or
        bytes stays in memory only (a miss next time, never an error)."""
        key = fingerprint("disk", 2)
        c1 = CompileCache(cache_dir=str(tmp_path))
        art, _ = c1.get_or_compile(key, lambda: Strategy(mesh=MeshConfig(dp=2)).to_json())
        c1.get_or_compile("obj", lambda: object())
        c2 = CompileCache(cache_dir=str(tmp_path))
        art2, hit = c2.get_or_compile(
            key, lambda: (_ for _ in ()).throw(AssertionError("rebuilt")))
        assert hit and c2.disk_hits == 1 and art2 == art
        _, hit_obj = c2.get_or_compile("obj", lambda: object())
        assert not hit_obj

    def test_tree_signature_meta_vs_concrete_collide(self):
        """A key computed from a state's shapes on the meta device (a
        speculative derivation) and one from the live state collide."""
        live = {"w": torch.ones(4, 2)}
        with torch.device("meta"):
            spec = {"w": torch.empty(4, 2)}
        assert tree_signature(live) == tree_signature(spec)


class TestSpeculativeCompiler:
    def test_background_compile_lands_in_cache(self):
        cache = CompileCache()
        built = []

        def build():
            built.append(1)
            return "exe"

        sc = SpeculativeCompiler(cache, budget_s=30.0)
        try:
            sc.submit([CompileTask(label="m1", key="k1", build=build)])
            assert sc.wait_idle(10.0)
            assert cache.peek("k1") and built == [1]
            # already-cached keys are skipped without a build
            sc.submit([CompileTask(label="m1", key="k1", build=build)])
            assert sc.wait_idle(10.0)
            assert built == [1]
        finally:
            sc.close()

    def test_pause_defers_until_released(self):
        cache = CompileCache()
        paused = {"v": True}
        sc = SpeculativeCompiler(cache, pause_fn=lambda: paused["v"], budget_s=30.0)
        try:
            sc.submit([CompileTask(label="m", key="kp", build=lambda: "exe")])
            time.sleep(0.3)
            assert not cache.peek("kp")  # a staging window holds it off
            paused["v"] = False
            assert sc.wait_idle(10.0)
            assert cache.peek("kp")
        finally:
            sc.close()

    def test_budget_drops_remaining_candidates(self):
        cache = CompileCache()
        sc = SpeculativeCompiler(cache, budget_s=0.0)
        try:
            sc.submit([CompileTask(label="m", key="kb", build=lambda: "exe")])
            assert sc.wait_idle(10.0)
            assert not cache.peek("kb") and sc.dropped == 1
        finally:
            sc.close()

    def test_stale_task_not_requeued_after_replacement(self):
        cache = CompileCache()
        paused = {"v": True}
        sc = SpeculativeCompiler(cache, pause_fn=lambda: paused["v"], budget_s=30.0)
        try:
            sc.submit([CompileTask(label="old", key="kold", build=lambda: "e")])
            time.sleep(0.2)  # the worker pops and requeues under pause
            sc.submit(())  # the prediction is replaced
            paused["v"] = False
            assert sc.wait_idle(10.0)
            time.sleep(0.2)
            assert not cache.peek("kold")
        finally:
            sc.close()

    def test_build_error_does_not_kill_the_thread(self):
        cache = CompileCache()
        sc = SpeculativeCompiler(cache, budget_s=30.0)

        def boom():
            raise RuntimeError("bad candidate")

        try:
            sc.submit([CompileTask(label="bad", key="kx", build=boom),
                       CompileTask(label="good", key="ky", build=lambda: "exe")])
            assert sc.wait_idle(10.0)
            assert sc.errors == 1 and cache.peek("ky")
        finally:
            sc.close()


# -- the trainer's strategy cache ------------------------------------------------
def _trainer(**kw):
    return ttrainer.ElasticTrainer(
        tcfg.tiny(), ttrainer.build_optimizer("sgd"), tdw.Tokens(),
        ttrainer.TrainerConfig(report_metrics=False, prefetch=0, **kw), devices="cpu",
        strategy=Strategy(mesh=MeshConfig(dp=2)))


def test_second_visit_to_a_world_is_a_cache_hit(tmp_path, monkeypatch):
    """dp=2 pinned on one process is carried to dp=1 (a miss, written to
    the disk layer); a second trainer (a relaunch into the same world)
    finds it there. The world-2 prediction is derived in the background
    into the same cache; with ``speculative_compile`` off nothing is."""
    monkeypatch.setenv("DLROVER_TPU_STRATEGY_CACHE", str(tmp_path))
    first = _trainer()
    try:
        assert first.strategy.mesh.num_devices == 1 and first._cache_hit is False
        assert first.pipeline_stats.compile_cache_misses == 1
        assert first.update_scale_candidates([1, 2, 0]) == 1  # 1 is this world
        assert first._spec_compiler.wait_idle(30.0)
        key = first._strategy_key(first.strategy, 2)
        assert first._compile_cache.peek(key)
        assert os.path.exists(os.path.join(str(tmp_path), f"{key}.str"))
        assert Strategy.from_json(first._compile_cache.get_or_compile(key, None)[0]).mesh.dp == 2
    finally:
        first.close()
    second = _trainer()
    try:
        assert second._cache_hit is True and second.pipeline_stats.compile_cache_hits == 1
        assert second.strategy == first.strategy
    finally:
        second.close()
    off = _trainer(speculative_compile=False)
    try:
        assert off.update_scale_candidates([2]) == 0 and off._spec_compiler is None
    finally:
        off.close()


def test_enable_compile_cache_points_the_builds_at_one_dir(tmp_path, monkeypatch):
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.elastic.distributed import enable_compile_cache

    for var in ("DLROVER_TPU_KERNEL_BUILD_DIR", "TRITON_CACHE_DIR", "DLROVER_TPU_STRATEGY_CACHE"):
        # set, then removed: the fixture restores what was there, so the
        # variables enable_compile_cache sets do not outlive the test
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", "off")
    assert enable_compile_cache() == ""
    assert _build.build_dir_in_use() == _build.BUILD_DIR
    monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "triton")
    assert os.environ["DLROVER_TPU_STRATEGY_CACHE"] == str(tmp_path / "strategy")
    # the JAX package's executable cache stays off
    assert "DLROVER_TPU_AOT_CACHE" not in os.environ
    assert _build.build_dir_in_use() == tmp_path / "nvcc"
