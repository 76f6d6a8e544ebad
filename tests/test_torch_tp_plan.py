"""Tensor parallelism's planning, gates and pricing against the JAX
package's, with no processes:

- the plans of kind ``tp`` (dp x tp[, sp]) and ``3d`` (dp x fsdp x tp)
  against the JAX ``plan_for_mesh`` on the same mesh of the 8-device CPU
  mesh: the ``tp`` plan's buckets and every byte count equal (its leaves
  are the global ones, as the JAX plan's), the ``3d`` plan's leaves the
  JAX package's tp-local ones with the same per-leaf tp dims and
  grouping, its padding the port's ZeRO block layout's, every byte count
  the JAX formula on it (``test_torch_grad_sync_plan``'s zero rule);
- the compression gate: int8 on ``tp`` plans and ``none`` on ``3d``, as
  the JAX gate gives them when its residual probe answers True (it does
  at the JAX release here, which is why the JAX package's own tests that
  pin the opposite are red: ``test_hybrid_sync.py::TestSyncModeGate::
  test_tp_plan_forces_compress_off`` and ``test_plan_buckets_rejects_
  bad_combos``, ``test_sparse_sync.py::TestAutoAxisResidualProbe``);
- the rule table, the tp dims (the JAX ``_localize_axis`` rule: a dim
  tp does not divide stays whole), a rank's box and the mesh's groups;
- what no longer raises (tp, 3d, fsdp x sp) and what still does (ep,
  pp; a tp that does not divide the heads, kv heads or MLP width);
- the dry runner's static peak and step-time terms at tp = 2, and a
  search over two ranks of a Llama-shaped model that picks tp."""

import jax
import numpy as np
import pytest

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models.transformer import init_params
from dlrover_tpu.parallel import grad_sync as jgs
from dlrover_tpu.parallel import sharding_rules as jrules
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.parallel import grad_sync as tgs
from dlrover_tpu_torch.parallel import sharding_rules as trules
from dlrover_tpu_torch.parallel.mesh import MeshConfig

MODEL = dict(rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)


class _Mesh:
    """What the port's ``plan_for_mesh`` reads of a built mesh."""

    def __init__(self, **sizes):
        self.config = MeshConfig(**sizes)

    def axis_sizes(self):
        return self.config.axis_sizes()


def _plans(sizes, compress, bucket_mb=1, model=MODEL):
    jc, tc = jcfg.tiny(**model), tcfg.tiny(**model)
    n = int(np.prod(list(sizes.values())))
    jmesh = build_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), jc))
    j = jgs.plan_for_mesh(jc, jmesh, compress, bucket_mb, params_shape=shapes)
    t = tgs.plan_for_mesh(tc, _Mesh(**sizes), compress, bucket_mb,
                          params_shape=tgs.model_leaves(tc))
    return j, t


def _buckets(plan):
    return [dict(vars(b)) for b in plan.buckets]


def _bytes(plan):
    return dict(raw=plan.raw_bytes, explicit=plan.explicit_wire_bytes(),
                gspmd=plan.gspmd_allreduce_bytes(), num=plan.num_buckets)


TP_MESHES = [dict(dp=2, tp=2), dict(dp=4, tp=2), dict(dp=2, sp=2, tp=2)]


@pytest.mark.parametrize("sizes", TP_MESHES, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("bucket_mb", [1, 4])
def test_tp_plans_are_the_jax_plans(sizes, bucket_mb):
    j, t = _plans(sizes, "none", bucket_mb)
    assert t.kind == j.kind == "tp" and t.model_shard == j.model_shard == 2
    assert _buckets(t) == _buckets(j)
    assert t.leaf_shapes == j.leaf_shapes and t.leaf_dtypes == j.leaf_dtypes
    assert _bytes(t) == _bytes(j) and t.wire_bytes == j.wire_bytes
    assert t.describe() == j.describe() and t.compress == j.compress == "none"
    # the port's own: each rank's boxes of the global leaves
    _, jdims = jgs._localize_tp(jax.eval_shape(
        lambda: init_params(jax.random.PRNGKey(0), jcfg.tiny(**MODEL))), 2, jcfg.tiny(**MODEL))
    assert t.tp == 2 and t.leaf_tp_dims == jdims
    for i, (shape, d) in enumerate(zip(t.leaf_shapes, t.leaf_tp_dims)):
        assert t.local_shape(i) == tuple(n // 2 if k == d else n for k, n in enumerate(shape))


def test_tp_plans_run_int8_as_the_probing_jax_gate_does():
    """int8 on a tp plan: the buckets the JAX plan's; the byte counts
    too but ``wire_bytes``, which prices the legs as the port ships them
    (C4's departure: the int16 all-gather of the summed codes)."""
    j, t = _plans(dict(dp=2, tp=2), "int8")
    assert j.compress == t.compress == "int8"
    assert _buckets(t) == _buckets(j) and _bytes(t) == _bytes(j)
    assert t.wire_bytes - j.wire_bytes == sum(t.code_gather_bytes(b) for b in t.buckets)
    # the residual covers each rank's tp-local bucket
    for b in t.buckets:
        local = sum(int(np.prod(t.local_shape(i))) for i in range(b.start, b.stop))
        assert t.residual_elems(b) == -(-local // 2) * 2 < b.padded
    _, top = _plans(dict(dp=2, tp=2), "int8_topk")
    assert top.compress == "int8"


@pytest.mark.parametrize("sizes", [dict(fsdp=2, tp=2), dict(dp=2, fsdp=2, tp=2),
                                   dict(fsdp=2, tp=2, sp=2)],
                         ids=["fsdp2tp2", "dp2fsdp2tp2", "fsdp2tp2sp2"])
@pytest.mark.parametrize("compress", ["none", "int8"])
def test_3d_plans_differ_from_the_jax_plans_only_by_the_block_padding(sizes, compress):
    j, t = _plans(sizes, compress, bucket_mb=1)
    assert t.kind == j.kind == "3d" and t.compress == j.compress == "none"
    assert (t.tp, t.model_shard, t.fsdp, t.dp) == (j.tp, j.model_shard, j.fsdp, j.dp)
    assert t.leaf_shapes == j.leaf_shapes and t.leaf_tp_dims == j.leaf_tp_dims
    assert [(b.start, b.stop, b.elems, b.raw_bytes) for b in t.buckets] == [
        (b.start, b.stop, b.elems, b.raw_bytes) for b in j.buckets]
    F, dp = t.fsdp, t.dp
    for b in t.buckets:
        rows = sum(-(-int(np.prod(t.leaf_shapes[i])) // (F * 128)) * 128
                   for i in range(b.start, b.stop))
        assert b.padded == F * (-(-rows // dp) * dp)
    same = jgs.BucketPlan(**{**j.__dict__, "buckets": t.buckets})
    assert _bytes(t) == _bytes(same) and t.wire_bytes == same.wire_bytes
    assert t.describe() == same.describe()


def test_resolve_plan_plans_tp_and_3d_and_still_names_a11():
    tc = tcfg.tiny(num_layers=1)
    for sizes, kind in ((dict(dp=2, tp=2), "tp"), (dict(dp=2, sp=2, tp=2), "tp"),
                        (dict(dp=2, fsdp=2, tp=2), "3d")):
        plan = tgs.resolve_plan(tc, Strategy(mesh=MeshConfig(**sizes), comm_overlap=True))
        assert plan.kind == kind
    # fsdp x sp without tp: no explicit plan, as in the JAX package
    s = Strategy(mesh=MeshConfig(fsdp=2, sp=2), comm_overlap=True)
    assert tgs.resolve_plan(tc, s) is None
    assert "fsdp x sp" in tgs.fallback_reason(s.mesh.axis_sizes())
    # dp x ep plans its expert and dense leaves apart (tests/test_torch_
    # grad_sync_plan.py), pp x dp per stage (tests/test_torch_pipeline.py);
    # pp x tp falls back to the default sync, as in the JAX package, and
    # the fallback names the composition (the model runs it)
    assert tgs.resolve_plan(tcfg.tiny(num_layers=2, num_experts=4),
                            Strategy(mesh=MeshConfig(dp=2, ep=2), comm_overlap=True)).kind == "ep"
    assert tgs.resolve_plan(tcfg.tiny(num_layers=2),
                            Strategy(mesh=MeshConfig(pp=2, dp=2), comm_overlap=True)).kind == "pp"
    s = Strategy(mesh=MeshConfig(pp=2, dp=2, tp=2), comm_overlap=True)
    assert tgs.resolve_plan(tc, s) is None
    assert "pp x tp composition" in tgs.fallback_reason(s.mesh.axis_sizes())
    from dlrover_tpu_torch.models.transformer import check_supported

    check_supported(tcfg.tiny(num_layers=2), s.mesh)


def test_the_rule_table_is_the_jax_package_s():
    assert trules.default_lm_rules().rules == jrules.default_lm_rules().rules
    rules = trules.default_lm_rules()
    for axes in (("embed", "heads", "head_dim"), ("vocab", "embed"), ("layer_stack", "mlp", "embed")):
        assert trules.logical_to_mesh_axes(axes, rules) == tuple(
            jrules.logical_to_mesh_axes(axes, jrules.default_lm_rules()))


@pytest.mark.parametrize("model,vocab_dim", [
    (dict(MODEL), 0), (dict(MODEL, vocab_size=255), None), (dict(scan_layers=True), 0),
], ids=["gpt2_form", "vocab255", "stacked"])
def test_tp_dims_follow_the_localize_rule(model, vocab_dim):
    jc, tc = jcfg.tiny(**model), tcfg.tiny(**model)
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), jc))
    local, jdims = jgs._localize_tp(shapes, 2, jc)
    assert trules.leaf_tp_dims(tc, 2) == jdims
    dims = trules.tp_dims(tc, 2)
    assert dims["embed.tokens"] == vocab_dim
    # a rank's leaves are the JAX package's tp-local shapes
    mine = [tuple(p.shape) for p in tgs.model_leaves(tc, MeshConfig(tp=2))]
    assert mine == [tuple(x.shape) for x in jax.tree_util.tree_leaves(local)]


def test_a_box_and_its_inverse():
    full = np.arange(4 * 6 * 2).reshape(4, 6, 2)
    boxes = [trules.local_shard(full, 1, 3, c) for c in range(3)]
    assert [b.shape for b in boxes] == [(4, 2, 2)] * 3
    np.testing.assert_array_equal(np.concatenate(boxes, 1), full)
    assert trules.tp_box(full.shape, 1, 3, 2) == ((0, 4), (4, 6), (0, 2))
    assert trules.local_shard(full, None, 3, 1) is full


def test_tp_groups_and_the_other_groups_per_tp_coordinate():
    """tp is innermost: its groups are runs of adjacent ranks, and every
    other axis's groups are one per tp coordinate (``_axis_runs`` fixes
    the other axes)."""
    from dlrover_tpu_torch.parallel.mesh import _axis_runs, rank_layout

    layout = rank_layout(MeshConfig(dp=2, fsdp=2, sp=2, tp=2))
    assert _axis_runs(layout, ("tp",)) == [[2 * i, 2 * i + 1] for i in range(8)]
    data = _axis_runs(layout, ("dp", "fsdp"))
    assert [0, 4, 8, 12] in data and [1, 5, 9, 13] in data and len(data) == 4
    for run in data + _axis_runs(layout, ("dp", "fsdp", "sp")) + _axis_runs(layout, ("dp",)):
        assert len({r % 2 for r in run}) == 1  # one tp coordinate each


def test_what_runs_and_what_still_raises():
    from dlrover_tpu_torch.accel.dry_runner import _check_unported
    from dlrover_tpu_torch.models.transformer import check_supported
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    cfg = tcfg.tiny()
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=4096)
    for sizes in (dict(tp=2), dict(dp=2, tp=2), dict(sp=2, tp=2), dict(fsdp=2, tp=2),
                  dict(fsdp=2, sp=2), dict(pp=2, tp=2)):
        check_supported(cfg, MeshConfig(**sizes))
        _check_unported(Strategy(mesh=MeshConfig(**sizes)), cfg, tx)
    # MoE with ep x tp (ROADMAP A19) builds
    check_supported(tcfg.tiny(num_experts=4, moe_every=2), MeshConfig(ep=2, tp=2))
    for bad, dim in ((dict(num_heads=6, num_kv_heads=2), "num_heads"),
                     (dict(num_kv_heads=1), "kv_heads"),
                     (dict(num_kv_heads=4, mlp_dim=66), "ffn_dim")):
        with pytest.raises(ValueError, match=f"does not divide {dim}"):
            check_supported(tcfg.tiny(**bad), MeshConfig(tp=2 if dim == "kv_heads" else 4))
    flat = tt.build_optimizer("adamw_8bit_flat")
    with pytest.raises(ValueError, match="adamw_8bit_flat"):
        _check_unported(Strategy(mesh=MeshConfig(tp=2)), cfg, flat)


def test_static_peak_prices_a_tp_rank():
    """A tp rank's static peak: its tp-local params, grads and state,
    H/tp and F/tp activations and V/tp logits; under 3d fsdp divides on
    top: each well below one rank's (the head's logits, the largest
    term at this shape, are priced at V/tp and by the vocab-parallel
    loss's two f32 tensors)."""
    from dlrover_tpu_torch.accel.dry_runner import static_peak_bytes
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    cfg = tcfg.tiny(num_layers=4, model_dim=256, num_heads=8, num_kv_heads=8, mlp_dim=1024,
                    vocab_size=4096, max_seq_len=512)
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=4096)
    one = static_peak_bytes(cfg, Strategy(mesh=MeshConfig()), tx, 2, 512)
    tp2 = static_peak_bytes(cfg, Strategy(mesh=MeshConfig(tp=2)), tx, 2, 512)
    three = static_peak_bytes(cfg, Strategy(mesh=MeshConfig(fsdp=2, tp=2), comm_overlap=True),
                              tx, 2, 512)
    assert tp2 < 0.6 * one and three < tp2


def test_the_step_time_prices_the_tp_all_reduces():
    from dlrover_tpu_torch.accel import dry_runner as tdr
    from dlrover_tpu_torch.parallel import topology

    cfg = tcfg.tiny()
    model = topology.get_link_model()
    for remat, n in ((False, 2 * 4 + 2), (True, 2 * 5 + 2)):
        c = tcfg.tiny(remat=remat)
        r = tdr.DryRunReport(strategy=Strategy(mesh=MeshConfig(dp=2, tp=2), grad_accum=2), ok=True)
        tdr._tp_comm_estimate(r, c, 8, 64)
        tok = 8 * 64 / 2 / 2  # a rank's rows of one microbatch
        wire = 2 * (2 - 1) / 2 * tok * cfg.model_dim * 4
        want = n * 2 * (wire * model.sec_per_axis_byte("tp") + 2 * 2 * model.ici_lat_s)
        np.testing.assert_allclose(r.comm_exposed_s, want, rtol=1e-12)
        assert r.comm_ici_s == r.comm_exposed_s and r.comm_bytes_per_device == n * 2 * wire
    r = tdr.DryRunReport(strategy=Strategy(mesh=MeshConfig(dp=2)), ok=True)
    tdr._tp_comm_estimate(r, cfg, 8, 64)
    assert r.comm_exposed_s == 0.0


def test_a_two_rank_search_of_a_llama_shape_may_pick_tp():
    """The candidates over two ranks of a Llama-shaped model include tp =
    2, and the static tier now prices it (it was refused, A10): with a
    budget only a tp rank's half of the state fits, tp wins."""
    from dlrover_tpu_torch.accel import dry_runner as tdr
    from dlrover_tpu_torch.accel.candidates import candidate_strategies
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    cfg = tcfg.tiny(num_layers=2, model_dim=512, num_heads=8, num_kv_heads=8, mlp_dim=1376,
                    vocab_size=32000, max_seq_len=256)
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=4096)
    cands = candidate_strategies(cfg, 2, 2, 256)
    assert any(c.mesh.tp == 2 for c in cands)
    costs = {c.mesh.tp: tdr.compiled_cost(c, cfg, tx, 2, 256, devices=2) for c in cands
             if c.mesh.fsdp == 1 and c.mesh.sp == 1}
    assert costs[2].ok and costs[1].ok, (costs[2].error, costs[1].error)
    budget = 0.5 * (costs[1].mem_bytes + costs[2].mem_bytes)
    fits = [tp for tp, r in costs.items() if tdr.hbm_fits(r.mem_bytes, budget)]
    assert fits == [2]
