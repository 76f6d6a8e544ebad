"""The port's gradient-sync planning against the JAX package's, with no
processes: the mesh gate over the mesh matrix, the bucket plans of a
tiny GPT-2 and their byte accounting, the ZeRO layout's padding, the
same ValueErrors for bad combinations, and the ROADMAP items named by
what the port does not plan yet.

One count departs from the JAX package's, by design: ``wire_bytes`` of a
compressed plan prices the legs as the port ships them
(``_wire_departure``), and every test that compares the byte counts
asserts that departure by name."""

import jax
import numpy as np
import pytest

from dlrover_tpu.accel.strategy import Strategy as JStrategy
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models.transformer import init_params
from dlrover_tpu.parallel import grad_sync as jgs
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.parallel import grad_sync as tgs
from dlrover_tpu_torch.parallel.mesh import MeshConfig

# every axis combination of tests/test_mesh_matrix.py and the hybrid
# sync tests, plus the degenerate ones
MESHES = [
    {}, {"dp": 2}, {"dp": 4}, {"dp": 8}, {"fsdp": 2}, {"dp": 2, "fsdp": 2},
    {"dp": 4, "fsdp": 2}, {"dp": 2, "tp": 2}, {"dp": 2, "sp": 2},
    {"dp": 2, "tp": 2, "sp": 2}, {"dp": 2, "ep": 2}, {"ep": 2},
    {"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2, "sp": 2},
    {"dp": 2, "fsdp": 2, "sp": 2}, {"pp": 2, "dp": 4}, {"pp": 2},
    {"pp": 2, "ep": 2, "dp": 2}, {"pp": 2, "tp": 2, "fsdp": 2, "dp": 2},
    {"ep": 2, "tp": 2, "dp": 2}, {"ep": 2, "fsdp": 2, "dp": 2}, {"tp": 2},
]


def _as(x):
    """A dataclass's fields (the two packages' classes never compare
    equal themselves)."""
    return None if x is None else dict(vars(x))


def _buckets(plan):
    return [_as(b) for b in plan.buckets]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()) or "one")
def test_the_gate_matches_the_jax_package(sizes):
    assert _as(tgs.resolve_sync_mode(sizes)) == _as(jgs.resolve_sync_mode(sizes))
    assert tgs.fallback_reason(sizes) == jgs.fallback_reason(sizes)


def _leaves():
    """The tiny GPT-2's leaves: the JAX shapes tree and the port's
    leaves in the JAX order."""
    jc = jcfg.tiny(rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)
    tc = tcfg.tiny(rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), jc))
    return shapes, tgs.model_leaves(tc)


def _bytes(plan):
    """Every byte count but ``wire_bytes`` (see ``_assert_wire``)."""
    return dict(
        raw=plan.raw_bytes,
        explicit=plan.explicit_wire_bytes(), gspmd=plan.gspmd_allreduce_bytes(),
        dcn_flat=plan.dcn_bytes_flat(), dcn_2level=plan.dcn_bytes_twolevel(),
        dcn_sparse=plan.dcn_bytes_sparse(), density=plan.dcn_density,
        num=plan.num_buckets,
    )


def _wire_departure(t, j) -> int:
    """The port's ``wire_bytes`` less the JAX package's for the same
    buckets: on compressed plans the all-gather of the summed int8 codes
    (int16; the JAX count prices the codes alone), and under
    ``int8_topk`` the dense int8 shard the port ships in place of the k
    blocks and their int32 indices the JAX count prices."""
    if not t.compressed:
        return 0
    extra = sum(t.code_gather_bytes(b) for b in t.buckets)
    if t.sparse:
        extra += sum(t.shard_elems(b) - j.topk_blocks(b)[1] * (j.topk_block + 4)
                     for b in t.buckets)
    return extra


def _assert_wire(t, j):
    assert t.wire_bytes - j.wire_bytes == _wire_departure(t, j)
    if t.compressed:
        n = t.slices if t.two_level else t.dp
        assert all(t.code_gather_bytes(b) == t.shard_elems(b) // n * 2 for b in t.buckets)


DP_PLANS = [
    dict(dp=4, slices=1, compress="none"), dict(dp=4, slices=1, compress="int8"),
    dict(dp=4, slices=2, compress="none"), dict(dp=4, slices=2, compress="int8"),
    dict(dp=4, slices=2, compress="int8_topk", topk_density=0.25),
    dict(dp=4, slices=2, compress="int8_topk", topk_density=1.0),
    dict(dp=2, slices=1, compress="none"), dict(dp=3, slices=1, compress="int8"),
]


@pytest.mark.parametrize("kw", DP_PLANS, ids=lambda k: "-".join(str(v) for v in k.values()))
@pytest.mark.parametrize("bucket_bytes", [4096, 1 << 20])
def test_dp_plans_account_as_the_jax_package(kw, bucket_bytes):
    shapes, leaves = _leaves()
    j = jgs.plan_buckets(shapes, bucket_bytes=bucket_bytes, **kw)
    t = tgs.plan_buckets(leaves, bucket_bytes=bucket_bytes, **kw)
    assert _buckets(t) == _buckets(j)
    assert t.leaf_shapes == j.leaf_shapes and t.leaf_dtypes == j.leaf_dtypes
    assert _bytes(t) == _bytes(j)
    _assert_wire(t, j)
    assert [t.shard_elems(b) for b in t.buckets] == [j.shard_elems(b) for b in j.buckets]
    assert [t.topk_blocks(b) for b in t.buckets] == [j.topk_blocks(b) for b in j.buckets]
    assert t.describe() == j.describe()


@pytest.mark.parametrize("dp,fsdp,slices,compress", [
    (1, 2, 1, "none"), (2, 2, 1, "none"), (2, 2, 1, "int8"), (4, 2, 2, "int8"),
    (4, 2, 2, "int8_topk"),
])
def test_zero_plans_differ_only_by_the_block_padding(dp, fsdp, slices, compress):
    """The same leaf grouping as the JAX package's zero plan. The port
    pads each leaf to ``fsdp * 128`` (whole 8-bit AdamW blocks, split
    evenly over fsdp) and each rank's chunk of the bucket to a multiple
    of dp, so a bucket of leaves n_i holds

        padded = fsdp * ceil(sum_i ceil(n_i / (fsdp*128)) * 128 / dp) * dp

    elements where the JAX package's holds ceil(sum_i n_i / (dp*fsdp))
    * dp * fsdp; every byte count is the JAX formula on that padded."""
    shapes, leaves = _leaves()
    kw = dict(dp=dp, fsdp=fsdp, slices=slices, compress=compress, bucket_bytes=8192,
              topk_density=0.25)
    j = jgs.plan_buckets(shapes, **kw)
    t = tgs.plan_buckets(leaves, kind="zero", leaf_block=128, **kw)
    assert [(b.start, b.stop, b.elems, b.raw_bytes) for b in t.buckets] == [
        (b.start, b.stop, b.elems, b.raw_bytes) for b in j.buckets]
    for b in t.buckets:
        rows = sum(-(-int(np.prod(t.leaf_shapes[i])) // (fsdp * 128)) * 128
                   for i in range(b.start, b.stop))
        assert b.padded == fsdp * (-(-rows // dp) * dp)
        assert b.padded >= b.elems and b.padded % (dp * fsdp) == 0
    # the JAX formulas, evaluated on the port's padding
    same = jgs.BucketPlan(**{**j.__dict__, "buckets": t.buckets})
    assert _bytes(t) == _bytes(same)
    _assert_wire(t, same)
    assert t.raw_bytes == j.raw_bytes


def test_resolve_plan_matches_for_dp_and_zero():
    jc, tc = jcfg.tiny(num_layers=1), tcfg.tiny(num_layers=1)
    for mesh, comp in ((dict(dp=4), "int8"), (dict(dp=4, dcn_axes=("dp",), slices=2), "int8_topk"),
                       (dict(dp=2), "none")):
        j = jgs.resolve_plan(jc, JStrategy(mesh=JMeshConfig(**mesh), comm_overlap=True,
                                           grad_compress=comp, grad_bucket_mb=1))
        t = tgs.resolve_plan(tc, Strategy(mesh=MeshConfig(**mesh), comm_overlap=True,
                                          grad_compress=comp, grad_bucket_mb=1))
        assert _buckets(t) == _buckets(j) and _bytes(t) == _bytes(j) and t.compress == j.compress
        _assert_wire(t, j)
    # no data axis: both keep the default schedule
    assert tgs.resolve_plan(tc, Strategy(comm_overlap=True)) is None
    assert jgs.resolve_plan(jc, JStrategy(comm_overlap=True)) is None
    # the requested mode only on the strategy's opt names
    assert tgs.resolve_plan(tc, Strategy(mesh=MeshConfig(dp=2))) is None


@pytest.mark.parametrize("kw", [
    dict(dp=4, compress="int4"), dict(dp=0), dict(dp=4, fsdp=0), dict(dp=4, slices=3),
    dict(dp=4, compress="int8_topk"), dict(dp=4, slices=2, compress="int8_topk", topk_density=0.0),
    dict(dp=4, slices=2, compress="int8_topk", topk_block=0),
    dict(dp=2, fsdp=2, auto_axes=("tp",)), dict(dp=2, kind="3d", tp=1),
])
def test_bad_combinations_raise_the_same_value_errors(kw):
    shapes, leaves = _leaves()
    with pytest.raises(ValueError) as je:
        jgs.plan_buckets(shapes, **kw)
    with pytest.raises(ValueError) as te:
        tgs.plan_buckets(leaves, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("sizes,item", [
    (dict(pp=2, dp=4, tp=2), "A11c"), (dict(pp=2, dp=2, fsdp=2), "A11c"),
])
def test_model_sharded_plans_name_their_roadmap_item(sizes, item):
    """pp composed with a model axis: the sync falls back as in the JAX
    package (no plan, the composition named), and the model runs the
    mesh: its ROADMAP item (``item``) has landed (pp x dp plans per
    stage: tests/test_torch_pipeline.py; the 3D steps:
    tests/test_torch_pipeline_3d.py)."""
    from dlrover_tpu_torch.models.transformer import check_supported

    s = Strategy(mesh=MeshConfig(**sizes), comm_overlap=True)
    assert tgs.resolve_plan(tcfg.tiny(num_layers=2), s) is None
    assert tgs.fallback_reason(s.mesh.axis_sizes()) == jgs.fallback_reason(s.mesh.axis_sizes())
    assert "pp x" in tgs.fallback_reason(s.mesh.axis_sizes()) and item == "A11c"
    check_supported(tcfg.tiny(num_layers=2), s.mesh)


# one fixed link model for both packages (the field names and values are
# the JAX package's fallback, so either package's pricing reads the same
# numbers), and a near-parity one that keeps compression off
LINK_KW = [
    dict(ici_gbps=90.0, dcn_gbps=12.5, host_d2h_gbps=8.0, host_h2d_gbps=8.0, ici_lat_s=1e-6,
         dcn_lat_s=5e-5, host_lat_s=1e-5, ici_axis_gbps=(("fsdp", 45.0),), source="measured",
         fingerprint="fixed-a"),
    dict(ici_gbps=60.0, dcn_gbps=40.0, host_d2h_gbps=20.0, host_h2d_gbps=25.0, ici_lat_s=2e-6,
         dcn_lat_s=2e-5, host_lat_s=1e-5, source="measured", fingerprint="fixed-b"),
]
# relative tolerance of the priced seconds (the same float expressions in
# both packages: only summation order could part them)
PRICE_RTOL = 1e-12


@pytest.fixture(params=range(len(LINK_KW)), ids=["ratio7.2", "ratio1.5"])
def links(request):
    """The same LinkModel installed as the process-current model of both
    packages (every pricing call without an explicit model reads it)."""
    from dlrover_tpu.parallel import topology as jtop
    from dlrover_tpu_torch.parallel import topology as ttop

    kw = LINK_KW[request.param]
    jm, tm = jtop.LinkModel(**kw), ttop.LinkModel(**kw)
    # a model an earlier test of this process probed for the device's
    # fingerprint (or rail rates it observed) would win over the
    # installed one
    for top in (jtop, ttop):
        top.reset_link_model()
        top.reset_rail_rates()
    jtop.set_link_model(jm)
    ttop.set_link_model(tm)
    yield jm, tm
    jtop.reset_link_model()
    ttop.reset_link_model()


def test_link_model_knobs_name_a9(links):
    """``grad_compress="auto"`` and ``grad_bucket_mb=0`` and the link-time
    pricing no longer raise (they waited for ROADMAP A9): the plans they
    resolve and the seconds priced equal the JAX package's under the
    same link model."""
    jc = jcfg.tiny(rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)
    tc = tcfg.tiny(rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)
    shapes, leaves = _leaves()
    for mesh in (dict(dp=2), dict(dp=4, dcn_axes=("dp",), slices=2), dict(dp=4, dcn_axes=("dp",))):
        for kw in (dict(grad_compress="auto"), dict(grad_bucket_mb=0),
                   dict(grad_compress="auto", grad_bucket_mb=0)):
            t = Strategy(mesh=MeshConfig(**mesh), comm_overlap=True, **kw)
            j = JStrategy(mesh=JMeshConfig(**mesh), comm_overlap=True, **kw)
            pt, pj = tgs.resolve_plan(tc, t, leaves), jgs.resolve_plan(jc, j, shapes)
            assert _bytes(pt) == _bytes(pj) and _buckets(pt) == _buckets(pj)
            for fn in ("comm_time_per_device_s", "comm_time_legs_s"):
                np.testing.assert_allclose(getattr(tgs, fn)(1e6, t), getattr(jgs, fn)(1e6, j),
                                           rtol=PRICE_RTOL)


@pytest.mark.parametrize("slices,whole_dcn,auto_axes", [
    (1, False, ()), (2, False, ()), (4, False, ()), (1, True, ()), (2, False, ("tp",)),
])
def test_resolve_auto_compress_matches(links, slices, whole_dcn, auto_axes):
    jm, tm = links
    kw = dict(slices=slices, whole_dcn=whole_dcn, auto_axes=auto_axes)
    assert tgs.resolve_auto_compress(**kw) == jgs.resolve_auto_compress(**kw)
    assert tgs.resolve_auto_compress(link_model=tm, **kw) == jgs.resolve_auto_compress(
        link_model=jm, **kw)


@pytest.mark.parametrize("kw", [
    dict(dp=2), dict(dp=8, slices=2), dict(dp=8, slices=2, compress="int8"),
    dict(dp=8, slices=4, compress="int8_topk", topk_density=0.25), dict(dp=4, slices=2, fsdp=2),
    dict(dp=64, slices=2, compress="int8"),
])
def test_auto_bucket_bytes_match(links, kw):
    """``resolve_bucket_bytes(0)``: sized by ``topology.bucket_bytes_for``
    on the link each bucket crosses, as in the JAX package."""
    assert tgs.resolve_bucket_bytes(0, **kw) == jgs.resolve_bucket_bytes(0, **kw)
    assert tgs.resolve_bucket_bytes(8, **kw) == jgs.resolve_bucket_bytes(8, **kw) == 8 << 20


@pytest.mark.parametrize("mesh", [
    dict(dp=4), dict(dp=2, fsdp=2), dict(dp=2, tp=2), dict(pp=2, dp=2), dict(dp=2, ep=2),
    dict(dp=4, dcn_axes=("dp",), slices=2), dict(dp=4, dcn_axes=("dp",)),
    dict(dp=2, fsdp=2, dcn_axes=("fsdp",)), dict(dp=2, fsdp=2, tp=2), dict(dp=8, fsdp=2, slices=4, dcn_axes=("dp",)),
])
@pytest.mark.parametrize("comp", ["none", "int8", "int8_topk", "auto"])
def test_comm_time_matches(links, mesh, comp):
    """``comm_time_per_device_s`` / ``comm_time_legs_s`` (and the bytes)
    equal the JAX package's on the same strategies and link model,
    within ``PRICE_RTOL``."""
    jm, tm = links
    for overlap in (False, True):
        t = Strategy(mesh=MeshConfig(**mesh), comm_overlap=overlap, grad_compress=comp)
        j = JStrategy(mesh=JMeshConfig(**mesh), comm_overlap=overlap, grad_compress=comp)
        for itemsize in (2, 4):
            np.testing.assert_allclose(
                tgs.comm_time_legs_s(3e6, t, grad_itemsize=itemsize),
                jgs.comm_time_legs_s(3e6, j, grad_itemsize=itemsize), rtol=PRICE_RTOL)
            np.testing.assert_allclose(
                tgs.comm_time_per_device_s(3e6, t, link_model=tm, grad_itemsize=itemsize),
                jgs.comm_time_per_device_s(3e6, j, link_model=jm, grad_itemsize=itemsize),
                rtol=PRICE_RTOL)
        assert tgs.comm_bytes_per_device(3e6, t) == jgs.comm_bytes_per_device(3e6, j)


@pytest.mark.parametrize("mesh", [dict(dp=4), dict(dp=2, fsdp=2), dict(dp=2, tp=2), dict(pp=2, dp=2),
                                  dict(dp=4, dcn_axes=("dp",), slices=2)])
@pytest.mark.parametrize("comp", ["none", "int8"])
def test_comm_bytes_and_overlap_estimate_match(mesh, comp):
    for overlap in (False, True):
        t = Strategy(mesh=MeshConfig(**mesh), comm_overlap=overlap, grad_compress=comp)
        j = JStrategy(mesh=JMeshConfig(**mesh), comm_overlap=overlap, grad_compress=comp)
        assert tgs.comm_bytes_per_device(3e6, t) == jgs.comm_bytes_per_device(3e6, j)
        assert tgs.estimate_overlap_pct(t) == jgs.estimate_overlap_pct(j)


def test_compress_gauges_match():
    from dlrover_tpu.obs.metrics import MetricsRegistry as JReg
    from dlrover_tpu_torch.obs.metrics import MetricsRegistry as TReg

    shapes, leaves = _leaves()
    kw = dict(dp=4, slices=2, compress="int8_topk", topk_density=0.25, bucket_bytes=4096)
    for plan_j, plan_t in ((jgs.plan_buckets(shapes, **kw), tgs.plan_buckets(leaves, **kw)), (None, None)):
        rj, rt = JReg(), TReg()
        jgs.export_compress_metrics(plan_j, rj)
        tgs.export_compress_metrics(plan_t, rt)
        assert rt.scalars() == rj.scalars()


def test_strategy_is_the_jax_package_s():
    s = Strategy(mesh=MeshConfig(dp=4, dcn_axes=("dp",), slices=2), comm_overlap=True,
                 grad_compress="int8_topk", grad_bucket_mb=8, grad_accum=2)
    j = JStrategy.from_json(s.to_json())
    assert j.to_json() == s.to_json() and Strategy.from_json(j.to_json()) == s
    assert s.describe() == j.describe()
    assert s.resolved_grad_compress() == j.resolved_grad_compress()
    assert s.mesh.dp_slices() == j.mesh.dp_slices() == 2


@pytest.mark.parametrize("kw", [
    dict(prefetch_hits=3, prefetch_misses=1, grad_sync_ms=2.5, comm_overlap_pct=70.0,
         grad_bytes_wire=25_000, grad_bytes_raw=100_000, grad_sync_path="explicit"),
    dict(grad_sync_ms=3.25, grad_sync_ici_ms=1.0, grad_sync_dcn_ms=2.25, grad_bytes_raw=1 << 20,
         grad_bytes_wire=1 << 18, comm_overlap_pct=70.0, grad_sync_path="explicit"),
    dict(grad_sync_path="gspmd"), {},
])
def test_pipeline_stats_grad_sync_fields_match_the_jax_package(kw):
    """The grad-sync fields of the port's ``PipelineStats`` (as
    ``tests/test_grad_sync.py::TestPipelineStatsGradSync`` holds the JAX
    package's): the same values in ``as_dict``, the same grad-sync part
    of ``summary``, and the same gauges folded into a registry."""
    import json

    from dlrover_tpu.accel.profiler import PipelineStats as JStats
    from dlrover_tpu.obs.metrics import MetricsRegistry as JReg, fold_pipeline_stats as jfold
    from dlrover_tpu_torch.data.prefetch import PipelineStats as TStats
    from dlrover_tpu_torch.obs.metrics import MetricsRegistry as TReg, fold_pipeline_stats as tfold

    j, t = JStats(**kw), TStats(**kw)
    keys = ("grad_sync_path", "grad_sync_explicit", "grad_sync_ms", "grad_sync_ici_ms",
            "grad_sync_dcn_ms", "comm_overlap_pct", "grad_bytes_wire", "grad_bytes_raw",
            "grad_bytes_wire_vs_raw")
    assert {k: t.as_dict()[k] for k in keys} == {k: j.as_dict()[k] for k in keys}
    json.dumps(t.as_dict())
    tail = lambda s: s[s.index(", grad sync"):] if ", grad sync" in s else ""  # noqa: E731
    assert tail(t.summary()) == tail(j.summary())
    jr, tr = JReg(), TReg()
    jfold(j, jr)
    tfold(t, tr)
    js, ts = jr.scalars(), tr.scalars()
    for k in keys:
        name = "dlrover_pipeline_" + k
        assert (name in ts) == (name in js) and ts.get(name) == js.get(name)


@pytest.mark.parametrize("sizes", [dict(dp=2, ep=2), dict(dp=4, ep=2), dict(dp=2, ep=4)],
                         ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("bucket_mb", [1, 4])
def test_ep_plans_split_and_account_as_the_jax_package(sizes, bucket_mb):
    """A dp x ep mesh's ``EPSyncPlan``: the same expert leaf ids and
    dims (the ep-local ``w_up`` / ``w_down`` of each MoE layer, dim 0),
    the same buckets and byte counts of its expert and dense plans, and
    the same totals and description as the JAX plan; with
    ``grad_accum`` > 1 neither package plans (the default path)."""
    kw = dict(num_layers=4, num_experts=4, moe_every=2, moe_top_k=2)
    jc, tc = jcfg.tiny(**kw), tcfg.tiny(**kw)
    j = jgs.resolve_plan(jc, JStrategy(mesh=JMeshConfig(**sizes), comm_overlap=True,
                                       grad_bucket_mb=bucket_mb))
    t = tgs.resolve_plan(tc, Strategy(mesh=MeshConfig(**sizes), comm_overlap=True,
                                      grad_bucket_mb=bucket_mb))
    assert (t.kind, t.ep, t.dp, t.compress) == (j.kind, j.ep, j.dp, j.compress) == (
        "ep", sizes["ep"], sizes["dp"], "none")
    assert t.expert_leaf_ids == j.expert_leaf_ids and len(t.expert_leaf_ids) == 4
    assert t.expert_leaf_dims == j.expert_leaf_dims == (0, 0, 0, 0)
    for part in ("expert_plan", "dense_plan"):
        tp_, jp_ = getattr(t, part), getattr(j, part)
        assert _buckets(tp_) == _buckets(jp_), part
        assert tp_.leaf_shapes == tuple(tuple(s) for s in jp_.leaf_shapes), part
        assert _bytes(tp_) == _bytes(jp_) and tp_.wire_bytes == jp_.wire_bytes, part
    assert (t.raw_bytes, t.wire_bytes, t.num_buckets) == (j.raw_bytes, j.wire_bytes, j.num_buckets)
    assert t.explicit_wire_bytes() == j.explicit_wire_bytes()
    assert t.gspmd_allreduce_bytes() == j.gspmd_allreduce_bytes()
    assert t.describe() == j.describe()
    ga = dict(mesh=dict(sizes), comm_overlap=True, grad_accum=2)
    assert tgs.resolve_plan(tc, Strategy(mesh=MeshConfig(**ga.pop("mesh")), **ga)) is None
    assert jgs.resolve_plan(jc, JStrategy(mesh=JMeshConfig(**sizes), comm_overlap=True,
                                          grad_accum=2)) is None
