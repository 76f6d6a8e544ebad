"""The port's bucketed gradient sync across 4 gloo ranks against the
JAX package's ``sync_grads`` on the CPU mesh: the same per-lane
gradients (lanes of one seeded numpy array a leaf) go through both, for
flat dp (``none``; ``int8`` over two steps with the residual carried),
two-level over 2 slices (``none``, ``int8``, ``int8_topk``) and ZeRO at
dp=2 x fsdp=2 (``none``, ``int8``). Compared: the synced grads, the
error-feedback residual, the grad norm and the per-lane norms.

Tolerances: the f32 paths to 1e-6 of the largest |value| (a ring's
summation order is not XLA's); the int8 paths bitwise on the residual
(the quantization error: the codes and the shared scale agree exactly)
and to 1e-7 of the largest |value| on the dequantized grads. Rank
processes start once for the file; every case runs in them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models.transformer import init_params
from dlrover_tpu.parallel import grad_sync as jgs
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.parallel import grad_sync as tgs

import torch_dist_worker as tdw

F32_TOL = 1e-6
INT8_TOL = 1e-7
MODEL = dict(num_layers=1, rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)
TWO = dict(dp=4, dcn_axes=("dp",), slices=2)
CASES = {
    "dp_none": dict(mesh=dict(dp=4), plan=dict(dp=4, compress="none", bucket_bytes=4096), steps=1),
    "dp_int8": dict(mesh=dict(dp=4), plan=dict(dp=4, compress="int8", bucket_bytes=4096), steps=2),
    "2level_none": dict(mesh=TWO, plan=dict(dp=4, slices=2, compress="none", bucket_bytes=4096),
                        steps=1),
    "2level_int8": dict(mesh=TWO, plan=dict(dp=4, slices=2, compress="int8", bucket_bytes=4096),
                        steps=2),
    "2level_topk": dict(mesh=TWO, plan=dict(dp=4, slices=2, compress="int8_topk", topk_density=0.25,
                                            topk_block=64, bucket_bytes=16384), steps=2),
    "zero_none": dict(mesh=dict(dp=2, fsdp=2), plan=dict(dp=2, fsdp=2, compress="none",
                                                         bucket_bytes=8192, kind="zero",
                                                         leaf_block=128), steps=1),
    "zero_int8": dict(mesh=dict(dp=2, fsdp=2), plan=dict(dp=2, fsdp=2, compress="int8",
                                                         bucket_bytes=8192, kind="zero",
                                                         leaf_block=128), steps=2),
}
for i, c in enumerate(CASES.values()):
    c["seed"] = 100 + i


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tdw.run_ranks("sync", 4, {"model": MODEL, "cases": CASES},
                         str(tmp_path_factory.mktemp("sync")))


def _jax_plan(plan_kw):
    kw = {k: v for k, v in plan_kw.items() if k not in ("kind", "leaf_block")}
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), jcfg.tiny(**MODEL)))
    return shapes, jgs.plan_buckets(shapes, **kw)


def _jax_steps(case):
    shapes, plan = _jax_plan(case["plan"])
    mesh = build_mesh(JMeshConfig(**case["mesh"]), devices=jax.devices()[:4])
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    sh = NamedSharding(mesh, P(plan.stack_axes))
    res = jgs.zero_residual(plan, mesh) if plan.compressed else None
    fn = jax.jit(lambda t, r: jgs.sync_grads(t, mesh, plan, residual=r, device_norms=True))
    out = []
    for step in range(case["steps"]):
        grads = tdw.case_grads([l.shape for l in leaves], plan.total, case["seed"], step)
        tree = jax.tree_util.tree_unflatten(
            treedef, [jax.device_put(jnp.asarray(g), sh) for g in grads])
        synced, res, gnorm, lanes = fn(tree, res)
        out.append(dict(
            synced=[np.asarray(x) for x in jax.tree_util.tree_leaves(synced)],
            residual=None if res is None else [np.asarray(r) for r in res],
            gnorm=float(gnorm), lanes=np.asarray(lanes),
        ))
    return plan, out


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30))


def _full_leaves(name, ranks, step):
    """Every leaf whole: a dp rank's leaves, or under ZeRO the fsdp
    ranks' block rows of dp index 0 put back together."""
    case = CASES[name]
    if "fsdp" not in case["mesh"]:
        return ranks[0][name]["steps"][step]["synced"]
    plan = tgs.plan_buckets(tgs.model_leaves(tcfg.tiny(**MODEL)), **case["plan"])
    by_lane = {r[name]["lane"]: r[name]["steps"][step]["synced"] for r in ranks}
    out = []
    for i, shape in enumerate(plan.leaf_shapes):
        flat = np.concatenate([by_lane[f][i] for f in range(plan.fsdp)])
        out.append(flat[:int(np.prod(shape))].reshape(shape))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_synced_grads_and_norms_match(ranks, name):
    case = CASES[name]
    plan, jsteps = _jax_steps(case)
    tol = INT8_TOL if plan.compressed else F32_TOL
    for step, js in enumerate(jsteps):
        for got, want in zip(_full_leaves(name, ranks, step), js["synced"]):
            assert got.shape == want.shape
            _close(got, want, tol)
        for r in ranks:
            ts = r[name]["steps"][step]
            np.testing.assert_allclose(ts["gnorm"], js["gnorm"], rtol=F32_TOL)
            np.testing.assert_allclose(ts["lanes"], js["lanes"], rtol=F32_TOL)
    # every rank holds the same synced values (their own rows, on zero)
    if "fsdp" not in case["mesh"]:
        for r in ranks[1:]:
            for a, b in zip(r[name]["steps"][-1]["synced"], ranks[0][name]["steps"][-1]["synced"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["plan"]["compress"] != "none"])
def test_residual_is_the_jax_residual_bitwise(ranks, name):
    case = CASES[name]
    plan, jsteps = _jax_steps(case)
    tplan = tgs.plan_buckets(tgs.model_leaves(tcfg.tiny(**MODEL)), **case["plan"])
    by_lane = {r[name]["lane"]: r[name] for r in ranks}
    for step, js in enumerate(jsteps):
        lanes = [by_lane[ln]["steps"][step]["residual"] for ln in range(plan.total)]
        got = tgs.residual_to_jax(tplan, lanes)
        for g, w in zip(got, js["residual"]):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
            assert np.abs(w).max() > 0
        # and back: each lane's rows from the JAX state
        for ln in range(plan.total):
            back = tgs.residual_from_jax(tplan, js["residual"], ln)
            for a, b in zip(back, lanes[ln]):
                np.testing.assert_array_equal(a.numpy(), b)


def test_collectives_per_bucket(ranks):
    """One reduce-scatter and one all-gather a bucket on the flat dp leg
    (int8: an all-to-all of the codes in place of the reduce-scatter, and
    one MAX all-reduce a bucket), none over fsdp but its reduce-scatter
    on ZeRO."""
    nb = {n: tgs.plan_buckets(tgs.model_leaves(tcfg.tiny(**MODEL)), **c["plan"]).num_buckets
          for n, c in CASES.items()}
    r0 = ranks[0]
    # device_norms adds one all-gather of the lane norms a step; ZeRO
    # one all-reduce of the chunk's sum of squares
    assert r0["dp_none"]["issued"] == dict(reduce_scatter=nb["dp_none"], all_to_all=0,
                                           all_gather=nb["dp_none"] + 1, all_reduce=0)
    # int8: the codes' all-to-all in place of the reduce-scatter
    assert r0["dp_int8"]["issued"] == dict(reduce_scatter=0, all_to_all=2 * nb["dp_int8"],
                                           all_gather=2 * nb["dp_int8"] + 2,
                                           all_reduce=2 * nb["dp_int8"])
    z = nb["zero_none"]
    assert r0["zero_none"]["issued"] == dict(reduce_scatter=2 * z, all_to_all=0, all_gather=z + 1,
                                             all_reduce=1)


# -- the int8 codes' wire ----------------------------------------------------
WIRE_CASES = {
    2: {"flat_dp2": dict(mesh=dict(dp=2), plan=dict(dp=2, compress="int8", bucket_bytes=4096))},
    3: {"flat_dp3": dict(mesh=dict(dp=3), plan=dict(dp=3, compress="int8", bucket_bytes=4096))},
    4: {"flat_dp4": dict(mesh=dict(dp=4), plan=dict(dp=4, compress="int8", bucket_bytes=4096)),
        "2level_dp4": dict(mesh=TWO, plan=dict(dp=4, slices=2, compress="int8", bucket_bytes=4096)),
        "2level_topk": dict(mesh=TWO, plan=dict(dp=4, slices=2, compress="int8_topk",
                                                topk_density=0.25, topk_block=64,
                                                bucket_bytes=16384))},
}


@pytest.fixture(scope="module")
def wire_ranks(tmp_path_factory):
    out = {}
    for world, cases in WIRE_CASES.items():
        for i, c in enumerate(cases.values()):
            c["seed"] = 200 + 10 * world + i
        res = tdw.run_ranks("wire", world, {"model": MODEL, "cases": cases},
                            str(tmp_path_factory.mktemp(f"wire{world}")))
        for name in cases:
            out[name] = [r[name] for r in res]
    return out


@pytest.mark.parametrize("name", [n for c in WIRE_CASES.values() for n in c])
def test_int8_codes_cross_the_wire_as_int8_and_sum_bitwise(wire_ranks, name):
    """The codes ship as int8 (an all-to-all), their sums as int16 (an
    all-gather of their bytes), and the synced grads, the residual and the norm are
    bitwise those of the int32 wire the codes had before. The bytes of
    the compressed legs' inputs are what ``BucketPlan.wire_bytes``
    prices (the outer f32 legs of a two-level plan at padded x 4)."""
    for r in wire_ranks[name]:
        new, old = r["runs"]["int8_wire"], r["runs"]["int32_wire"]
        for a, b in zip(new["synced"], old["synced"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(new["residual"], old["residual"]):
            np.testing.assert_array_equal(a, b)
        assert new["gnorm"] == old["gnorm"]
        codes = [w for w in new["wire"] if w[0] == "all_to_all_single"]
        # the int16 sums travel as their bytes
        sums = [w for w in new["wire"] if w[0] == "all_gather_into_tensor" and w[1] == "uint8"]
        scales = [w for w in new["wire"] if w[0] == "all_reduce"]
        assert codes and all(w[1] == "int8" for w in codes)
        assert len(sums) == len(codes) == len(scales) == len(r["padded"])
        assert not [w for w in new["wire"] if w[1] == "int32"]
        outer = sum(4 * p for p in r["padded"]) if name.startswith("2level") else 0
        assert outer + sum(w[2] for w in codes + sums + scales) == r["wire_bytes"]
        # the int32 wire shipped 4 bytes a code
        assert sum(w[2] for w in old["wire"] if w[1] == "int32") == 4 * sum(w[2] for w in codes)


def test_code_sums_widen_to_int32_past_258_ranks():
    assert tgs.code_sum_dtype_bytes(2) == 2 and tgs.code_sum_dtype_bytes(258) == 2
    assert tgs.code_sum_dtype_bytes(259) == 4
    plan = tgs.plan_buckets(tgs.model_leaves(tcfg.tiny(**MODEL)), dp=260, compress="int8",
                            bucket_bytes=1 << 20)
    assert all(plan.code_gather_bytes(b) == b.padded // 260 * 4 for b in plan.buckets)
