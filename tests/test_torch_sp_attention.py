"""Port parity: sequence-parallel attention (``parallel/ring_attention``,
``parallel/ulysses``), the declared mask family (``KeyIntervals``),
``merge_partials`` and ``flash_attention_fwd_chunked`` against the JAX
package on the CPU.

The port's ring and Ulysses run on 8 gloo ranks at ``MeshConfig(dp=2,
sp=4)`` (``tests/torch_dist_worker.py``, job ``sp``; each rank its rows
and its sequence block), the JAX package's on the 8-device CPU mesh of
``tests/conftest.py``; the inputs are numpy arrays from a seed. The
masks: causal, none, the GLM prefix mask (``KeyIntervals.prefix`` in the
port, the same object as a callable in JAX) and the prefix with rows that
see nothing.

Tolerances: 2e-5 on the forward in f32 (the JAX tests' own), 5e-4 on the
gradients (ROADMAP's attention gradient tolerance), against ``jax.grad``
through the JAX ring and Ulysses."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh
from dlrover_tpu.parallel.ring_attention import ring_self_attention as jring
from dlrover_tpu.parallel.ulysses import ulysses_self_attention as julysses
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.parallel import sp_select as tsel

import torch_dist_worker as tdw

jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")
jsel = importlib.import_module("dlrover_tpu.parallel.sp_select")

FWD_TOL = 2e-5
BWD_TOL = 5e-4
MESH = dict(dp=2, sp=4)
B, S, D = 2, 64, 8
PREFIX = ("prefix", (S, 24))
EMPTY = ("prefix_empty", (S, 24, list(range(40, 52))))

# name -> (H, Hkv, causal, mask spec, schemes)
ATTN = {
    "causal": (4, 4, True, None, ("ring_plain", "ring_kernel", "ulysses")),
    "noncausal": (4, 4, False, None, ("ring_plain", "ring_kernel", "ulysses")),
    "gqa": (4, 2, True, None, ("ring_plain", "ring_kernel", "ulysses")),
    "prefix": (4, 4, True, PREFIX, ("ring_plain", "ring_kernel", "ulysses")),
    "empty_rows": (4, 4, True, EMPTY, ("ring_plain", "ring_kernel", "ulysses")),
    "indivisible_heads": (2, 2, True, None, ("ulysses",)),
}


def _inputs(H, Hkv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)  # the cotangent
    return q, k, v, w


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {"attn": {}}
    for i, (name, (H, Hkv, causal, mask, schemes)) in enumerate(ATTN.items()):
        cases["attn"][name] = dict(mesh=MESH, inputs=_inputs(H, Hkv, 10 + i), causal=causal,
                                   mask=mask, schemes=schemes)
    return tdw.run_ranks("sp", 8, cases, str(tmp_path_factory.mktemp("sp_attn")))


def _assemble(ranks, name, how, key, shape):
    """A global array from every rank's rows and sequence block."""
    out = np.zeros(shape, np.float32)
    for r in ranks:
        a = r["attn"][name]
        lo, hi = a["block"]
        out[np.ix_(a["rows"], range(lo, hi))] = a[how][key]
    return out


def _jax(name, fn):
    H, Hkv, causal, mask, _ = ATTN[name]
    q, k, v, w = (jnp.asarray(x) for x in _inputs(H, Hkv, 10 + list(ATTN).index(name)))
    mesh = build_mesh(JMeshConfig(**MESH))
    mask_fn = tdw._mask_of(mask)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mesh, causal=causal, mask_fn=mask_fn) * w)

    o = fn(q, k, v, mesh, causal=causal, mask_fn=mask_fn)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", [n for n in ATTN if n != "indivisible_heads"])
@pytest.mark.parametrize("how", ["ring_plain", "ring_kernel"])
def test_ring_matches_jax(ranks, name, how):
    """The port's plain ring and its kernel ring (the plain versions of
    the kernels on the CPU) against the JAX ring, forward and grads."""
    H, Hkv = ATTN[name][:2]
    o, (gq, gk, gv) = _jax(name, jring)
    np.testing.assert_allclose(_assemble(ranks, name, how, "o", o.shape), o, atol=FWD_TOL)
    for key, g in (("dq", gq), ("dk", gk), ("dv", gv)):
        np.testing.assert_allclose(_assemble(ranks, name, how, key, g.shape), g, atol=BWD_TOL)
    if name == "empty_rows":  # rows that see nothing come out 0
        got = _assemble(ranks, name, how, "o", o.shape)
        assert np.all(got[:, 40:52] == 0.0) and np.abs(got[:, 52:]).max() > 0


@pytest.mark.parametrize("name", [n for n in ATTN if n != "indivisible_heads"])
def test_ulysses_matches_jax(ranks, name):
    o, (gq, gk, gv) = _jax(name, julysses)
    np.testing.assert_allclose(_assemble(ranks, name, "ulysses", "o", o.shape), o, atol=FWD_TOL)
    for key, g in (("dq", gq), ("dk", gk), ("dv", gv)):
        np.testing.assert_allclose(_assemble(ranks, name, "ulysses", key, g.shape), g, atol=BWD_TOL)


def test_ulysses_refuses_indivisible_heads(ranks):
    """sp=4 does not divide 2 heads: the JAX package's error, on every
    rank."""
    with pytest.raises(Exception, match="divide the local head"):
        _jax("indivisible_heads", julysses)
    for r in ranks:
        assert "divide the local head" in r["attn"]["indivisible_heads"]["ulysses"]["error"]


# -- single process: the mask family, the merge, the chunked driver ----------
def _families(T):
    docs = np.repeat([0, 1, 2, 3], [T // 4 - 8, T // 4 + 20, T // 4 - 4, T // 4 - 8])
    return {
        "causal": tfa.KeyIntervals.causal(T),
        "prefix": tfa.KeyIntervals.prefix(T, T // 3),
        "window": tfa.KeyIntervals.window(T, 40),
        "documents": tfa.KeyIntervals.documents(docs),
        "empty_rows": tfa.KeyIntervals.window(T, 40).without_rows(range(70, 90)),
    }


@pytest.mark.parametrize("family", list(_families(128)))
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (128, 0), (128, 128)])
def test_each_family_forward_and_backward_match_jax(family, q_off, k_off):
    """The plain forward (o, lse) and backward of every family, at the
    offsets of a ring's hops, against JAX ``flash_attention_reference``
    with the same ``KeyIntervals`` as its mask function."""
    T, H, Dh = 128, 4, 16
    iv = _families(2 * T)[family]
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.normal(size=(2, T, H, Dh)).astype(np.float32) for _ in range(4))
    kw = dict(causal=True, mask_fn=iv, q_offset=q_off, k_offset=k_off)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o_t, lse_t = tfa.flash_attention_fwd(qt, kt, vt, **kw)
    o_j, lse_j = jfa.flash_attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                               return_residuals=True, **kw)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=FWD_TOL)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j), atol=FWD_TOL)
    with torch.no_grad():
        g_t = tfa.flash_attention_bwd(qt, kt, vt, o_t, lse_t, torch.from_numpy(do), **kw)
    g_j = jax.grad(lambda a, b, c: jnp.sum(
        jfa.flash_attention_reference(a, b, c, **kw) * do), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL)
    # the differentiable entry takes the same route
    out = tfa.flash_attention(qt, kt, vt, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_j), atol=FWD_TOL)


def test_per_batch_documents_match_jax_row_by_row():
    """Intervals with one row a batch row (packed documents of two
    layouts): each batch row against JAX with that row's mask."""
    T = 128
    ids = np.stack([np.repeat([0, 1, 2], [40, 50, 38]), np.repeat([0, 1], [90, 38])])
    iv = tfa.KeyIntervals.documents(ids)
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, T, 2, 16)).astype(np.float32) for _ in range(3))
    o_t = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), mask_fn=iv)
    for b in range(2):
        one = tfa.KeyIntervals.documents(ids[b])
        o_j = jfa.flash_attention_reference(*(jnp.asarray(x[b:b + 1]) for x in (q, k, v)),
                                            mask_fn=one)
        np.testing.assert_allclose(o_t[b:b + 1].numpy(), np.asarray(o_j), atol=FWD_TOL)


def test_tables_classify_the_tiles():
    """The kernels' tables against the mask itself: for every 64-row
    query tile the (min lo, max lo, min hi, max hi) of its non-empty rows,
    and for every 128-key block the hull of the query tiles that see it."""
    T = 512
    for iv in _families(T).values():
        lo, hi, qstat, kblk = iv.tables("cpu", 0, T, 0, T)
        m = iv(torch.arange(T)[:, None], torch.arange(T)[None, :])
        for t in range(T // 64):
            rows = slice(64 * t, 64 * t + 64)
            keep = (hi[0, rows] > lo[0, rows])
            if keep.any():
                assert qstat[0, t, 0] == lo[0, rows][keep].min()
                assert qstat[0, t, 3] == hi[0, rows][keep].max()
        for kb in range(T // 128):
            seen = [t for t in range(T // 64) if m[64 * t:64 * t + 64, 128 * kb:128 * kb + 128].any()]
            if seen:
                assert kblk[0, kb, 0] <= min(seen) and kblk[0, kb, 1] > max(seen)
            else:
                assert kblk[0, kb, 0] == kblk[0, kb, 1]


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(1)
    o_a, o_b = (rng.normal(size=(2, 32, 4, 8)).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.normal(size=(2, 4, 32)).astype(np.float32) for _ in range(2))
    lse_b[0, 0, :4] = tfa.NEG_INF  # a partial that saw nothing
    o_t, l_t = tfa.merge_partials(*(torch.from_numpy(x) for x in (o_a, lse_a, o_b, lse_b)))
    o_j, l_j = jfa.merge_partials(*(jnp.asarray(x) for x in (o_a, lse_a, o_b, lse_b)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=FWD_TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=FWD_TOL)


@pytest.mark.parametrize("causal,mask,q_off,k_off", [
    (True, None, 0, 0), (False, None, 0, 0), (True, None, 128, 0),
    (True, "window", 0, 0), (True, "documents", 0, 0),
])
def test_fwd_chunked_matches_jax(causal, mask, q_off, k_off):
    """The tiled long-sequence forward against the JAX driver (whose
    tiles run the JAX package's kernels in interpret mode on the CPU,
    as its tests run them), tiles of 64."""
    T = 256
    iv = _families(T + max(q_off, k_off))[mask] if mask else None
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, T, 2, 16)).astype(np.float32) for _ in range(3))
    kw = dict(causal=causal, mask_fn=iv, q_offset=q_off, k_offset=k_off, chunk=64)
    o_t, l_t = tfa.flash_attention_fwd_chunked(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    o_j, l_j = jfa.flash_attention_fwd_chunked(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=FWD_TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=FWD_TOL)


def test_cuda_refuses_a_callable_mask_and_names_the_family():
    x = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="KeyIntervals"):
        tfa._check_cuda(x, x, x, lambda a, b: a >= b, 0, 0)
    tfa._check_cuda(x, x, x, tfa.KeyIntervals.causal(128), 0, 0)  # taken
    with pytest.raises(ValueError, match="outside"):
        tfa._check_cuda(x, x, x, tfa.KeyIntervals.causal(128), 64, 0)


def test_sp_select_keeps_the_jax_rule():
    """The same rule and tie margin as the JAX package: on the JAX
    package's own table the port's pick equals the JAX pick; the port's
    table is its own (measured on the H100, not the TPU's)."""
    assert tsel._TIE_MARGIN == jsel._TIE_MARGIN == 0.9
    assert tsel.MEASURED_MS != jsel.MEASURED_MS
    saved = dict(tsel.MEASURED_MS)
    try:
        for table in (jsel.MEASURED_MS, {4096: {"ring": 5.0, "ulysses": 4.0}},
                      {4096: {"ring": 5.0, "ulysses": 4.6}}):
            tsel.MEASURED_MS.clear()
            tsel.MEASURED_MS.update(table)
            jsaved = dict(jsel.MEASURED_MS)
            jsel.MEASURED_MS.clear()
            jsel.MEASURED_MS.update(table)
            try:
                for seq in (1024, 4096, 6000, 8192, 32768):
                    assert tsel.pick_sp_scheme(seq) == jsel.pick_sp_scheme(seq)
            finally:
                jsel.MEASURED_MS.clear()
                jsel.MEASURED_MS.update(jsaved)
    finally:
        tsel.MEASURED_MS.clear()
        tsel.MEASURED_MS.update(saved)
