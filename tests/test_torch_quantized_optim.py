"""Port parity: the 8-bit AdamW of dlrover_tpu_torch (its plain CPU
path) against the JAX package's fused Pallas kernel in interpret mode
and its jnp twin.

Codes must be equal; scales and deltas are held to the JAX package's
kernel-vs-twin tolerances (tests/test_ops.py): 1e-6 and 1e-7. The
Triton kernel's own arithmetic (a dequantize without division, a
requantize by a per-row factor) is modelled here on the CPU and held
to the plain version: bitwise for the dequantize, within one code on a
share of at most 1e-3 for the requantize."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import quantized_optim as jq
from dlrover_tpu_torch.ops import quantized_optim as tq

SCALE_TOL = 1e-6
DELTA_TOL = 1e-7


def _group(rows=2048, seed=0):
    """g and a non-trivial 8-bit moment state of one flat group."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(rows, 128)) * 1e-3).astype(np.float32)
    m = (rng.normal(size=(rows, 128)) * 1e-3).astype(np.float32)
    v = (rng.random(size=(rows, 128)) * 1e-6).astype(np.float32)
    v[:7] = 0.0  # all-zero blocks: scale 0, codes 0
    mc, ms = jq._quant_block_math_wide(jnp.asarray(m), True)
    vc, vs = jq._quant_block_math_wide(jnp.asarray(v), False)
    return g, tuple(np.asarray(x) for x in (mc, ms, vc, vs))


def _scalars(lr, count, eps):
    b1, b2 = 0.9, 0.999
    cf = np.float32(count)
    lrA = np.float32(lr) / (np.float32(1.0) - np.float32(b1) ** cf)
    invbc2 = np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** cf)
    return np.array([lrA, invbc2, eps], np.float32)


@pytest.mark.parametrize("classic", [True, False])
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "jnp"])
def test_update_matches_jax(classic, jax_path):
    g, (mc, ms, vc, vs) = _group()
    R = g.shape[0]
    sc = _scalars(3e-4, 3, 1e-8)
    tm = tq.Quantized8(*(torch.from_numpy(x.copy()) for x in (mc, ms)), (R * 128,), True)
    tv = tq.Quantized8(*(torch.from_numpy(x.copy()) for x in (vc, vs)), (R * 128,), False)
    jm = jq.Quantized8(jnp.asarray(mc), jnp.asarray(ms), (R * 128,), True)
    jv = jq.Quantized8(jnp.asarray(vc), jnp.asarray(vs), (R * 128,), False)
    if jax_path == "pallas_interpret":
        jm2, jv2, jd = jq._adam8_update_pallas_flat(
            jnp.asarray(g), jm, jv, jnp.asarray(sc), 0.9, 0.999,
            interpret=True, classic_eps=classic,
        )
    else:
        jm2, jv2, jd = jq._adam8_update_jnp(
            jnp.asarray(g), jm, jv, jnp.asarray(sc), 0.9, 0.999, classic
        )
    td = tq.adam8_update_flat(
        torch.from_numpy(g), tm, tv, tuple(float(x) for x in sc), 0.9, 0.999, classic
    )
    np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm2.codes))
    np.testing.assert_array_equal(tv.codes.numpy(), np.asarray(jv2.codes))
    np.testing.assert_allclose(tm.scales.numpy(), np.asarray(jm2.scales), atol=SCALE_TOL)
    np.testing.assert_allclose(tv.scales.numpy(), np.asarray(jv2.scales), atol=SCALE_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DELTA_TOL)


def test_tree_form_quantize_matches_jax():
    x = np.random.default_rng(3).normal(size=(37, 300)).astype(np.float32)
    for signed in (True, False):
        src = x if signed else np.abs(x)
        jqz = jq.quantize_8bit(jnp.asarray(src), signed)
        tqz = tq.quantize_8bit(torch.from_numpy(src), signed)
        np.testing.assert_array_equal(tqz.codes.numpy(), np.asarray(jqz.codes))
        np.testing.assert_allclose(tqz.scales.numpy(), np.asarray(jqz.scales), rtol=0, atol=0)
        np.testing.assert_allclose(
            tq.dequantize_8bit(tqz).numpy(), np.asarray(jq.dequantize_8bit(jqz)), atol=1e-7
        )


# a param tree with big leaves (some BLOCK-ragged), small leaves, and a
# group size that forces several groups; keys sorted = JAX flatten order
_TREE = {"a_w": (64, 128), "b_s": (300,), "c_w": (4101,), "d_s": (2, 3), "e_w": (128, 96)}


@pytest.mark.parametrize("wd,eps_root", [(0.0, 0.0), (0.01, 0.0), (0.01, 1e-8)])
def test_optimizer_five_steps_match_jax(wd, eps_root):
    import jax

    rng = np.random.default_rng(7)
    names = sorted(_TREE)
    params0 = {k: rng.normal(size=_TREE[k]).astype(np.float32) for k in names}
    grads = [
        {k: (rng.normal(size=_TREE[k]) * 1e-2).astype(np.float32) for k in names}
        for _ in range(5)
    ]
    eps = 0.0 if eps_root else 1e-8
    kw = dict(weight_decay=wd, min_quantized_size=4096, group_elems=9000,
              eps=eps, eps_root=eps_root)
    jtx = jq.adamw_8bit_flat(1e-2, use_pallas=False, **kw)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    js = jtx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params0[k].copy())) for k in names]
    topt = tq.adamw_8bit_flat(tp, lr=1e-2, **kw)
    assert len(topt.layout.groups) == len(js.mu) == 3
    for step in range(5):
        u, js = jtx.update({k: jnp.asarray(v) for k, v in grads[step].items()}, js, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for p, k in zip(tp, names):
            p.grad = torch.from_numpy(grads[step][k])
        topt.step()
        for p, k in zip(tp, names):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    for tm, jm in zip(topt.mu + topt.nu, js.mu + js.nu):
        np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm.codes))
        np.testing.assert_allclose(tm.scales.numpy(), np.asarray(jm.scales), atol=SCALE_TOL)
    np.testing.assert_allclose(topt.mu_small.numpy(), np.asarray(js.mu_small), atol=1e-7)
    np.testing.assert_allclose(topt.nu_small.numpy(), np.asarray(js.nu_small), atol=1e-7)


def test_both_eps_forms_refused_together():
    with pytest.raises(ValueError):
        tq.adamw_8bit_flat([torch.nn.Parameter(torch.zeros(3))], eps=1e-8, eps_root=1e-8)


# -- the per-leaf form (adamw_8bit, the B7 contract) -------------------------
def _leaf_state(rows, seed=0):
    """A non-trivial per-leaf 8-bit state: JAX tree-form codes and
    ``[R, 1]`` scales, and the port's ``[R]`` scales."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(rows, 128)) * 1e-3).astype(np.float32)
    m = (rng.normal(size=(rows, 128)) * 1e-3).astype(np.float32)
    v = (rng.random(size=(rows, 128)) * 1e-6).astype(np.float32)
    v[:3] = 0.0
    jm, jv = jq.quantize_8bit(jnp.asarray(m), True), jq.quantize_8bit(jnp.asarray(v), False)
    return g, jm, jv


@pytest.mark.parametrize("classic", [True, False])
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "jnp"])
def test_leaf_update_matches_jax(classic, jax_path):
    """R = 301 rows: neither a multiple of the Triton kernel's 8-row
    tile nor of the Pallas kernel's 256-row tile (which pads to it)."""
    g, jm, jv = _leaf_state(301)
    R = g.shape[0]
    sc = _scalars(3e-4, 4, 1e-8)
    if jax_path == "pallas_interpret":
        jm2, jv2, jd = jq._adam8_update_pallas(
            jnp.asarray(g), jm, jv, jnp.asarray(sc), 0.9, 0.999,
            interpret=True, classic_eps=classic,
        )
    else:
        jm2, jv2, jd = jq._adam8_update_jnp(jnp.asarray(g), jm, jv, jnp.asarray(sc), 0.9, 0.999, classic)
    tm, tv = (
        tq.Quantized8(torch.from_numpy(np.asarray(q.codes).copy()),
                      torch.from_numpy(np.asarray(q.scales).reshape(R).copy()), (R * 128,), s)
        for q, s in ((jm, True), (jv, False))
    )
    tq.reset_launch_counts()
    td = tq.adam8_update_leaf(torch.from_numpy(g), tm, tv, tuple(float(x) for x in sc), 0.9, 0.999, classic)
    assert tq.launch_counts == {"adam8_flat": 0, "adam8_leaf": 0}  # the CPU runs the plain version
    assert tuple(tm.scales.shape) == (R,)
    np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm2.codes))
    np.testing.assert_array_equal(tv.codes.numpy(), np.asarray(jv2.codes))
    np.testing.assert_allclose(tm.scales.numpy(), np.asarray(jm2.scales).reshape(R), atol=SCALE_TOL)
    np.testing.assert_allclose(tv.scales.numpy(), np.asarray(jv2.scales).reshape(R), atol=SCALE_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DELTA_TOL)


def _run_both(jtx_fn, topt_fn, steps=5, seed=7):
    import jax

    rng = np.random.default_rng(seed)
    names = sorted(_TREE)
    params0 = {k: rng.normal(size=_TREE[k]).astype(np.float32) for k in names}
    grads = [
        {k: (rng.normal(size=_TREE[k]) * 1e-2).astype(np.float32) for k in names}
        for _ in range(steps)
    ]
    jtx = jtx_fn()
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    js = jtx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params0[k].copy())) for k in names]
    topt = topt_fn(tp)
    for step in range(steps):
        u, js = jtx.update({k: jnp.asarray(v) for k, v in grads[step].items()}, js, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for p, k in zip(tp, names):
            p.grad = torch.from_numpy(grads[step][k])
        topt.step()
        for p, k in zip(tp, names):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    return names, js, topt, tp


@pytest.mark.parametrize("wd,eps_root", [(0.0, 0.0), (0.01, 0.0), (0.01, 1e-8)])
def test_per_leaf_optimizer_five_steps_match_jax(wd, eps_root):
    """Leaves: a_w and e_w quantized (64 and 96 rows), c_w quantized with
    a ragged last block (4101 elements, 33 rows), b_s and d_s under
    min_quantized_size (f32 moments)."""
    eps = 0.0 if eps_root else 1e-8
    kw = dict(weight_decay=wd, min_quantized_size=4096, eps=eps, eps_root=eps_root)
    names, js, topt, _ = _run_both(
        lambda: jq.adamw_8bit(1e-2, use_pallas=False, **kw),
        lambda tp: tq.adamw_8bit(tp, lr=1e-2, **kw),
    )
    st = topt.adam_state
    assert st.count == int(js.count) == 5
    for i, k in enumerate(names):
        tm, tv, jm, jv = st.mu[i], st.nu[i], js.mu[k], js.nu[k]
        if isinstance(tm, tq.Quantized8):
            assert k in ("a_w", "c_w", "e_w")
            for a, b in ((tm, jm), (tv, jv)):
                np.testing.assert_array_equal(a.codes.numpy(), np.asarray(b.codes))
                np.testing.assert_allclose(a.scales.numpy(), np.asarray(b.scales).reshape(-1), atol=SCALE_TOL)
        else:
            assert k in ("b_s", "d_s")
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-7)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-7)


def test_per_leaf_and_flat_forms_are_bitwise_equal():
    """Blocks never straddle leaves in either form, so the two give the
    same parameters to the bit (the JAX docstring's claim, on the port)."""
    rng = np.random.default_rng(4)
    names = sorted(_TREE)
    p0 = {k: rng.normal(size=_TREE[k]).astype(np.float32) for k in names}
    runs = []
    for make in (
        lambda tp: tq.adamw_8bit(tp, lr=1e-2, weight_decay=0.01),
        lambda tp: tq.adamw_8bit_flat(tp, lr=1e-2, weight_decay=0.01, group_elems=9000),
    ):
        tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in names]
        opt = make(tp)
        g_rng = np.random.default_rng(5)
        for _ in range(4):
            for p, k in zip(tp, names):
                p.grad = torch.from_numpy((g_rng.normal(size=_TREE[k]) * 1e-2).astype(np.float32))
            opt.step()
        runs.append([p.detach().numpy().copy() for p in tp])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# -- the Triton kernel's arithmetic, modelled on the CPU ----------------------
INV127 = 0.007874015718698502  # the kernel's literal for rn(1/127) in f32


def _rn32(x: Fraction) -> float:
    """The f32 nearest to the exact rational ``x`` (ties to even); normal
    numbers only."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    ulp = Fraction(2) ** (e - 23)
    n, rem = divmod(x, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and n % 2):
        n += 1
    return sign * float(n * ulp)


def test_dequantize_without_division_is_bitwise_the_plain_one():
    """The kernel dequantizes code c as q |q| scale with q = fma(fma(-q0,
    127, c), rn(1/127), q0) and q0 = c rn(1/127): every one of the 256
    codes gives the plain version's sign(c) rn(rn(c / 127)^2), bitwise."""
    assert INV127 == _rn32(Fraction(1, 127)) == float(np.float32(1) / np.float32(127))
    inv = Fraction(INV127)
    codes = np.arange(-128, 128, dtype=np.float32)
    got = []
    for c in codes.astype(int):
        q0 = _rn32(c * inv)
        r = _rn32(c - Fraction(q0) * 127)  # fma(-q0, 127, c), exact
        q = np.float32(_rn32(Fraction(r) * inv + Fraction(q0)))  # fma(r, inv, q0)
        got.append(q * np.abs(q))
    want = tq._sqrt_map_dequant(torch.from_numpy(codes), torch.ones(()), 127.0).numpy()
    np.testing.assert_array_equal(np.array(got, np.float32).view(np.uint32), want.view(np.uint32))


def _requant_model(x, signed, sqrt_ulps=0, seed=0):
    """The kernel's requantize in plain PyTorch: per row ``k = 127 /
    sqrt(s)``, then ``rint(sqrt(|x|) k)`` with x's sign. ``sqrt_ulps``
    moves each square root by up to that many ulp at random, standing in
    for the approximate square root the kernel takes."""
    s = (x.abs() if signed else x).amax(-1, keepdim=True)
    k = 127.0 / torch.sqrt(s.clamp_min(1e-30))
    root = torch.sqrt(x.abs())
    if sqrt_ulps:
        rng = np.random.default_rng(seed)
        wobble = rng.integers(-sqrt_ulps, sqrt_ulps + 1, size=tuple(x.shape))
        root = root * (1.0 + torch.from_numpy(wobble).float() * 2.0**-23)
    q = torch.round(root * k)
    q = torch.where(x < 0, -q, q)
    return q.clamp(-127.0 if signed else 0.0, 127.0), s


@pytest.mark.parametrize("sqrt_ulps", [0, 2])
def test_requantize_by_row_factor_stays_within_one_code(sqrt_ulps):
    """Against the plain requantize (``div_rn``, ``sqrt_rn``) on moments
    after an update from a numpy seed: scales equal, codes off by at most
    1 on a share of at most 1e-3 (chip_smoke.py's ADAM_CODE_SHARE)."""
    g, (mc, ms, vc, vs) = _group(rows=4096, seed=11)
    R = g.shape[0]
    tm = tq.Quantized8(torch.from_numpy(mc.copy()), torch.from_numpy(ms.copy()), (R * 128,), True)
    tv = tq.Quantized8(torch.from_numpy(vc.copy()), torch.from_numpy(vs.copy()), (R * 128,), False)
    m = tq._sqrt_map_dequant(tm.codes.float(), tm.scales.view(R, 1), 127.0)
    v = tq._sqrt_map_dequant(tv.codes.float(), tv.scales.view(R, 1), 127.0)
    gt = torch.from_numpy(g)
    for x, signed in ((0.9 * m + 0.1 * gt, True), (0.999 * v + 0.001 * gt * gt, False)):
        want, s_want = tq._sqrt_map_quant(x, signed, 127.0)
        got, s_got = _requant_model(x, signed, sqrt_ulps, seed=int(signed))
        assert torch.equal(s_got, s_want)
        diff = (got - want).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() <= 1e-3


def test_four_bit_form_is_not_ported():
    with pytest.raises(NotImplementedError, match="A4"):
        tq.adamw_8bit([torch.nn.Parameter(torch.zeros(3))], bits=4)
    with pytest.raises(ValueError):
        tq.adamw_8bit([torch.nn.Parameter(torch.zeros(3))], eps=1e-8, eps_root=1e-8)
