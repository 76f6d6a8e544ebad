"""Port parity for the optimizer leftovers, on the CPU: AGD over five
steps and under the train step, WSAM's gradient function and its
sharpness, the 4-bit AdamW (codes and scales as
``tests/test_torch_quantized_optim.py`` holds the 8-bit ones), the muP
LR scales and ``mup_adamw``, the mixed-precision policy's parsing, the
flat 8-bit AdamW's updates against the step it had before its deltas
were applied group by group (bitwise), and the AGD and 4-bit states
through Flash Checkpoint: restored bitwise by the port and read by the
JAX package's reader.

Tolerances: params fed the same gradients 1e-6 (as the 8-bit tests);
the train steps those of ``tests/test_torch_train.py``; WSAM's
gradients the model's 1e-4 (``tests/test_torch_transformer.py``) and
its sharpness ``2 alpha`` times that (the difference of two gradients,
times alpha)."""

import tempfile
import uuid
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ckpt.sharding import _flatten_with_path, _keystr
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import mup as jmup
from dlrover_tpu.models import policy as jpolicy
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.models import transformer as jtr
from dlrover_tpu.ops import optimizers as jopt
from dlrover_tpu.ops import quantized_optim as jq
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.ckpt.sharding import flatten_state
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import mup as tmup
from dlrover_tpu_torch.models import policy as tpolicy
from dlrover_tpu_torch.models import train as ttrain
from dlrover_tpu_torch.models.convert import (
    load_train_state_tree,
    params_from_jax,
    params_to_numpy,
    train_state_tree,
)
from dlrover_tpu_torch.ops import optimizers as topt
from dlrover_tpu_torch.ops import quantized_optim as tq
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

from test_torch_quantized_optim import _TREE, SCALE_TOL  # noqa: E402
from test_torch_train import (  # noqa: E402  (the slice's tolerances)
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_CLOSE_ATOL,
    PARAM_FLIP_SHARE,
    _batches,
)

PARAM_TOL = 1e-6
GRAD_TOL = 1e-4
WSAM_GAMMA = 0.9
SHARP_TOL = 2 * WSAM_GAMMA / (1 - WSAM_GAMMA) * GRAD_TOL
# the 4-bit form's quantized leaves in the tiny model
OPT4_KW = dict(min_quantized_size=512)


def _grads_and_params(steps, seed):
    rng = np.random.default_rng(seed)
    names = sorted(_TREE)
    p0 = {k: rng.normal(size=_TREE[k]).astype(np.float32) for k in names}
    grads = [{k: (rng.normal(size=_TREE[k]) * 1e-2).astype(np.float32) for k in names}
             for _ in range(steps)]
    return names, p0, grads


def _run(jtx, make_topt, steps=5, seed=7):
    """The same gradients into a JAX transform and a port optimizer;
    params held to ``PARAM_TOL`` after every step."""
    names, p0, grads = _grads_and_params(steps, seed)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jtx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in names]
    o = make_topt(tp)
    for step in range(steps):
        u, js = jtx.update({k: jnp.asarray(v) for k, v in grads[step].items()}, js, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for p, k in zip(tp, names):
            p.grad = torch.from_numpy(grads[step][k])
        o.step()
        for p, k in zip(tp, names):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=PARAM_TOL)
    return names, js, o


# ---------------------------------------------------------------------------
# AGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wd,amsgrad,clip", [
    (0.0, False, None), (0.01, False, None), (0.01, True, None), (0.0, False, 0.5),
])
def test_agd_five_steps_match_jax(wd, amsgrad, clip):
    kw = dict(weight_decay=wd, amsgrad=amsgrad, clip=clip)
    names, js, o = _run(jopt.agd(1e-2, **kw), lambda tp: topt.agd(tp, 1e-2, **kw))
    assert o.count == int(js.count) == 5
    for p, k in zip(o.param_groups[0]["params"], names):
        st = o.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(js.exp_avg[k]), atol=1e-7)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(js.exp_avg_sq[k]), rtol=1e-5)
        if amsgrad:
            np.testing.assert_allclose(st["max_exp_avg_sq"].numpy(),
                                       np.asarray(js.max_exp_avg_sq[k]), rtol=1e-5)


def _three_steps(jname, tname, jkw, tkw, seed=0):
    """Three train steps of the tiny model with ``build_optimizer`` of each
    package; held as ``test_three_steps_match_jax``. Returns both states."""
    jc, tc = jcfg.tiny(), tcfg.tiny()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer(jname, lr=1e-3, weight_decay=0.01, **jkw)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(seed), jc, mesh, jtx)
    jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False)
    ttx = ttrainer.build_optimizer(tname, lr=1e-3, weight_decay=0.01, **tkw)
    tstate = ttrain.state_from_params(params_from_jax(jax.device_get(jstate.params), tc), ttx)
    tstep = ttrain.build_train_step(tc, ttx)
    for x, y in _batches(jc, 3):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tstate.params)),
                    jax.tree.leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        assert np.mean(np.abs(a - b) > PARAM_CLOSE_ATOL) <= PARAM_FLIP_SHARE
    return jstate, tstate


@pytest.mark.parametrize("jname,tname,kw", [
    ("agd", "agd", {}),
    ("adamw_8bit", "adamw_4bit", OPT4_KW),
])
def test_build_optimizer_three_steps_match_jax(jname, tname, kw):
    jkw = dict(kw, bits=4) if tname == "adamw_4bit" else kw
    jstate, tstate = _three_steps(jname, tname, jkw, kw)
    assert tstate.opt_state.count == 3


@pytest.mark.parametrize("jname,tname,kw", [
    ("agd", "agd", dict(amsgrad=True)),
    ("adamw_8bit", "adamw_4bit", OPT4_KW),
])
def test_state_tree_paths_are_the_jax_trees(jname, tname, kw):
    jkw = dict(kw, bits=4) if tname == "adamw_4bit" else kw
    jc, tc = jcfg.tiny(), tcfg.tiny()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jstate, _ = jtrain.init_sharded_state(
        jax.random.PRNGKey(0), jc, mesh, jtrainer.build_optimizer(jname, lr=1e-3, **jkw))
    want = {_keystr(kp): (tuple(np.shape(v)), np.asarray(v).dtype.name)
            for kp, v in _flatten_with_path(jax.device_get(jstate))}
    tstate = ttrain.init_state(tc, ttrainer.build_optimizer(tname, lr=1e-3, **kw), devices="cpu")
    got = {}
    for path, v in flatten_state(train_state_tree(tstate)):
        dt = str(v.dtype).replace("torch.", "") if isinstance(v, torch.Tensor) else np.asarray(v).dtype.name
        got[path] = (tuple(np.shape(v)), dt)
    assert got == want
    # the 4-bit start is the JAX package's bit for bit (code 0 is nibble 8)
    if tname == "adamw_4bit":
        for kp, v in _flatten_with_path(jax.device_get(jstate)):
            if "/mu/" in _keystr(kp) and np.asarray(v).dtype == np.uint8:
                assert (np.asarray(v) == 0x88).all()


# ---------------------------------------------------------------------------
# WSAM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decouple,adaptive", [(True, False), (False, False), (True, True)])
def test_wsam_grad_fn_matches_jax(decouple, adaptive):
    jc, tc = jcfg.tiny(), tcfg.tiny()
    params = jax.device_get(jtr.init_params(jax.random.PRNGKey(4), jc))
    x, y = _batches(jc, 1, B=2, T=16, seed=4)[0]
    kw = dict(rho=0.05, gamma=WSAM_GAMMA, decouple=decouple, adaptive=adaptive)

    def jgrad(p, xx, yy):
        return jax.value_and_grad(jtr.loss_fn)(p, xx, yy, jc)

    jl, jg, js = jopt.make_wsam_grad_fn(jgrad, **kw)(params, x, y)
    model = params_from_jax(params, tc)
    wsam = topt.make_wsam_grad_fn(topt.model_grad_fn(model, tc), **kw)
    tl, tg, ts = wsam(model.jax_ordered_parameters(), torch.from_numpy(x).long(),
                      torch.from_numpy(y).long())
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL)
    for a, b in zip(ts, jax.tree.leaves(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SHARP_TOL)
    # the model's own params are untouched by the perturbation
    for a, b in zip(jax.tree.leaves(params_to_numpy(model)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    upd = [torch.full_like(g, 0.5) for g in tg]
    j_upd = jopt.apply_wsam_sharpness(jax.tree.map(lambda g: jnp.full_like(g, 0.5), jg), js, 0.1)
    for a, b in zip(topt.apply_wsam_sharpness(upd, ts, 0.1), jax.tree.leaves(j_upd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SHARP_TOL * 0.1)


# ---------------------------------------------------------------------------
# muP and the policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, dict(scan_layers=True),
                                dict(rope=False, rmsnorm=False, swiglu=False,
                                     tie_embeddings=True, num_kv_heads=None)])
def test_mup_config_and_lr_scales_match_jax(kw):
    jb, tb = jcfg.tiny(**kw), tcfg.tiny(**kw)
    jc, tc = jcfg.tiny(model_dim=64, **kw), tcfg.tiny(model_dim=64, **kw)
    assert tmup.width_mult(tc, tb) == jmup.width_mult(jc, jb) == 2.0
    assert asdict(tmup.mup_config(tc, tb)) == asdict(jmup.mup_config(jc, jb))
    j, t = jmup.mup_lr_scales(jc, jb), tmup.mup_lr_scales(tc, tb)
    assert jax.tree.structure(j) == jax.tree.structure(t)
    assert jax.tree.leaves(j) == jax.tree.leaves(t)
    assert tmup.lr_scales_by_param(tc, tb) == jax.tree.leaves(j)
    assert set(jax.tree.leaves(t)) == {1.0, 0.5}


def test_mup_adamw_three_steps_match_jax():
    jb, tb = jcfg.tiny(), tcfg.tiny()
    jc, tc = jcfg.tiny(model_dim=64), tcfg.tiny(model_dim=64)
    params = jax.device_get(jtr.init_params(jax.random.PRNGKey(6), jc))
    model = params_from_jax(params, tc)
    jtx = jmup.mup_adamw(1e-2, jc, jb, weight_decay=0.1)
    js = jtx.init(params)
    leaves = model.jax_ordered_parameters()
    o = tmup.mup_adamw(leaves, 1e-2, tc, tb, weight_decay=0.1)
    jp = params
    rng = np.random.default_rng(6)
    for _ in range(3):
        g = [(rng.normal(size=p.shape) * 1e-2).astype(np.float32) for p in leaves]
        u, js = jtx.update(jax.tree.unflatten(jax.tree.structure(jp), g), js, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for p, gg in zip(leaves, g):
            p.grad = torch.from_numpy(gg)
        o.step()
    for a, b in zip(leaves, jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=PARAM_TOL)


@pytest.mark.parametrize("spec", [
    "mixed_bf16", "full_fp32", "full_bf16", "params=f32,compute=bf16",
    "params=bf16", "compute=fp16", "param=float32,compute=float32, ",
])
def test_policy_parses_as_the_jax_package(spec):
    j, t = jpolicy.MixedPrecisionPolicy.parse(spec), tpolicy.MixedPrecisionPolicy.parse(spec)
    assert asdict(t) == asdict(j) and t.describe() == j.describe()
    assert asdict(t.apply(tcfg.tiny())) == asdict(j.apply(jcfg.tiny()))
    assert set(tpolicy.PRESETS) == set(jpolicy.PRESETS)


@pytest.mark.parametrize("spec", ["params=f8", "output=f32", "compute=int8"])
def test_policy_refuses_what_the_jax_package_refuses(spec):
    with pytest.raises(ValueError):
        jpolicy.MixedPrecisionPolicy.parse(spec)
    with pytest.raises(ValueError):
        tpolicy.MixedPrecisionPolicy.parse(spec)


# ---------------------------------------------------------------------------
# 4-bit AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_4bit_matches_jax(signed):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(37, 129)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    jqz = jq.quantize_4bit(jnp.asarray(x), signed)
    tqz = tq.quantize_4bit(torch.from_numpy(x), signed)
    assert tqz.packed.dtype == torch.uint8 and tqz.shape == jqz.shape
    np.testing.assert_array_equal(tqz.packed.numpy(), np.asarray(jqz.packed))
    np.testing.assert_allclose(tqz.scales.numpy(), np.asarray(jqz.scales), atol=0)
    np.testing.assert_allclose(tq.dequantize_4bit(tqz).numpy(),
                               np.asarray(jq.dequantize_4bit(jqz)), atol=1e-7)


@pytest.mark.parametrize("wd,eps_root", [(0.0, 0.0), (0.01, 0.0), (0.01, 1e-8)])
def test_adamw_4bit_five_steps_match_jax(wd, eps_root):
    eps = 0.0 if eps_root else 1e-8
    kw = dict(weight_decay=wd, min_quantized_size=4096, eps=eps, eps_root=eps_root)
    names, js, o = _run(jq.adamw_4bit(learning_rate=1e-2, **kw),
                        lambda tp: tq.adamw_4bit(tp, lr=1e-2, **kw))
    st = o.adam_state
    assert st.count == int(js.count) == 5
    for i, k in enumerate(names):
        tm, tv, jm, jv = st.mu[i], st.nu[i], js.mu[k], js.nu[k]
        if isinstance(tm, tq.Quantized4):
            assert k in ("a_w", "c_w", "e_w") and isinstance(tv, tq.Quantized8)
            np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
            np.testing.assert_array_equal(tv.codes.numpy(), np.asarray(jv.codes))
            for a, b in ((tm, jm), (tv, jv)):
                np.testing.assert_allclose(a.scales.numpy(), np.asarray(b.scales).reshape(-1), atol=SCALE_TOL)
        else:
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-7)


def test_four_bit_state_is_smaller_than_eight_bit():
    """1.5 bytes of codes a quantized parameter against 2, and the same
    f32 scale a block of 128 in both."""
    p = [torch.nn.Parameter(torch.zeros(128, 256))]

    def nbytes(o, part):
        return sum(t.numel() * t.element_size() for q in (o.adam_state.mu + o.adam_state.nu)
                   for t in ((getattr(q, "packed", None) if hasattr(q, "packed") else q.codes)
                             if part == "codes" else q.scales,))

    o4, o8 = tq.adamw_4bit(p), tq.adamw_8bit(p)
    assert nbytes(o4, "codes") * 4 == nbytes(o8, "codes") * 3 == 3 * 2 * p[0].numel()
    assert nbytes(o4, "scales") == nbytes(o8, "scales") == 2 * 4 * p[0].numel() // 128


# ---------------------------------------------------------------------------
# the flat 8-bit AdamW applies each group's delta at once, bitwise as before
# ---------------------------------------------------------------------------
def _step_before(opt):
    """``adamw_8bit_flat.step`` as it was before each group's delta was
    applied at once: every delta first, then one out-of-place weight
    decay, retune multiply and add over all leaves."""
    group = opt.param_groups[0]
    leaves, lr = group["params"], group["lr"]
    grads = [p.grad for p in leaves]
    opt.count += 1
    scalars = opt._scalars(lr, opt.count)
    out = [None] * len(leaves)
    with torch.no_grad():
        for gi, g in enumerate(opt.layout.groups):
            gflat = tq._pack_group(grads, g, grads[g.idx[0]].dtype)
            delta = tq.adam8_update_flat(gflat.view(-1, tq.BLOCK), opt.mu[gi], opt.nu[gi],
                                         scalars, opt.b1, opt.b2, opt.classic).view(-1)
            for i, off in zip(g.idx, g.offsets):
                out[i] = delta[off:off + leaves[i].numel()].view(leaves[i].shape)
        if opt.layout.small_idx:
            gs = torch.cat([grads[i].reshape(-1).float() for i in opt.layout.small_idx])
            opt.mu_small, opt.nu_small, ds = tq._adam8_block_math(
                gs, opt.mu_small, opt.nu_small, scalars[0], scalars[1], opt.eps_val,
                opt.b1, opt.b2, opt.classic)
            for i, off in zip(opt.layout.small_idx, opt.layout.small_offsets):
                out[i] = ds[off:off + leaves[i].numel()].view(leaves[i].shape).to(leaves[i].dtype)
        wd = float(torch.tensor(lr, dtype=torch.float32) * opt.weight_decay)
        out = torch._foreach_add(out, leaves, alpha=-wd)
        out = torch._foreach_mul(out, float(group["retune_scale"]))
        torch._foreach_add_(leaves, out)


@pytest.mark.parametrize("form", ["flat", "leaf"])
def test_updates_are_bitwise_the_step_before_per_group_apply(form):
    names, p0, grads = _grads_and_params(4, 9)
    runs = []
    for new in (True, False):
        tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in names]
        o = tq.adamw_8bit_flat(tp, lr=1e-2, weight_decay=0.01, group_elems=9000)
        o.param_groups[0]["retune_scale"] = 0.7
        for step in range(4):
            for p, k in zip(tp, names):
                p.grad = torch.from_numpy(grads[step][k])
            o.step() if new else _step_before(o)
        runs.append(([p.detach().clone() for p in tp], o))
    (a, oa), (b, ob) = runs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x.codes, y.codes) and torch.equal(x.scales, y.scales)
    if form == "leaf":  # the per-leaf form applies leaf by leaf: the same bits
        tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in names]
        o = tq.adamw_8bit(tp, lr=1e-2, weight_decay=0.01)
        o.param_groups[0]["retune_scale"] = 0.7
        for step in range(4):
            for p, k in zip(tp, names):
                p.grad = torch.from_numpy(grads[step][k])
            o.step()
        for x, y in zip(tp, a):
            assert torch.equal(x.detach(), y)


# ---------------------------------------------------------------------------
# AGD and 4-bit state through Flash Checkpoint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jname,tname,kw", [
    ("agd", "agd", {}),
    ("adamw_8bit", "adamw_4bit", OPT4_KW),
])
def test_state_round_trips_flash_checkpoint_and_the_jax_reader_reads_it(
        jname, tname, kw, tmp_path, monkeypatch):
    from dlrover_tpu.ckpt.checkpointer import FlashCheckpointer as JaxCheckpointer
    from dlrover_tpu.ckpt.saver import AsyncCheckpointSaver as JaxSaver
    from dlrover_tpu_torch.ckpt.checkpointer import FlashCheckpointer, StorageType
    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", tempfile.mkdtemp(prefix="dlr"))
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()  # no agent: both packages write and read synchronously
    jkw = dict(kw, bits=4) if tname == "adamw_4bit" else kw
    jstate, tstate = _three_steps(jname, tname, jkw, kw)
    d = str(tmp_path / "ck")
    assert FlashCheckpointer(d).save_checkpoint(3, {"train": train_state_tree(tstate)},
                                                StorageType.DISK)
    saved = {p: (v.detach().clone() if isinstance(v, torch.Tensor) else np.asarray(v))
             for p, v in flatten_state(train_state_tree(tstate))}
    # the port restores it into a fresh state, bit for bit
    fresh = ttrain.init_state(tcfg.tiny(), ttrainer.build_optimizer(tname, lr=1e-3, weight_decay=0.01, **kw),
                              devices="cpu")
    step, got = FlashCheckpointer(d).load_checkpoint({"train": train_state_tree(fresh)})
    assert step == 3
    load_train_state_tree(fresh, got["train"])
    assert fresh.step == 3 and fresh.opt_state.count == 3
    for p, v in flatten_state(train_state_tree(fresh)):
        if isinstance(v, torch.Tensor):
            assert v.detach().numpy().tobytes() == saved[p].numpy().tobytes(), p
        else:
            assert np.asarray(v) == saved[p], p
    # the JAX package's reader assembles the same leaves into its own tree
    jstep, jgot = JaxCheckpointer(d).load_checkpoint({"train": jstate})
    assert jstep == 3
    for kp, v in _flatten_with_path(jax.device_get(jgot["train"])):
        p = _keystr(kp)
        want = saved[p].numpy() if isinstance(saved[p], torch.Tensor) else saved[p]
        assert np.asarray(v).tobytes() == np.asarray(want).tobytes(), p
