"""Port parity for the slice as a whole, on the CPU: the train step
with the flat 8-bit AdamW against the JAX package's sharded step on a
one-device mesh, gradient accumulation against the port's own
single-batch step, the LR schedules against optax, and the trainer's
data order against the JAX sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu.trainer.elastic.sampler import (
    ElasticDistributedSampler as JaxSampler,
)
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import train as ttrain
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

LOSS_RTOL = 1e-5
# params after 3 steps of lr 1e-3: the gradients agree to ~1e-7
# relative, but a moment value that lands on a rounding boundary of
# the 8-bit sqrt map can take the neighbouring code, which moves that
# element's update by a few percent of one step. So nearly every
# element agrees to 1e-6, and the rest to a tenth of one step's lr.
PARAM_ATOL = 1e-4
PARAM_CLOSE_ATOL = 1e-6
PARAM_FLIP_SHARE = 5e-3
OPT_KW = dict(min_quantized_size=512, group_elems=8192)


def _batches(cfg, n, B=4, T=32, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, cfg.vocab_size, (n, B, T + 1)).astype(np.int32)
    return [(d[:, :-1], d[:, 1:]) for d in data]


@pytest.mark.parametrize("overrides", [{}, dict(rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)])
def test_three_steps_match_jax(overrides):
    jc, tc = jcfg.tiny(**overrides), tcfg.tiny(**overrides)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False)
    model = params_from_jax(jax.device_get(jstate.params), tc)
    ttx = ttrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, weight_decay=0.01, **OPT_KW)
    tstate = ttrain.state_from_params(model, ttx)
    assert len(tstate.opt_state.opt.layout.groups) == len(jstate.opt_state.inner_state[0].mu) > 1
    tstep = ttrain.build_train_step(tc, ttx)
    for x, y in _batches(jc, 3):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    assert tstate.step == int(jstate.step) == 3
    j_leaves = jax.tree.leaves(jax.device_get(jstate.params))
    t_leaves = jax.tree.leaves(params_to_numpy(tstate.params))
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        assert np.mean(np.abs(a - b) > PARAM_CLOSE_ATOL) <= PARAM_FLIP_SHARE


@pytest.mark.parametrize("name", ["sgd", "adamw_8bit_flat"])
def test_grad_accum_matches_single_batch(name):
    """K f32-averaged microbatches give the full batch's step (held to
    the math, not to the JAX ga path)."""
    cfg = tcfg.tiny()
    x, y = (torch.from_numpy(a).long() for a in _batches(cfg, 1, B=4)[0])
    out = []
    for ga in (1, 2):
        tx = ttrainer.build_optimizer(name, lr=0.1 if name == "sgd" else 1e-3, **(OPT_KW if name != "sgd" else {}))
        state = ttrain.init_state(cfg, tx, seed=0, devices="cpu")
        state, m = ttrain.build_train_step(cfg, tx, grad_accum=ga)(state, x, y)
        out.append((m, params_to_numpy(state.params)))
    (m1, p1), (m2, p2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "schedule,warmup", [("constant", 0), ("constant", 5), ("cosine", 0),
                        ("cosine", 5), ("linear", 0), ("linear", 5)]
)
def test_lr_schedules_match_optax(schedule, warmup):
    jtx = jtrainer.build_optimizer("sgd", lr=0.3, schedule=schedule, warmup_steps=warmup, total_steps=20)
    params = {"w": jnp.ones((3,))}
    state = jtx.init(params)
    mk = ttrainer.build_optimizer("sgd", lr=0.3, schedule=schedule, warmup_steps=warmup, total_steps=20)
    opt = mk([torch.nn.Parameter(torch.ones(3))])
    for _ in range(25):
        # the injected hyperparam holds the value the update just used;
        # optax evaluates it in f32, the port in double: they agree to
        # f32 precision of the peak lr (0.3 x 2^-24 ~ 2e-8)
        _, state = jtx.update({"w": jnp.ones((3,))}, state, params)
        np.testing.assert_allclose(
            opt.lr_fn(opt.count), float(state.hyperparams["learning_rate"]), rtol=1e-6, atol=3e-8
        )
        opt.count += 1


class _Tokens:
    """Random token rows that record which indices were read."""

    def __init__(self, n=32, seq=32, vocab=256, seed=0):
        self.data = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1), dtype=np.int32)
        self.read = []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        self.read.append(i)
        return {"x": self.data[i, :-1], "y": self.data[i, 1:]}


def test_trainer_runs_on_cpu_in_the_jax_sampler_order():
    ds, ev = _Tokens(), _Tokens(n=8, seed=1)
    seen = []
    tr = ttrainer.ElasticTrainer(
        tcfg.tiny(), ttrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, schedule="linear",
                                              warmup_steps=2, total_steps=10, **OPT_KW),
        ds, ttrainer.TrainerConfig(batch_size=4, seq_len=32, log_interval=1, eval_interval=3, eval_steps=2),
        devices="cpu", metrics_hook=lambda s, m: seen.append((s, sorted(m))), eval_dataset=ev,
    )
    tr.train(3)
    assert tr.global_step == 3
    assert tr.state.params.embed["tokens"].device.type == "cpu"
    expect = list(JaxSampler(len(ds), shuffle=True))[:12]
    assert ds.read == expect
    assert [s for s, _ in seen] == [1, 2, 3, 3]
    assert seen[0][1] == ["grad_norm", "loss"] and seen[3][1] == ["eval_loss", "eval_ppl"]
    assert tr.current_lr() == pytest.approx(1e-3 * 1.0)  # lr_fn(2) at warmup end
    assert np.isfinite(tr.evaluate()["eval_loss"])
    tr.close()


@pytest.mark.parametrize("knob,value", [
    ("comm_overlap", True), ("grad_compress", "int8"), ("sdc_detect", True),
    ("moe_rebalance_interval", 5),
])
def test_unported_knob_raises(knob, value):
    tc = ttrainer.TrainerConfig(**{knob: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrainer.ElasticTrainer(tcfg.tiny(), ttrainer.build_optimizer("sgd"), _Tokens(), tc, devices="cpu")


@pytest.mark.parametrize("save_best", [False, True])
def test_checkpoint_knobs_are_honored(save_best, tmp_path, monkeypatch):
    """``ckpt_dir`` (and ``save_best``) no longer raise: with no saver
    serving the job every save is written to disk, ``save_best`` adds
    the best eval's checkpoint and its sidecar under ``ckpt_dir/best``,
    and a fresh trainer resumes from the newest step."""
    import json
    import os

    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"nosaver{os.getpid()}{save_best}")
    d = str(tmp_path / "ck")
    tc = ttrainer.TrainerConfig(
        batch_size=4, seq_len=32, ckpt_dir=d, save_best=save_best, save_best_min_interval_s=0.0,
        save_memory_interval=2, save_storage_interval=4, eval_interval=2, eval_steps=1,
    )
    mk = lambda: ttrainer.ElasticTrainer(  # noqa: E731
        tcfg.tiny(), ttrainer.build_optimizer("adamw"), _Tokens(), tc, devices="cpu",
        eval_dataset=_Tokens(n=8, seed=1))
    tr = mk()
    tr.train(4)
    tr.close()
    assert [(s["step"], s["kind"], s["ok"]) for s in tr.save_log if s["kind"] != "best"] == [
        (2, "memory", True), (4, "storage", True)]
    assert open(os.path.join(d, "latest_step")).read() == "4"
    best = os.path.join(d, "best", "best_eval.json")
    assert os.path.exists(best) == save_best
    if save_best:
        assert json.load(open(best))["step"] in (2, 4)
    tr2 = mk()
    assert (tr2.restored_step, tr2.restore_source, tr2.global_step) == (4, "storage", 4)
    tr2.close()


def test_trainer_config_keeps_the_jax_fields_and_defaults():
    import dataclasses

    j = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainerConfig)}
    t = {f.name: f.default for f in dataclasses.fields(ttrainer.TrainerConfig)}
    assert t == j


@pytest.mark.parametrize("name", ["agd", "adamw_8bit"])
def test_unported_optimizers_raise(name):
    """agd is not ported; adamw_8bit is, all but its 4-bit form."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if name == "agd":
            ttrainer.build_optimizer(name)
        else:
            ttrainer.build_optimizer(name, bits=4)([torch.nn.Parameter(torch.zeros(3))])


def test_three_steps_match_jax_per_leaf_adamw_8bit():
    """The per-leaf 8-bit AdamW under the train step, against the JAX
    step with the same optimizer (its jnp path on the CPU); held to the
    flat form's tolerances (above)."""
    jc, tc = jcfg.tiny(), tcfg.tiny()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer("adamw_8bit", lr=1e-3, weight_decay=0.01, min_quantized_size=512)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False)
    ttx = ttrainer.build_optimizer("adamw_8bit", lr=1e-3, weight_decay=0.01, min_quantized_size=512)
    tstate = ttrain.state_from_params(params_from_jax(jax.device_get(jstate.params), tc), ttx)
    tstep = ttrain.build_train_step(tc, ttx)
    for x, y in _batches(jc, 3):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    st = tstate.opt_state.opt.adam_state
    assert st.count == 3 and any(not isinstance(m, torch.Tensor) for m in st.mu)
    j_leaves = jax.tree.leaves(jax.device_get(jstate.params))
    t_leaves = jax.tree.leaves(params_to_numpy(tstate.params))
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        assert np.mean(np.abs(a - b) > PARAM_CLOSE_ATOL) <= PARAM_FLIP_SHARE


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.init_state(tcfg.tiny(), ttrainer.build_optimizer("sgd"))
    _ = optax  # the JAX side's optimizer library is imported for parity
