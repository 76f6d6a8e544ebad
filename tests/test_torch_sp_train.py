"""Port parity: a tiny model under sequence parallelism against the JAX
package's ``forward`` / ``loss_fn`` on an sp mesh of the 8-device CPU
mesh, and ``ElasticTrainer`` on an sp strategy against one process.

The port runs in gloo rank processes (``tests/torch_dist_worker.py``,
jobs ``sp`` and ``train``); each rank holds its rows and its block of the
sequence. Compared, from JAX weights converted leaf for leaf and numpy
tokens from a seed:

- the logits of sp = 2 (ring and Ulysses, GQA: 4 heads over 2 kv heads,
  which sp = 2 divides) against the JAX ``forward`` on ``MeshConfig(sp=2)``,
  atol 3e-5 (``tests/test_models_parallel.py``'s own tolerance);
- one ``build_train_step`` step (sgd at lr 1, so the update is the
  gradient): the loss and every gradient against ``jax.value_and_grad``
  of the JAX ``loss_fn`` on the same mesh, 3e-5, for sp = 2 (the
  default path's sp sum) and dp = 2 x sp = 2 (the explicit plan of kind
  ``tp``: the sp sum before the dp legs; and the default path);
- ``ElasticTrainer`` at sp = 2, both schemes, against one process:
  losses within 1e-6 (f32; the ring merges where one kernel runs the
  row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models.transformer import forward as jforward, init_params, loss_fn as jloss
from dlrover_tpu.parallel.mesh import MeshConfig as JMeshConfig, build_mesh

import torch_dist_worker as tdw

LOGIT_TOL = 3e-5
STEP_TOL = 3e-5
TRAIN_TOL = 1e-6
B, T = 4, 32
MODEL = dict(num_heads=4, num_kv_heads=2)


def _params(cfg):
    p = init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(np.asarray, p)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, T + 1)).astype(np.int32)
    return x[:, :-1], x[:, 1:]


CASES = {
    "ring_sp2": dict(mesh=dict(sp=2), scheme="ring", step=True),
    "ulysses_sp2": dict(mesh=dict(sp=2), scheme="ulysses", step=True),
}
DPSP_CASES = {
    "explicit_dp2sp2": dict(mesh=dict(dp=2, sp=2), scheme="ring", step=True, comm_overlap=True),
    "default_dp2sp2": dict(mesh=dict(dp=2, sp=2), scheme="ulysses", step=True),
}


def _runs(cases):
    tokens, targets = _tokens()
    out = {}
    for name, c in cases.items():
        model = dict(MODEL, sp_scheme=c["scheme"])
        out[name] = dict(model=model, mesh=c["mesh"], params=_params(jcfg.tiny(**model)),
                         tokens=tokens, targets=targets, step=c["step"], lr=1.0,
                         comm_overlap=c.get("comm_overlap", False))
    return out


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    return tdw.run_ranks("sp", 2, {"train": _runs(CASES)}, str(tmp_path_factory.mktemp("sp2")))


@pytest.fixture(scope="module")
def dpsp(tmp_path_factory):
    return tdw.run_ranks("sp", 4, {"train": _runs(DPSP_CASES)},
                         str(tmp_path_factory.mktemp("dpsp")))


def _jax(name, case):
    cfg = jcfg.tiny(**dict(MODEL, sp_scheme=case["scheme"]))
    mesh = build_mesh(JMeshConfig(**case["mesh"]),
                      devices=jax.devices()[:int(np.prod(list(case["mesh"].values())))])
    params = jax.tree.map(jnp.asarray, _params(cfg))
    tokens, targets = (jnp.asarray(x) for x in _tokens())
    logits, _ = jax.jit(lambda p, t: jforward(p, t, cfg, mesh))(params, tokens)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, tokens, targets, cfg, mesh)))(params)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads), params


def _assemble_logits(ranks, name):
    out = np.zeros((B, T, 256), np.float32)
    for r in ranks:
        t = r["train"][name]
        lo, hi = t["block"]
        out[np.ix_(t["rows"], range(lo, hi))] = t["logits"]
    return out


def _check(ranks, name, case):
    logits, loss, grads, params = _jax(name, case)
    np.testing.assert_allclose(_assemble_logits(ranks, name), logits, atol=LOGIT_TOL)
    for r in ranks:
        t = r["train"][name]
        # the logged loss: the same global token mean on every rank
        assert t["loss"] == ranks[0]["train"][name]["loss"]
        np.testing.assert_allclose(t["loss"], loss, atol=STEP_TOL)
        # sgd at lr 1: params after the step = params - grads
        got = jax.tree.map(lambda a, b: np.asarray(a) - b, params, t["params"])
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(grads)):
            np.testing.assert_allclose(g, w, atol=STEP_TOL, err_msg=jax.tree_util.keystr(path))
    return ranks[0]["train"][name]


@pytest.mark.parametrize("name", list(CASES))
def test_sp2_forward_and_step_match_jax(sp2, name):
    t = _check(sp2, name, CASES[name])
    assert t["kind"] is None  # sp alone: no plan, the default path's sp sum


@pytest.mark.parametrize("name", list(DPSP_CASES))
def test_dp2_sp2_forward_and_step_match_jax(dpsp, name):
    t = _check(dpsp, name, DPSP_CASES[name])
    assert t["kind"] == ("tp" if DPSP_CASES[name].get("comm_overlap") else None)
    if t["kind"] is None:
        # the default path: one all-reduce of the gradients over the
        # replica group (the sp sum and the data mean at once), one of
        # the loss
        assert t["issued"]["all_reduce"] == 2


def test_unknown_scheme_raises_the_jax_error():
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models.transformer import _attention_block, init_params as tinit
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh as tbuild

    cfg = tcfg.tiny(sp_scheme="ulyses")
    model = tinit(torch.Generator().manual_seed(0), cfg)
    mesh = tbuild(MeshConfig())
    mesh.config = MeshConfig(sp=2)  # an sp mesh as the block sees it
    x = torch.zeros((1, 8, cfg.model_dim))
    with pytest.raises(ValueError, match="unknown sp_scheme"):
        _attention_block(x, model.layers[0], cfg, torch.arange(8)[None], mesh)


@pytest.mark.parametrize("mesh,item", [
    (dict(sp=2, pp=2), "A11c"), (dict(sp=2, ep=2), "A19"),
])
def test_unported_meshes_still_raise(mesh, item):
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models.transformer import check_supported
    from dlrover_tpu_torch.parallel.mesh import MeshConfig

    # sp inside pp stages is the JAX package's refusal (a ValueError in
    # its words), not a part of A11c that waits; ep x sp, which A19
    # ported, now builds on a MoE model
    if item == "A11c":
        with pytest.raises(ValueError, match=r"sp \(ring attention\) inside pp stages"):
            check_supported(tcfg.tiny(num_layers=4), MeshConfig(**mesh))
        return
    check_supported(tcfg.tiny(num_experts=4, moe_every=2), MeshConfig(**mesh))


# -- ElasticTrainer on an sp strategy -----------------------------------------
TRAIN = {
    "ring": dict(mesh=dict(sp=2), model=dict(sp_scheme="ring"), steps=3, optimizer="adamw_8bit",
                 opt_kw=dict(min_quantized_size=4096), lr=3e-3, batch=4),
    "ulysses": dict(mesh=dict(sp=2), model=dict(sp_scheme="ulysses"), steps=3,
                    optimizer="adamw_8bit", opt_kw=dict(min_quantized_size=4096), lr=3e-3, batch=4),
}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    one = tdw.run_ranks("train", 1, {"one": dict(TRAIN["ring"], mesh=dict())},
                        str(tmp_path_factory.mktemp("sp_one")))[0]
    two = tdw.run_ranks("train", 2, TRAIN, str(tmp_path_factory.mktemp("sp_two")))
    return one, two


@pytest.mark.parametrize("scheme", list(TRAIN))
def test_elastic_trainer_on_an_sp_strategy_matches_one_process(trainer_runs, scheme):
    """Both sp ranks log the one process's losses; the state stays a
    replica on both (per-leaf 8-bit AdamW: the flat form is refused on
    an sp mesh)."""
    one, two = trainer_runs
    for r in two:
        np.testing.assert_allclose(r[scheme]["losses"], one["one"]["losses"], rtol=0,
                                   atol=TRAIN_TOL * max(one["one"]["losses"]))
        assert r[scheme]["strategy"] == two[0][scheme]["strategy"]
    for a, b in zip(jax.tree_util.tree_leaves(two[0][scheme]["params"]),
                    jax.tree_util.tree_leaves(two[1][scheme]["params"])):
        np.testing.assert_array_equal(a, b)


# -- Flash Checkpoint at world 2 on an sp mesh ----------------------------------
def test_flash_checkpoint_on_an_sp_mesh_resumes_bitwise(tmp_path):
    """sp ranks hold one replica of the state: it is staged once for the
    replica set (dp x fsdp x sp), and a fresh pair of sp ranks restores
    it from the saver's shm and trains on bitwise as an uninterrupted
    run."""
    ck = dict(save_memory_interval=2, save_storage_interval=4, ckpt_dir=str(tmp_path / "ck"))
    base = dict(TRAIN["ring"], steps=6)
    runs = {"full": base, "first": dict(base, steps=4, trainer=ck),
            "resume": dict(base, trainer=ck)}
    with tdw.hosted_saver(2) as env:
        two = tdw.run_ranks("train", 2, runs, str(tmp_path / "ranks"), env=env)
    for r in two:
        assert r["first"]["losses"] == r["full"]["losses"][:4]
        assert (r["resume"]["restored"], r["resume"]["source"]) == (4, "memory")
        assert r["resume"]["losses"] == r["full"]["losses"][4:]
        for a, b in zip(jax.tree_util.tree_leaves(r["resume"]["params"]),
                        jax.tree_util.tree_leaves(r["full"]["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_static_peak_prices_the_block_and_the_scheme_buffers(scheme):
    """Under sp a rank's activations are those of its 1/sp of the
    tokens, plus one layer's in-flight buffers of the scheme; the dry
    runner builds an sp strategy, an sp x tp one, and an sp x ep one on a
    MoE model (ROADMAP A19)."""
    from dlrover_tpu_torch.accel.dry_runner import _check_unported, _sp_buffers, static_peak_bytes
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    cfg = tcfg.tiny(sp_scheme=scheme)
    tx = tt.build_optimizer("adamw_8bit", min_quantized_size=4096)
    whole = static_peak_bytes(cfg, Strategy(mesh=MeshConfig()), tx, 1, 2048)
    half = static_peak_bytes(cfg, Strategy(mesh=MeshConfig()), tx, 1, 1024)
    sp2 = static_peak_bytes(cfg, Strategy(mesh=MeshConfig(sp=2)), tx, 1, 2048)
    assert sp2 < whole
    assert sp2 == pytest.approx(half + _sp_buffers(cfg, 1024, 4))
    _check_unported(Strategy(mesh=MeshConfig(sp=2)), cfg, tx)
    _check_unported(Strategy(mesh=MeshConfig(sp=2, tp=2)), cfg, tx)
    _check_unported(Strategy(mesh=MeshConfig(sp=2, ep=2)),
                    tcfg.tiny(sp_scheme=scheme, num_experts=4, moe_every=2), tx)
