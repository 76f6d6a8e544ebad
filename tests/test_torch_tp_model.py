"""Port parity under tensor parallelism: a tiny model on tp meshes against
the JAX package's ``forward`` / ``loss_fn`` on the same ``MeshConfig`` of
the 8-device CPU mesh, and the explicit sync's ``tp`` and ``3d`` plans
held to an exact mean.

The port runs in gloo rank processes (``tests/torch_dist_worker.py``,
job ``tp``; one start of two ranks and one of four, every case of a
world in it). Each rank holds its tp boxes of the JAX weights (converted
leaf for leaf, ``params_from_jax(mesh=)``) and its rows (and sequence
block) of numpy tokens from a seed. Compared:

- the logits (gathered over tp) of tp = 2, dp 2 x tp 2, sp 2 x tp 2
  (ring and Ulysses) and fsdp 2 x tp 2 against the JAX ``forward`` on
  the same mesh, atol 3e-5 (``tests/test_models_parallel.py``'s
  tolerance at the sp tests' size); a vocab tp does not divide (255)
  runs its table and head whole, against the JAX ``forward``;
- one ``build_train_step`` step (sgd at lr 1, so the update is the
  gradient): its loss and every gradient, gathered to the whole leaf,
  against ``jax.value_and_grad`` of the JAX ``loss_fn``, 3e-5, on tp = 2
  (the default path; the GPT-2 form too: learned positions, LayerNorm,
  GELU's biases, the tied vocab-parallel head), dp 2 x tp 2 (the
  explicit ``tp`` plan), fsdp 2 x tp 2 (the ``3d`` plan) and fsdp 2 x
  sp 2 (the default path);
- the grads of every leaf tp leaves whole, bitwise equal across the tp
  ranks (no tp collective makes them so: the layout does);
- ``sync_grads`` of kind ``tp`` and ``3d`` against the exact mean of
  the lanes' gradients, 1e-6 of the largest value (the JAX oracles of
  these plans are red here, ROADMAP §C), and int8 on a ``tp`` plan
  within half a code of the bucket's shared scale."""

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
SYNC_TOL = 1e-6
B, T = 4, 32
MODEL = dict(num_heads=4, num_kv_heads=2)
GPT2 = dict(MODEL, rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)


def _params(model):
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg.tiny(**model)))


def _tokens(vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
    return x[:, :-1], x[:, 1:]


CASES2 = {
    "tp2": dict(mesh=dict(tp=2), step=True),
    "tp2_gpt2": dict(mesh=dict(tp=2), model=GPT2, step=True),
    "tp2_vocab255": dict(mesh=dict(tp=2), model=dict(MODEL, vocab_size=255), step=True),
    "tp2_remat": dict(mesh=dict(tp=2), model=dict(MODEL, remat=True), step=True),
}
CASES4 = {
    "dp2tp2": dict(mesh=dict(dp=2, tp=2), step=True, comm_overlap=True),
    "sp2tp2_ring": dict(mesh=dict(sp=2, tp=2), scheme="ring"),
    "sp2tp2_ulysses": dict(mesh=dict(sp=2, tp=2), scheme="ulysses"),
    "fsdp2tp2": dict(mesh=dict(fsdp=2, tp=2), step=True, comm_overlap=True),
    "fsdp2sp2": dict(mesh=dict(fsdp=2, sp=2), step=True),
}
# Ulysses needs sp to divide a rank's local heads: 2 heads over tp = 2
# leave one, which sp = 2 does not divide
INDIVISIBLE = {"sp2tp2_ulysses_2heads": dict(mesh=dict(sp=2, tp=2), scheme="ulysses",
                                             model=dict(num_heads=2, num_kv_heads=2))}
SYNC_MODEL = dict(num_layers=1, rope=False, rmsnorm=False, swiglu=False, tie_embeddings=True)
SYNC4 = {
    "tp_none": dict(mesh=dict(dp=2, tp=2), compress="none", seed=11),
    "tp_int8": dict(mesh=dict(dp=2, tp=2), compress="int8", seed=12),
    "3d_none": dict(mesh=dict(fsdp=2, tp=2), compress="none", seed=13),
    "3d_int8_forced_off": dict(mesh=dict(fsdp=2, tp=2), compress="int8", seed=14),
}


def _model(c):
    return dict(c.get("model", MODEL), sp_scheme=c.get("scheme", "ring"))


def _runs(cases):
    out = {}
    for name, c in cases.items():
        model = _model(c)
        tokens, targets = _tokens(model.get("vocab_size", 256))
        out[name] = dict(model=model, mesh=c["mesh"], params=_params(model), tokens=tokens,
                         targets=targets, step=c.get("step", False), lr=1.0,
                         comm_overlap=c.get("comm_overlap", False))
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return tdw.run_ranks("tp", 2, {"train": _runs(CASES2)}, str(tmp_path_factory.mktemp("tp2")))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    sync = {n: dict(c, model=SYNC_MODEL) for n, c in SYNC4.items()}
    return tdw.run_ranks("tp", 4, {"train": _runs({**CASES4, **INDIVISIBLE}), "sync": sync},
                         str(tmp_path_factory.mktemp("tp4")))


def _jax(case):
    model = _model(case)
    cfg = jcfg.tiny(**model)
    n = int(np.prod(list(case["mesh"].values())))
    # a vocab tp does not divide is not a layout the JAX rules can put on
    # the mesh: its reference is the one-device model (the same math)
    mesh = None if cfg.vocab_size % case["mesh"].get("tp", 1) else build_mesh(
        JMeshConfig(**case["mesh"]), devices=jax.devices()[:n])
    params = jax.tree.map(jnp.asarray, _params(model))
    tokens, targets = (jnp.asarray(x) for x in _tokens(cfg.vocab_size))
    logits, _ = jax.jit(lambda p, t: jforward(p, t, cfg, mesh))(params, tokens)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, tokens, targets, cfg, mesh)))(params)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads), params, cfg


def _check(ranks, name, case):
    logits, loss, grads, params, cfg = _jax(case)
    got = np.zeros((B, T, cfg.vocab_size), np.float32)
    for r in ranks:
        t = r["train"][name]
        lo, hi = t["block"]
        got[np.ix_(t["rows"], range(lo, hi))] = t["logits"]
    np.testing.assert_allclose(got, logits, atol=LOGIT_TOL)
    if not case.get("step"):
        return None
    for r in ranks:
        t = r["train"][name]
        # the logged loss: the same number on every rank
        assert t["loss"] == ranks[0]["train"][name]["loss"]
        np.testing.assert_allclose(t["loss"], loss, atol=STEP_TOL)
        # sgd at lr 1: params after the step = params - grads
        after = jax.tree.map(lambda a, b: np.asarray(a) - b, params, t["params"])
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(after),
                                     jax.tree_util.tree_leaves_with_path(grads)):
            np.testing.assert_allclose(g, w, atol=STEP_TOL, err_msg=jax.tree_util.keystr(path))
        # the whole tree's norm, the split leaves' squares summed over tp
        np.testing.assert_allclose(t["grad_norm"], np.sqrt(sum(
            float(np.sum(np.square(w))) for w in jax.tree_util.tree_leaves(grads))), rtol=1e-5)
    return ranks[0]["train"][name]


def _whole_grads_agree(ranks, name):
    """Every tp rank of one data lane and sequence block got bitwise the
    same grads of the leaves tp leaves whole."""
    by = {}
    for r in ranks:
        t = r["train"][name]
        by.setdefault((tuple(t["rows"]), t["block"]), []).append(t)
    for group in by.values():
        assert len(group) == 2 and {t["tp"] for t in group} == {0, 1}
        a, b = group
        assert a["whole_grads"].keys() == b["whole_grads"].keys() and a["whole_grads"]
        for i in a["whole_grads"]:
            np.testing.assert_array_equal(a["whole_grads"][i], b["whole_grads"][i])
        assert a["tp_calls"] == b["tp_calls"] > 0


@pytest.mark.parametrize("name", list(CASES2))
def test_tp2_forward_and_step_match_jax(world2, name):
    t = _check(world2, name, CASES2[name])
    assert t["kind"] is None  # tp alone: no data axis, nothing to sync
    _whole_grads_agree(world2, name)


@pytest.mark.parametrize("name", list(CASES4))
def test_four_rank_meshes_match_jax(world4, name):
    case = CASES4[name]
    t = _check(world4, name, case)
    if t is None:
        return
    kind = {"dp2tp2": "tp", "fsdp2tp2": "3d", "fsdp2sp2": None}[name]
    assert t["kind"] == kind
    if case["mesh"].get("tp", 1) > 1:
        _whole_grads_agree(world4, name)


def test_ulysses_under_tp_rejects_indivisible_local_heads(world4):
    """The JAX package's error (``tests/test_models_parallel.py::
    test_rejects_indivisible_heads``), on the rank's local heads."""
    for r in world4:
        assert "divide the local head" in r["train"]["sp2tp2_ulysses_2heads"]["error"]


def test_the_vocab_split_follows_the_divisor(world2):
    """tp = 2 splits a vocab of 256 (each rank's embedding rows and head
    columns, the vocab-parallel loss) and leaves 255 whole; with the
    whole table the tp collectives are the blocks' alone."""
    split = world2[0]["train"]["tp2"]["tp_calls"]
    whole = world2[0]["train"]["tp2_vocab255"]["tp_calls"]
    # two layers: per block 2 forward + 2 backward; the split adds the
    # embedding's sum and the head's copy (one each) and the loss's two
    assert whole == 2 * 4
    assert split == whole + 2 + 2
    # under remat the recompute adds the attention's sum alone (the
    # checkpoint stops before the MLP's), the count the dry runner's
    # step time prices (``_tp_comm_estimate``)
    assert world2[0]["train"]["tp2_remat"]["tp_calls"] == 2 * 5 + 4


def _sync_expect(case, lane_count):
    """The exact mean of every lane's seeded gradient, per global leaf."""
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel import grad_sync as gs

    shapes = [tuple(p.shape) for p in gs.model_leaves(tcfg.tiny(**SYNC_MODEL))]
    grads = tdw.case_grads(shapes, lane_count, case["seed"], 0)
    return [g.mean(0) for g in grads]


@pytest.mark.parametrize("name", list(SYNC4))
def test_tp_and_3d_syncs_are_the_exact_mean(world4, name):
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel.sharding_rules import leaf_tp_dims, local_shard

    case = SYNC4[name]
    runs = [r["sync"][name] for r in world4]
    kind = runs[0]["kind"]
    assert kind == ("tp" if "dp" in case["mesh"] else "3d")
    # the JAX gate: int8 on tp plans, never on 3d
    assert runs[0]["compress"] == ("int8" if name == "tp_int8" else "none")
    lanes = case["mesh"].get("dp", 1) * case["mesh"].get("fsdp", 1)
    want = _sync_expect(case, lanes)
    dims = leaf_tp_dims(tcfg.tiny(**SYNC_MODEL), 2)
    scale = max(float(np.abs(g).max()) for g in tdw.case_grads(
        [w.shape for w in want], lanes, case["seed"], 0)) / 127.0
    for r in runs:
        for i, (got, w, d) in enumerate(zip(r["synced"], want, dims)):
            box = np.asarray(local_shard(w, d, 2, r["tp"]))
            if kind == "3d":
                # this fsdp rank's block rows of the padded flatten
                sh = r["leaf_shard"][i]
                box = np.pad(box.reshape(-1), (0, 2 * sh - box.size))[r["lane"] * sh:(r["lane"] + 1) * sh]
            tol = 0.5 * scale + 1e-7 if r["compress"] == "int8" else SYNC_TOL * float(np.abs(w).max())
            np.testing.assert_allclose(got, box, rtol=0, atol=tol, err_msg=f"{name} leaf {i}")
        full = np.sqrt(sum(float(np.sum(np.square(w))) for w in want))
        np.testing.assert_allclose(r["gnorm"], full, rtol=1e-3 if r["compress"] == "int8" else 1e-5)
