"""A checkpoint the JAX package wrote, read into the port: the JAX
package trains ``tiny()`` for 2 steps (``adamw_8bit_flat``, and
separately ``adamw``) and saves as its trainer does (``train/`` and
``sampler/``, no agent, so synchronously); ``state_from_jax_checkpoint``
loads it into a port ``TrainState`` on the CPU, without JAX. One more
step then runs in both packages on the same batch, and the loss and
every param must agree within ``tests/test_torch_train.py``'s
tolerances."""

import tempfile
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ckpt.checkpointer import FlashCheckpointer, StorageType
from dlrover_tpu.ckpt.saver import AsyncCheckpointSaver
from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import train as jtrain
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import train as ttrain
from dlrover_tpu_torch.models.convert import params_to_numpy, state_from_jax_checkpoint
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

from test_torch_train import (  # noqa: E402  (the slice's tolerances)
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_CLOSE_ATOL,
    PARAM_FLIP_SHARE,
    _batches,
)

OPTS = {
    "adamw_8bit_flat": dict(min_quantized_size=512, group_elems=8192),
    "adamw": {},
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_jax_checkpoint_takes_the_next_step_in_the_port(name, tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", tempfile.mkdtemp(prefix="dlr"))
    AsyncCheckpointSaver.reset()
    jc, tc = jcfg.tiny(), tcfg.tiny()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtx = jtrainer.build_optimizer(name, lr=1e-3, weight_decay=0.01, **OPTS[name])
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    jstep = jtrain.build_train_step(jc, mesh, jtx, donate=False)
    batches = _batches(jc, 3)
    for x, y in batches[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    d = str(tmp_path / "jax")
    tree = {"train": jstate, "sampler": {"epoch": 0, "completed_num": 8}}
    assert FlashCheckpointer(d).save_checkpoint(2, tree, StorageType.DISK)

    ttx = ttrainer.build_optimizer(name, lr=1e-3, weight_decay=0.01, **OPTS[name])
    tstate = state_from_jax_checkpoint(d, tc, ttx, devices="cpu")
    assert tstate.step == 2 and tstate.opt_state.count == 2
    assert tstate.opt_state.learning_rate == pytest.approx(1e-3)
    j_before = jax.tree.leaves(jax.device_get(jstate.params))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tstate.params)), j_before):
        assert a.tobytes() == np.asarray(b).tobytes()  # params restored exactly

    x, y = batches[2]
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tm = ttrain.build_train_step(tc, ttx)(
        tstate, torch.from_numpy(x).long(), torch.from_numpy(y).long()
    )
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    assert tstate.step == int(jstate.step) == 3
    j_leaves = jax.tree.leaves(jax.device_get(jstate.params))
    t_leaves = jax.tree.leaves(params_to_numpy(tstate.params))
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        assert np.mean(np.abs(a - b) > PARAM_CLOSE_ATOL) <= PARAM_FLIP_SHARE


def test_a_layout_mismatch_is_refused(tmp_path, monkeypatch):
    """The flat optimizer's groups must be the JAX run's: a port built
    with other group sizes is refused, naming the leaves."""
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", tempfile.mkdtemp(prefix="dlr"))
    AsyncCheckpointSaver.reset()
    jc, tc = jcfg.tiny(), tcfg.tiny()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    kw = OPTS["adamw_8bit_flat"]
    jtx = jtrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, **kw)
    jstate, _ = jtrain.init_sharded_state(jax.random.PRNGKey(0), jc, mesh, jtx)
    d = str(tmp_path / "jax")
    assert FlashCheckpointer(d).save_checkpoint(0, jstate, StorageType.DISK)
    other = ttrainer.build_optimizer("adamw_8bit_flat", lr=1e-3, min_quantized_size=512)
    with pytest.raises(ValueError, match="opt_state/inner_state/0/mu/1"):
        state_from_jax_checkpoint(d, tc, other, devices="cpu")
