"""ZeRO's params sharded through the step (``models/train.ZeroUnits``),
on the CPU over gloo in 2 rank processes (``tests/torch_dist_worker.py``'s
``units`` job; one start):

- a ``TorchDispatchMode`` reads every param's storage at each op of the
  forward and the backward of a ZeRO dp=1 x fsdp=2 step: the params
  allocated at any op are within one unit (the embedding, one block or
  the head; under ``scan_layers`` the stacked blocks, since a stacked
  leaf's shard runs across layers), with remat on and off, and none is
  allocated between steps. Without remat the backward gathers each unit
  whose graph saved its params (all of them in f32), under remat every
  block once more for its recompute;
- the losses do not depend on remat (as the remat tests of
  ``tests/test_torch_remat_scan.py`` hold for one process) and the two
  ranks agree;
- ``static_peak_bytes`` prices ZeRO's resident params at 1/fsdp and the
  unit its backward gathers again.

The ZeRO-against-dp=2 bitwise test of ``tests/test_torch_dp_trainer.py``
holds the per-unit step's losses.
"""

import pytest

from dlrover_tpu_torch.accel.dry_runner import static_peak_bytes
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.parallel import grad_sync
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer

import torch_dist_worker as tdw

CASES = {
    "list": dict(),
    "list_remat": dict(model=dict(remat=True)),
    "scan": dict(model=dict(scan_layers=True)),
    "scan_remat": dict(model=dict(scan_layers=True, remat=True)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tdw.run_ranks("units", 2, CASES, str(tmp_path_factory.mktemp("units")))


@pytest.mark.parametrize("case", list(CASES))
def test_at_most_one_unit_is_gathered_at_any_op(runs, case):
    for r in runs:
        c = r[case]
        assert c["bad"] == [], c["bad"][:5]
        assert 0 < c["most"] <= c["unit_leaves"] < c["leaves"]
        assert c["freed"]
        assert r[case]["losses"] == runs[0][case]["losses"]
    c = runs[0][case]
    L = tcfg.tiny().num_layers
    steps = len(c["losses"])
    if case.startswith("scan"):
        assert c["units"] == ["embed", "head", "layers"]
        # forward + backward (saved f32 params, or the remat recompute)
        assert c["gathers"]["layers"] == 2 * steps
    else:
        assert c["units"] == sorted(["embed", "head"] + [str(("layer", i)) for i in range(L)])
        assert all(c["gathers"][str(("layer", i))] == 2 * steps for i in range(L))
    assert c["gathers"]["head"] == 2 * steps


def test_remat_does_not_change_the_losses(runs):
    for r in runs:
        assert r["list"]["losses"] == r["list_remat"]["losses"] == r["scan"]["losses"]
        assert r["scan"]["losses"] == r["scan_remat"]["losses"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_static_peak_prices_the_sharded_params_and_the_gathered_unit(dtype, remat):
    cfg = tcfg.tiny(dtype=dtype, remat=remat)
    tx = ttrainer.build_optimizer("adamw_8bit", lr=1e-3)
    leaves = grad_sync.model_leaves(cfg)
    p_bytes = sum(p.numel() * 4 for p in leaves)
    D, V, L = cfg.model_dim, cfg.vocab_size, cfg.num_layers
    block = (sum(p.numel() for p in leaves) - 2 * V * D) / L
    zero = Strategy(mesh=MeshConfig(fsdp=2), comm_overlap=True)
    # the same mesh on the default path shards nothing but the state
    plain = Strategy(mesh=MeshConfig(fsdp=2))
    # 8 x 64 tokens: enough activations that the backward phase is the
    # peak with remat too (which prices the head's backward and one
    # block's recompute as the larger of the two, not their sum)
    a = static_peak_bytes(cfg, zero, tx, 8, 64, leaves)
    b = static_peak_bytes(cfg, plain, tx, 8, 64, leaves)
    f32 = dtype == "float32"
    regathered = 4 * max(block if (remat or f32) else 0, V * D if f32 else 0)
    # the backward phase is the peak at these shapes
    assert b - a == pytest.approx(p_bytes / 2 - regathered)
