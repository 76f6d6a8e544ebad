"""The ep step on the card. Marked ``cuda``; on a host without a card
the test skips (the CPU tests are ``tests/test_torch_moe.py`` and
``tests/test_torch_ep_trainer.py``).

Two gloo ranks on the card run ``build_train_step`` of a small MoE model
(4 layers, 2 MoE layers of 4 experts, top-2, bf16 activations, head dim
64 for the attention kernels) at dp 1 x ep 2, without remat and with it:
each step issues 4 ep all-to-alls a MoE layer (the dispatch and the
return, and their transposes in the backward), 6 under remat (the
recompute issues the forward's two again), the ranks' losses are the
same number, and remat's losses are the plain run's within
``REMAT_TOL``."""

import numpy as np
import pytest
import torch

import torch_dist_worker as tdw

pytestmark = pytest.mark.cuda
MODEL = dict(num_layers=4, model_dim=256, num_heads=4, num_kv_heads=4, mlp_dim=512,
             max_seq_len=64, dtype="bfloat16", num_experts=4, moe_every=2, moe_top_k=2)
N_MOE = 2
REMAT_TOL = 1e-6  # the recompute runs the same kernels on the same inputs


def test_ep_step_alltoalls_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's attention runs the card's kernels")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (3, 4, 65)).astype(np.int64)
    batches = [(d[:, :-1], d[:, 1:]) for d in data]
    case = dict(kind="step", mesh=dict(ep=2), batches=batches, optimizer="sgd", lr=0.1,
                device="cuda")
    ranks = tdw.run_ranks("ep", 2, {"plain": dict(case, model=MODEL),
                                    "remat": dict(case, model=dict(MODEL, remat=True))},
                          str(tmp_path))
    for r in ranks:
        assert [g["a2a"] for g in r["plain"]["metrics"]] == [4 * N_MOE] * 3
        assert [g["a2a"] for g in r["remat"]["metrics"]] == [6 * N_MOE] * 3
        np.testing.assert_allclose([g["loss"] for g in r["remat"]["metrics"]],
                                   [g["loss"] for g in r["plain"]["metrics"]], rtol=REMAT_TOL)
    assert [g["loss"] for g in ranks[0]["plain"]["metrics"]] == \
        [g["loss"] for g in ranks[1]["plain"]["metrics"]]
    assert all(np.isfinite(g["loss"]) for r in ranks for g in r["plain"]["metrics"])
