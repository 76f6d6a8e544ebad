"""Optimizer-state offload on the card (``ops/host_offload.py``). Marked
``cuda``; on a host without a card every test skips (the CPU's offload is
the numeric no-op, ``tests/test_torch_search_trainer.py``).

Between steps the state lives in pinned host memory and the card holds
only the double buffer; each update streams it through the card and is
bitwise the resident update (compared exactly)."""

import pytest
import torch

from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.ops import host_offload
from dlrover_tpu_torch.trainer.elastic import trainer as tt

import torch_dist_worker as tdw

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: offload streams the state through it")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _train(opt, offload):
    """A small model the kernels take (bf16, head_dim 64, T = 64)."""
    losses = []
    tr = tt.ElasticTrainer(
        tcfg.tiny(num_layers=4, model_dim=256, mlp_dim=512, max_seq_len=64, dtype="bfloat16"),
        tt.build_optimizer(opt, lr=1e-2), tdw.Tokens(seq=64),
        tt.TrainerConfig(batch_size=4, seq_len=64, report_metrics=False),
        strategy=Strategy(offload_opt=offload), devices="cuda",
        metrics_hook=lambda s, m: losses.append(float(m["loss"])) if "loss" in m else None,
    )
    return tr, losses


def _state_tensors(inner):
    if isinstance(inner, torch.optim.AdamW):
        return [t for st in inner.state.values() for k, t in st.items() if k != "step"]
    return ([q.codes for q in inner.mu + inner.nu] + [q.scales for q in inner.mu + inner.nu]
            + [inner.mu_small, inner.nu_small])


@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit_flat"])
def test_state_is_pinned_host_memory_between_steps_and_bitwise(dev, opt):
    assert host_offload.placement_active(dev)
    res, want = _train(opt, False)
    res.train(3)
    resident = [p.detach().clone() for p in res.state.params.jax_ordered_parameters()]
    res.close()
    off, got = _train(opt, True)
    inner = off.state.opt_state.opt
    for step in range(3):
        off.train(step + 1)
        torch.cuda.synchronize()
        tensors = _state_tensors(inner)
        assert tensors and all(t.device.type == "cpu" and t.is_pinned() for t in tensors)
    assert got == want
    for a, b in zip(resident, off.state.params.jax_ordered_parameters()):
        assert torch.equal(a, b)
    io = inner.offload
    assert io.updates == 3 and io.bytes_streamed == 3 * 2 * io.host_bytes
    assert all(s.device.type == "cuda" for s in io.slots)
    off.close()


def test_offloaded_state_checkpoints_and_restores_bitwise(dev, tmp_path, monkeypatch):
    """Flash Checkpoint of an offloaded state (no saver serves the job:
    each save is a synchronous disk write; the host state is read after
    the last update's copies landed, with no card-to-host copy): a fresh
    offloaded trainer restores it bitwise and trains on as the
    uninterrupted run does."""
    import uuid

    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")

    def run(steps, ckpt):
        losses = []
        tr = tt.ElasticTrainer(
            tcfg.tiny(num_layers=2, model_dim=256, mlp_dim=512, max_seq_len=64, dtype="bfloat16"),
            tt.build_optimizer("adamw_8bit_flat", lr=1e-2), tdw.Tokens(seq=64),
            tt.TrainerConfig(batch_size=4, seq_len=64, report_metrics=False, prefetch=0,
                             ckpt_dir=ckpt, save_memory_interval=1000, save_storage_interval=2),
            strategy=Strategy(offload_opt=True), devices="cuda",
            metrics_hook=lambda s, m: losses.append(float(m["loss"])) if "loss" in m else None,
        )
        tr.train(steps)
        tr.wait_for_checkpoint()
        return tr, losses

    whole, want = run(4, str(tmp_path / "a"))
    whole.close()
    first, _ = run(2, str(tmp_path / "b"))
    first.close()
    again, rest = run(4, str(tmp_path / "b"))
    assert again.restored_step == 2 and again.restore_source == "storage"
    assert rest == want[2:]
    assert all(t.is_pinned() for t in _state_tensors(again.state.opt_state.opt))
    again.close()


@pytest.mark.parametrize("kind", ["adamw_8bit_flat", "adamw"])
def test_streamed_update_is_bitwise_the_resident_one(dev, kind, monkeypatch):
    """The unit bookkeeping: units of at most ``UNIT_BYTES`` (adamw) or
    one packed group (flat), two slots of the largest unit, updates
    bitwise the resident optimizer's, and every byte of the state
    streamed both ways each update; any other optimizer is refused."""
    from dlrover_tpu_torch.ops import quantized_optim as qo

    monkeypatch.setattr(host_offload, "UNIT_BYTES", 200_000)
    shapes = [(300, 128), (50,), (4096, 2), (70000,), (7, 9)]

    def leaves():
        return [torch.nn.Parameter(
            torch.randn(s, generator=torch.Generator().manual_seed(i)).to(dev))
            for i, s in enumerate(shapes)]

    def make(ps):
        if kind == "adamw":
            return torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.01)
        return qo.adamw_8bit_flat(ps, lr=1e-2, weight_decay=0.01, group_elems=40_000)

    a, b = leaves(), leaves()
    oa, ob = make(a), make(b)
    host_offload.offload_optimizer(ob, dev)
    io = ob.offload
    assert len(io.units) >= 3 and io.slot_bytes == 2 * max(io.unit_bytes)
    for step in range(4):
        for p, q, i in zip(a, b, range(len(a))):
            g = torch.randn(p.shape, generator=torch.Generator().manual_seed(100 * step + i)).to(dev)
            p.grad, q.grad = g.clone(), g.clone()
        oa.step()
        ob.step()
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert io.updates == 4 and io.bytes_streamed == 4 * 2 * io.host_bytes
    with pytest.raises(NotImplementedError, match="adamw and adamw_8bit_flat"):
        host_offload.offload_optimizer(torch.optim.SGD(leaves(), lr=0.1), dev)
