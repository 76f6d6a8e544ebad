"""The port's hand-written kernels against their plain PyTorch versions
on the card. Marked ``cuda``; on a host without a card every test skips
(decided inside a fixture, so every worker collects the same tests).

Run on the card:  python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: attention outputs and gradients within 0.2 of the plain f32
result's rms in every 64-row tile (the kernels' tile; bf16 inputs and
outputs, p and ds rounded to bf16 before their products), lse within
1e-3; the 8-bit update's codes may
differ by 1 on at most 0.1 % of elements, scales and deltas within 1e-6
of their largest value; the embedding row kernels equal their plain
versions bitwise (they only move f32 rows). The plain versions run with
TF32 off."""

import math

import pytest
import torch

from dlrover_tpu_torch.ops import embedding_rows as er
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import quantized_optim as qo

pytestmark = pytest.mark.cuda

ATTN_TOL = 0.2  # per 64-row tile, over the tile's rms (see _tile_err)
LSE_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _tile_err(got, ref, rows=64):
    """Largest over 64-row tiles of max |got - ref| / rms(ref tile); empty
    tiles are floored at 1e-3 of the tensor's rms."""
    ref = ref.float()
    shape = ref.shape[:-2] + (ref.shape[-2] // rows, rows * ref.shape[-1])
    err = (got.float() - ref).abs().reshape(shape).amax(-1)
    rms = ref.reshape(shape).square().mean(-1).sqrt()
    return (err / rms.clamp_min(1e-3 * ref.square().mean().sqrt())).max().item()


@pytest.mark.parametrize(
    "B,H,Hkv,T,D,q_off,k_off,causal",
    [
        (2, 4, 4, 256, 64, 0, 0, True),
        (1, 4, 4, 256, 128, 0, 0, True),
        (1, 8, 2, 192, 128, 0, 0, True),  # a last block with one warpgroup idle
        (2, 4, 4, 256, 64, 0, 128, True),  # whole tiles skipped, empty rows
        (1, 4, 2, 128, 64, 256, 0, True),  # every key visible
        (2, 4, 4, 64, 64, 0, 0, True),  # one tile: half a forward block
        (2, 4, 4, 256, 64, 0, 0, False),
        (1, 4, 2, 192, 128, 0, 0, False),
        (2, 4, 4, 256, 64, 0, 32, True),  # the diagonal crosses two tiles
        (2, 4, 2, 256, 64, 40, 0, True),
        (1, 8, 2, 64, 128, 0, 0, True),
    ],
)
def test_attention_kernels_match_plain(dev, B, H, Hkv, T, D, q_off, k_off, causal):
    _check_attention(dev, B, H, Hkv, T, T, D, q_off, k_off, causal)


@pytest.mark.parametrize(
    "Tq,Tk,q_off,k_off,causal",
    [
        (128, 384, 256, 0, True),  # a chunk of queries at the end of its keys
        (384, 128, 0, 0, True),  # later queries see every key
        (192, 320, 0, 0, False),
        (256, 256, -64, 0, True),  # the first 64 queries lie before key 0
    ],
)
def test_attention_kernels_lengths_and_offsets(dev, Tq, Tk, q_off, k_off, causal):
    _check_attention(dev, 1, 4, 2, Tq, Tk, 64, q_off, k_off, causal)


def _check_attention(dev, B, H, Hkv, Tq, Tk, D, q_off, k_off, causal):
    g = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn((B, H, Tq, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Hkv, Tk, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    fa.reset_launch_counts()
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, layout="bhtd")
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts == {"fa_fwd": 1, "fa_bwd_dkdv": 1, "fa_bwd_dq": 1}
    leaves = [x.float().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    o_ref, lse_ref = fa.flash_attention_reference(
        *leaves, causal=causal, q_offset=q_off, k_offset=k_off, return_residuals=True
    )
    refs = torch.autograd.grad(o_ref, leaves, do.float().transpose(1, 2))
    assert _tile_err(o, o_ref.detach().transpose(1, 2)) <= ATTN_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.bfloat16
        assert _tile_err(got, ref.transpose(1, 2)) <= ATTN_TOL


@pytest.mark.parametrize(
    "B,H,Hkv,T,D",
    [
        (1, 32, 32, 4096, 128),  # Llama-2 width
        (1, 32, 8, 2048, 128),  # GQA, four query heads a kv head
    ],
)
def test_dq_kernel_matches_plain_at_full_width(dev, B, H, Hkv, T, D):
    """``fa_bwd_dq`` alone against the plain backward's dq on the same
    inputs and residuals (the forward kernel's o and lse)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, do = (torch.randn((B, H, T, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, layout="bhtd")
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty_like(q)
    fa.reset_launch_counts()
    fa._bwd_launch("fa_bwd_dq", (dq,), q, k, v, do, lse, delta, D**-0.5, True, 0, 0)
    torch.cuda.synchronize()
    assert fa.launch_counts["fa_bwd_dq"] == 1
    ref, _, _ = fa._bwd_plain(q, k, v, do, lse, delta, D**-0.5, True, None, 0, 0)
    assert torch.isfinite(dq).all()
    assert _tile_err(dq, ref) <= ATTN_TOL


def test_attention_kernels_with_every_key_in_the_future(dev):
    """No tile is loaded at all: o = 0, lse = NEG_INF, zero gradients."""
    q, k, v, do = (torch.randn((1, 2, 192, 64), device=dev, dtype=torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, q_offset=0, k_offset=4096, layout="bhtd")
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert not o.any() and (lse == fa.NEG_INF).all()
    assert not any(g.any() for g in grads)


def test_autograd_op_counts_one_launch_each(dev):
    q, k, v = (torch.randn((1, 2, 128, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v, layout="bhtd").square().sum().backward()
    assert fa.launch_counts == {"fa_fwd": 1, "fa_bwd_dkdv": 1, "fa_bwd_dq": 1}
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_cuda_refuses_mask_fn(dev):
    x = torch.zeros((1, 2, 128, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(x, x, x, mask_fn=lambda a, b: a >= b, layout="bhtd")


@pytest.mark.parametrize("classic", [True, False])
def test_adam8_kernel_matches_plain(dev, classic):
    R = 4096
    g = torch.Generator(device=dev).manual_seed(1)
    grad = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    m0 = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    v0 = torch.rand((R, 128), generator=g, device=dev) * 1e-6

    def state():
        return [qo.Quantized8(*qo._quant_block_math_wide(x, s), (R * 128,), s)
                for x, s in ((m0, True), (v0, False))]

    scalars = (3e-4 / (1 - 0.9**2), 1 / (1 - 0.999**2), 1e-8)
    scalars = tuple(float(torch.tensor(x, dtype=torch.float32)) for x in scalars)
    (mk, vk), (mp, vp) = state(), state()
    qo.reset_launch_counts()
    dk = qo.adam8_update_flat(grad, mk, vk, scalars, 0.9, 0.999, classic)
    dp = qo._adam8_update_plain(grad, mp, vp, scalars, 0.9, 0.999, classic)
    torch.cuda.synchronize()
    assert qo.launch_counts["adam8_flat"] == 1
    for a, b in ((mk, mp), (vk, vp)):
        diff = (a.codes.int() - b.codes.int()).abs()
        assert diff.max().item() <= 1 and diff.float().mean().item() <= 1e-3
        assert _rel(a.scales, b.scales) <= 1e-6
    assert _rel(dk, dp) <= 1e-6


def test_small_train_step_on_the_card(dev):
    from dataclasses import replace

    from dlrover_tpu_torch.models import gpt2_small, train
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    cfg = replace(gpt2_small(), num_layers=2, model_dim=128, num_heads=2, vocab_size=512, max_seq_len=128)
    tx = build_optimizer("adamw_8bit_flat", lr=1e-3, min_quantized_size=4096)
    state = train.init_state(cfg, tx, seed=0)
    step = train.build_train_step(cfg, tx)
    x = torch.randint(0, 512, (4, 128), device=dev)
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    losses = []
    for _ in range(3):
        state, m = step(state, x, x.roll(-1, 1))
        losses.append(float(m["loss"]))
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert fa.launch_counts == {"fa_fwd": 6, "fa_bwd_dkdv": 6, "fa_bwd_dq": 6}
    assert qo.launch_counts["adam8_flat"] == 3 * len(state.opt_state.opt.layout.groups)


def test_adam8_flat_on_rows_no_multiple_of_the_tile(dev):
    """The flat entry over 4,096 + 17 rows: the last tile is masked."""
    R = 4096 + 17
    assert R % qo._TILE_ROWS
    g = torch.Generator(device=dev).manual_seed(6)
    grad = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    m0 = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    v0 = torch.rand((R, 128), generator=g, device=dev) * 1e-6

    def state():
        out = []
        for x, s in ((m0, True), (v0, False)):
            c, sc = qo._sqrt_map_quant(x, s, 127.0)
            out.append(qo.Quantized8(c.to(torch.int8), sc.view(R).contiguous(), (R * 128,), s))
        return out

    scalars = tuple(float(torch.tensor(x, dtype=torch.float32))
                    for x in (3e-4 / (1 - 0.9**5), 1 / (1 - 0.999**5), 1e-8))
    (mk, vk), (mp, vp) = state(), state()
    qo.reset_launch_counts()
    dk = qo.adam8_update_flat(grad, mk, vk, scalars, 0.9, 0.999)
    dp = qo._adam8_update_plain(grad, mp, vp, scalars, 0.9, 0.999)
    torch.cuda.synchronize()
    assert qo.launch_counts == {"adam8_flat": 1, "adam8_leaf": 0}
    for a, b in ((mk, mp), (vk, vp)):
        diff = (a.codes.int() - b.codes.int()).abs()
        assert diff.max().item() <= 1 and diff.float().mean().item() <= 1e-3
        assert _rel(a.scales, b.scales) <= 1e-6
    assert _rel(dk, dp) <= 1e-6
    info = qo.triton_kernel_info("adam8_flat")
    assert info["n_spills"] == 0 and info["n_regs"] > 0


@pytest.mark.parametrize("R", [301, 64])
def test_adam8_leaf_route_masks_the_tail(dev, R):
    """Per-leaf rows (R = 301 is no multiple of the 8-row tile) with
    [R] scales; the rows past R in the last tile are neither read nor
    written: a guard row after the state keeps its bytes."""
    g = torch.Generator(device=dev).manual_seed(2)
    grad = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    m0 = torch.randn((R, 128), generator=g, device=dev) * 1e-3
    v0 = torch.rand((R, 128), generator=g, device=dev) * 1e-6

    def state():
        out = []
        for x, s in ((m0, True), (v0, False)):
            codes = torch.full((R + 1, 128), 7, dtype=torch.int8, device=dev)
            scales = torch.full((R + 1,), 3.0, device=dev)
            c, sc = qo._sqrt_map_quant(x, s, 127.0)
            codes[:R], scales[:R] = c.to(torch.int8), sc.view(R)
            out.append((codes, scales, qo.Quantized8(codes[:R], scales[:R], (R * 128,), s)))
        return out

    scalars = tuple(float(torch.tensor(x, dtype=torch.float32))
                    for x in (3e-4 / (1 - 0.9**3), 1 / (1 - 0.999**3), 1e-8))
    k_state, p_state = state(), state()
    qo.reset_launch_counts()
    dk = qo.adam8_update_leaf(grad, k_state[0][2], k_state[1][2], scalars, 0.9, 0.999)
    dp = qo._adam8_update_plain(grad, p_state[0][2], p_state[1][2], scalars, 0.9, 0.999)
    torch.cuda.synchronize()
    assert qo.launch_counts == {"adam8_flat": 0, "adam8_leaf": 1}
    for (kc, ks, a), (_, _, b) in zip(k_state, p_state):
        diff = (a.codes.int() - b.codes.int()).abs()
        assert diff.max().item() <= 1 and diff.float().mean().item() <= 1e-3
        assert _rel(a.scales, b.scales) <= 1e-6
        assert (kc[R] == 7).all() and ks[R].item() == 3.0  # the guard row
    assert _rel(dk, dp) <= 1e-6


@pytest.mark.parametrize("row_floats", [256, 16, 6, 130])
def test_embedding_row_kernels_equal_plain(dev, row_floats):
    """Sorted unique slots padded with the scratch slot (the last row)
    many times; widths that take the 16-byte path (256, 16) and the
    scalar path (6, 130)."""
    cap = 5000
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((cap + 1, row_floats), generator=g, device=dev)
    real = torch.randperm(cap, generator=g, device=dev)[:700].sort().values
    slots = torch.full((1024,), cap, dtype=torch.int32, device=dev)
    slots[:700] = real.int()
    er.reset_launch_counts()
    got = er.emb_gather(table, slots)
    assert torch.equal(got, er.gather_plain(table, slots))
    rows = torch.randn((1024, row_floats), generator=g, device=dev)
    rows[700:] = rows[700]  # padding entries carry identical values
    ref = er.scatter_plain(table.clone(), slots, rows)
    out = er.emb_scatter_(table, slots, rows)
    torch.cuda.synchronize()
    assert out.data_ptr() == table.data_ptr()  # in place
    assert torch.equal(table, ref)
    assert er.launch_counts == {"emb_gather": 1, "emb_scatter": 1}


def test_device_tier_on_the_card_matches_the_cpu_and_repeats(dev):
    """A spilling run of the tier on the card against the same run on
    the CPU (1e-5 of the largest value: the dense math rounds
    differently), and two card runs bitwise equal (the duplicate-id sum
    is deterministic)."""
    import numpy as np

    from dlrover_tpu_torch.ops.embedding import (
        DeviceSparseEmbedding,
        ShardedKvEmbedding,
    )

    def run(devices):
        host = ShardedKvEmbedding(2, 32, num_slots=2, seed=0)
        emb = DeviceSparseEmbedding(host, capacity=256, sparse_optimizer="adam",
                                    lr=0.05, devices=devices)
        rng = np.random.default_rng(0)
        for step in range(1, 9):
            ids = np.minimum(rng.zipf(1.3, 512), 2000).astype(np.int64)
            prep = emb.prepare(ids)
            rows = emb.gather_for(prep)
            emb.apply_grads(prep, rows * 0.1 + 0.01, step=step)
        emb.flush()
        assert emb.stats.spill_rows > 0
        st = host.export_state()
        order = np.argsort(st["keys"])
        emb.close()
        return st["keys"][order], st["rows"][order]

    k1, r1 = run("cuda")
    k2, r2 = run("cuda")
    k0, r0 = run("cpu")
    assert np.array_equal(k1, k2) and np.array_equal(r1, r2)
    assert np.array_equal(k0, k1)
    assert np.abs(r1 - r0).max() <= 1e-5 * np.abs(r0).max()


def test_pipelined_tier_under_a_side_stream_repeats_bitwise(dev):
    """``SparseTrainer.run(overlapped=True)`` over a spilling tier while
    the train thread runs under a stream of its own: the row pipeline's
    thread prepares on that stream, so its fault-ins and victim reads
    stay ordered against the train thread's gathers and updates, and
    every run equals the run on the default stream bitwise (before the
    pipeline took the consumer's stream, about one run in ten
    differed)."""
    import numpy as np

    from dlrover_tpu_torch.ops.embedding import (
        DeviceSparseEmbedding,
        ShardedKvEmbedding,
    )
    from dlrover_tpu_torch.trainer.sparse import SparseTrainer

    def dense_step(w, rows, batch):
        rows = rows.detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        y = torch.as_tensor(batch, device=w.device)
        p = torch.sigmoid(rows @ wg)
        loss = -torch.mean(y * torch.log(p + 1e-7) + (1 - y) * torch.log(1 - p + 1e-7))
        gw, grows = torch.autograd.grad(loss, (wg, rows))
        return (w - 0.3 * gw).detach(), grows, {"loss": loss.item()}

    def stream():
        for s in range(12):
            r = np.random.default_rng(11 * 100_000 + s)
            ids = np.minimum(r.zipf(1.6, 4096), 50_000).astype(np.int64)
            yield ids, (ids % 2).astype(np.float32)

    def run():
        host = ShardedKvEmbedding(4, 128, num_slots=1, seed=0)
        emb = DeviceSparseEmbedding(host, capacity=1024, sparse_optimizer="adagrad",
                                    lr=0.1, devices="cuda")
        t = SparseTrainer(emb, torch.zeros(128, device="cuda"), dense_step)
        t.run(stream(), overlapped=True)
        emb.flush()
        torch.cuda.synchronize()
        assert emb.stats.spill_rows > 0
        st = host.export_state()
        emb.close()
        return st["rows"][np.argsort(st["keys"])]

    ref = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(6):
            assert np.array_equal(run(), ref)
    torch.cuda.current_stream().wait_stream(side)


def test_staged_bytes_equal_a_sync_snapshot_while_the_next_step_runs(dev, tmp_path, monkeypatch):
    """A staged save begun after step 1 lands in shm with step 1's bytes
    although step 2 (forward and backward beside the copies, then its
    optimizer behind the copy fence) updates the state in place
    meanwhile: equal to a synchronous snapshot of step 1, byte for
    byte."""
    import tempfile
    import uuid
    from dataclasses import replace

    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.ckpt.sharding import host_shard_records
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.models.convert import train_state_tree
    from dlrover_tpu_torch.models.train import build_train_step, init_state
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", tempfile.mkdtemp(prefix="dlr"))
    AsyncCheckpointSaver.reset()
    AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    engine = CheckpointEngine()
    try:
        cfg = replace(gpt2_small(), num_layers=2, model_dim=128, num_heads=2,
                      vocab_size=512, max_seq_len=128)
        tx = build_optimizer("adamw_8bit_flat", lr=1e-3, min_quantized_size=512)
        state = init_state(cfg, tx, seed=0, devices=dev)

        def fence():
            ev = engine.copy_fence()
            if ev is not None:
                torch.cuda.current_stream().wait_event(ev)

        step = build_train_step(cfg, tx, before_update=fence)
        g = torch.Generator(device=dev).manual_seed(0)
        x, y = (torch.randint(0, 512, (4, 128), generator=g, device=dev) for _ in range(2))
        state, _ = step(state, x, y)
        tree = train_state_tree(state)
        snap = {r.path: r.data.tobytes() for r in host_shard_records(tree)}
        stager = engine.begin_chunked_save(1, tree, str(tmp_path), chunk_bytes=1 << 20)
        assert stager.copy_done is not None
        state, _ = step(state, x, y)
        assert stager.commit()
        _, recs, _ = engine._shm.load_records(copy=True, verify=True)
        assert {r.path: r.data.tobytes() for r in recs} == snap
        after = {r.path: r.data.tobytes() for r in host_shard_records(train_state_tree(state))}
        assert after["params/embed/tokens"] != snap["params/embed/tokens"]  # step 2 updated
    finally:
        engine.close()
        AsyncCheckpointSaver.reset()
