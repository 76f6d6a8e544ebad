#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dlrover_tpu_torch``) on one card.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a torch.profiler window of 3 more training steps.)

1. device: the card's name, power limit and count; builds the CUDA
   kernels from the checkout's sources;
2. kernels: every hand-written kernel of the main path against its plain
   PyTorch version on the card, in bf16, at the main path's shapes (and
   the streaming contracts' shapes), with error, time, plain time,
   library time and the bound from shapes;
3. slice: ``ElasticTrainer(gpt2_small(), build_optimizer("adamw_8bit_flat"),
   ...).train(10)`` at batch 8 x seq 1024 with the launch counts reset
   just before, read just after; plus one small model's loss on the card
   against the plain CPU path from the same weights;
4. a ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line; any failure raises, and the script then
exits nonzero without the last line. It needs a CUDA card and the
repository around it; it imports nothing of JAX or of ``dlrover_tpu``.
Times are CUDA-event means over many launches after warm-up; the inputs
of the attention shapes (50 MB and up) are about the size of the 50 MB
L2 cache or larger, so launches find them mostly cold.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 non-tensor operations/s
HBM_BPS = 3.35e12
BF16_OPS = 989e12
F32_OPS = 67e12
# attention: in each 64-row tile (the kernels' tile), the largest error
# over that tile's rms in the plain f32 result (see ``tile_err``); set
# between the kernels' readings and the diagonal-tile bug probe's, with
# room to both (PERF.md gives the readings)
ATTN_TOL = 0.2
LSE_TOL = 1e-3  # absolute
ADAM_CODE_SHARE = 1e-3  # share of codes allowed to differ, by 1 at most
ADAM_SCALE_TOL = 1e-6  # relative to the largest scale
ADAM_DELTA_TOL = 1e-6  # relative to the largest |delta|


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def tile_err(got, ref, rows=64):
    """The largest, over 64-row tiles of ``[..., T, D]``, of a tile's
    max |got - ref| over the rms of the tile's reference values. A tile
    is scaled by its own values, so a wrong late tile (where o and dv are
    small) shows as much as a wrong early one; a row alone would not do,
    since a row of few visible keys may cancel to near zero. Tiles the
    mask leaves empty are floored at 1e-3 of the tensor's rms."""
    ref = ref.float()
    shape = ref.shape[:-2] + (ref.shape[-2] // rows, rows * ref.shape[-1])
    err = (got.float() - ref).abs().reshape(shape).amax(-1)
    rms = ref.reshape(shape).square().mean(-1).sqrt()
    floor = 1e-3 * ref.square().mean().sqrt()
    return (err / rms.clamp_min(floor)).max().item()


def visible_pairs(Tq, Tk, q_off, k_off):
    """(q, k) pairs a causal mask leaves visible for these offsets."""
    rows = q_off + np.arange(Tq) - k_off + 1
    return int(np.clip(rows, 0, Tk).sum())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def check_attention(torch, fa, label, B, H, Hkv, T, D, q_off=0, k_off=0,
                    timed=False, seed=0):
    """Kernels against the plain f32 result at one shape. ``timed`` (the
    main shape) also times them and reads the limit's power: the plain
    output with each query of the last tile missing its own key, a
    diagonal-tile bug, must fail ``ATTN_TOL``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((B, H, T, D), generator=g, device=dev, dtype=bf)
    k = torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=bf)
    v = torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=bf)
    do = torch.randn((B, H, T, D), generator=g, device=dev, dtype=bf)
    kw = dict(causal=True, q_offset=q_off, k_offset=k_off, layout="bhtd")
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()

    # plain f32 result on the same inputs (autograd through the
    # materialized reference), TF32 off
    qf, kf, vf = (x.float().transpose(1, 2).requires_grad_() for x in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_reference(
        qf, kf, vf, causal=True, q_offset=q_off, k_offset=k_off,
        return_residuals=True,
    )
    gq, gk, gv = torch.autograd.grad(o_ref, (qf, kf, vf), do.float().transpose(1, 2))
    refs = {
        "o": (o, o_ref.detach().transpose(1, 2)),
        "dq": (dq, gq.transpose(1, 2)),
        "dk": (dk, gk.transpose(1, 2)),
        "dv": (dv, gv.transpose(1, 2)),
    }
    tile, rel, abs_err = {}, {}, {}
    for name, (got, ref) in refs.items():
        diff = (got.float() - ref).abs().max().item()
        abs_err[name] = diff
        rel[name] = diff / max(ref.abs().max().item(), 1e-30)
        tile[name] = tile_err(got, ref)
    lse_err = (lse - lse_ref.detach()).abs().max().item()
    for x in (o, lse, dq, dk, dv):
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{label}: non-finite kernel output")
    ok = all(r <= ATTN_TOL for r in tile.values()) and lse_err <= LSE_TOL
    # rel_err (error over the tensor's largest |ref|) is shown, not gated
    res = dict(shape=[B, H, Hkv, T, D], offsets=[q_off, k_off],
               tile_err=tile, tol=ATTN_TOL, rel_err=rel,
               lse_abs_err=lse_err, lse_tol=LSE_TOL, ok=ok)
    if timed:
        last = q_off + T - 64
        o_bug = fa.flash_attention_reference(
            qf.detach(), kf.detach(), vf.detach(), q_offset=q_off,
            k_offset=k_off,
            mask_fn=lambda qp, kp: (qp >= kp) & ~((qp == kp) & (qp >= last)),
        )
        res["diag_bug_tile_err"] = tile_err(o_bug.transpose(1, 2), refs["o"][1])
        if res["diag_bug_tile_err"] <= ATTN_TOL:
            raise RuntimeError(f"{label}: ATTN_TOL would pass a diagonal-tile bug")
        del o_bug
    del qf, kf, vf, o_ref, lse_ref, gq, gk, gv, refs
    if timed:
        res.update(time_attention(torch, fa, q, k, v, o, lse, do, q_off, k_off))
    emit("kernel_check", label=label, **res)
    if not ok:
        raise RuntimeError(f"{label}: kernel disagrees with the plain version")
    return res, abs_err


def time_attention(torch, fa, q, k, v, o, lse, do, q_off, k_off):
    """Kernel, plain and library times at these inputs, and bounds."""
    import torch.nn.functional as F

    B, H, T, D = q.shape
    scale = D**-0.5
    pairs = visible_pairs(T, T, q_off, k_off) * B * H
    delta = (do.float() * o.float()).sum(-1)
    # the gradients' dtypes on the path: bf16, and dk/dv f32 per q head
    # under GQA
    gdt = torch.bfloat16 if k.shape[1] == H else torch.float32
    dk = torch.empty((B, H, T, D), dtype=gdt, device=q.device)
    dv, dq = torch.empty_like(dk), torch.empty_like(q)
    args = (q, k, v, do, lse, delta, scale, True, q_off, k_off)
    t = {
        "fa_fwd": time_ms(torch, lambda: fa._fwd_cuda(q, k, v, scale, True, q_off, k_off)),
        "fa_bwd_dkdv": time_ms(torch, lambda: fa._bwd_launch("fa_bwd_dkdv", (dk, dv), *args)),
        "fa_bwd_dq": time_ms(torch, lambda: fa._bwd_launch("fa_bwd_dq", (dq,), *args)),
    }
    qb, kb, vb = (x.transpose(1, 2) for x in (q, k, v))
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        qb, kb, vb, causal=True, q_offset=q_off, k_offset=k_off,
        return_residuals=True), iters=5)
    plain_bwd = time_ms(torch, lambda: fa._bwd_plain(
        q, k, v, do, lse, delta, scale, True, None, q_off, k_off), iters=5)
    lib_fwd = lib_bwd = None
    if q_off == k_off and k.shape[1] == H:
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True))
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
    bf, fl = 2, 4
    n_q, n_kv = q.numel(), k.numel()
    rows = B * H * T
    b_fwd = bound((n_q + 2 * n_kv + n_q) * bf + rows * fl, 4 * D * pairs, BF16_OPS)
    # inputs read once (q, k, v, do bf16; lse, delta f32), outputs
    # written once in the dtype the path writes
    b_dkdv = bound((n_q + 2 * n_kv + n_q) * bf + 2 * rows * fl
                   + 2 * dk.numel() * dk.element_size(), 8 * D * pairs, BF16_OPS)
    b_dq = bound((n_q + 2 * n_kv + n_q) * bf + 2 * rows * fl
                 + dq.numel() * dq.element_size(), 6 * D * pairs, BF16_OPS)
    return {
        "ms": t,
        "plain_ms": {"fa_fwd": plain_fwd, "fa_bwd_dkdv": plain_bwd, "fa_bwd_dq": plain_bwd},
        "library_ms": {"fa_fwd": lib_fwd, "fa_bwd_dkdv": lib_bwd, "fa_bwd_dq": lib_bwd},
        "bound": {"fa_fwd": b_fwd, "fa_bwd_dkdv": b_dkdv, "fa_bwd_dq": b_dq},
    }


# ---------------------------------------------------------------------------
# 8-bit AdamW
# ---------------------------------------------------------------------------
def check_adam8(torch, qo, cfg):
    from dlrover_tpu_torch.models.transformer import init_params

    dev = torch.device("cuda")
    model = init_params(torch.Generator().manual_seed(0), cfg, dev)
    leaves = model.jax_ordered_parameters()
    n_params = sum(p.numel() for p in leaves)
    layout = qo._flat_layout(leaves, 4096, 1 << 27)
    total = sum(g.total for g in layout.groups)
    g0 = layout.groups[0]
    R = g0.total // qo.BLOCK
    del model, leaves
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((R, qo.BLOCK), generator=gen, device=dev) * 1e-3
    m0 = torch.randn((R, qo.BLOCK), generator=gen, device=dev) * 1e-3
    v0 = torch.rand((R, qo.BLOCK), generator=gen, device=dev) * 1e-6

    def state():
        out = []
        for x, signed in ((m0, True), (v0, False)):
            c, s = qo._quant_block_math_wide(x, signed)
            out.append(qo.Quantized8(c, s.contiguous(), (R * qo.BLOCK,), signed))
        return out

    b1, b2 = 0.9, 0.999
    scalars = (3e-4 / (1 - b1**3), 1 / (1 - b2**3), 1e-8)
    scalars = tuple(float(torch.tensor(x, dtype=torch.float32)) for x in scalars)
    mk, vk = state()
    mp, vp = state()
    d_k = qo._adam8_update_triton(g, mk, vk, scalars, b1, b2, True)
    d_p = qo._adam8_update_plain(g, mp, vp, scalars, b1, b2, True)
    torch.cuda.synchronize()
    code_diff = torch.cat([(mk.codes.int() - mp.codes.int()).abs().view(-1),
                           (vk.codes.int() - vp.codes.int()).abs().view(-1)])
    share = (code_diff > 0).float().mean().item()
    max_code = code_diff.max().item()
    scale_err = max(
        ((a.scales - b.scales).abs().max() / b.scales.abs().max()).item()
        for a, b in ((mk, mp), (vk, vp))
    )
    delta_abs = (d_k - d_p).abs().max().item()
    delta_err = delta_abs / d_p.abs().max().item()
    ok = (max_code <= 1 and share <= ADAM_CODE_SHARE
          and scale_err <= ADAM_SCALE_TOL and delta_err <= ADAM_DELTA_TOL
          and bool(torch.isfinite(d_k).all()))
    ms = time_ms(torch, lambda: qo._adam8_update_triton(g, mk, vk, scalars, b1, b2, True))
    plain = time_ms(torch, lambda: qo._adam8_update_plain(g, mp, vp, scalars, b1, b2, True), iters=5)
    n = R * qo.BLOCK
    # g f32 read, 2x codes read+written, delta f32 written, 2x scales
    # read+written; ~45 f32 operations an element (dequantize, moments,
    # delta, requantize), off the tensor cores
    nbytes = n * (4 + 2 + 2 + 4) + 4 * R * 4
    b_ms, b_by = bound(nbytes, 45 * n, F32_OPS)
    res = dict(params=n_params, group_elems=n, groups=len(layout.groups),
               packed_total=total, code_mismatch_share=share,
               code_max_diff=max_code, code_share_tol=ADAM_CODE_SHARE,
               scale_rel_err=scale_err, scale_tol=ADAM_SCALE_TOL,
               delta_rel_err=delta_err, delta_tol=ADAM_DELTA_TOL,
               ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, ok=ok)
    emit("kernel_check", label="B6 adam8_flat gpt2_small group", **res)
    if not ok:
        raise RuntimeError("adam8_flat disagrees with the plain version")
    return res, delta_abs


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------
class RandomTokens:
    """Stand-in corpus (a copy of examples/train_gpt2.py's)."""

    def __init__(self, n=4096, seq=128, vocab=50257, seed=0):
        self.rng = np.random.default_rng(seed)
        self.data = self.rng.integers(0, vocab, (n, seq + 1), dtype=np.int32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        row = self.data[i]
        return {"x": row[:-1], "y": row[1:]}


def small_model_agrees(torch):
    """One small GPT-2-shaped model's loss on the card (kernels, bf16)
    against the plain CPU path from the same weights."""
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.models.transformer import init_params, loss_fn
    from dataclasses import replace

    cfg = replace(gpt2_small(), num_layers=2, model_dim=128, num_heads=2,
                  vocab_size=512, max_seq_len=128)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    data = RandomTokens(n=4, seq=128, vocab=512, seed=3).data.astype(np.int64)
    x, y = torch.from_numpy(data[:, :-1]), torch.from_numpy(data[:, 1:])
    with torch.no_grad():
        l_cpu = float(loss_fn(cpu, x, y, cfg))
        l_gpu = float(loss_fn(gpu, x.cuda(), y.cuda(), cfg))
    ok = abs(l_cpu - l_gpu) <= 2e-2 and math.isfinite(l_gpu)
    emit("small_model", loss_card=l_gpu, loss_cpu_plain=l_cpu, tol=2e-2, ok=ok)
    if not ok:
        raise RuntimeError("small model's loss on the card disagrees with the CPU")


def profile_steps(torch, trainer, start, step_ms, n=3):
    """``--profile``: n more steps under torch.profiler. Reads the raw
    device events (kernels, copies, sets; not the annotations, whose
    device spans cover kernels already counted): their summed time, the
    union of their intervals (the device's busy time), the busy share,
    the port's kernels' share and the top 15 by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(start + n)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(
                ("Optimizer.", "ProfilerStep")) or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        us, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + b - a, calls + 1)
    total = sum(b - a for a, b in spans)
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):  # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    ours = sum(us for k, (us, _) in by_name.items() if any(
        x in k for x in ("fa_fwd_kernel", "fa_bwd_dkdv_kernel", "fa_bwd_dq_kernel", "adam8_flat")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # the profiler slows the host, so the busy time is also set against
    # the unprofiled median step
    emit("profile", steps=n, wall_ms=wall_us / 1e3, events=len(spans),
         device_ms_per_step=total / 1e3 / n, busy_ms_per_step=busy / 1e3 / n,
         busy_share_profiled=busy / wall_us,
         busy_share_vs_unprofiled_step=busy / n / 1e3 / step_ms,
         port_kernels_share=ours / max(total, 1),
         top=[{"kernel": k[:90], "ms_per_step": us / 1e3 / n, "calls": c}
              for k, (us, c) in top])


def run_slice(torch, fa, qo, profile=False):
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    B, T, steps = 8, 1024, 10
    losses, stamps = [], []

    def hook(step, metrics):
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    trainer = ElasticTrainer(
        gpt2_small(), build_optimizer("adamw_8bit_flat", lr=3e-4),
        RandomTokens(seq=T), TrainerConfig(batch_size=B, seq_len=T),
        metrics_hook=hook,
    )
    groups = len(trainer.state.opt_state.opt.layout.groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train(steps)
    counts = {**fa.launch_counts, **qo.launch_counts}
    step_s = np.diff([t0] + stamps)[1:]  # the first step includes warm-up
    med = float(statistics.median(step_s))
    peak = torch.cuda.max_memory_allocated()
    L = gpt2_small().num_layers
    expect = {"fa_fwd": L * steps, "fa_bwd_dkdv": L * steps,
              "fa_bwd_dq": L * steps, "adam8_flat": groups * steps}
    ok = (
        len(losses) == steps
        and all(math.isfinite(x) for x in losses)
        and abs(losses[0] - math.log(50257)) <= 1.0
        and counts == expect
    )
    emit("slice", model="gpt2_small", batch=B, seq=T, steps=steps,
         losses=losses, launches=counts, expected_launches=expect,
         median_step_ms=med * 1e3, tokens_per_s=B * T / med,
         max_memory_allocated_bytes=peak, ok=ok)
    if not ok:
        raise RuntimeError("the slice's training run failed its checks")
    if profile:
        profile_steps(torch, trainer, steps, med * 1e3)
    trainer.close()
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.models import gpt2_small

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    _build.load_library("flash_attention")  # the one CUDA source
    emit("build", seconds=time.perf_counter() - t0, sources=list(_build.build_logs))
    for name, log in _build.build_logs.items():  # nvcc's register / spill report
        print(f"nvcc {name}.cu:\n{log}", flush=True)

    main_res, main_abs = check_attention(
        torch, fa, "B1/B2 gpt2_small", 8, 12, 12, 1024, 64, timed=True)
    check_attention(torch, fa, "B3-B5 llama2_7b width", 1, 32, 32, 4096, 128)
    check_attention(torch, fa, "B3-B5 GQA", 1, 32, 8, 2048, 128)
    # keys start 512 positions after the queries: whole tiles are
    # skipped and the queries before position 512 see no key at all
    check_attention(torch, fa, "B3-B5 k_offset", 2, 4, 4, 1024, 64, q_off=0, k_off=512)
    adam_res, adam_abs = check_adam8(torch, qo, gpt2_small())
    torch.cuda.empty_cache()

    small_model_agrees(torch)
    counts = run_slice(torch, fa, qo, profile="--profile" in sys.argv)

    src_fa = "dlrover_tpu_torch/ops/csrc/flash_attention.cu"
    fa_tpu = "dlrover_tpu/ops/flash_attention.py"
    kernels = []
    for name, replaces, also, errs in (
        ("fa_fwd", f"{fa_tpu}:273", [f"{fa_tpu}:77"], ("o",)),
        ("fa_bwd_dkdv", f"{fa_tpu}:337", [f"{fa_tpu}:585"], ("dk", "dv")),
        ("fa_bwd_dq", f"{fa_tpu}:337", [f"{fa_tpu}:508"], ("dq",)),
    ):
        b_ms, b_by = main_res["bound"][name]
        kernels.append(dict(
            name=name, route="cuda", source=src_fa, replaces=replaces,
            also_replaces=also, launches=counts[name],
            max_abs_err=max(main_abs[e] for e in errs),
            ms=main_res["ms"][name], plain_ms=main_res["plain_ms"][name],
            bound_ms=b_ms, bound_by=b_by,
            library_ms=main_res["library_ms"][name],
        ))
    kernels.append(dict(
        name="adam8_flat", route="triton",
        source="dlrover_tpu_torch/ops/quantized_optim.py",
        replaces="dlrover_tpu/ops/quantized_optim.py:403", also_replaces=[],
        launches=counts["adam8_flat"], max_abs_err=adam_abs,
        ms=adam_res["ms"], plain_ms=adam_res["plain_ms"],
        bound_ms=adam_res["bound_ms"], bound_by=adam_res["bound_by"],
        library_ms=None,
    ))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
