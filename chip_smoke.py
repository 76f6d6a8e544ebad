#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dlrover_tpu_torch``) on one card.

    python3 chip_smoke.py [--profile] [--phase flash_ckpt|evict]

(``--profile`` adds a torch.profiler window of a few more steps to the
per-leaf gpt2_small path and to the full-size sparse path; ``--phase
flash_ckpt`` builds the kernels and runs that phase alone, ``--phase
evict`` its uninterrupted run and the eviction drill alone, without the
contract's closing lines.)

1. device: the card's name, power limit and count; builds the CUDA
   kernels from the checkout's sources (one nvcc for each ``.cu``, and
   g++ for the embedding store's ``kv_store.cc``, all started together);
2. kernels: every hand-written kernel against its plain PyTorch version
   on the card, at the main paths' shapes (and the streaming attention
   contracts' shapes: Llama-2 width, GQA, a key offset, offsets that are
   no multiple of a tile, no mask), with error, time, plain time, library
   time, the bound from shapes, achieved TFLOP/s and the share of the
   bound; nvcc's register and spill report is printed and held to 0
   spill bytes and no serialized wgmma for the three attention kernels,
   and Triton's register and spill counts are printed beside the 8-bit
   AdamW's checks: attention in bf16, the 8-bit AdamW on a packed
   group (B6) and on gpt2_small's ``wte`` leaf (B7), the embedding row
   gather/scatter on a 4 GiB table (B8/B9, bitwise);
3. paths, each driven with the launch counts set to 0 just before it and
   read just after:
   - ``ElasticTrainer(gpt2_small(), build_optimizer("adamw_8bit_flat"),
     ...).train(10)`` at batch 8 x seq 1024, plus one small model's loss
     on the card against the plain CPU path from the same weights; then
     3 steps and 3 under torch.profiler, the goodput ledger's
     ``productive_compute`` a step against the profiled device time
     (``ledger_vs_profile``);
   - the same with the per-leaf ``build_optimizer("adamw_8bit")``, its
     losses held to the flat run's;
   - ``SparseTrainer(DeviceSparseEmbedding(ShardedKvEmbedding(8, 128),
     hbm_budget_bytes=4 << 30), ...).run(stream, overlapped=True)``: 60
     steps of 65,536 ids, zipf 1.1 over 10,000,000 ids;
   - a small tier that spills (1,024 rows, bench.py's zipf 1.6 stream),
     its flushed host state held to the same run on the CPU and to a
     second run on the card;
   - ``flash_ckpt``: Flash Checkpoint under ``ElasticTrainer`` on
     gpt2_small (``examples/train_gpt2_torch.py`` workers): an
     uninterrupted run twice beside a saver in this process; then the
     port's launcher (``python -m dlrover_tpu_torch.trainer.run``: its
     own master, the agent hosting the saver), whose worker is killed
     after step 9 and relaunched by the agent from its shm; a launcher
     whose whole process group is killed after step 10, and a fresh
     launcher resuming from disk; every resumed loss held to the
     uninterrupted losses bit for bit, the launch counts of every
     worker, and no CUDA context in the launcher or the master (a
     ``launcher`` line gives their timings, the step and goodput report
     the master last received); the second uninterrupted run takes a
     ``profile`` and a ``flight_dump`` command through its
     worker-commands file (a ``commands`` line: the capture's Chrome
     trace names the path's kernels, the bundle holds spans and the
     registry); E, a launcher whose worker gets SIGTERM after step 7
     and drains within ``DLROVER_TPU_EVICTION_DEADLINE_S`` (shm save of
     step 7, its disk persist, a flight bundle, the notice at the
     master), and R, a fresh launcher of E's job whose
     ``--network-check`` runs ``gpu_check`` on the card (the first NCCL
     communicator, at world size 1) before its worker resumes step 7 (an
     ``eviction`` line); then the staging routes timed against each
     other, and gpt2_xl's state when ``/dev/shm`` holds it;
4. a ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line; any failure raises, and the script then
exits nonzero without the last line. It needs a CUDA card and the
repository around it; it imports nothing of JAX or of ``dlrover_tpu``.
Times are CUDA-event means over many launches after warm-up (for the
embedding row kernels and the two small attention shapes, which run for
tens of µs, over a replayed CUDA graph, so the wrapper's host time drops
out); the inputs of the
attention shapes (50 MB and up) are about the size of the 50 MB L2
cache or larger, so launches find them mostly cold.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import re
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
LOSS_MATCH_RTOL = 1e-4  # per step, adamw_8bit against adamw_8bit_flat
SPILL_STATE_TOL = 1e-5  # card vs CPU host state, of its largest |value|
FIRST_LOSS_TOL = 1e-3  # the sparse slice's first loss against ln 2


T0 = time.perf_counter()


def emit(phase, **kv):
    """One phase's JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **kv, "t_s": time.perf_counter() - T0}), flush=True)


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


def graph_ms(torch, fn, iters=20):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed and timed. For kernels that run for tens of µs, the
    Python wrapper's own time a call (checks, allocation, the ctypes
    launch) is of the same size, so ``time_ms`` would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    prev = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except BaseException:
        # a capture that fails in capture_end leaves the capture stream
        # current on this thread: restore the stream, or every later
        # launch of this thread runs on a stream other threads' work is
        # not ordered against
        torch.cuda.set_stream(prev)
        raise
    ms = time_ms(torch, graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


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


def visible_pairs(Tq, Tk, q_off, k_off, causal=True):
    """(q, k) pairs the mask leaves visible for these offsets."""
    if not causal:
        return Tq * Tk
    rows = q_off + np.arange(Tq) - k_off + 1
    return int(np.clip(rows, 0, Tk).sum())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def check_attention(torch, fa, label, B, H, Hkv, T, D, q_off=0, k_off=0,
                    causal=True, probe=False, graph=False, seed=0):
    """Kernels against the plain f32 result at one shape, then their
    times (``graph``: from a replayed CUDA graph, for shapes whose kernels
    run for tens of µs). ``probe`` (the main shape) also reads the limit's
    power: the plain output with each query of the last tile missing its
    own key, a diagonal-tile bug, must fail ``ATTN_TOL``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((B, H, T, D), generator=g, device=dev, dtype=bf)
    k = torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=bf)
    v = torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=bf)
    do = torch.randn((B, H, T, D), generator=g, device=dev, dtype=bf)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, layout="bhtd")
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()

    # plain f32 result on the same inputs (autograd through the
    # materialized reference), TF32 off
    qf, kf, vf = (x.float().transpose(1, 2).requires_grad_() for x in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_reference(
        qf, kf, vf, causal=causal, q_offset=q_off, k_offset=k_off,
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
    res = dict(shape=[B, H, Hkv, T, D], offsets=[q_off, k_off], causal=causal,
               tile_err=tile, tol=ATTN_TOL, rel_err=rel,
               lse_abs_err=lse_err, lse_tol=LSE_TOL, ok=ok)
    if probe:
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
    res.update(time_attention(torch, fa, q, k, v, o, lse, do, q_off, k_off, causal, graph))
    if probe:  # every SDPA backend once at the main shape (fwd, bwd ms)
        res["library_by_backend"] = {
            name: time_sdpa(torch, q, k, v, do, (name,))[:2]
            for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")}
    emit("kernel_check", label=label, **res)
    if not ok:
        raise RuntimeError(f"{label}: kernel disagrees with the plain version")
    return res, abs_err


def time_attention(torch, fa, q, k, v, o, lse, do, q_off, k_off, causal, graph):
    """Kernel, plain and library times at these inputs, the bounds, and
    from them each kernel's achieved TFLOP/s and share of its bound."""
    B, H, T, D = q.shape
    scale = D**-0.5
    pairs = visible_pairs(T, T, q_off, k_off, causal) * B * H
    delta = (do.float() * o.float()).sum(-1)
    # the gradients' dtypes on the path: bf16, and dk/dv f32 per q head
    # under GQA
    gdt = torch.bfloat16 if k.shape[1] == H else torch.float32
    dk = torch.empty((B, H, T, D), dtype=gdt, device=q.device)
    dv, dq = torch.empty_like(dk), torch.empty_like(q)
    args = (q, k, v, do, lse, delta, scale, causal, q_off, k_off)
    timer = graph_ms if graph else time_ms
    t = {
        "fa_fwd": timer(torch, lambda: fa._fwd_cuda(q, k, v, scale, causal, q_off, k_off)),
        "fa_bwd_dkdv": timer(torch, lambda: fa._bwd_launch("fa_bwd_dkdv", (dk, dv), *args)),
        "fa_bwd_dq": timer(torch, lambda: fa._bwd_launch("fa_bwd_dq", (dq,), *args)),
    }
    qb, kb, vb = (x.transpose(1, 2) for x in (q, k, v))
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        qb, kb, vb, causal=causal, q_offset=q_off, k_offset=k_off,
        return_residuals=True), iters=5)
    plain_bwd = time_ms(torch, lambda: fa._bwd_plain(
        q, k, v, do, lse, delta, scale, causal, None, q_off, k_off), iters=5)
    mask = None
    if causal and q_off != k_off:
        # SDPA has no offsets: the same function is one call with a
        # boolean mask, which its flash backend does not take
        pos = torch.arange(T, device=q.device)
        mask = (q_off + pos)[:, None] >= (k_off + pos)[None, :]
    lib_fwd, lib_bwd, lib_backend, lib_timed = time_sdpa(
        torch, q, k, v, do, causal=causal, mask=mask, timer=timer,
        backends=("EFFICIENT_ATTENTION", "MATH") if mask is not None
        else ("FLASH_ATTENTION", "EFFICIENT_ATTENTION"))
    bf, fl = 2, 4
    n_q, n_kv = q.numel(), k.numel()
    rows = B * H * T
    # inputs read once (q, k, v, do bf16; lse, delta f32), outputs
    # written once in the dtype the path writes
    work = {
        "fa_fwd": ((n_q + 2 * n_kv + n_q) * bf + rows * fl, 4 * D * pairs),
        "fa_bwd_dkdv": ((n_q + 2 * n_kv + n_q) * bf + 2 * rows * fl
                        + 2 * dk.numel() * dk.element_size(), 8 * D * pairs),
        "fa_bwd_dq": ((n_q + 2 * n_kv + n_q) * bf + 2 * rows * fl
                      + dq.numel() * dq.element_size(), 6 * D * pairs),
    }
    bounds = {name: bound(nbytes, ops, BF16_OPS) for name, (nbytes, ops) in work.items()}
    return {
        "ms": t,
        "timed": "cuda graph replay" if graph else "eager launches",
        "plain_ms": {"fa_fwd": plain_fwd, "fa_bwd_dkdv": plain_bwd, "fa_bwd_dq": plain_bwd},
        "library_ms": {"fa_fwd": lib_fwd, "fa_bwd_dkdv": lib_bwd, "fa_bwd_dq": lib_bwd},
        "library_backend": lib_backend,
        "library_timed": lib_timed,
        "bound": bounds,
        "tflops": {name: work[name][1] / (ms * 1e-3) / 1e12 for name, ms in t.items()},
        "bound_share": {name: bounds[name][0] / ms for name, ms in t.items()},
    }


def time_sdpa(torch, q, k, v, do, backends=("FLASH_ATTENTION", "EFFICIENT_ATTENTION"),
              causal=True, mask=None, timer=time_ms):
    """``scaled_dot_product_attention`` forward and its autograd backward
    (dq, dk, dv together), pinned to one named backend (the first of
    ``backends`` that takes the shape; GQA through ``enable_gqa``), so the
    column times one kernel and not whichever SDPA picks. With a boolean
    ``mask`` (the offsets' causal mask) the call takes it in place of
    ``is_causal``. Where the library's call cannot be captured into a CUDA
    graph (``timer=graph_ms``), it is timed eagerly, and the result says
    so: it is a yardstick only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gqa = k.shape[1] != q.shape[1]
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    how = ["eager launches" if timer is time_ms else "cuda graph replay"]

    def timed(fn):
        if timer is not time_ms:
            try:
                return timer(torch, fn)
            except RuntimeError as e:
                torch.cuda.synchronize()
                how[0] = f"eager launches (capture refused: {str(e)[:80]})"
        return time_ms(torch, fn)

    for backend in (getattr(SDPBackend, name) for name in backends):
        try:
            with sdpa_kernel(backend):
                def fwd():
                    return F.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=gqa)
                out = fwd()
                lib_fwd = timed(fwd)
                lib_bwd = timed(lambda: torch.autograd.grad(
                    out, (ql, kl, vl), do, retain_graph=True))
            return lib_fwd, lib_bwd, backend.name, how[0]
        except RuntimeError as e:  # this backend does not take the shape
            emit("sdpa_backend_refused", backend=backend.name, error=str(e)[:200])
    return None, None, None, None


# ---------------------------------------------------------------------------
# 8-bit AdamW
# ---------------------------------------------------------------------------
def adam8_contract(torch, qo, label, R, quant, counter, seed, **info):
    """The Triton kernel against its plain version on R rows of random
    8-bit moments, quantized by ``quant`` into the contract's scale
    layout, under the ``ADAM_*`` limits; then both timed. Returns the
    result dict and the max |delta| error."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((R, qo.BLOCK), generator=gen, device=dev) * 1e-3
    m0 = torch.randn((R, qo.BLOCK), generator=gen, device=dev) * 1e-3
    v0 = torch.rand((R, qo.BLOCK), generator=gen, device=dev) * 1e-6

    def state():
        return [qo.Quantized8(*quant(x, signed), (R * qo.BLOCK,), signed)
                for x, signed in ((m0, True), (v0, False))]

    b1, b2 = 0.9, 0.999
    scalars = (3e-4 / (1 - b1**3), 1 / (1 - b2**3), 1e-8)
    scalars = tuple(float(torch.tensor(x, dtype=torch.float32)) for x in scalars)
    mk, vk = state()
    mp, vp = state()

    def kernel():
        return qo._adam8_update_triton(g, mk, vk, scalars, b1, b2, True, counter=counter)

    d_k = kernel()
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
    ms = time_ms(torch, kernel)
    plain = time_ms(torch, lambda: qo._adam8_update_plain(g, mp, vp, scalars, b1, b2, True), iters=5)
    n = R * qo.BLOCK
    # g f32 read, 2x codes read+written, delta f32 written, 2x scales
    # read+written; ~60 f32 operations an element, off the tensor cores:
    # two dequantizations (a multiply, two fma, a square, the scale), the
    # moments, the delta's square root and division (IEEE, each a short
    # sequence), two requantizations (an approximate square root, a
    # multiply, rint, sign, clamp) and the row maxima
    nbytes = n * (4 + 2 + 2 + 4) + 4 * R * 4
    b_ms, b_by = bound(nbytes, 60 * n, F32_OPS)
    res = dict(**info, **qo.triton_kernel_info(counter), code_mismatch_share=share,
               code_max_diff=max_code, code_share_tol=ADAM_CODE_SHARE,
               scale_rel_err=scale_err, scale_tol=ADAM_SCALE_TOL,
               delta_rel_err=delta_err, delta_tol=ADAM_DELTA_TOL,
               ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, ok=ok)
    emit("kernel_check", label=label, **res)
    if not ok:
        raise RuntimeError(f"{label}: the kernel disagrees with the plain version")
    return res, delta_abs


def check_adam8(torch, qo, cfg):
    """B6: gpt2_small's packed group, wide ``[R//128, 128]`` scales."""
    from dlrover_tpu_torch.models.transformer import init_params

    model = init_params(torch.Generator().manual_seed(0), cfg, torch.device("cuda"))
    leaves = model.jax_ordered_parameters()
    n_params = sum(p.numel() for p in leaves)
    layout = qo._flat_layout(leaves, 4096, 1 << 27)
    total = sum(g.total for g in layout.groups)
    R = layout.groups[0].total // qo.BLOCK
    del model, leaves

    def wide(x, signed):
        c, s = qo._quant_block_math_wide(x, signed)
        return c, s.contiguous()

    return adam8_contract(
        torch, qo, "B6 adam8_flat gpt2_small group", R, wide, "adam8_flat", 1,
        params=n_params, group_elems=R * qo.BLOCK, groups=len(layout.groups),
        packed_total=total)


def check_adam8_leaf(torch, qo, cfg):
    """B7, the per-leaf route, on gpt2_small's ``wte`` leaf: 50257 x 768
    = 301,542 rows of 128, no multiple of the 8-row tile, with ``[R]``
    scales."""
    R = cfg.vocab_size * cfg.model_dim // qo.BLOCK

    def per_row(x, signed):
        c, s = qo._sqrt_map_quant(x, signed, 127.0)
        return c.to(torch.int8), s.view(R).contiguous()

    return adam8_contract(
        torch, qo, "B7 adam8_leaf gpt2_small wte", R, per_row, "adam8_leaf", 2,
        rows=R, tile_rows=qo._TILE_ROWS, tail_rows=R % qo._TILE_ROWS)


# ---------------------------------------------------------------------------
# embedding rows (B8 / B9)
# ---------------------------------------------------------------------------
def check_embedding_rows(torch, er):
    """``emb_gather`` / ``emb_scatter`` on the sparse slice's 4 GiB table
    ([4,194,305, 256] f32: 4,194,304 rows of dim 128 + one adagrad slot,
    and the scratch row) with n = 32,768 sorted unique slots spread over
    it (the bucket of the slice's ~17k unique ids a step), against their
    plain versions, BITWISE; then a padded call whose last 15,000 entries
    all name the scratch row with identical values. Times: CUDA events
    around a replayed CUDA graph (``graph_ms``); library:
    ``torch.index_select`` / ``Tensor.index_copy_``."""
    dev = torch.device("cuda")
    cap, rf, n = 4 << 20, 256, 32768
    gen = torch.Generator(device=dev).manual_seed(4)
    table = torch.randn((cap + 1, rf), generator=gen, device=dev)
    slots = torch.randperm(cap, generator=gen, device=dev)[:n].sort().values.int()
    rows = torch.randn((n, rf), generator=gen, device=dev)
    padded = slots.clone()
    padded[n - 15000:] = cap
    prow = rows.clone()
    prow[n - 15000:] = rows[n - 15000]
    sl = slots.long()
    got = er.emb_gather(table, slots)
    gather_eq = torch.equal(got, er.gather_plain(table, slots))
    pad_gather_eq = torch.equal(er.emb_gather(table, padded), er.gather_plain(table, padded))
    ref = er.scatter_plain(table.clone(), slots, rows)
    er.emb_scatter_(table, slots, rows)
    scatter_eq = torch.equal(table, ref)
    ref = er.scatter_plain(ref, padded, prow)
    er.emb_scatter_(table, padded, prow)
    pad_scatter_eq = torch.equal(table, ref)
    torch.cuda.synchronize()
    del ref, got
    ok = gather_eq and pad_gather_eq and scatter_eq and pad_scatter_eq
    nbytes = 2 * n * rf * 4 + n * 4  # rows read once + written once, slots
    b_ms, b_by = bound(nbytes, 0, F32_OPS)
    out = torch.empty((n, rf), device=dev)
    fns = {
        "emb_gather": (lambda: er.emb_gather(table, slots),
                       lambda: er.gather_plain(table, slots),
                       lambda: torch.index_select(table, 0, sl, out=out)),
        "emb_scatter": (lambda: er.emb_scatter_(table, slots, rows),
                        lambda: er.scatter_plain(table, slots, rows),
                        lambda: table.index_copy_(0, sl, rows)),
    }
    # device times from graph replay; the eager times (one call after
    # another, host overhead included) beside them
    t = {name: dict(ms=graph_ms(torch, k), plain_ms=graph_ms(torch, p),
                    library_ms=graph_ms(torch, lib), bound_ms=b_ms, bound_by=b_by,
                    eager_ms=[time_ms(torch, f) for f in (k, p, lib)])
         for name, (k, p, lib) in fns.items()}
    emit("kernel_check", label="B8/B9 emb rows, 4 GiB table", table=[cap + 1, rf], n=n,
         gather_bitwise=gather_eq, padded_gather_bitwise=pad_gather_eq,
         scatter_bitwise=scatter_eq, padded_scatter_bitwise=pad_scatter_eq,
         bound_bytes=nbytes, times=t, ok=ok)
    if not ok:
        raise RuntimeError("an embedding row kernel differs from its plain version")
    del table, rows, prow, out
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------
# the dense paths
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


PORT_KERNELS = ("fa_fwd_kernel", "fa_bwd_dkdv_kernel", "fa_bwd_dq_kernel",
                "adam8_flat", "emb_gather_kernel", "emb_scatter_kernel")


def profile_steps(torch, label, run_steps, step_ms, n):
    """``--profile``: ``run_steps()`` (n more steps) under torch.profiler.
    Reads the raw device events (kernels, copies, sets; not the
    annotations, whose device spans cover kernels already counted): their
    summed time, the union of their intervals (the device's busy time),
    the busy share, the port's kernels' share, each of them by name, and
    the top 15 of all kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps()
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
    # host spans the code marks with record_function (e.g. the sparse
    # tier's prepare legs), summed per name
    notes = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and getattr(e, "is_user_annotation", False):
            notes[e.name] = notes.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):  # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    port = {k: v for k, v in by_name.items() if any(x in k for x in PORT_KERNELS)}
    ours = sum(us for us, _ in port.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # the profiler slows the host, so the busy time is also set against
    # the unprofiled median step
    res = dict(label=label, steps=n, wall_ms=wall_us / 1e3, events=len(spans),
         device_ms_per_step=total / 1e3 / n, busy_ms_per_step=busy / 1e3 / n,
         # first device event to last, a step: the device's span of the
         # window, its idle gaps included
         span_ms_per_step=(max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3 / n
         if spans else None,
         busy_share_profiled=busy / wall_us,
         busy_share_vs_unprofiled_step=busy / n / 1e3 / step_ms,
         port_kernels_share=ours / max(total, 1),
         port_kernels={k.split("(")[0][:60]: {"ms_per_step": us / 1e3 / n, "calls": c}
                       for k, (us, c) in port.items()},
         host_spans_ms_per_step={k: v / 1e3 / n for k, v in notes.items()},
         top=[{"kernel": k[:90], "ms_per_step": us / 1e3 / n, "calls": c}
              for k, (us, c) in top])
    emit("profile", **res)
    return res


def ledger_vs_profile(torch, trainer, done, step_ms, n=3):
    """How far the goodput ledger's ``productive_compute`` a step is from
    the profiled device time a step. The trainer books ``compute`` from
    two CUDA events around each step (no per-step host sync), so the
    windows here run without the slice's per-step hook: ``n`` steps
    unprofiled, then ``n`` under torch.profiler (``profile_steps``), the
    ledger read around each."""
    trainer._metrics_hook = None

    def booked():
        return trainer._goodput.snapshot().seconds["productive_compute"]

    torch.cuda.synchronize()
    c0, t0 = booked(), time.perf_counter()
    trainer.train(done + n)  # ends in a synchronize; books every step
    c1, t1 = booked(), time.perf_counter()
    prof = profile_steps(torch, "gpt2_small adamw_8bit_flat",
                         lambda: trainer.train(done + 2 * n), step_ms, n)
    c2 = booked()
    ledger, ledger_prof = (c1 - c0) / n * 1e3, (c2 - c1) / n * 1e3
    rep = trainer._goodput.snapshot()
    emit("ledger_vs_profile", steps=n, card=card_line(),
         ledger_compute_ms_per_step=ledger, wall_ms_per_step=(t1 - t0) / n * 1e3,
         ledger_compute_ms_per_step_profiled=ledger_prof,
         profile_busy_ms_per_step=prof["busy_ms_per_step"],
         profile_device_ms_per_step=prof["device_ms_per_step"],
         profile_span_ms_per_step=prof["span_ms_per_step"],
         ledger_over_busy=ledger / prof["busy_ms_per_step"],
         ledger_profiled_over_span=ledger_prof / prof["span_ms_per_step"],
         goodput=rep.as_dict(), ok=rep.closure_error_pct <= CLOSURE_GATE_PCT and ledger > 0)
    if not (rep.closure_error_pct <= CLOSURE_GATE_PCT and ledger > 0):
        raise RuntimeError("the slice's goodput ledger booked no compute or does not close")


def run_slice(torch, fa, qo, opt="adamw_8bit_flat", profile=False):
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
        gpt2_small(), build_optimizer(opt, lr=3e-4),
        RandomTokens(seq=T), TrainerConfig(batch_size=B, seq_len=T),
        metrics_hook=hook,
    )
    inner = trainer.state.opt_state.opt
    if opt == "adamw_8bit_flat":  # one launch a packed group a step
        expect_opt = {"adam8_flat": len(inner.layout.groups) * steps, "adam8_leaf": 0}
    else:  # one launch a quantized leaf a step
        big = sum(isinstance(m, qo.Quantized8) for m in inner.adam_state.mu)
        expect_opt = {"adam8_flat": 0, "adam8_leaf": big * steps}
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
              "fa_bwd_dq": L * steps, **expect_opt}
    ok = (
        len(losses) == steps
        and all(math.isfinite(x) for x in losses)
        and abs(losses[0] - math.log(50257)) <= 1.0
        and counts == expect
    )
    emit("slice", model="gpt2_small", optimizer=opt, batch=B, seq=T, steps=steps,
         losses=losses, launches=counts, expected_launches=expect,
         median_step_ms=med * 1e3, tokens_per_s=B * T / med,
         max_memory_allocated_bytes=peak, ok=ok)
    if not ok:
        raise RuntimeError("the slice's training run failed its checks")
    if opt == "adamw_8bit_flat":
        ledger_vs_profile(torch, trainer, steps, med * 1e3)
    elif profile:
        profile_steps(torch, f"gpt2_small {opt}", lambda: trainer.train(steps + 3),
                      med * 1e3, 3)
    trainer.close()
    del trainer, inner
    torch.cuda.empty_cache()
    return counts, losses[:steps]  # not the profiled steps' losses


# ---------------------------------------------------------------------------
# the sparse paths
# ---------------------------------------------------------------------------
def logistic_dense_step(torch, lr=0.3, stamps=None):
    """The logistic head of examples/train_sparse_torch.py (a copy):
    ``p = sigmoid(rows @ w)``, binary cross-entropy, SGD on ``w``; returns
    the row gradients for the sparse update. ``stamps`` gets the host
    clock after each step's loss reached the host."""

    def dense_step(w, rows, batch):
        rows = rows.to(w.device).detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        y = torch.as_tensor(batch, device=w.device)
        p = torch.sigmoid(rows @ wg)
        loss = -torch.mean(y * torch.log(p + 1e-7) + (1 - y) * torch.log(1 - p + 1e-7))
        gw, grows = torch.autograd.grad(loss, (wg, rows))
        metrics = {"loss": loss.item()}
        if stamps is not None:
            stamps.append(time.perf_counter())
        return (w - lr * gw).detach(), grows, metrics

    return dense_step


def run_sparse_full(torch, er, profile=False):
    """The sparse slice at the size a recommender job gives one card: a
    4 GiB hot tier (4,194,304 rows of dim 128 + one adagrad slot), 60
    steps of 65,536 ids (the MLPerf DLRM-DCNv2 global batch), zipf 1.1
    over 10,000,000 ids from seed 0, labels ``ids % 2``. The tier holds
    every id this stream brings (476,896), so nothing is evicted."""
    from dlrover_tpu_torch.ops.embedding import (
        DeviceSparseEmbedding, ShardedKvEmbedding,
    )
    from dlrover_tpu_torch.trainer.sparse import SparseTrainer

    steps, n_ids, vocab = 60, 65536, 10_000_000
    rng = np.random.default_rng(0)
    stream = [np.minimum(rng.zipf(1.1, n_ids), vocab).astype(np.int64) for _ in range(steps)]
    extra = [np.minimum(rng.zipf(1.1, n_ids), vocab).astype(np.int64) for _ in range(5)]
    data = [(ids, (ids % 2).astype(np.float32)) for ids in stream]
    distinct = int(len(np.unique(np.concatenate(stream))))
    host = ShardedKvEmbedding(8, 128, num_slots=1, seed=0)
    emb = DeviceSparseEmbedding(host, hbm_budget_bytes=4 << 30,
                                sparse_optimizer="adagrad", lr=0.05)
    stamps = []
    trainer = SparseTrainer(emb, torch.zeros(128, device=emb.device),
                            logistic_dense_step(torch, stamps=stamps))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    er.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [m["loss"] for m in trainer.run(iter(data), overlapped=True)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(er.launch_counts)
    st = emb.stats
    expect = {"emb_gather": 2 * steps + st.scatter_drains,
              "emb_scatter": steps + st.fault_batches}
    step_s = np.diff(stamps)  # the first step includes the first prepare
    med = float(statistics.median(step_s))
    ok = (
        len(losses) == steps
        and all(math.isfinite(x) for x in losses)
        and abs(losses[0] - math.log(2)) <= FIRST_LOSS_TOL
        and float(np.mean(losses[-10:])) < losses[0]
        and st.faults == len(emb.hot) == distinct
        and st.spill_rows == 0
        and counts == expect
    )
    emit("sparse_slice", table_rows=emb.hot.capacity, row_floats=emb.hot.row_floats,
         steps=steps, ids_per_step=n_ids, distinct_ids=distinct,
         first_loss=losses[0], first_loss_tol=FIRST_LOSS_TOL,
         mean_last10_loss=float(np.mean(losses[-10:])), losses=losses,
         faults=st.faults, fault_batches=st.fault_batches, resident=len(emb.hot),
         hit_pct=st.hit_pct, unique_ids_per_step=st.unique_ids / max(st.gathers, 1),
         launches=counts, expected_launches=expect,
         median_step_ms=med * 1e3, ids_per_s=n_ids / med, wall_s=wall,
         pipeline=trainer.pipeline_stats,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), ok=ok)
    if not ok:
        emb.close()
        raise RuntimeError("the sparse slice failed its checks")
    if profile:
        # 5 more steps, on ids the run has not seen, with prepare inline:
        # the profiler records only the host spans of the thread that
        # started it, not the row pipeline's
        profile_steps(torch, "sparse slice, prepare inline", lambda: trainer.run(
            iter([(ids, (ids % 2).astype(np.float32)) for ids in extra]), overlapped=False),
            med * 1e3, len(extra))
    emb.close()
    del trainer, emb, host
    torch.cuda.empty_cache()
    return counts


def run_sparse_spill(torch):
    """A tier that spills: 1,024 rows against bench.py's stream (zipf 1.6
    over 50,000 ids, 4,096 ids a step, seeded per step), 20 steps, 1,587
    distinct ids. After ``flush()`` the host state must equal the same
    run of a tier on the CPU (its plain path) within ``SPILL_STATE_TOL``
    of its largest value, and a second run on the card bitwise. The
    logistic head runs on the card in all three runs, so the comparison
    sees only the tier: on the CPU its matmul rounds by the host's
    thread count, which moves the CPU run's final state."""
    from dlrover_tpu_torch.ops.embedding import (
        DeviceSparseEmbedding, ShardedKvEmbedding,
    )
    from dlrover_tpu_torch.trainer.sparse import SparseTrainer

    def stream():
        for s in range(20):
            r = np.random.default_rng(11 * 100_000 + s)
            ids = np.minimum(r.zipf(1.6, 4096), 50_000).astype(np.int64)
            yield ids, (ids % 2).astype(np.float32)

    def run(devices):
        host = ShardedKvEmbedding(4, 128, num_slots=1, seed=0)
        emb = DeviceSparseEmbedding(host, capacity=1024, sparse_optimizer="adagrad",
                                    lr=0.1, devices=devices)
        trainer = SparseTrainer(emb, torch.zeros(128, device="cuda"),
                                logistic_dense_step(torch))
        t0 = time.perf_counter()
        losses = [m["loss"] for m in trainer.run(stream(), overlapped=True)]
        emb.flush()
        wall = time.perf_counter() - t0
        state = host.export_state()
        order = np.argsort(state["keys"])
        spills = emb.stats.spill_rows
        emb.close()
        return state["keys"][order], state["rows"][order], losses, spills, wall

    k1, r1, l1, s1, w1 = run("cuda")
    k2, r2, _, s2, _ = run("cuda")
    k0, r0, l0, _, w0 = run("cpu")
    bitwise = bool(np.array_equal(k1, k2) and np.array_equal(r1, r2))
    same_keys = bool(np.array_equal(k0, k1))
    err = float(np.abs(r1 - r0).max() / np.abs(r0).max()) if same_keys else math.inf
    rows_off = int((r1 != r0).any(axis=1).sum()) if same_keys else -1
    ok = s1 > 0 and s2 > 0 and bitwise and same_keys and err <= SPILL_STATE_TOL
    res = dict(capacity=1024, steps=20, rows=len(k1), spill_rows=[s1, s2],
               card_repeat_bitwise=bitwise, same_keys=same_keys, cpu_rel_err=err,
               cpu_rows_not_bitwise=rows_off, tol=SPILL_STATE_TOL)
    emit("sparse_spill", **res, losses_card=l1[::5], losses_cpu=l0[::5],
         wall_s_card=w1, wall_s_cpu=w0, ok=ok)
    if not ok:
        raise RuntimeError(f"the spilling tier disagrees with the CPU or with itself: {res}")


# ---------------------------------------------------------------------------
# flash checkpoint
# ---------------------------------------------------------------------------
REPO = os.path.dirname(os.path.abspath(__file__))
CKPT_WORKER = os.path.join(REPO, "examples", "train_gpt2_torch.py")
CKPT_RUN = ["--model", "gpt2_small", "--steps", "12", "--batch", "8", "--seq", "1024",
            "--prefetch", "2", "--save-memory-interval", "4", "--save-storage-interval", "6",
            "--log-interval", "3"]
LOGGED_STEPS = (3, 6, 9, 12)  # the trainer's log cadence in CKPT_RUN
EVICT_AFTER_STEP = 7  # E's SIGTERM lands after this step (no save step)
EVICT_GRACE_S = 10.0  # DLROVER_TPU_EVICTION_DEADLINE_S of E
AGENT_KILL_S = 15.0  # the agent's SIGTERM-to-SIGKILL window (_stop_workers)
CLOSURE_GATE_PCT = 1.0  # a goodput report's partition closes to this
XL_SHM_BYTES = 24e9  # /dev/shm needed to also time gpt2_xl's state


def read_procs(ev_path):
    """The worker processes that appended to one events file (a launcher
    run's relaunched worker appends to its predecessor's), each one's
    events summarized."""
    evs = []
    if os.path.exists(ev_path):
        with open(ev_path) as f:
            evs = [json.loads(line) for line in f]
    procs = []
    for e in evs:
        if e["event"] == "start":
            procs.append([])
        if procs:
            procs[-1].append(e)

    def summary(pe):
        def last(kind, default=None):
            return next((e for e in reversed(pe) if e["event"] == kind), default)

        start = pe[0]
        loss_ev = [e for e in pe if e["event"] == "loss"]
        return dict(
            pid=start["pid"], restart=start.get("restart", 0), t0=start.get("t0"),
            import_s=start.get("import_s"),
            losses={e["step"]: e["loss"] for e in loss_ev},
            loss_t={e["step"]: e["t"] for e in loss_ev},
            first_loss_s=(loss_ev[0]["t"] - start["t0"]) if loss_ev and "t0" in start else None,
            restored=last("restored", {}), saves=last("saves", {}).get("log", []),
            launches=last("launches", {}), telemetry=last("telemetry", {}),
            await_t=last("await_eviction", {}).get("t"), exit_t=last("exit", {}).get("t"),
        )

    return [summary(pe) for pe in procs]


def run_files(evdir, label):
    """The files a run's worker and agent share, each run its own: the
    runtime-metrics file, the worker-commands file and the flight
    recorder's directory (bundles and profiler captures)."""
    return {
        "DLROVER_TPU_RUNTIME_METRICS_PATH": os.path.join(evdir, f"{label}.metrics.json"),
        "DLROVER_TPU_WORKER_COMMANDS_PATH": os.path.join(evdir, f"{label}.commands.json"),
        "DLROVER_TPU_FLIGHT_DIR": os.path.join(evdir, f"{label}_flight"),
    }


def wait_for_event(ev_path, kind, proc, timeout=300.0):
    """The first ``kind`` event in an events file, polled while ``proc``
    runs (None when it ends first or the time runs out)."""
    deadline = time.time() + timeout
    while time.time() < deadline and proc.poll() is None:
        if os.path.exists(ev_path):
            with open(ev_path) as f:
                for line in f:
                    e = json.loads(line)
                    if e["event"] == kind:
                        return e
        time.sleep(0.02)
    return None


def ckpt_worker(label, ckpt_dir, evdir, *extra, commands=()):
    """One training process of the drill run directly
    (``examples/train_gpt2_torch.py``, started with ``subprocess``, never
    a fork of this process), beside the saver this process hosts;
    returns what its event file says. ``commands``, (kind, arg, reason)
    each, are appended to its worker-commands file with the port's
    ``append_worker_commands``, as the agent's relay does, once its
    trainer is built (commands already in the file at that point target
    an earlier incarnation and are skipped)."""
    from dlrover_tpu_torch.agent.monitor import append_worker_commands
    from dlrover_tpu_torch.common.comm import WorkerCommand

    ev = os.path.join(evdir, f"{label}.jsonl")
    files = run_files(evdir, label)
    t0 = time.time()
    p = subprocess.Popen(
        [sys.executable, CKPT_WORKER, *CKPT_RUN, "--ckpt-dir", ckpt_dir, "--events", ev, *extra],
        cwd=REPO, env={**os.environ, **files, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    sent = []
    if commands and wait_for_event(ev, "restored", p) is not None:
        cmds = [WorkerCommand(id=i + 1, kind=k, arg=a, reason=r)
                for i, (k, a, r) in enumerate(commands)]
        append_worker_commands(files["DLROVER_TPU_WORKER_COMMANDS_PATH"], cmds)
        sent = [dict(id=c.id, kind=c.kind, arg=c.arg, reason=c.reason, t=time.time())
                for c in cmds]
    try:
        _, err = p.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        p.kill()
        _, err = p.communicate()
    procs = read_procs(ev)
    w = procs[0] if procs else dict(losses={}, loss_t={}, first_loss_s=None, restored={},
                                    saves=[], launches={}, telemetry={})  # it wrote nothing
    return dict(w, label=label, rc=p.returncode, wall_s=time.time() - t0,
                stderr=err[-3000:], commands=sent, files=files)


_LOG_LINE = re.compile(r"^\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})\] \[\w+\] \[[^\]]*\] (.*)$")


def launcher_log(text):
    """(wall time, message) of each log line the launcher, its agent and
    saver wrote."""
    out = []
    for line in text.splitlines():
        m = _LOG_LINE.match(line)
        if m:
            t = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            out.append((t, m.group(2)))
    return out


class CardHolders:
    """While a launcher runs, which processes of its group hold the card:
    polls every process whose process group is the launcher's for open
    ``/dev/nvidia*`` files (a CUDA context holds them) and, beside it,
    ``nvidia-smi --query-compute-apps=pid``."""

    def __init__(self, pgid):
        import threading

        self.pgid = pgid
        self.roles = {}  # pid -> "launcher" / "master" / "worker"
        self.by_fd, self.by_smi = set(), set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _group(self):
        pids = []
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            try:
                with open(f"/proc/{name}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                if int(fields[2]) == self.pgid:
                    pids.append(int(name))
            except (OSError, IndexError, ValueError):
                pass
        return pids

    def _sample(self):
        for pid in self._group():
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode(errors="replace").split("\0")
                fds = os.listdir(f"/proc/{pid}/fd")
            except OSError:
                continue
            # a child forked but not yet exec'd still shows the launcher's
            # command line, and an exiting one shows none: a role, once
            # known, is kept
            role = ("launcher" if pid == self.pgid else
                    "master" if "dlrover_tpu_torch.master.main" in argv else
                    "worker" if len(argv) > 1 and argv[1].endswith("train_gpt2_torch.py")
                    else "other")
            if role != "other" or pid not in self.roles:
                self.roles[pid] = role
            for fd in fds:
                try:
                    if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                        self.by_fd.add(pid)
                        break
                except OSError:
                    pass
        p = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        self.by_smi |= {int(x) for x in p.stdout.split() if x.strip().isdigit()}

    def _run(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(0.5)

    def stop(self):
        self._stop.set()
        self._thread.join()
        holders = self.by_fd | self.by_smi
        roles = lambda kind: sorted(p for p, r in self.roles.items() if r == kind)  # noqa: E731
        return dict(
            launcher_pids=roles("launcher"), master_pids=roles("master"),
            worker_pids=roles("worker"), holding_by_fd=sorted(self.by_fd),
            holding_by_nvidia_smi=sorted(self.by_smi & set(self.roles)),
            control_plane_holds_card=any(p in holders for p in roles("launcher") + roles("master")),
            probe_sees_a_worker=any(p in self.by_fd for p in roles("worker")),
        )


_MASTER_EXIT = re.compile(r"master exiting: \w+; global step (-?\d+); goodput (.*)$")


def ckpt_launcher(label, job, ckpt_dir, evdir, *extra, background=False, env=None,
                  launcher_args=(), files_of=None):
    """One launcher run of the drill: ``python -m
    dlrover_tpu_torch.trainer.run`` in a session of its own (its master,
    agent, saver and workers share its process group), the worker
    ``examples/train_gpt2_torch.py``. ``files_of`` names the run whose
    metrics and command files it shares (a job resumed by a fresh
    launcher). With ``background`` it returns a function that waits for
    the run and returns its record (``proc`` / ``events`` name the
    running launcher and its events file meanwhile)."""
    ev = os.path.join(evdir, f"{label}.jsonl")
    log_path = os.path.join(evdir, f"{label}.launcher.log")
    log = open(log_path, "w")
    files = run_files(evdir, files_of or label)
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.run", "--nnodes=1",
         "--nproc-per-node=1", "--monitor-interval=0.5", f"--job-name={job}",
         f"--log-dir={os.path.join(evdir, label + '_workers')}", *launcher_args, CKPT_WORKER,
         *CKPT_RUN, "--ckpt-dir", ckpt_dir, "--events", ev, *extra],
        cwd=REPO, env={**os.environ, **files, **(env or {}), "PYTHONPATH": REPO}, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True,
    )
    holders = CardHolders(proc.pid)

    def finish():
        try:
            rc = proc.wait(timeout=400)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            rc = proc.wait()
        wall = time.time() - t0
        cards = holders.stop()
        log.close()
        try:  # nothing of the group may outlive the run
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
        with open(log_path) as f:
            text = f.read()
        lines = launcher_log(text)

        def at(fragment, last=False):
            hits = [t - t0 for t, msg in lines if fragment in msg]
            return (hits[-1] if last else hits[0]) if hits else None

        exits = [m for _, msg in lines for m in [_MASTER_EXIT.search(msg)] if m]
        master = (dict(global_step=int(exits[-1].group(1)),
                       goodput=json.loads(exits[-1].group(2))) if exits else {})
        return dict(label=label, rc=rc, wall_s=wall, t0=t0, log=text[-4000:], lines=lines,
                    procs=read_procs(ev), cards=cards, files=files, master=master,
                    master_s=at("spawned local master"), rendezvous_s=at("joined round 0"),
                    # the last: a node check's rounds start workers first
                    worker_start_s=at("started 1 workers (restart 0)", last=True),
                    failure_s=at("worker failure"),
                    relaunch_s=at("started 1 workers (restart 1)"),
                    persist=[dict(step=int(m.group(1)), s=float(m.group(2)), outcome=m.group(3))
                             for _, msg in lines
                             for m in [re.match(r"persisted step (\d+) .* in ([\d.]+)s \[(\w+)\]", msg)]
                             if m])

    if background:
        finish.proc, finish.events = proc, ev
        return finish
    return finish()


def drill_step_ms(w):
    """A worker's step times (host clock between the losses of two
    steps, each read after its stream finished) split by whether a
    staged save's copies or host side were in flight; steps right after
    a disk save (which blocks the loop) are left out."""
    t, drain, after_disk = w["loss_t"], set(), set()
    for s in w["saves"]:
        if s["kind"] == "memory" and "end_step" in s:
            drain |= set(range(s["step"] + 1, s["end_step"] + 1))
        elif s["kind"] == "storage":
            after_disk.add(s["step"] + 1)
    steps = sorted(t)
    with_drain, without = [], []
    for a, b in zip(steps, steps[1:]):
        if b not in after_disk:
            (with_drain if b in drain else without).append((t[b] - t[a]) * 1e3)
    return with_drain, without


def drill_launches_ok(w):
    """fa_fwd / fa_bwd_dkdv / fa_bwd_dq once a layer and adam8_flat once
    a packed group on every step the worker ran."""
    n, la = len(w["losses"]), w["launches"]
    c = la.get("counts", {})
    want = {"fa_fwd": la.get("layers", 0) * n, "fa_bwd_dkdv": la.get("layers", 0) * n,
            "fa_bwd_dq": la.get("layers", 0) * n, "adam8_flat": la.get("groups", 0) * n}
    return n > 0 and all(c.get(k) == v for k, v in want.items()), want


def stage_ring(torch, tensors, shm_buf, chunk_bytes, slots=2):
    """Route (b), measured beside the engine's route (a): each tensor's
    bytes go to the host through a ring of ``slots`` pinned buffers of
    ``chunk_bytes`` on a side stream, and a host thread copies every
    chunk into shm and folds its crc32. Returns (ms until the last
    device copy finished, which is when an optimizer could go on; ms
    until all is in shm; seconds of memcpy; seconds of crc)."""
    import threading
    import zlib

    dev = tensors[0].device
    stream = torch.cuda.Stream(device=dev)
    ring = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
    free = [threading.Semaphore(1) for _ in range(slots)]
    chunks, off = [], 0
    for t in tensors:
        flat = t.reshape(-1).view(torch.uint8)
        for lo in range(0, flat.numel(), chunk_bytes):
            n = min(chunk_bytes, flat.numel() - lo)
            chunks.append((flat[lo:lo + n], off, n))
            off += n
    issued = []  # (event, slot, shm offset, n) in order
    ready = threading.Condition()
    timing = {"memcpy_s": 0.0, "crc_s": 0.0}
    t0 = time.perf_counter()
    torch.cuda.current_stream(dev).synchronize()

    def host():
        crc = 0
        for i in range(len(chunks)):
            with ready:
                while len(issued) <= i:
                    ready.wait()
                ev, slot, o, n = issued[i]
            ev.synchronize()
            if i == len(chunks) - 1:
                timing["last_copy_ms"] = (time.perf_counter() - t0) * 1e3
            a = time.perf_counter()
            shm_buf[o:o + n] = ring[slot][:n].numpy()
            b = time.perf_counter()
            crc = zlib.crc32(shm_buf[o:o + n], crc)
            timing["memcpy_s"] += b - a
            timing["crc_s"] += time.perf_counter() - b
            free[slot].release()

    th = threading.Thread(target=host)
    th.start()
    for i, (src, o, n) in enumerate(chunks):
        slot = i % slots
        free[slot].acquire()  # the host has copied this slot out
        with torch.cuda.stream(stream):
            ring[slot][:n].copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        with ready:
            issued.append((ev, slot, o, n))
            ready.notify()
    th.join()
    timing["total_ms"] = (time.perf_counter() - t0) * 1e3
    return timing


def measure_stage_routes(torch, cfg, ckpt_root, label, rounds=2, ring=True):
    """One model's train state staged into shm by the engine (route a:
    the device copies land in the pinned segment, host threads fold the
    crcs), ``rounds`` times (the first also pins the segment), and as
    often by route (b) into a plain segment; then one restore of it
    from shm into the live tensors. The saver runs in this process."""
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.ckpt.sharding import flatten_state
    from dlrover_tpu_torch.common.multi_process import SharedMemory
    from dlrover_tpu_torch.models.convert import train_state_tree
    from dlrover_tpu_torch.models.train import state_from_params
    from dlrover_tpu_torch.models.transformer import Transformer
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    # zeros, built on the card (a CPU draw of 1.5 B weights takes
    # minutes); what is timed does not depend on the values
    state = state_from_params(Transformer(cfg, device="cuda"), build_optimizer("adamw_8bit_flat"))
    tree = {"train": train_state_tree(state), "sampler": {"epoch": 0, "completed_num": 0}}
    tensors = [v for _, v in flatten_state(tree) if isinstance(v, torch.Tensor)]
    AsyncCheckpointSaver.reset()
    saver = AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
    # these saves are measurements: their steps count as persisted, so
    # the saver hands each back without writing it to disk (gpt2_xl's
    # would take a minute and another ~20 GB of host RAM)
    saver._persisted_step = rounds
    engine = CheckpointEngine()
    d = os.path.join(ckpt_root, label)
    res = {"label": label, "rounds": []}
    try:
        for r in range(rounds):
            while not engine._lock.acquire(blocking=False):  # the saver hands it back
                time.sleep(0.01)
            engine._lock.force_release()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = engine.begin_chunked_save(r + 1, tree, d)
            begin_ms = (time.perf_counter() - t0) * 1e3
            st.commit()
            total_ms = (time.perf_counter() - t0) * 1e3
            res["state_bytes"] = st.total_bytes
            res["rounds"].append(dict(
                begin_ms=begin_ms, d2h_ms=st.timings["d2h_ms"], crc_s=st.timings["crc_s"],
                total_ms=total_ms, d2h_GBps=st.total_bytes / st.timings["d2h_ms"] / 1e6,
                crc_GBps=st.total_bytes / st.timings["crc_s"] / 1e9))
        t0 = time.perf_counter()
        step, _ = engine.load(tree, d)
        res["restore_from_shm_s"] = time.perf_counter() - t0
        if (step, engine.last_load_source) != (rounds, "memory"):
            raise RuntimeError(f"{label}: shm restore gave {step} from {engine.last_load_source}")
    finally:
        engine.close()
        AsyncCheckpointSaver.reset()
    if ring:
        name = f"dlrover_tpu_ring_{os.getpid()}"
        seg = SharedMemory(name=name, create=True, size=res["state_bytes"])
        try:
            buf = np.ndarray((res["state_bytes"],), dtype=np.uint8, buffer=seg.buf)
            nb = res["state_bytes"]
            res["ring"] = []
            for _ in range(rounds):  # the first also faults the segment's pages in
                t = stage_ring(torch, tensors, buf, 64 << 20)
                res["ring"].append(dict(t, memcpy_GBps=nb / t["memcpy_s"] / 1e9,
                                        crc_GBps=nb / t["crc_s"] / 1e9))
            del buf
        finally:
            seg.close()
            seg.unlink()
    del state, tree, tensors
    torch.cuda.empty_cache()
    return res


def trace_kernels(path, names):
    """A torch.profiler Chrome trace: whether it is valid (the port's
    ``validate_chrome_trace``), and for each of ``names`` how many
    kernels whose name holds it ran on the card (``cat`` ``kernel``)."""
    from dlrover_tpu_torch.obs.trace import validate_chrome_trace

    with open(path) as f:
        trace = json.load(f)
    ok, why = validate_chrome_trace(trace)
    kernels = [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]
    return ok, why, {n: sum(n in e["name"] for e in kernels) for n in names}


def check_commands(u2):
    """U2's ``profile`` and ``flight_dump`` commands: the capture's Chrome
    trace names the path's kernels launched on the card, and the bundle
    holds its reason, the last spans and the registry."""
    from dlrover_tpu_torch.obs.trace import validate_chrome_trace

    tel = u2.get("telemetry", {})
    profiles, dumps = tel.get("profiles", []), tel.get("flight_dumps", [])
    out = dict(sent=u2.get("commands"), profiles=profiles, flight_dumps=dumps)
    trace = os.path.join(profiles[0], "trace.json") if profiles else ""
    if os.path.exists(trace):
        ok, why, kern = trace_kernels(trace, ("fa_fwd", "fa_bwd_dkdv", "fa_bwd_dq", "adam8_flat"))
        out.update(profile_trace_valid=ok, profile_trace_why=why, profile_kernels=kern,
                   profile_trace_bytes=os.path.getsize(trace))
    bundle = next((d for d in dumps if "_request_" in os.path.basename(d)), None)
    if bundle is not None:
        with open(os.path.join(bundle, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(bundle, "trace.json")) as f:
            spans = json.load(f)
        with open(os.path.join(bundle, "metrics.prom")) as f:
            prom = f.read()
        out.update(bundle_reason=manifest.get("reason"),
                   bundle_spans=sum(e.get("ph") == "X" for e in spans["traceEvents"]),
                   bundle_spans_valid=validate_chrome_trace(spans)[0],
                   bundle_registry_lines=len(prom.splitlines()),
                   bundle_has_step_time="dlrover_step_time_seconds" in prom)
    checks = {
        "u2_commands_sent": len(out["sent"] or []) == 2,
        "u2_profile_trace_valid": bool(out.get("profile_trace_valid")),
        "u2_profile_names_kernels": bool(out.get("profile_kernels"))
        and all(v > 0 for v in out["profile_kernels"].values()),
        "u2_flight_bundle": out.get("bundle_reason", "").startswith("request_")
        and out.get("bundle_spans", 0) > 0 and bool(out.get("bundle_spans_valid"))
        and bool(out.get("bundle_has_step_time")),
    }
    return out, checks


def report_closure(goodput):
    """A goodput report as the master holds it: the categories,
    ``goodput_pct`` and the partition's closure error in % of wall."""
    if not goodput:
        return None
    wall, secs = goodput["wall_s"], goodput["seconds"]
    return dict(wall_s=wall, seconds=secs, goodput_pct=goodput["goodput_pct"],
                closure_error_pct=100.0 * abs(sum(secs.values()) - wall) / wall if wall else None)


def start_evict(job, ckpt_dir, evdir):
    """E: a launcher of gpt2_small with ``DLROVER_TPU_EVICTION_DEADLINE_S``
    whose worker holds after step 7's loss; a thread of this process
    sends the worker SIGTERM then, as the agent's ``_stop_workers`` does,
    and the worker drains. Returns a function that waits for E and
    returns its record (with the signal's time and the metrics file the
    drained worker left)."""
    import signal
    import threading

    from dlrover_tpu_torch.agent.monitor import read_runtime_metrics

    wait = ckpt_launcher(
        "E", job, ckpt_dir, evdir, "--await-eviction-after-step", str(EVICT_AFTER_STEP),
        background=True, env={"DLROVER_TPU_EVICTION_DEADLINE_S": str(EVICT_GRACE_S)})
    box = {}

    def signal_worker():
        start = wait_for_event(wait.events, "start", wait.proc)
        held = wait_for_event(wait.events, "await_eviction", wait.proc)
        if start is not None and held is not None:
            os.kill(start["pid"], signal.SIGTERM)
            box["t_sig"] = time.time()

    th = threading.Thread(target=signal_worker, daemon=True)
    th.start()

    def finish():
        e = wait()
        th.join(timeout=60)
        e["t_sig"] = box.get("t_sig")
        e["metrics_file"] = read_runtime_metrics(
            e["files"]["DLROVER_TPU_RUNTIME_METRICS_PATH"])
        return e

    return finish


def start_resume(job, ckpt_dir, evdir):
    """R: a fresh launcher of E's job (the metrics file E's worker left,
    as on the node) with ``--network-check``: ``gpu_check`` on the card
    before the worker starts, then the worker resumes E's step."""
    return ckpt_launcher("R", job, ckpt_dir, evdir, launcher_args=("--network-check",),
                         files_of="E", background=True)


def evict_result(e, r, u):
    """The ``eviction`` line and its checks."""
    ew = e["procs"][0] if len(e["procs"]) == 1 else {}
    tel = ew.get("telemetry", {})
    ev = tel.get("eviction", {})
    metrics = e["metrics_file"]
    flight = e["files"]["DLROVER_TPU_FLIGHT_DIR"]
    bundles = sorted(d for d in os.listdir(flight) if "_eviction_" in d) if os.path.isdir(flight) else []
    reason = None
    if bundles:
        with open(os.path.join(flight, bundles[-1], "manifest.json")) as f:
            reason = json.load(f).get("reason")
    notices = [msg for _, msg in e["lines"] if "eviction notice for worker-" in msg]
    rw = r["procs"][0] if len(r["procs"]) == 1 else {}
    restored = rw.get("restored", {})
    checks_msgs = [json.loads(msg.split("gpu check: ", 1)[1]) for _, msg in r["lines"]
                   if "gpu check: " in msg]
    rounds = [(t - r["t0"], msg) for t, msg in r["lines"] if " check round " in msg]
    persisted = ev.get("persisted")
    line = dict(
        card=card_line(), grace_s=EVICT_GRACE_S, signal_after_step=EVICT_AFTER_STEP,
        drain_ms=ev.get("drain_ms"), emergency_stage_ms=ev.get("stage_ms"),
        persist_s=ev.get("persist_s") if persisted else "skipped (floor)",
        committed=ev.get("committed"), drained_step=ev.get("step"),
        sigterm_to_worker_exit_s=(ew["exit_t"] - e["t_sig"])
        if ew.get("exit_t") and e["t_sig"] else None,
        metrics_file={k: metrics.get(k) for k in ("global_step", "eviction_pending",
                                                    "eviction_grace_s", "eviction_drain_ms")},
        flight_bundle=bundles[-1] if bundles else None, flight_bundle_reason=reason,
        ledger_eviction_s=tel.get("goodput", {}).get("eviction"),
        worker_goodput=tel.get("goodput"),
        master_logged_notice=bool(notices), master_notices=notices,
        master_after_drain=report_closure(e["master"].get("goodput")),
        master_global_step=e["master"].get("global_step"),
        restored=dict(step=restored.get("step"), source=restored.get("source"),
                      restore_s=restored.get("restore_s")),
        network_check=dict(gpu_check=checks_msgs, rounds=rounds,
                           worker_start_s=r["worker_start_s"]),
        launcher_wall_s=dict(E=e["wall_s"], R=r["wall_s"]),
    )
    steps = range(1, EVICT_AFTER_STEP + 1)
    checks = {
        "e_launcher_rc0": e["rc"] == 0 and r["rc"] == 0,
        "e_one_worker_drained_at_7": tel.get("evicted") is True and ev.get("step") == EVICT_AFTER_STEP
        and ev.get("committed") is True,
        "e_losses_bitwise": ew.get("losses") == {s: u.get(s) for s in steps},
        "e_drain_within_grace": (ev.get("drain_ms") or math.inf) < EVICT_GRACE_S * 1e3,
        "e_exit_before_agent_kill": (line["sigterm_to_worker_exit_s"] or math.inf) < AGENT_KILL_S,
        "e_metrics_file": metrics.get("eviction_pending") == 1.0
        and metrics.get("eviction_grace_s") == EVICT_GRACE_S
        and (metrics.get("eviction_drain_ms") or 0) > 0 and metrics.get("global_step") == EVICT_AFTER_STEP,
        "e_flight_bundle": reason == "eviction",
        "e_ledger_booked_eviction": (line["ledger_eviction_s"] or 0) > 0,
        "e_master_logged_notice": bool(notices),
        "r_restored_7": restored.get("step") == EVICT_AFTER_STEP,
        "r_bitwise": rw.get("losses") == {s: u.get(s) for s in range(EVICT_AFTER_STEP + 1, 13)},
        "r_network_check_passed": len(checks_msgs) == 2
        and all(c["backend"] == "nccl" and c["world_size"] == 1 for c in checks_msgs)
        and sum("success=True" in m for _, m in rounds) == 2,
        "r_worker_after_check": bool(rounds) and r["worker_start_s"] is not None
        and r["worker_start_s"] > max(t for t, _ in rounds),
    }
    return line, checks


def run_flash_ckpt(torch, phase="flash_ckpt"):
    """Flash Checkpoint and the worker's control loop under
    ElasticTrainer on gpt2_small (8 x 1024, ``adamw_8bit_flat``,
    ``prefetch=2``, shm saves every 4 steps, disk every 6, the trainer's
    log and command poll every 3). U: two direct runs beside the saver
    this process hosts (12 steps, the same losses to the bit); the second
    runs beside Ck and takes a ``profile`` (3 steps) and a
    ``flight_dump`` command through its worker-commands file. L: the
    port's launcher, whose worker SIGKILLs itself after step 9's loss;
    its agent persists at the breakpoint and relaunches it, and the
    relaunched worker restores the newest staged step from the agent's
    shm and trains to 12, its losses U's to the bit; its master must
    hold the worker's last logged step and a goodput report that closes.
    Ck: a launcher whose worker, after step 10 and once the newest staged
    step is on disk, kills the launcher's whole process group (a node
    that dies); its shm segment is unlinked. C: a fresh launcher of Ck's
    job restores the newest verified step on disk and trains to 12, U's
    losses to the bit. E / R: the eviction drill (``start_evict`` /
    ``start_resume``), E beside L and R beside C. Neither
    launcher nor master may hold the card. Then route (a) against route
    (b), and gpt2_xl's state when ``/dev/shm`` holds it. ``phase``
    ``evict``: U1, E and R alone."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver, read_tracker
    from dlrover_tpu_torch.ckpt.shm_handler import shard_shm_name, shm_free_bytes
    from dlrover_tpu_torch.common.multi_process import attach_shared_memory
    from dlrover_tpu_torch.common.storage import PosixDiskStorage
    from dlrover_tpu_torch.models import gpt2_small, gpt2_xl

    full = phase == "flash_ckpt"
    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True).stdout.strip()
    shm_free = shm_free_bytes()
    smoke_job = f"smoke{os.getpid()}"
    os.environ["DLROVER_TPU_JOB_NAME"] = smoke_job
    sock = tempfile.mkdtemp(prefix="dlr")  # unix socket paths stay short
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock
    root = tempfile.mkdtemp(prefix="flash_ckpt_")
    evdir = os.path.join(root, "events")
    os.makedirs(evdir)

    def restart_saver():
        AsyncCheckpointSaver.reset()
        return AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)

    def unlink_shm(job):
        """The segment a dead agent of ``job`` left in /dev/shm."""
        os.environ["DLROVER_TPU_JOB_NAME"] = job
        try:
            seg = attach_shared_memory(shard_shm_name(0))
        finally:
            os.environ["DLROVER_TPU_JOB_NAME"] = smoke_job
        if seg is not None:
            seg.close()
            seg.unlink()
        return seg is not None

    def cleanup():
        AsyncCheckpointSaver.reset()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(sock, ignore_errors=True)

    t_phase = time.perf_counter()
    persist = []
    try:
        runs, launched = {}, {}
        saver = restart_saver()
        runs["U1"] = ckpt_worker("U1", os.path.join(root, "U1"), evdir)
        persist += [dict(run="U1", step=st, s=sec, outcome=oc) for st, sec, oc in saver.persist_log]
        if full:
            saver = restart_saver()
            ck_job, c_dir = f"ck{os.getpid()}", os.path.join(root, "C")
            ck_wait = ckpt_launcher("Ck", ck_job, c_dir, evdir, "--kill-after-step", "10",
                                    "--kill-group", background=True)
            runs["U2"] = ckpt_worker("U2", os.path.join(root, "U2"), evdir,
                                     commands=[("profile", 3, "smoke"), ("flight_dump", 0, "smoke")])
            persist += [dict(run="U2", step=st, s=sec, outcome=oc) for st, sec, oc in saver.persist_log]
        AsyncCheckpointSaver.reset()
        e_job, e_dir = f"e{os.getpid()}", os.path.join(root, "E")
        if full:
            launched["Ck"] = ck_wait()
            c_on_disk = read_tracker(PosixDiskStorage(), c_dir)
            ck_shm_left = unlink_shm(ck_job)
            # E runs beside L, and R beside C (each pair shares the card)
            e_wait = start_evict(e_job, e_dir, evdir)
            launched["L"] = ckpt_launcher("L", f"l{os.getpid()}", os.path.join(root, "L"), evdir,
                                          "--kill-after-step", "9")
            launched["E"] = e_wait()
            r_wait = start_resume(e_job, e_dir, evdir)
            launched["C"] = ckpt_launcher("C", ck_job, c_dir, evdir)
            launched["R"] = r_wait()
        else:
            launched["E"] = start_evict(e_job, e_dir, evdir)()
            launched["R"] = start_resume(e_job, e_dir, evdir)()
        for label, r in launched.items():
            persist += [dict(run=label, **x) for x in r["persist"]]
        drill_s = time.perf_counter() - t_phase
        for label, w in runs.items():
            if w["rc"] != 0:
                print(w["stderr"], file=sys.stderr)
                raise RuntimeError(f"flash_ckpt worker {label} exited {w['rc']}")
        for label, r in launched.items():
            if r["rc"] != (-9 if label == "Ck" else 0):
                print(r["log"], file=sys.stderr)
                raise RuntimeError(f"flash_ckpt launcher {label} exited {r['rc']}")
    except BaseException:
        cleanup()
        raise

    u = runs["U1"]["losses"]
    steps = list(range(1, 13))
    evict_line, evict_checks = evict_result(launched["E"], launched["R"], u)
    emit("eviction", **evict_line, checks=evict_checks, ok=all(evict_checks.values()))
    checks = {
        "u_steps": sorted(u) == steps,
        "losses_finite": all(math.isfinite(x) for x in u.values()),
        "first_loss_near_ln_vocab": abs(u.get(1, math.inf) - math.log(50257)) <= 1.0,
        **evict_checks,
    }
    workers = dict(runs, **{f"{k}{i}": w for k in launched for i, w in enumerate(launched[k]["procs"])})
    if full:
        lw = launched["L"]["procs"]
        ck = launched["Ck"]["procs"]
        cw = launched["C"]["procs"]
        ok_steps = lambda w: [s["step"] for s in w["saves"] if s["ok"]]  # noqa: E731
        l_staged = max(ok_steps(lw[0]), default=None) if lw else None
        ck_staged = max(ok_steps(ck[0]), default=None) if ck else None
        commands, command_checks = check_commands(runs["U2"])
        l_master = launched["L"]["master"]
        l_logged = max((s for s in lw[-1]["losses"] if s in LOGGED_STEPS), default=None) if lw else None
        l_report = report_closure(l_master.get("goodput"))
        checks.update({
            "u_repeat_bitwise": runs["U2"]["losses"] == u,
            **command_checks,
            "l_one_relaunch": [w["restart"] for w in lw] == [0, 1],
            "l_failure_seen": any("exitcode=-9" in msg for _, msg in launched["L"]["lines"]),
            "l_killed_after_9_bitwise": len(lw) == 2 and lw[0]["losses"] == {s: u.get(s) for s in range(1, 10)},
            "l_from_agent_shm": len(lw) == 2 and (lw[1]["restored"].get("step"),
                                                  lw[1]["restored"].get("source")) == (l_staged, "memory"),
            "l_bitwise": len(lw) == 2 and l_staged is not None
            and lw[1]["losses"] == {s: u.get(s) for s in range(l_staged + 1, 13)},
            "l_master_holds_last_logged_step": l_logged is not None
            and l_master.get("global_step", -1) >= l_logged,
            "l_master_goodput_closes": l_report is not None
            and l_report["closure_error_pct"] <= CLOSURE_GATE_PCT,
            "ck_group_killed_after_10": len(ck) == 1 and ck[0]["losses"] == {s: u.get(s) for s in range(1, 11)},
            "ck_newest_staged_step_on_disk": c_on_disk == ck_staged,
            "ck_shm_left_and_unlinked": ck_shm_left,
            "c_from_disk": len(cw) == 1 and (cw[0]["restored"].get("step"),
                                             cw[0]["restored"].get("source")) == (c_on_disk, "storage"),
            "c_bitwise": len(cw) == 1 and cw[0]["losses"] == {s: u.get(s) for s in range(c_on_disk + 1, 13)},
        })
    for label in launched:
        cards = launched[label]["cards"]
        checks[f"no_card_in_control_plane_{label}"] = (
            not cards["control_plane_holds_card"] and bool(cards["launcher_pids"])
            and bool(cards["master_pids"]))
    checks["card_probe_sees_workers"] = all(launched[k]["cards"]["probe_sees_a_worker"]
                                            for k in launched)
    launches = {}
    for label, w in workers.items():
        ok, want = drill_launches_ok(w)
        checks[f"launches_{label}"] = ok
        launches[label] = {"counts": w["launches"].get("counts"), "expected": want}
    saves = [dict(worker=label, **s) for label, w in workers.items() for s in w["saves"]]
    mem = [s for s in saves if s["kind"] == "memory" and s["ok"]]
    disk = [s for s in saves if s["kind"] == "storage" and s["ok"]]
    # step times from U1, which ran alone (U2 shared the card with Ck)
    with_d, without = drill_step_ms(runs["U1"])
    med = lambda xs: float(statistics.median(xs)) if xs else None  # noqa: E731
    state_bytes = max((s.get("bytes", 0) for s in saves), default=0)
    if full:
        ll = launched["L"]
        ck_kinds = {s["step"]: s["kind"] for s in ck[0]["saves"] if s["ok"]} if ck else {}
        first_after = min(lw[1]["loss_t"].values()) if len(lw) == 2 and lw[1]["loss_t"] else None
        launcher = dict(
            card=card_line(),
            L=dict(master_s=ll["master_s"], rendezvous_s=ll["rendezvous_s"],
                   worker_start_s=ll["worker_start_s"],
                   first_loss_s=lw[0]["first_loss_s"] if lw else None,
                   failure_detected_s=ll["failure_s"], relaunch_s=ll["relaunch_s"],
                   failure_to_relaunched_first_loss_s=(
                       first_after - (ll["t0"] + ll["failure_s"])
                       if first_after and ll["failure_s"] is not None else None),
                   relaunched_restore_s=lw[1]["restored"].get("restore_s") if len(lw) == 2 else None,
                   restored=dict(step=lw[1]["restored"].get("step"),
                                 source=lw[1]["restored"].get("source")) if len(lw) == 2 else None,
                   worker_last_logged_step=l_logged,
                   master_global_step=l_master.get("global_step"),
                   master_goodput=l_report,
                   worker_goodput=lw[-1]["telemetry"].get("goodput") if lw else None,
                   wall_s=ll["wall_s"]),
            C=dict(master_s=launched["C"]["master_s"], rendezvous_s=launched["C"]["rendezvous_s"],
                   worker_start_s=launched["C"]["worker_start_s"],
                   first_loss_s=cw[0]["first_loss_s"] if cw else None,
                   restore_s=cw[0]["restored"].get("restore_s") if cw else None,
                   restored=dict(step=cw[0]["restored"].get("step"),
                                 source=cw[0]["restored"].get("source")) if cw else None,
                   restored_step_was=ck_kinds.get(c_on_disk),
                   wall_s=launched["C"]["wall_s"]),
            Ck=dict(wall_s=launched["Ck"]["wall_s"], on_disk_step=c_on_disk),
            worker_launches=launches,
            # each worker's start: imports, trainer ready (restore included), first loss
            worker_times={k: dict(import_s=w.get("import_s"),
                                  ready_s=w["restored"].get("since_start_s"),
                                  first_loss_s=w["first_loss_s"]) for k, w in workers.items()},
            cards={k: r["cards"] for k, r in launched.items()},
        )
        emit("launcher", **launcher)
        emit("commands", **commands, checks=command_checks, ok=all(command_checks.values()))
    try:
        routes = xl = "not run: --phase evict"
        if full:
            routes = measure_stage_routes(torch, gpt2_small(), root, "gpt2_small")
            xl = (measure_stage_routes(torch, gpt2_xl(), root, "gpt2_xl", rounds=1, ring=False)
                  if shm_free >= XL_SHM_BYTES else "not run: /dev/shm holds less than 24 GB")
    finally:
        cleanup()
    res = dict(
        model="gpt2_small", batch=8, seq=1024, optimizer="adamw_8bit_flat", prefetch=2,
        save_memory_interval=4, save_storage_interval=6, state_bytes=state_bytes,
        dev_shm_free_bytes=shm_free, df_dev_shm=df,
        memory_save_block_ms=[s["block_ms"] for s in mem],
        storage_save_block_ms=[s["block_ms"] for s in disk],
        saves=saves,
        step_ms_with_drain_median=med(with_d), step_ms_without_drain_median=med(without),
        step_ms_with_drain=with_d, step_ms_without_drain=without,
        d2h_GBps=[s["bytes"] / s["d2h_ms"] / 1e6 for s in mem if s.get("d2h_ms")],
        crc_GBps=[s["bytes"] / s["crc_s"] / 1e9 for s in mem if s.get("crc_s")],
        persist_s=persist,
        worker_import_s={k: w.get("import_s") for k, w in workers.items()},
        worker_first_loss_s={k: w["first_loss_s"] for k, w in workers.items()},
        worker_wall_s={k: w["wall_s"] for k, w in runs.items()},
        worker_goodput={k: w.get("telemetry", {}).get("goodput") for k, w in workers.items()},
        losses={k: [workers[k]["losses"][s] for s in sorted(workers[k]["losses"])]
                for k in workers},
        routes=routes, gpt2_xl=xl, drill_s=drill_s,
        checks=checks, ok=all(checks.values()),
    )
    emit(phase, **res)
    if not res["ok"]:
        for w in runs.values():
            print(w["label"], w["stderr"], file=sys.stderr)
        for r in launched.values():
            print(r["label"], r["log"], file=sys.stderr)
        raise RuntimeError(f"{phase} failed: {[k for k, v in checks.items() if not v]}")
    return res


def build_kernels():
    """Every kernel source, built at once: one nvcc for each ``.cu`` and
    g++ for the embedding store's ``kv_store.cc``."""
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops.embedding import store

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(_build.load_library, n) for n in ("flash_attention", "embedding_rows")]
        futs.append(ex.submit(store._load_library))
        for f in futs:
            f.result()
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(_build.build_logs) + ["kv_store.cc"])
    for name, log in _build.build_logs.items():  # nvcc's register / spill report
        print(f"nvcc {name}.cu:\n{log}", flush=True)
    check_ptxas_report(_build.build_logs.get("flash_attention", ""))


def check_ptxas_report(log):
    """From nvcc's ``-Xptxas -v`` report of flash_attention.cu (empty if the
    library was built by an earlier process): every instantiation's
    registers and spill bytes. All three kernels (``fa_fwd``,
    ``fa_bwd_dkdv``, ``fa_bwd_dq``) are wgmma kernels that keep their
    accumulators in registers by design, so a spill in any of them, or
    ptxas serializing their wgmma (its note C7512), fails the run; so does
    a report that lacks one of the three."""
    import re

    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            kernels.setdefault(cur, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            kernels.setdefault(cur, {})["registers"] = int(m.group(1))
    serialized = "C7512" in log
    if log and sum(any(f"{k}_kernel" in name for name in kernels)
                   for k in ("fa_fwd", "fa_bwd_dkdv", "fa_bwd_dq")) < 3:
        raise RuntimeError(f"ptxas report lacks an attention kernel: {sorted(kernels)}")
    bad = [k for k, v in kernels.items() if v.get("spill_bytes", 0)]
    emit("ptxas", kernels=kernels, wgmma_serialized=serialized, ok=not bad and not serialized)
    if bad or serialized:
        raise RuntimeError(f"ptxas spilled or serialized wgmma in {bad or 'flash_attention.cu'}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.ops import embedding_rows as er
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.models import gpt2_small

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    build_kernels()
    if "--phase" in sys.argv:  # one phase alone; the contract's lines need a full run
        phase = sys.argv[sys.argv.index("--phase") + 1]
        if phase not in ("flash_ckpt", "evict"):
            raise SystemExit(f"unknown phase {phase!r}")
        run_flash_ckpt(torch, phase)
        emit("timing", total_s=time.perf_counter() - T0)
        return 0

    main_res, main_abs = check_attention(
        torch, fa, "B1/B2 gpt2_small", 8, 12, 12, 1024, 64, probe=True)
    check_attention(torch, fa, "B3-B5 llama2_7b width", 1, 32, 32, 4096, 128)
    check_attention(torch, fa, "B3-B5 GQA", 1, 32, 8, 2048, 128)
    # keys start 512 positions after the queries: whole tiles are
    # skipped and the queries before position 512 see no key at all
    check_attention(torch, fa, "B3-B5 k_offset", 2, 4, 4, 1024, 64, q_off=0, k_off=512,
                    graph=True)
    # offsets that are no multiple of a tile: the diagonal crosses two
    # key tiles of every query tile
    check_attention(torch, fa, "B3-B5 misaligned offsets", 2, 4, 4, 1024, 64, q_off=40,
                    k_off=72, graph=True)
    check_attention(torch, fa, "B3-B5 not causal", 2, 12, 12, 1024, 64, causal=False)
    adam_res, adam_abs = check_adam8(torch, qo, gpt2_small())
    leaf_res, leaf_abs = check_adam8_leaf(torch, qo, gpt2_small())
    emb_t = check_embedding_rows(torch, er)
    torch.cuda.empty_cache()

    small_model_agrees(torch)
    counts, flat_losses = run_slice(torch, fa, qo, profile="--profile" in sys.argv)
    leaf_counts, leaf_losses = run_slice(torch, fa, qo, opt="adamw_8bit")
    rel = [abs(a - b) / abs(b) for a, b in zip(leaf_losses, flat_losses)]
    ok = len(rel) == len(flat_losses) and max(rel) <= LOSS_MATCH_RTOL
    emit("adamw_8bit_vs_flat", max_rel_diff=max(rel), tol=LOSS_MATCH_RTOL,
         bitwise=leaf_losses == flat_losses, ok=ok)
    if not ok:
        raise RuntimeError("adamw_8bit's losses leave adamw_8bit_flat's")
    emb_counts = run_sparse_full(torch, er, profile="--profile" in sys.argv)
    run_sparse_spill(torch)
    run_flash_ckpt(torch)

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
    src_qo, qo_tpu = "dlrover_tpu_torch/ops/quantized_optim.py", "dlrover_tpu/ops/quantized_optim.py"
    for name, replaces, res, abs_err, n in (
        ("adam8_flat", f"{qo_tpu}:403", adam_res, adam_abs, counts["adam8_flat"]),
        ("adam8_leaf", f"{qo_tpu}:198", leaf_res, leaf_abs, leaf_counts["adam8_leaf"]),
    ):
        kernels.append(dict(
            name=name, route="triton", source=src_qo, replaces=replaces,
            also_replaces=[], launches=n, max_abs_err=abs_err,
            ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"], library_ms=None,
        ))
    emb_tpu = "dlrover_tpu/ops/embedding/device_tier.py"
    for name, line in (("emb_gather", 139), ("emb_scatter", 162)):
        kernels.append(dict(
            name=name, route="cuda", source="dlrover_tpu_torch/ops/csrc/embedding_rows.cu",
            replaces=f"{emb_tpu}:{line}", also_replaces=[], launches=emb_counts[name],
            max_abs_err=0.0, **emb_t[name],
        ))
    emit("timing", total_s=time.perf_counter() - T0)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
