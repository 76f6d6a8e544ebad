#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dlrover_tpu_torch``) on one card.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a torch.profiler window of a few more steps to the
gpt2_small path and to the full-size sparse path.)

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
     on the card against the plain CPU path from the same weights;
   - the same with the per-leaf ``build_optimizer("adamw_8bit")``, its
     losses held to the flat run's;
   - ``SparseTrainer(DeviceSparseEmbedding(ShardedKvEmbedding(8, 128),
     hbm_budget_bytes=4 << 30), ...).run(stream, overlapped=True)``: 60
     steps of 65,536 ids, zipf 1.1 over 10,000,000 ids;
   - a small tier that spills (1,024 rows, bench.py's zipf 1.6 stream),
     its flushed host state held to the same run on the CPU and to a
     second run on the card;
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
LOSS_MATCH_RTOL = 1e-4  # per step, adamw_8bit against adamw_8bit_flat
SPILL_STATE_TOL = 1e-5  # card vs CPU host state, of its largest |value|
FIRST_LOSS_TOL = 1e-3  # the sparse slice's first loss against ln 2


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
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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
    emit("profile", label=label, steps=n, wall_ms=wall_us / 1e3, events=len(spans),
         device_ms_per_step=total / 1e3 / n, busy_ms_per_step=busy / 1e3 / n,
         busy_share_profiled=busy / wall_us,
         busy_share_vs_unprofiled_step=busy / n / 1e3 / step_ms,
         port_kernels_share=ours / max(total, 1),
         port_kernels={k.split("(")[0][:60]: {"ms_per_step": us / 1e3 / n, "calls": c}
                       for k, (us, c) in port.items()},
         host_spans_ms_per_step={k: v / 1e3 / n for k, v in notes.items()},
         top=[{"kernel": k[:90], "ms_per_step": us / 1e3 / n, "calls": c}
              for k, (us, c) in top])


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
    if profile:
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
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
