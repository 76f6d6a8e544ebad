#!/usr/bin/env python3
"""Times variants of the port's fused 8-bit AdamW Triton kernel on one
CUDA card, to find what holds it back; not used by the port.

    python3 tools/torch_adam8_variants.py [--rows R] [--leaf-rows R] [--out FILE]

Each variant is the update of ``dlrover_tpu_torch/ops/quantized_optim.py``
(dequantize -> moments -> delta -> requantize, in place) with one choice
from each axis:

- dequantize: ``div`` (IEEE ``code / 127``, the kernel's first design), ``table``
  (a 256-entry table of ``sign(c) rn(rn(|c|/127)^2)`` indexed by the
  code's byte, gathered from global memory), ``fma`` (``c * rn(1/127)``
  corrected by one fma, then squared: the same bits as ``div`` for every
  code, checked on the CPU by tests/test_torch_quantized_optim.py);
- requantize: ``exact`` (``rint(sqrt_rn(div_rn(x, s)) * 127)``) or
  ``recip`` (``rint(sqrt(|x|) * k)`` with ``k = 127 / sqrt(s)`` once a
  row and the approximate square root);
- delta: ``exact`` (``div_rn``, ``sqrt_rn``) or ``approx``;
- tiling: rows a program, warps, and one program per tile or a
  persistent grid of a few programs an SM walking the tiles.

Every variant is held to the plain version under chip_smoke.py's limits
(codes off by 1 on at most 1e-3 of elements, scales and delta within
1e-6) and timed with CUDA events (20 launches after 3 of warm-up) on
gpt2_small's packed group (the ``adam8_flat`` shape) and on its ``wte``
leaf (``adam8_leaf``), with Triton's register and spill counts. The
port's own launcher is timed beside them. One JSON line per variant on
stdout, and all of them in ``FILE`` with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BPS = 3.35e12
DEQ = {"div": 0, "table": 1, "fma": 2}


def build_kernel():
    # module globals, so that the kernels see each other and the language
    # whether or not this Triton resolves a jit function's closure
    global tl, libdevice, _dequant, _requant, _tile
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _dequant(c, tab_ptr, DQ: tl.constexpr):
        if DQ == 0:
            x = libdevice.div_rn(c.to(tl.float32), 127.0)
            sgn = tl.where(x > 0, 1.0, tl.where(x < 0, -1.0, 0.0))
            mag = sgn * x * x
        elif DQ == 1:
            mag = tl.load(tab_ptr + (c.to(tl.int32) & 255))
        else:
            cf = c.to(tl.float32)
            q0 = cf * 0.007874015718698502  # rn(1/127)
            q1 = tl.fma(tl.fma(-q0, 127.0, cf), 0.007874015718698502, q0)
            mag = q1 * tl.abs(q1)
        return mag

    @triton.jit
    def _requant(x, s, lo, RQ: tl.constexpr):
        if RQ == 0:
            y = libdevice.div_rn(x, tl.maximum(s, 1e-30)[:, None])
            sgn = tl.where(y > 0, 1.0, tl.where(y < 0, -1.0, 0.0))
            q = libdevice.rint(sgn * libdevice.sqrt_rn(tl.abs(y)) * 127.0)
        else:
            k = libdevice.div_rn(127.0, libdevice.sqrt_rn(tl.maximum(s, 1e-30)))
            q = libdevice.rint(tl.sqrt(tl.abs(x)) * k[:, None])
            q = tl.where(x < 0, -q, q)
        return tl.minimum(tl.maximum(q, lo), 127.0)

    @triton.jit
    def _tile(tile, g_ptr, mc_ptr, ms_ptr, vc_ptr, vs_ptr, d_ptr, tab_ptr, R,
              lrA, invbc2, eps, b1, omb1, b2, omb2,
              TILE_ROWS: tl.constexpr, DQ: tl.constexpr, RQ: tl.constexpr,
              DL: tl.constexpr):
        rows = tile * TILE_ROWS + tl.arange(0, TILE_ROWS)
        live = rows < R
        offs = rows[:, None] * 128 + tl.arange(0, 128)[None, :]
        mask = live[:, None]
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        cm = tl.load(mc_ptr + offs, mask=mask, other=0)
        cv = tl.load(vc_ptr + offs, mask=mask, other=0)
        m = _dequant(cm, tab_ptr, DQ) * tl.load(ms_ptr + rows, mask=live, other=0.0)[:, None]
        v = _dequant(cv, tab_ptr, DQ) * tl.load(vs_ptr + rows, mask=live, other=0.0)[:, None]
        m_new = b1 * m + omb1 * g
        v_new = b2 * v + omb2 * g * g
        if DL == 0:
            den = libdevice.sqrt_rn(v_new * invbc2) + eps
            delta = libdevice.div_rn(-lrA * m_new, den)
        else:
            delta = (-lrA * m_new) / (tl.sqrt(v_new * invbc2) + eps)
        tl.store(d_ptr + offs, delta.to(d_ptr.dtype.element_ty), mask=mask)
        s_m = tl.max(tl.abs(m_new), axis=1)
        s_v = tl.max(v_new, axis=1)
        tl.store(mc_ptr + offs, _requant(m_new, s_m, -127.0, RQ).to(tl.int8), mask=mask)
        tl.store(vc_ptr + offs, _requant(v_new, s_v, 0.0, RQ).to(tl.int8), mask=mask)
        tl.store(ms_ptr + rows, s_m, mask=live)
        tl.store(vs_ptr + rows, s_v, mask=live)

    @triton.jit
    def adam8_variant(g_ptr, mc_ptr, ms_ptr, vc_ptr, vs_ptr, d_ptr, tab_ptr, R,
                      lrA, invbc2, eps, b1, omb1, b2, omb2,
                      TILE_ROWS: tl.constexpr, DQ: tl.constexpr, RQ: tl.constexpr,
                      DL: tl.constexpr, PERSIST: tl.constexpr):
        if PERSIST:
            n_tiles = tl.cdiv(R, TILE_ROWS)
            for tile in tl.range(tl.program_id(0), n_tiles, tl.num_programs(0)):
                _tile(tile, g_ptr, mc_ptr, ms_ptr, vc_ptr, vs_ptr, d_ptr, tab_ptr, R,
                      lrA, invbc2, eps, b1, omb1, b2, omb2, TILE_ROWS, DQ, RQ, DL)
        else:
            _tile(tl.program_id(0), g_ptr, mc_ptr, ms_ptr, vc_ptr, vs_ptr, d_ptr, tab_ptr,
                  R, lrA, invbc2, eps, b1, omb1, b2, omb2, TILE_ROWS, DQ, RQ, DL)

    return adam8_variant


def gpt2_group_rows(torch, qo):
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.models.transformer import init_params

    model = init_params(torch.Generator().manual_seed(0), gpt2_small(), torch.device("cuda"))
    layout = qo._flat_layout(model.jax_ordered_parameters(), 4096, 1 << 27)
    rows = layout.groups[0].total // qo.BLOCK
    del model
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=0, help="group rows (default: gpt2_small's)")
    ap.add_argument("--leaf-rows", type=int, default=50257 * 768 // 128)
    ap.add_argument("--out", default="", help="also write every result to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.ops import quantized_optim as qo

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kernel = build_kernel()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # entry u: the value of the code whose byte is u
    codes = torch.cat([torch.arange(0, 128), torch.arange(-128, 0)]).float()
    tab = qo._sqrt_map_dequant(codes, torch.ones(()), 127.0).to(dev)

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    scalars = tuple(float(torch.tensor(x, dtype=torch.float32))
                    for x in (3e-4 / (1 - 0.9**3), 1 / (1 - 0.999**3), 1e-8))
    results = []

    def shape_inputs(R, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        g = torch.randn((R, 128), generator=gen, device=dev) * 1e-3
        m0 = torch.randn((R, 128), generator=gen, device=dev) * 1e-3
        v0 = torch.rand((R, 128), generator=gen, device=dev) * 1e-6

        def state():
            out = []
            for x, s in ((m0, True), (v0, False)):
                c, sc = qo._sqrt_map_quant(x, s, 127.0)
                out.append(qo.Quantized8(c.to(torch.int8), sc.view(R).contiguous(), (R * 128,), s))
            return out
        return g, state

    variants = [
        # (dequant, requant, delta, tile rows, warps, persistent programs an SM or 0)
        ("div", "exact", "exact", 32, 4, 0),  # the kernel's first design
        # the tiling alone, on that arithmetic
        ("div", "exact", "exact", 64, 8, 0),
        ("div", "exact", "exact", 16, 4, 0),
        ("div", "exact", "exact", 16, 8, 0),
        ("div", "exact", "exact", 8, 4, 0),
        ("div", "exact", "exact", 8, 2, 0),
        ("div", "exact", "exact", 32, 4, 4),
        # the arithmetic alone, on that tiling
        ("table", "exact", "exact", 32, 4, 0),
        ("fma", "exact", "exact", 32, 4, 0),
        ("div", "recip", "exact", 32, 4, 0),
        ("table", "recip", "exact", 32, 4, 0),
        ("fma", "recip", "exact", 32, 4, 0),
        ("fma", "recip", "approx", 32, 4, 0),
        ("table", "recip", "approx", 32, 4, 0),
        # both
        ("fma", "recip", "exact", 64, 4, 0),
        ("fma", "recip", "exact", 64, 8, 0),
        ("fma", "recip", "exact", 128, 8, 0),
        ("fma", "recip", "exact", 32, 8, 0),
        ("fma", "recip", "exact", 16, 2, 0),
        ("fma", "recip", "exact", 16, 4, 0),
        ("fma", "recip", "exact", 16, 8, 0),
        ("fma", "recip", "exact", 8, 1, 0),
        ("fma", "recip", "exact", 8, 2, 0),
        ("fma", "recip", "exact", 8, 4, 0),
        ("fma", "recip", "exact", 4, 1, 0),
        ("fma", "recip", "exact", 4, 2, 0),
        ("fma", "recip", "exact", 32, 4, 4),
        ("fma", "recip", "exact", 32, 4, 8),
        ("fma", "recip", "exact", 64, 8, 2),
        ("fma", "recip", "exact", 16, 4, 8),
        ("fma", "recip", "exact", 8, 4, 16),
        ("table", "recip", "exact", 16, 4, 0),
        ("table", "recip", "exact", 8, 4, 0),
        ("fma", "recip", "approx", 64, 8, 0),
        ("fma", "recip", "approx", 32, 4, 8),
        ("fma", "recip", "approx", 16, 4, 0),
        ("fma", "recip", "approx", 8, 2, 0),
        ("fma", "recip", "approx", 8, 4, 0),
    ]
    rows_group = args.rows or gpt2_group_rows(torch, qo)
    for shape, R, seed in (("adam8_flat gpt2_small group", rows_group, 1),
                           ("adam8_leaf gpt2_small wte", args.leaf_rows, 2)):
        g, state = shape_inputs(R, seed)
        mp, vp = state()
        d_p = qo._adam8_update_plain(g, mp, vp, scalars, 0.9, 0.999, True)
        nbytes = R * 128 * 12 + 4 * R * 4
        bound_ms = nbytes / HBM_BPS * 1e3

        def run_variant(mk, vk, d, dq, rq, dl, tile, warps, persist):
            n_tiles = -(-R // tile)
            grid = (min(n_tiles, persist * n_sm) if persist else n_tiles,)
            lrA, invbc2, eps = scalars
            return kernel[grid](
                g, mk.codes, mk.scales, vk.codes, vk.scales, d, tab, R,
                lrA, invbc2, eps, 0.9, 0.1, 0.999, 1.0 - 0.999,
                TILE_ROWS=tile, DQ=DEQ[dq], RQ=int(rq == "recip"), DL=int(dl == "approx"),
                PERSIST=bool(persist), num_warps=warps, enable_fp_fusion=False)

        def check(mk, vk, d_k):
            diff = torch.cat([(mk.codes.int() - mp.codes.int()).abs().view(-1),
                              (vk.codes.int() - vp.codes.int()).abs().view(-1)])
            return dict(
                code_share=(diff > 0).float().mean().item(), code_max=diff.max().item(),
                scale_err=max(((a.scales - b.scales).abs().max() / b.scales.abs().max()).item()
                              for a, b in ((mk, mp), (vk, vp))),
                delta_err=((d_k - d_p).abs().max() / d_p.abs().max()).item())

        # the port's own launcher first, then every variant
        mk, vk = state()
        d_k = qo._adam8_update_triton(g, mk, vk, scalars, 0.9, 0.999, True)
        torch.cuda.synchronize()
        res = dict(shape=shape, rows=R, variant="port", **check(mk, vk, d_k),
                   **qo.triton_kernel_info("adam8_flat"),
                   ms=time_ms(lambda: qo._adam8_update_triton(g, mk, vk, scalars, 0.9, 0.999, True)))
        res["bound_share"] = bound_ms / res["ms"]
        print(json.dumps(res), flush=True)
        results.append(res)
        for dq, rq, dl, tile, warps, persist in variants:
            mk, vk = state()
            d = torch.empty_like(g)
            h = run_variant(mk, vk, d, dq, rq, dl, tile, warps, persist)
            torch.cuda.synchronize()
            res = dict(shape=shape, rows=R, dequant=dq, requant=rq, delta=dl, tile_rows=tile,
                       warps=warps, persistent_per_sm=persist, **check(mk, vk, d),
                       n_regs=getattr(h, "n_regs", None), n_spills=getattr(h, "n_spills", None))
            res["ok"] = (res["code_max"] <= 1 and res["code_share"] <= 1e-3
                         and res["scale_err"] <= 1e-6 and res["delta_err"] <= 1e-6)
            res["ms"] = time_ms(lambda: run_variant(mk, vk, d, dq, rq, dl, tile, warps, persist))
            res["bound_ms"] = bound_ms
            res["bound_share"] = bound_ms / res["ms"]
            print(json.dumps(res), flush=True)
            results.append(res)
        del g, mp, vp, d_p
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
