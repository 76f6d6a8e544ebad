"""Model profiler: per-module flops/params/memory + measured step cost
(the port of ``dlrover_tpu/accel/profiler.py``).

Parity: ATorch ``AProfiler`` (atorch/atorch/utils/prof.py:38 — analytic
per-module flops formulas at :489-650 plus timed profiles feeding the
dry-runner). Two sources of truth:

- ``profile_model``: analytic per-block accounting from the config (no
  device needed) — params, fwd/bwd FLOPs, activation bytes. A copy of
  the JAX package's, number for number.
- ``measure_step``: the time of a step, achieved TFLOP/s and MFU
  against the card's published peak (``PEAK_TFLOPS``, keyed by
  ``torch.cuda.get_device_name``). On the card each step is timed by
  CUDA events around it; on the CPU by the host clock.

``module_breakdown`` times each module alone (CUDA events), and
``trace_steps`` captures a ``torch.profiler`` trace of a few steps
through the port's ``ProfilerCapture``.

``PipelineStats`` (the counters of the overlapped host-device pipeline)
is defined here, as in the JAX package; ``data/prefetch.py`` imports it
from here.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.models.config import TransformerConfig, is_moe_layer

# dense bf16 tensor-core peak TFLOP/s by card name (published specs),
# used for MFU. The key is a lower-case substring of
# ``torch.cuda.get_device_name()``; longer keys are tried first.
PEAK_TFLOPS = {
    # NVIDIA H100 SXM5 ("NVIDIA H100 80GB HBM3"), dense bf16
    "h100 80gb hbm3": 989.0,
    "h100 sxm": 989.0,
    # NVIDIA H100 PCIe, dense bf16
    "h100 pcie": 756.0,
}


def chip_peak_tflops(device=None) -> Optional[float]:
    """The card's dense bf16 peak, or None for a card (or the CPU) the
    table does not name. ``device``: a ``torch.device``, a card name, or
    None for the current card."""
    import torch

    if isinstance(device, str) and device not in ("cuda", "cpu") and not device.startswith("cuda:"):
        kind = device.lower()
    else:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name(dev).lower()
    for key in sorted(PEAK_TFLOPS, key=len, reverse=True):
        if key in kind:
            return PEAK_TFLOPS[key]
    return None


@dataclass
class PipelineStats:
    """Counters of the overlapped host-device pipeline (what the port
    uses of the JAX package's ``accel.profiler.PipelineStats``): the
    prefetcher's hits and waits, the checkpoint stager's work and the
    gradient sync's plan and probe."""

    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetch_reprimes: int = 0
    prefetch_wait_s: float = 0.0  # time the consumer blocked on misses
    stage_chunks: int = 0
    stage_bytes: int = 0
    stage_backlog_bytes: int = 0  # bytes still to stage (last observed)
    stage_block_s: float = 0.0  # loop-thread seconds in advance()
    stage_commits: int = 0
    fenced_steps: int = 0  # optimizer steps that waited for a staging copy
    # -- elastic resize (accel/compile_cache.py, the restart's landing) --
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    # state remapped without a host trip (none in the port: a resize
    # lands in the restore) / read back from shm or storage
    reshard_bytes_device: int = 0
    reshard_bytes_host: int = 0
    resize_count: int = 0
    resize_downtime_ms: float = 0.0  # the last resize's downtime
    # ranks left idle by the last resize's degradation (a world the
    # batch does not divide over; also the dlrover_resize_idle_ranks
    # gauge) and the zero-weight pad rows of its micro-batch rebalance
    # (dlrover_resize_mb_pad)
    resize_idle_ranks: int = 0
    resize_mb_pad: int = 0
    # capacity re-splits applied by the MoE rebalancer (the trainer's
    # moe_rebalance_interval; each one rebuilds the step; also the
    # dlrover_moe_capacity_resplits gauge)
    moe_capacity_resplits: int = 0
    # -- the gradient sync (parallel/grad_sync.py) ----------------------
    # "explicit" (the bucketed sync) or "gspmd" (the default schedule:
    # one all-reduce of the whole tree per microbatch); "" until a
    # trainer resolves the plan
    grad_sync_path: str = ""
    # standalone time of one bucketed sync (its roofline) and its
    # per-link split (slice-local legs vs the cross-slice all-reduce)
    grad_sync_ms: float = 0.0
    grad_sync_ici_ms: float = 0.0
    grad_sync_dcn_ms: float = 0.0
    # the analytic share of sync wire time hidden behind compute (None
    # until a plan is active)
    comm_overlap_pct: Optional[float] = None
    # wire bytes one sync moves vs the uncompressed sync's
    grad_bytes_wire: int = 0
    grad_bytes_raw: int = 0

    @property
    def grad_bytes_wire_vs_raw(self) -> Optional[list]:
        if not self.grad_bytes_raw:
            return None
        return [self.grad_bytes_wire, self.grad_bytes_raw]

    @property
    def compile_cache_hit_pct(self) -> Optional[float]:
        n = self.compile_cache_hits + self.compile_cache_misses
        if not n:
            return None
        return round(100.0 * self.compile_cache_hits / n, 2)

    def as_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["compile_cache_hit_pct"] = self.compile_cache_hit_pct
        d["reshard_bytes_device_vs_host"] = [self.reshard_bytes_device, self.reshard_bytes_host]
        d["resize_downtime_ms"] = round(d["resize_downtime_ms"], 2)
        for k in ("grad_sync_ms", "grad_sync_ici_ms", "grad_sync_dcn_ms"):
            d[k] = round(d[k], 3)
        # numeric twin for the metrics registry (fold_pipeline_stats
        # skips strings): 1 = explicit, 0 = default, None = unresolved
        d["grad_sync_explicit"] = (
            None if not self.grad_sync_path else int(self.grad_sync_path == "explicit")
        )
        d["grad_bytes_wire_vs_raw"] = self.grad_bytes_wire_vs_raw
        return d

    def summary(self) -> str:
        legs = (
            f" [{self.grad_sync_ici_ms:.1f} ici / {self.grad_sync_dcn_ms:.1f} dcn]"
            if self.grad_sync_dcn_ms
            else ""
        )
        path = f" [{self.grad_sync_path}]" if self.grad_sync_path else ""
        gsync = (
            f", grad sync{path} {self.grad_sync_ms:.1f} ms standalone{legs} "
            f"({'-' if self.comm_overlap_pct is None else self.comm_overlap_pct}"
            f"% overlapped, {self.grad_bytes_wire >> 10} KiB wire vs "
            f"{self.grad_bytes_raw >> 10} KiB raw per sync)"
            if self.grad_bytes_raw
            else (f", grad sync{path}" if self.grad_sync_path else "")
        )
        n = self.prefetch_hits + self.prefetch_misses
        ov = round(100.0 * self.prefetch_hits / n, 2) if n else None
        return (
            f"prefetch {self.prefetch_hits}h/{self.prefetch_misses}m"
            f" ({'-' if ov is None else ov}% overlap), "
            f"staged {self.stage_bytes >> 20} MiB in {self.stage_chunks} "
            f"chunks ({self.stage_block_s * 1e3:.1f} ms on critical "
            f"path, {self.stage_commits} commits){gsync}"
        )


@dataclass
class ModuleProfile:
    name: str
    params: int
    fwd_flops: float  # per step at the given batch/seq
    activation_bytes: int


@dataclass
class ModelProfile:
    batch: int
    seq: int
    modules: List[ModuleProfile] = field(default_factory=list)

    @property
    def total_params(self) -> int:
        return sum(m.params for m in self.modules)

    @property
    def fwd_flops(self) -> float:
        return sum(m.fwd_flops for m in self.modules)

    @property
    def step_flops(self) -> float:
        """fwd + bwd ≈ 3x fwd (the standard 6ND/2ND split)."""
        return 3.0 * self.fwd_flops

    @property
    def activation_bytes(self) -> int:
        return sum(m.activation_bytes for m in self.modules)

    def report(self) -> str:
        lines = [
            f"{'module':<18}{'params':>12}{'fwd GFLOPs':>14}{'act MB':>10}"
        ]
        for m in self.modules:
            lines.append(
                f"{m.name:<18}{m.params:>12,}"
                f"{m.fwd_flops / 1e9:>14.2f}"
                f"{m.activation_bytes / 1e6:>10.1f}"
            )
        lines.append(
            f"{'TOTAL':<18}{self.total_params:>12,}"
            f"{self.fwd_flops / 1e9:>14.2f}"
            f"{self.activation_bytes / 1e6:>10.1f}"
        )
        lines.append(
            f"step (fwd+bwd) ≈ {self.step_flops / 1e12:.3f} TFLOPs @ "
            f"batch={self.batch} seq={self.seq}"
        )
        return "\n".join(lines)


def profile_model(
    cfg: TransformerConfig, batch: int, seq: int, act_bytes: int = 2
) -> ModelProfile:
    """Analytic per-module accounting (parity: prof.py:489-650 flops
    formulas, transformer-specialized)."""
    d, f, v = cfg.model_dim, cfg.ffn_dim, cfg.vocab_size
    h, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    T, B = seq, batch
    tok = B * T
    prof = ModelProfile(batch=batch, seq=seq)

    emb_params = v * d + (0 if cfg.rope else cfg.max_seq_len * d)
    prof.modules.append(
        ModuleProfile("embed", emb_params, 0.0, tok * d * act_bytes)
    )

    for i in range(cfg.num_layers):
        qkv_params = d * (h + 2 * kvh) * hd + h * hd * d
        attn_flops = 2.0 * tok * d * (h + 2 * kvh) * hd  # projections
        attn_flops += 2.0 * tok * h * hd * d  # output proj
        # qk^T and softmax*v have identical causal structure: half each
        attn_flops += 2.0 * B * h * T * T * hd / 2
        attn_flops += 2.0 * B * h * T * T * hd / 2
        attn_act = tok * (h + 2 * kvh) * hd * act_bytes + tok * d * act_bytes
        prof.modules.append(
            ModuleProfile(
                f"block{i}.attn", qkv_params, attn_flops, attn_act
            )
        )
        if is_moe_layer(cfg, i):
            mlp_params = cfg.num_experts * 2 * d * f + d * cfg.num_experts
            mlp_flops = 2.0 * tok * 2 * d * f  # top-1: same flops as dense
        elif cfg.swiglu:
            mlp_params = 3 * d * f
            mlp_flops = 2.0 * tok * 3 * d * f
        else:
            mlp_params = 2 * d * f + f + d
            mlp_flops = 2.0 * tok * 2 * d * f
        prof.modules.append(
            ModuleProfile(
                f"block{i}.mlp", mlp_params, mlp_flops,
                tok * f * act_bytes,
            )
        )

    head_params = 0 if cfg.tie_embeddings else d * v
    prof.modules.append(
        ModuleProfile(
            "lm_head", head_params, 2.0 * tok * d * v,
            tok * v * 4,  # logits are fp32
        )
    )
    return prof


# -- timing -------------------------------------------------------------------


def _tensors_of(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors_of(v)]
    return []


def _device_of(args) -> "Any":
    import torch

    ts = _tensors_of(args)
    return ts[0].device if ts else torch.device("cpu")


class _Clock:
    """Elapsed milliseconds of what runs between ``start`` and ``stop``:
    CUDA events on the card (the device's clock, read once the card
    passed the end event), the host clock on the CPU."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self._a = self._b = None
        self._t0 = 0.0

    def start(self):
        import torch

        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t0) * 1e3


def trace_steps(step_fn, state, args: tuple, trace_dir: str, steps: int = 3):
    """Capture a ``torch.profiler`` trace (CPU and, on the card, CUDA
    activity; Chrome trace-event JSON) of ``steps`` train steps under
    ``trace_dir`` through the port's ``ProfilerCapture``; returns the
    capture's directory. One step runs first, outside the trace (the
    JAX package compiles there; here it warms the kernels' builds)."""
    from dlrover_tpu_torch.obs.flight_recorder import ProfilerCapture

    state, _ = step_fn(state, *args)
    cap = ProfilerCapture(out_root=trace_dir, cooldown_s=0.0)
    cap.request(steps, reason="trace_steps")
    for _ in range(steps):
        cap.on_step_begin()
        state, _ = step_fn(state, *args)
        cap.on_step_end()
    return cap.artifacts[-1] if cap.artifacts else trace_dir


@dataclass
class StepMeasurement:
    step_seconds: float
    achieved_tflops: float
    mfu_pct: Optional[float]
    device_kind: str


def measure_step(
    step_fn, state, args: tuple, model_flops: float, iters: int = 10
) -> StepMeasurement:
    """Time a train step and report achieved TFLOP/s + MFU against the
    card's peak. One warm-up step, then ``iters`` steps between two CUDA
    events (the device's clock: no host sync inside the window); on the
    CPU the host clock. MFU counts one card (the port drives one card a
    process)."""
    import torch

    device = _device_of(args)
    state, _ = step_fn(state, *args)  # warm-up (kernel builds, allocator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    clock = _Clock(device)
    clock.start()
    for _ in range(iters):
        state, _ = step_fn(state, *args)
    dt = clock.stop() / 1e3 / iters
    tflops = model_flops / dt / 1e12
    peak = chip_peak_tflops(device) if device.type == "cuda" else None
    return StepMeasurement(
        step_seconds=dt,
        achieved_tflops=tflops,
        mfu_pct=round(100.0 * tflops / peak, 2) if peak else None,
        device_kind=(
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
    )


@dataclass
class ModuleLatency:
    name: str
    ms: float
    gflops: float  # analytic, per invocation
    tflops_per_s: Optional[float]  # achieved (None when flops unknown)


def module_breakdown(
    cfg: TransformerConfig,
    tx,
    batch: int,
    seq: int,
    iters: int = 10,
    device=None,
) -> List[ModuleLatency]:
    """MEASURED per-module latency — the "why is my step slow" view
    (parity: AProfiler's per-module flops/latency/memory tables,
    atorch utils/prof.py:489-650).

    Each module is timed in isolation on ``device`` (the card unless the
    caller asks for the CPU): embedding lookup, ONE transformer block
    fwd and fwd+bwd, the LM head fwd+bwd (the vocab matmul + softmax
    NLL), and the optimizer update over the full parameter list (``tx``:
    an optimizer factory, ``build_optimizer``'s). Isolation overstates
    memory traffic relative to a whole step, so read the numbers as
    per-module rooflines: a module whose isolated time already dominates
    the measured whole-step time is the bottleneck."""
    import torch

    from dlrover_tpu_torch.models.transformer import (
        _attention_block,
        _mlp_block,
        _torch_dtype,
        embed_tokens,
        init_params,
        layer_views,
        lm_head,
        token_nll,
    )
    from dlrover_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg, dev)
    prof = profile_model(cfg, batch, seq)
    by_name = {m.name: m for m in prof.modules}
    tokens = torch.zeros((batch, seq), dtype=torch.long, device=dev)
    positions = torch.arange(seq, device=dev).expand(batch, seq)
    x = torch.zeros((batch, seq, cfg.model_dim), dtype=_torch_dtype(cfg.dtype),
                    device=dev, requires_grad=True)
    layer0 = layer_views(params.layers)[0]
    layer_leaves = [p for p in params.parameters() if p.requires_grad]

    def _block_fwd():
        with torch.no_grad():
            return _mlp_block(_attention_block(x, layer0, cfg, positions), layer0, cfg)

    def _block_fwd_bwd():
        h = _mlp_block(_attention_block(x, layer0, cfg, positions), layer0, cfg)
        return torch.autograd.grad(h.float().sum(), [x], allow_unused=True)

    def _head_fwd_bwd():
        loss = token_nll(lm_head(params, x, cfg), tokens)
        return torch.autograd.grad(loss, [x])

    def _embed():
        with torch.no_grad():
            return embed_tokens(params, tokens, cfg)

    leaves = params.jax_ordered_parameters()
    opt = tx(leaves)

    def _opt():
        for p in leaves:
            p.grad = torch.full_like(p, 1e-4)
        opt.step()

    block_fwd_flops = (
        by_name["block0.attn"].fwd_flops + by_name["block0.mlp"].fwd_flops
    )
    cases = [
        ("embed", _embed, 0.0),
        ("block_fwd", _block_fwd, block_fwd_flops),
        ("block_fwd_bwd", _block_fwd_bwd, 3.0 * block_fwd_flops),
        ("lm_head_fwd_bwd", _head_fwd_bwd, 3.0 * by_name["lm_head"].fwd_flops),
        ("optimizer_update", _opt, 0.0),
    ]
    out: List[ModuleLatency] = []
    for name, fn, flops in cases:
        fn()  # warm-up
        clock = _Clock(dev)
        clock.start()
        for _ in range(iters):
            fn()
        dt = clock.stop() / 1e3 / iters
        out.append(
            ModuleLatency(
                name=name,
                ms=round(dt * 1e3, 3),
                gflops=round(flops / 1e9, 4),
                tflops_per_s=round(flops / dt / 1e12, 2) if flops else None,
            )
        )
    del layer_leaves
    return out
