"""Dry-runner: score a Strategy without committing to it (the port of
``dlrover_tpu/accel/dry_runner.py``).

Parity: atorch's dry-runner (auto/dry_runner/dry_runner.py, used at
accelerate.py:118-147) transforms the model per strategy and times real
training steps. The JAX package reads XLA's cost and memory analysis of
the compiled step before running anything; torch has no compiler that
reports either, so the two tiers are, here:

- ``compiled_cost`` (the name is kept): a STATIC estimate that allocates
  nothing. The flops and bytes come from the profiler's formulas (the
  JAX package's analytic tier, ``est_source="analytic"``), the gradient
  sync from the measured ``LinkModel`` (``_comm_estimate``, copied), and
  the memory from ``static_peak_bytes``: a reckoning of the resident
  state, the gradients, the optimizer's transient and the activations
  live at the step's peak, by remat mode (its terms are in that
  function's docstring). It is the whole fits-in-memory decision on one
  card: the plain Llama-2-7B candidate must be refused here, before any
  allocation;
- ``timed_run``: a warm-up and the median of ``steps`` real steps of a
  fresh state on the device, with ``torch.cuda.max_memory_allocated``
  over the run (above what was allocated before it) as its memory. The
  timed state is drawn from a generator of the device's own (its values
  do not matter for timing), and its batch from a numpy generator of its
  own: nothing a dry run does moves the global generators, a sampler or
  what a trainer computes afterwards. A failed run is caught, its state
  freed (``gc.collect()``, ``torch.cuda.empty_cache()``), and on several
  ranks the ranks agree on every candidate's outcome (one all-reduce of
  a flag) before any goes on.

The roofline weights are the H100 SXM's published peaks, not the JAX
package's v5p numbers. The host-link term (``host_exposed_s``) is the
host-link arbiter's aggregate registered demand priced through the link
model's host leg (``transfer_sched.aggregate_host_exposed_s``), and
``host_hidden_measured`` says whether its hidden fraction came from a
calibration (else the documented constant).

``_build`` returns the port's ``(cfg, mesh, step_fn, init_fn,
make_batch, abstract_state)``: the mesh of ``parallel/mesh.build_mesh``
(cached per layout, so repeated builds make no new process groups), the
step of ``models/train.build_train_step``, ``init_fn(seed,
device_generator=False)``, and the abstract state's params on the
``meta`` device. Strategies that need machinery the port does not have
raise here, naming its ROADMAP item.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Optional, Tuple

import numpy as np

from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.config import TransformerConfig

# roofline weights for the static cost: seconds per flop / per HBM byte.
# Only the *ratio* matters for ranking; these are the H100 SXM's
# published peaks (NVIDIA H100 80GB HBM3: 989 TFLOP/s dense bf16, 3.35
# TB/s HBM3).
_SEC_PER_FLOP = 1 / 989e12
_SEC_PER_BYTE = 1 / 3.35e12


@dataclass
class DryRunReport:
    strategy: Strategy
    ok: bool
    error: Optional[str] = None
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    # the static peak estimate (compiled_cost) or the measured peak of
    # a timed run, per device
    mem_bytes: float = 0.0
    # tri-state memory gate: True = fits, False = overflows, None = no
    # memory figure ("unknown"). Unknown is VIABLE (`fits is not False`)
    # in both search paths.
    fits: Optional[bool] = True
    est_step_s: float = 0.0  # roofline estimate
    # where est_step_s came from: "analytic" (the profiler's formulas;
    # the port has no compiler cost analysis), "+calib" once repriced
    # by the drift factors
    est_source: str = "analytic"
    step_s: Optional[float] = None  # measured (finalists only)
    # gradient-sync wire bytes per device per optimizer step and the
    # seconds of it billed as EXPOSED
    comm_bytes_per_device: float = 0.0
    comm_exposed_s: float = 0.0
    # the exposed comm term itemized by interconnect; sums to
    # comm_exposed_s
    comm_ici_s: float = 0.0
    comm_dcn_s: float = 0.0
    # exposed seconds of the host-link traffic (the arbiter's registered
    # demand, priced), and whether its hidden fraction was measured
    host_exposed_s: float = 0.0
    host_hidden_measured: bool = False


def hbm_fits(
    mem_bytes: float, hbm_budget: Optional[float]
) -> Optional[bool]:
    """Tri-state memory gate shared by BOTH search paths (combination and
    TPE import this one function so the semantic cannot diverge):
    True = fits, False = overflows, None = no memory figure ("unknown" —
    viable but ranked below known fits)."""
    if not hbm_budget:
        return True
    if mem_bytes > 0:
        return mem_bytes <= hbm_budget
    return None


def _n_ranks(devices) -> int:
    """The rank count a search prices for: an int, a sequence's length,
    or (None) the default process group's size."""
    if isinstance(devices, int):
        return max(devices, 1)
    if isinstance(devices, (list, tuple)):
        return max(len(devices), 1)
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


# -- building a strategy -----------------------------------------------------

_MESHES = {}


def _mesh_for(config, device_type: str):
    """``build_mesh`` once per (layout, device type, process group): every
    build makes the axes' process groups anew (a collective on every
    rank), and a search builds the same layout for each timed run and
    again for the winner."""
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel.mesh import build_mesh

    pg = dist.distributed_c10d._get_default_group() if dist.is_initialized() else None
    key = (config, device_type)
    hit = _MESHES.get(key)
    if hit is None or hit[0] is not pg:
        hit = _MESHES[key] = (pg, build_mesh(config, device_type))
    return hit[1]


def _check_unported(strategy: Strategy, cfg: TransformerConfig, tx) -> None:
    """Raise for what the port cannot build yet, naming the ROADMAP item
    (as ``models/transformer.check_supported`` does)."""
    from dlrover_tpu_torch.models.transformer import check_supported

    m = strategy.mesh
    if m.pp > 1:
        if strategy.offload_opt:
            # a silently-ignored offload would let a run OOM while its
            # strategy claims the state left the card
            raise ValueError(
                "offload_opt is not supported on the pipeline (pp>1) "
                "path: pipeline state keeps its own on-device layout"
            )
        raise NotImplementedError("pipeline parallelism (pp > 1) is not ported yet (ROADMAP A11)")
    for name in ("1f1b", "interleaved"):
        if name in strategy.opts:
            raise NotImplementedError(
                f"the {name} pipeline schedule is not ported yet (ROADMAP A11)"
            )
    if m.ep > 1:
        raise NotImplementedError("expert parallel meshes are not ported yet (ROADMAP A11)")
    check_supported(cfg, m)
    if getattr(tx, "opt_name", None) == "adamw_8bit_flat" and (m.fsdp > 1 or m.tp > 1):
        # the flat optimizer concatenates every big leaf per step: on a
        # model-sharded mesh that defeats the sharding
        raise ValueError(
            "adamw_8bit_flat is for replicated/dp-only states; use "
            "adamw_8bit (per-leaf) with fsdp/tp/ep/sp/pp sharding"
        )


def _apply_strategy(strategy: Strategy, cfg: TransformerConfig):
    """(config, strategy) with the strategy's named optimizations applied
    and its remat pinned on the config, as the JAX package pins it. The
    dtype is pinned only by the ``bf16`` / ``fp32`` optimizations: a
    Strategy's default ``dtype`` field does not override a config's own
    dtype in the port (it never has: an explicit ``Strategy()`` on a
    float32 config trains in float32)."""
    from dlrover_tpu_torch.accel.opt_lib import apply_optimizations

    cfg, strategy = apply_optimizations(cfg, strategy, strategy.opts)
    cfg = dc_replace(cfg, remat=strategy.remat)
    if "bf16" in strategy.opts or "fp32" in strategy.opts:
        cfg = dc_replace(cfg, dtype=strategy.dtype)
    return cfg, strategy


def _build(
    strategy: Strategy,
    cfg: TransformerConfig,
    tx,
    device=None,
    before_update=None,
    abstract: bool = False,
):
    """Build (cfg, mesh, step_fn, init_fn, make_batch, abstract_state)
    for a strategy. ``abstract=True`` (the static tier) validates and
    returns the abstract state only: no mesh, no step, nothing on a
    device. ``before_update`` reaches ``build_train_step`` (the
    trainer's fence for a checkpoint's copies)."""
    import torch

    from dlrover_tpu_torch.models.transformer import Transformer

    # re-derive the config from the strategy's named optimizations (a
    # Strategy is a serializable value — another rank applying the same
    # one must build the identical step)
    cfg, applied = _apply_strategy(strategy, cfg)
    _check_unported(applied, cfg, tx)

    def abstract_state():
        """The state's params on the meta device (shapes and dtypes,
        no storage)."""
        from dlrover_tpu_torch.models.train import TrainState

        with torch.device("meta"):
            return TrainState(step=0, params=Transformer(cfg), opt_state=None)

    if abstract:
        return cfg, None, None, None, None, abstract_state

    from dlrover_tpu_torch.models.train import build_train_step, init_state
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.parallel.mesh import batch_sharding
    from dlrover_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mesh = _mesh_for(applied.mesh, dev.type)
    plan = grad_sync.resolve_plan(cfg, applied, grad_sync.model_leaves(cfg))
    step_fn = build_train_step(
        cfg, tx, grad_accum=applied.grad_accum, before_update=before_update,
        mesh=mesh, plan=plan, batch_pad=applied.batch_pad,
    )
    step_fn.plan = plan

    def init_fn(seed: int = 0, device_generator: bool = False):
        """The train state: params from ``torch.Generator().manual_seed
        (seed)`` (a trainer's: the same weights on every device), or with
        ``device_generator`` from a generator on the device (fast for a
        7 B state; the dry runs' timed state)."""
        gen = (
            torch.Generator(device=dev).manual_seed(seed)
            if device_generator else None
        )
        state = init_state(
            cfg, tx, seed=seed, devices=dev, mesh=mesh, plan=plan,
            offload_opt_state=applied.offload_opt, generator=gen,
        )
        grad_sync.ensure_residual(state, plan, dev)
        return state

    def make_batch(batch, seq):
        """This rank's rows of a seeded global batch (a numpy generator
        of its own), padded by ``batch_pad``."""
        rng = np.random.default_rng(0)
        x = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
        if applied.batch_pad:
            from dlrover_tpu_torch.models.train import pad_batch_rows

            x = pad_batch_rows(x, batch + applied.batch_pad)
        m = applied.mesh
        if m.dp * m.fsdp > 1:
            x = x[batch_sharding(mesh, x.shape[0], applied.grad_accum)]
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return t, t

    return cfg, mesh, step_fn, init_fn, make_batch, abstract_state


# -- the static memory estimate ----------------------------------------------


def _opt_state_bytes(tx, leaves) -> Tuple[float, float, float]:
    """(state bytes, step transient bytes, largest offload unit bytes) of
    ``tx``'s optimizer over ``leaves``, from ``build_optimizer``'s name
    (``tx.opt_name``; an unknown factory is priced as AdamW).

    - ``adamw`` / ``adam`` / ``agd``: two f32 moments (8 B a param); the
      foreach update holds one param-sized f32 list (its sqrt of the
      second moment);
    - ``adamw_8bit_flat``: int8 codes and one f32 scale a 128-block per
      moment for leaves of at least ``min_quantized_size``, f32 moments
      below; the step holds one packed group's grads and delta (8 B an
      element of the largest group);
    - ``adamw_8bit`` (``bits=4``: a nibble first moment) per leaf; its
      transient is one leaf's f32 delta (the kernel updates the moments
      in place), and for a leaf narrower than f32 its f32 grad and the
      delta's cast (an H100 80GB HBM3 at 700 W, Llama-2 width x 4,
      tp = 1: the step's peak held the grads and the embedding's 524 MB
      delta, ``chip_smoke.py --phase tp``'s allocator trace);
    - ``sgd``: a momentum buffer when momentum is set."""
    from dlrover_tpu_torch.ops.host_offload import UNIT_BYTES
    from dlrover_tpu_torch.ops.quantized_optim import BLOCK

    name = getattr(tx, "opt_name", "adamw")
    kw = getattr(tx, "opt_kwargs", {}) or {}
    sizes = [int(p.numel()) for p in leaves]
    n = sum(sizes)
    big = max(sizes, default=0)
    if name in ("adamw_8bit", "adamw_8bit_flat", "adamw_4bit"):
        minq = int(kw.get("min_quantized_size", 4096))
        bits = 4 if name == "adamw_4bit" else int(kw.get("bits", 8))
        codes = (0.5 if bits == 4 else 1.0) + 1.0  # both moments, a byte each
        per_elem = codes + 2 * 4 / BLOCK  # + one f32 scale a block each
        small = float(sum(s for s in sizes if s < minq))
        if name == "adamw_8bit_flat":
            from dlrover_tpu_torch.ops.quantized_optim import _flat_layout

            groups = _flat_layout(leaves, minq, int(kw.get("group_elems", 1 << 27))).groups
            largest = float(max((g.total for g in groups), default=0))
            state = per_elem * sum(g.total for g in groups) + 8.0 * small
            # one group's packed grads and delta; the small leaves'
            # packed grads, new moments and deltas
            trans = max(8.0 * largest, 16.0 * small)
            return state, trans, max(per_elem * largest, 8.0 * small)
        q = [s for s in sizes if s >= minq]
        state = sum(-(-s // BLOCK) * BLOCK * per_elem for s in q) + 8.0 * small
        # one leaf's f32 delta; a narrower leaf's f32 grad and cast delta
        pb = leaves[0].element_size() if len(leaves) else 4
        return state, (4.0 + (4.0 + pb if pb < 4 else 0.0)) * big, per_elem * big
    if name == "sgd":
        state = 4.0 * n if kw.get("momentum") else 0.0
        return state, 0.0, 4.0 * big
    unit = max(min(8.0 * n, float(UNIT_BYTES)), 8.0 * big)
    return 8.0 * n, 4.0 * n, unit


def _sp_buffers(cfg: TransformerConfig, tok: int, ab: int) -> float:
    """One layer's in-flight bytes of the sequence-parallel scheme, for a
    rank's ``tok`` tokens: the ring's backward holds a key/value hop
    (sent and received) and the travelling f32 dk / dv (sent and
    received) beside its f32 dq; Ulysses holds the all-to-alls' copies
    of q, k, v and the output, in and out."""
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    if cfg.sp_scheme == "ulysses":
        return 2.0 * tok * (2 * q + 2 * kv) * ab
    return 2.0 * 2 * tok * kv * ab + 2.0 * 2 * tok * kv * 4 + tok * q * 4.0


def static_peak_bytes(
    cfg: TransformerConfig,
    strategy: Strategy,
    tx,
    batch: int,
    seq: int,
    leaves=None,
) -> float:
    """Peak device bytes of one train step on one rank, reckoned from the
    shapes alone (nothing is allocated). ``cfg`` and ``strategy`` as
    ``_build`` applies them. For this rank's microbatch of ``tok``
    tokens and a compute dtype of ``ab`` bytes:

    - resident: the params ``P`` and the optimizer state ``S``
      (``_opt_state_bytes``; 1/fsdp of it on an fsdp mesh; under
      ``offload_opt`` none of it, but the two slots of the double
      buffer). Under ZeRO (fsdp with the explicit sync) the params are
      1/fsdp too, and the backward phase adds the unit
      (``models/train.ZeroUnits``) its backward gathers again: the
      largest block (the stacked blocks under ``scan_layers``) under
      remat, which recomputes it, or when the params are no wider than
      the compute dtype, so the graph saved their storage; else only
      the norm scales, priced 0 (the weights were saved as casts);
    - the optimizer phase: the grads ``G`` (the param dtype; plus f32
      accumulators under ``grad_accum``; under ZeRO this rank's shards
      of them) and the update's transient ``T``;
    - with the explicit bucketed sync (``comm_overlap`` on a mesh with
      data axes), the sync phase: the local grads ``G``, the f32 sums it
      returns (the whole tree, or under ZeRO this rank's 1/fsdp of it)
      and one bucket in flight (its f32 flat and the backend's copy of
      it: gloo's reduce-scatter copies its input);
    - under remat, the backward's end: the grads of every leaf beside
      the first block's recompute, which stops after its attention (the
      non-reentrant checkpoint's early stop): the attention norm's two
      f32 tensors (16 B a dim), the normed input and its copy, q, k, v
      and the output, q and k after RoPE, and under tp the tp sum's
      result (the same trace: the grads and 424 MB of those at tp = 2);
    - the backward phase (its start): what the forward saved and the lm
      head's backward. A block saves, a token: its two norms' f32
      tensors (RMSNorm ``x`` and ``y``: 8 B a dim; LayerNorm also
      ``x - mean``: 12), the normed input in ``ab`` twice, q/k/v and
      the attention output in ``ab`` (and q/k once more after RoPE),
      the MLP's ``ab`` tensors (SwiGLU: gate, its silu, up, their
      product; GELU: its input and output), and the block's weights
      cast to ``ab`` when the params are wider. The head holds the
      logits in ``ab`` and five f32 logits-sized tensors (the f32
      logits, the logsumexp's and the gather's grads, their sum, the
      logsumexp's work tensor) and its weight's f32 grad. Without remat
      every block's saved set is live beside the head's; with remat the
      blocks' inputs and the larger of the head's backward and one
      block's recompute beside the head's f32 weight grad (the same
      trace: Llama-2 width x 2, tp = 1, peaked at the update, 7.32 GB,
      where the two summed priced 8.82).

    Under sequence parallelism a rank holds 1/sp of each row's tokens,
    and the backward phase adds one layer's in-flight buffers of the
    scheme (``_sp_buffers``).

    Under tensor parallelism a rank holds its tp-local leaves (1/tp of
    each split leaf: ``parallel/sharding_rules``), and with them the
    grads and the optimizer state of its boxes (under 3d the fsdp
    division on top); its block activations are those of H/tp heads and
    F/tp MLP columns, and a vocab split over tp holds the logits of
    V/tp: the ``ab`` logits and two f32 ones (the saved f32 logits and
    the vocab-parallel loss's softmax grad, ``_VocabParallelNLL``) with
    the local head's f32 grad. Each tp collective adds its f32 copy of
    the rank's ``tok x D`` and the cast back.

    The peak is the resident state plus the largest phase. Held against
    the measured peaks on an H100 80GB HBM3 at 700 W (``chip_smoke.py
    --phase peak_memory`` and its accel phase): -0.5 % to +4.4 % without
    remat (Llama-2 width at 4, 8 and 16 layers, gpt2_small, gpt2_xl with
    AdamW), -0.6 % and -0.1 % under remat (Llama-2 width at 4 and 32
    layers), -4.6 % for gpt2_xl with its AdamW state offloaded;
    Llama-2-7B without remat is priced 85.95 GB and ran out of the
    card's memory."""
    import torch

    from dlrover_tpu_torch.parallel import grad_sync

    if leaves is None:
        leaves = grad_sync.model_leaves(cfg)
    m = strategy.mesh
    tp = max(m.tp, 1)
    plan_leaves = leaves
    if tp > 1:
        # the rank's own leaves: its boxes of the split ones
        leaves = grad_sync.model_leaves(cfg, m)
    shards = max(m.dp * m.fsdp, 1)
    rows = max((batch + strategy.batch_pad) // shards, 1)
    ga = max(strategy.grad_accum, 1)
    sp = max(m.sp, 1)
    tok = max(rows // ga, 1) * seq // sp
    p_bytes = float(sum(p.numel() * p.element_size() for p in leaves))
    n_params = float(sum(p.numel() for p in leaves))
    ab = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    pb = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    state, trans, unit = _opt_state_bytes(tx, leaves)
    state /= max(m.fsdp, 1)
    zero = m.fsdp > 1 and strategy.resolved_comm_overlap()
    plan = None
    if shards > 1 and strategy.resolved_comm_overlap():
        plan = grad_sync.resolve_plan(cfg, strategy, plan_leaves)
    if strategy.offload_opt:
        state, trans = 0.0, trans + 2.0 * unit
    grads = p_bytes + (4.0 * n_params if ga > 1 else 0.0)
    D, F, L, V = cfg.model_dim, cfg.ffn_dim // tp, cfg.num_layers, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim // tp, cfg.kv_heads * cfg.head_dim // tp
    split_vocab = tp > 1 and V % tp == 0
    if split_vocab:
        V //= tp
    head_params = V * D * (1 if cfg.tie_embeddings else 2)
    block_params = (n_params - head_params) / max(L, 1)
    per_tok = (
        2 * (8 if cfg.rmsnorm else 12) * D  # two norms' f32 tensors
        + 2 * ab * D  # the normed inputs
        + ab * (q + 2 * kv + q)  # q, k, v, the attention output
        + (ab * (q + kv) if cfg.rope else 0)  # q, k after RoPE
        + ab * F * (4 if cfg.swiglu else 2)
    )
    a_block = tok * per_tok + (block_params * ab if pb > ab else 0.0)
    head = tok * V * (ab + (2 if split_vocab else 5) * 4) + V * D * 4
    if cfg.remat:
        live = L * tok * D * ab + max(a_block + V * D * 4, head)
    else:
        live = L * a_block + head
    if sp > 1:
        live += _sp_buffers(cfg, tok, ab)
    if tp > 1:
        live += tok * D * (4 + ab)
    bwd_end = 0.0
    if cfg.remat:
        bwd_end = grads + tok * (
            16 * D + 2 * ab * D + ab * (2 * q + 2 * kv)
            + (ab * (q + kv) if cfg.rope else 0) + (ab * D if tp > 1 else 0)
        )
    sync = 0.0
    if plan is not None:
        bucket = 4.0 * max(plan.local_padded(b) for b in plan.buckets)
        sync = grads + 4.0 * n_params / (m.fsdp if zero else 1) + 2.0 * bucket
    if zero:
        regathered = 0.0
        if cfg.remat or pb <= ab:
            blocks = block_params * (L if cfg.scan_layers else 1)
            regathered = pb * max(blocks, V * D if pb <= ab else 0)
        shard = p_bytes / m.fsdp
        return shard + state + max(shard + trans, sync, live + regathered)
    return p_bytes + state + max(grads + trans, sync, live, bwd_end)


# -- the estimate tiers --------------------------------------------------------


def _analytic_estimate(
    report: DryRunReport, cfg: TransformerConfig, batch, seq, devices
) -> None:
    """Fill flops/bytes per device from the profiler's analytic model
    (accel/profiler.py formulas). ``devices``: the rank count (an int,
    a sequence, or None for the process group's size).

    Work is assumed to split uniformly over the mesh, so candidates at
    different factorization sizes stay comparable. The
    parallelism-dependent *communication* cost is priced separately
    (``_comm_estimate``); the timed finalists settle the rest."""
    from dlrover_tpu_torch.accel.profiler import profile_model

    n_dev = _n_ranks(devices)
    act_bytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    p_bytes = 2 if cfg.param_dtype in ("bfloat16", "float16") else 4
    prof = profile_model(cfg, batch, seq, act_bytes=act_bytes)
    param_bytes = prof.total_params * p_bytes
    flops = prof.step_flops / n_dev
    s = report.strategy
    if cfg.remat:
        # full activation checkpointing recomputes the forward in the
        # backward: fwd+fwd+bwd = 4/3 of the fwd+bwd ideal
        flops *= 4.0 / 3.0
    if s.mesh.pp > 1:
        # pipeline bubble: (pp-1) fill/drain ticks over M microbatch
        # ticks of useful work; interleaving shrinks it v-fold
        M = max(s.num_microbatches, 1)
        v = s.resolved_virtual()
        flops *= 1.0 + (s.mesh.pp - 1) / float(M * v)
    report.flops_per_device = flops
    # HBM traffic model: params are read twice + written once per update
    # (grad + optimizer pass) and activations flow once each way
    report.bytes_per_device = (
        3.0 * param_bytes + 2.0 * prof.activation_bytes
    ) / n_dev
    report.est_source = "analytic"


def _comm_estimate(
    report: DryRunReport, cfg: TransformerConfig, batch, seq, devices
) -> None:
    """Gradient-sync comm term (a copy of the JAX package's).

    Models what the step does: the explicit scheduler (a
    ``resolve_sync_mode``-qualifying mesh with comm_overlap/grad_compress
    requested) syncs ONCE per optimizer step and is billed
    ``1 - OVERLAP_HIDDEN_FRACTION`` of its wire time as exposed; the
    default path syncs every microbatch at full precision with no
    overlap credit. Wire seconds are priced per link from
    ``topology.get_link_model()``."""
    from dlrover_tpu_torch.accel.profiler import profile_model
    from dlrover_tpu_torch.parallel.grad_sync import (
        OVERLAP_HIDDEN_FRACTION,
        comm_bytes_per_device,
        comm_time_legs_s,
        resolve_sync_mode,
    )

    s = report.strategy
    m = s.mesh
    p_bytes = 2 if cfg.param_dtype in ("bfloat16", "float16") else 4
    prof = profile_model(cfg, batch, seq)
    param_bytes = prof.total_params * p_bytes

    # MoE all-to-all term: the dispatch/combine all-to-alls run on the
    # critical path — 2 forward + 2 backward per MoE layer per step
    if cfg.num_experts and m.ep > 1:
        from dlrover_tpu_torch.parallel import topology

        act_bytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
        tokens_loc = batch * seq / max(m.dp * m.fsdp, 1)
        a2a_payload = (
            cfg.capacity_factor
            * max(cfg.moe_top_k, 1)
            * tokens_loc
            * cfg.model_dim
            * act_bytes
        )
        from dlrover_tpu_torch.models.config import num_moe_layers

        n_moe = num_moe_layers(cfg)
        a2a_dcn = "ep" in m.dcn_axes
        a2a_s = topology.alltoall_time_s(
            int(a2a_payload), m.ep, dcn=a2a_dcn
        )
        a2a_total = 4.0 * n_moe * a2a_s * max(s.grad_accum, 1)
        report.comm_exposed_s += a2a_total
        if a2a_dcn:
            report.comm_dcn_s += a2a_total
        else:
            report.comm_ici_s += a2a_total

    if m.dp * m.fsdp <= 1:
        return
    mode = resolve_sync_mode(m.axis_sizes())
    explicit = (
        mode is not None
        and s.resolved_comm_overlap()
        and not (mode.kind == "ep" and s.grad_accum > 1)
    )
    if explicit:
        one_sync = comm_bytes_per_device(
            param_bytes, s, grad_itemsize=p_bytes
        )
        one_ici_s, one_dcn_s = comm_time_legs_s(
            param_bytes, s, grad_itemsize=p_bytes
        )
        one_sync_s = one_ici_s + one_dcn_s
        syncs = 1
        if mode.kind == "pp":
            # per-stage sync scheduled into the pipeline bubble: only
            # the spill past the bubble is exposed
            M = max(s.num_microbatches, 1)
            v = s.resolved_virtual()
            bubble_frac = (m.pp - 1) / float(M * v + m.pp - 1)
            compute_s = max(
                report.flops_per_device * _SEC_PER_FLOP,
                report.bytes_per_device * _SEC_PER_BYTE,
            )
            bubble_s = compute_s * bubble_frac
            report.comm_bytes_per_device += one_sync
            spill = max(0.0, one_sync_s - bubble_s)
            report.comm_exposed_s += spill
            if one_sync_s > 0:
                report.comm_ici_s += spill * one_ici_s / one_sync_s
                report.comm_dcn_s += spill * one_dcn_s / one_sync_s
            return
        exposed_frac = 1.0 - OVERLAP_HIDDEN_FRACTION
    else:
        # the default schedule: full precision, per microbatch.
        # compress="none" explicitly — the strategy may carry the
        # compression knob as an opt NAME
        one_sync = comm_bytes_per_device(
            param_bytes, s, grad_itemsize=p_bytes, compress="none"
        )
        one_ici_s, one_dcn_s = comm_time_legs_s(
            param_bytes, s, grad_itemsize=p_bytes, compress="none"
        )
        one_sync_s = one_ici_s + one_dcn_s
        syncs = max(s.grad_accum, 1)
        exposed_frac = 1.0
    report.comm_bytes_per_device += one_sync * syncs
    report.comm_exposed_s += one_sync_s * syncs * exposed_frac
    report.comm_ici_s += one_ici_s * syncs * exposed_frac
    report.comm_dcn_s += one_dcn_s * syncs * exposed_frac


def _tp_comm_estimate(report: DryRunReport, cfg: TransformerConfig, batch, seq) -> None:
    """The tp collectives of the model (the JAX package's GSPMD fuses
    them into its matmuls, and its dry runner prices none): per layer two
    all-reduces in the forward, two in the backward, and under remat one
    more in the recompute (the attention's: the non-reentrant checkpoint
    stops recomputing at the last tensor the backward saved, before the
    MLP's sum); one more each way around a vocab split over tp. Each carries this rank's microbatch of tokens x
    D in f32 (the dtype ``models/transformer._tp_sum`` reduces in) over
    the tp group's link (``topology``), at the ring factor plus one
    ring's latency, and none of it is hidden."""
    m = report.strategy.mesh
    if m.tp <= 1:
        return
    from dlrover_tpu_torch.parallel import topology

    model = topology.get_link_model()
    topology.note_fallback_use(model)
    ga = max(report.strategy.grad_accum, 1)
    tok = batch * seq / float(max(m.dp * m.fsdp * m.sp, 1) * ga)
    n = cfg.num_layers * (5 if cfg.remat else 4) + (2 if cfg.vocab_size % m.tp == 0 else 0)
    wire = 2.0 * (m.tp - 1) / m.tp * tok * cfg.model_dim * 4.0
    t = n * ga * (wire * model.sec_per_axis_byte("tp") + 2 * m.tp * model.ici_lat_s)
    report.comm_bytes_per_device += n * ga * wire
    report.comm_exposed_s += t
    report.comm_ici_s += t


def _finalize_estimate(
    report: DryRunReport, cfg: TransformerConfig, batch, seq, devices
) -> None:
    """Price a report: the analytic flops/bytes (the port has no
    compiler cost analysis, so the JAX package's XLA tier and its
    plausibility gate do not apply), the comm terms (the gradient sync,
    and the tp collectives, ``_tp_comm_estimate``), and the host term:
    the aggregate staging/spill demand priced through the link model's
    host leg with the arbiter's scheduling credit, so ``est_step_s``
    sees the overlapped cost of the host link instead of assuming it
    free (or exclusive)."""
    from dlrover_tpu_torch.parallel.transfer_sched import (
        aggregate_host_exposed_s,
        get_calibration,
    )

    _analytic_estimate(report, cfg, batch, seq, devices)
    _comm_estimate(report, cfg, batch, seq, devices)
    _tp_comm_estimate(report, cfg, batch, seq)
    report.host_exposed_s = aggregate_host_exposed_s()
    report.host_hidden_measured = get_calibration() is not None
    report.est_step_s = (
        max(
            report.flops_per_device * _SEC_PER_FLOP,
            report.bytes_per_device * _SEC_PER_BYTE,
        )
        + report.comm_exposed_s
        + report.host_exposed_s
    )


def reprice_report(report: DryRunReport, factors: dict) -> float:
    """``est_step_s`` with each priced component scaled by its drift
    factor (``obs.audit.current_drift_factors`` vocabulary): the
    compute roofline by ``compute``, the itemized sync legs by
    ``ici_sync``/``dcn_sync``, the host term by ``host_xfer``."""
    compute = max(
        report.est_step_s
        - report.comm_exposed_s
        - report.host_exposed_s,
        0.0,
    )
    ici = report.comm_ici_s
    dcn = report.comm_dcn_s
    other_comm = max(report.comm_exposed_s - ici - dcn, 0.0)
    return (
        compute * factors.get("compute", 1.0)
        + ici * factors.get("ici_sync", 1.0)
        + dcn * factors.get("dcn_sync", 1.0)
        + other_comm
        + report.host_exposed_s * factors.get("host_xfer", 1.0)
    )


def price_rebalance_options(
    cfg: TransformerConfig,
    batch: int,
    seq: int,
    idle_strategy: Strategy,
    rebalanced_strategy: Strategy,
    measured_step_s: Optional[float] = None,
    current_strategy: Optional[Strategy] = None,
) -> Tuple[float, float]:
    """(idle_est_s, rebalanced_est_s): the analytic roofline of one step
    under (a) the degraded mesh that idles surplus ranks and (b) the
    padded micro-batch rebalance that uses every rank
    (``Strategy.batch_pad``). Per-device compute scales with
    rows-per-rank and the gradient sync is priced per link. Pure Python.

    ``measured_step_s`` (+ ``current_strategy``): self-calibration —
    the row term is rescaled so the current world's estimate reproduces
    the trainer's MEASURED step time."""
    from dlrover_tpu_torch.accel.profiler import profile_model
    from dlrover_tpu_torch.obs.audit import current_drift_factors
    from dlrover_tpu_torch.parallel.grad_sync import comm_time_legs_s

    p_bytes = 2 if cfg.param_dtype in ("bfloat16", "float16") else 4
    drift = current_drift_factors()

    def row_est(s: Strategy) -> float:
        shards = max(s.mesh.dp * s.mesh.fsdp, 1)
        rows = (batch + s.batch_pad) // shards
        prof = profile_model(cfg, max(rows, 1), seq)
        return (
            prof.step_flops * _SEC_PER_FLOP
            + 2.0 * prof.activation_bytes * _SEC_PER_BYTE
        )

    calib = 1.0
    if measured_step_s and current_strategy is not None:
        cur = row_est(current_strategy)
        if cur > 0:
            calib = max(1.0, measured_step_s / cur)

    def est(s: Strategy) -> float:
        prof = profile_model(cfg, 1, seq)
        p_total = prof.total_params * p_bytes
        ici_s, dcn_s = comm_time_legs_s(
            p_total, s, grad_itemsize=p_bytes
        )
        return (
            row_est(s) * calib
            + ici_s * drift.get("ici_sync", 1.0)
            + dcn_s * drift.get("dcn_sync", 1.0)
        )

    return est(idle_strategy), est(rebalanced_strategy)


def compiled_cost(
    strategy: Strategy,
    cfg: TransformerConfig,
    tx,
    batch: int,
    seq: int,
    devices=None,
    hbm_budget: Optional[float] = None,
) -> DryRunReport:
    """The static tier (the JAX package compiles abstractly and reads
    XLA's accounting): validate the strategy (``_build`` raises for what
    the port cannot run), price it analytically, and estimate its peak
    memory (``static_peak_bytes``). Never touches device memory.
    ``devices``: the rank count (None: the process group's)."""
    report = DryRunReport(strategy=strategy, ok=False)
    try:
        cfg2, _, _, _, _, abstract_state = _build(
            strategy, cfg, tx, abstract=True
        )
        _, applied = _apply_strategy(strategy, cfg)
        leaves = abstract_state().params.jax_ordered_parameters()
        report.mem_bytes = float(
            static_peak_bytes(cfg2, applied, tx, batch, seq, leaves)
        )
        report.fits = hbm_fits(report.mem_bytes, hbm_budget)
        _finalize_estimate(report, cfg2, batch, seq, devices)
        report.ok = True
    except Exception as e:  # unported or invalid factorization, …
        report.error = f"{type(e).__name__}: {e}"
    return report


def _ranks_agree(ok: bool) -> bool:
    """True when every rank's timed run succeeded (one MIN all-reduce of
    a flag on the default group; alone: ``ok``)."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return ok
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(int(flag.item()))


def timed_run(
    strategy: Strategy,
    cfg: TransformerConfig,
    tx,
    batch: int,
    seq: int,
    device=None,
    steps: int = 3,
) -> Tuple[Optional[float], float]:
    """(measured seconds/step — median of ``steps`` after one warm-up,
    the run's peak device bytes). Each step is timed on the host clock
    up to ``torch.cuda.synchronize()``; the peak is
    ``torch.cuda.max_memory_allocated`` over the run above what was
    allocated before it (0.0 on the CPU: no figure, "unknown"). A failed
    run returns (None, 0.0) after its state is freed; on several ranks
    every rank returns None when any failed."""
    import torch

    from dlrover_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    state = x = y = None
    t, mem, ok = None, 0.0, True
    try:
        _, _, step_fn, init_fn, make_batch, _ = _build(strategy, cfg, tx, dev)
        if cuda:
            gc.collect()
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        state = init_fn(0, device_generator=True)
        x, y = make_batch(batch, seq)
        state, _ = step_fn(state, x, y)  # warm-up
        if cuda:
            torch.cuda.synchronize(dev)
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, _ = step_fn(state, x, y)
            if cuda:
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        if cuda:
            mem = float(torch.cuda.max_memory_allocated(dev) - base)
    except Exception as e:
        logger.warning(
            f"timed dry run failed for {strategy.describe()}: {e!r}"
        )
        t, mem, ok = None, 0.0, False
    finally:
        del state, x, y
        if cuda:
            gc.collect()  # a closed state lives until the cyclic GC runs
            torch.cuda.empty_cache()
    if not _ranks_agree(ok):
        return None, 0.0
    return t, mem


def dry_run(
    strategies,
    cfg: TransformerConfig,
    tx,
    batch: int,
    seq: int,
    device=None,
    hbm_budget: Optional[float] = None,
    max_timed: int = 3,
    timed_steps: int = 3,
    devices=None,
):
    """Static-score every candidate, then time the ``max_timed`` best
    that fit. Returns reports sorted best-first (measured time beats
    estimate; non-fitting and failed candidates sink). ``device``: where
    the timed runs run; ``devices``: the rank count the static tier
    prices for (None: the process group's)."""
    reports = [
        compiled_cost(s, cfg, tx, batch, seq, devices, hbm_budget)
        for s in strategies
    ]
    viable = [r for r in reports if r.ok and r.fits is not False]
    # known-fit candidates get timed before unknown-memory ones
    viable.sort(key=lambda r: (r.fits is None, r.est_step_s))
    for r in viable[:max_timed]:
        r.step_s, _ = timed_run(
            r.strategy, cfg, tx, batch, seq, device, steps=timed_steps
        )
    # self-calibrate the roofline per component (obs.audit drift
    # estimators, shared with the step auditor): a timed row seeds the
    # compute factor — the residual left after the priced comm/host legs
    # is attributed to the roofline — and every estimate is repriced
    timed = [
        r
        for r in viable[:max_timed]
        if r.step_s is not None and r.est_step_s > 0
    ]
    if timed:
        from dlrover_tpu_torch.obs.audit import seed_default_drift

        ratios = []
        for r in timed:
            compute_est = max(
                r.est_step_s - r.comm_exposed_s - r.host_exposed_s,
                0.0,
            )
            implied = r.step_s - r.comm_exposed_s - r.host_exposed_s
            if compute_est > 0 and implied > 0:
                ratios.append(implied / compute_est)
        if ratios:
            seed_default_drift("compute", float(np.median(ratios)))
    from dlrover_tpu_torch.obs.audit import current_drift_factors

    factors = current_drift_factors()
    if any(abs(f - 1.0) > 0.02 for f in factors.values()):
        for r in reports:
            if r.ok and r.est_step_s > 0:
                r.est_step_s = reprice_report(r, factors)
                r.est_source += "+calib"

    def rank(r: DryRunReport):
        """Same tier order as tpe_search: measured+fit < measured+unknown
        < estimated+fit < estimated+unknown < non-viable."""
        if not (r.ok and r.fits is not False):
            return (4, 0.0)
        known = 0 if r.fits else 1  # fits is True vs None here
        if r.step_s is not None:
            return (0 + known, r.step_s)
        return (2 + known, r.est_step_s)

    reports.sort(key=rank)
    return reports
