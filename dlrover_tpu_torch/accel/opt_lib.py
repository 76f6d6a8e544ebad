"""Pluggable optimization library (a copy of
``dlrover_tpu/accel/opt_lib.py``: the same registry, names and
transforms of ``(TransformerConfig, Strategy)``).

In the port, names whose machinery is not ported yet still apply as
transforms; ``accel/dry_runner._build`` then raises on the result,
naming the ROADMAP item, as ``models/transformer.check_supported``
does: ``int8_mlp`` (A12). ``1f1b`` / ``interleaved`` set the pipeline
schedule that ``parallel/pipeline.py`` runs on a pp mesh.
``sp_auto`` reads the sequence-parallel scheme table
(``parallel/sp_select.py``, measured on the H100): on a strategy
without an sp axis it is the JAX package's no-op.

Parity: atorch's optimization registry (auto/opt_lib/
optimization_library.py:39-58 — 14 named, composable optimizations:
zero/FSDP, AMP, fp8, TP, module replace, activation checkpointing,
compile, PP, mixed parallel, half...). The TPU translation is radically
smaller because GSPMD subsumes the parallelism entries (they are mesh
axes on the Strategy, searched by ``candidate_strategies``); what
remains pluggable are the *program-level* knobs — each a named, pure
transform of ``(TransformerConfig, Strategy)``:

- ``remat``      — activation checkpointing (HBM <-> FLOPs trade)
- ``bf16``/``fp32`` — compute dtype policy (AMP analog)
- ``int8_mlp``   — int8 MXU matmuls in the MLP (FP8 analog)
- ``offload_opt``— optimizer state in pinned-host memory (CPU-offload
  Adam analog; ops/host_offload.py)
- ``1f1b``       — 1F1B pipeline schedule instead of GPipe
- ``interleaved``— interleaved 1F1B (virtual pipeline stages)

A Strategy records applied optimization *names* (``strategy.opts``), so
the strategy stays a serializable value: ``agree_strategy`` publishes it
through the master KV store and every host re-derives the identical
config via this registry. Third-party optimizations register with
``register_optimization`` (they must be registered on every host before
the strategy is applied — same contract as the reference's custom
opt_lib entries).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Dict, Sequence, Tuple

from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.models.config import TransformerConfig

ApplyFn = Callable[
    [TransformerConfig, Strategy], Tuple[TransformerConfig, Strategy]
]


@dataclass(frozen=True)
class Optimization:
    name: str
    apply: ApplyFn
    # tunable entries may be auto-added by the search (e.g. remat when
    # the memory gate rejects every plain candidate); non-tunable ones
    # only apply when the user asks by name
    tunable: bool = False


_REGISTRY: Dict[str, Optimization] = {}


def register_optimization(
    name: str, apply: ApplyFn, tunable: bool = False
) -> None:
    _REGISTRY[name] = Optimization(name=name, apply=apply, tunable=tunable)


def get_optimization(name: str) -> Optimization:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown optimization {name!r} (registered: "
            f"{sorted(_REGISTRY)}); register it on every host with "
            f"register_optimization before applying strategies"
        )
    return _REGISTRY[name]


def registered_optimizations() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def apply_optimizations(
    cfg: TransformerConfig,
    strategy: Strategy,
    names: Sequence[str],
) -> Tuple[TransformerConfig, Strategy]:
    """Apply named optimizations in order; the result strategy records
    them in ``opts`` (deduplicated, order-preserving)."""
    seen = []
    for n in names:
        if n in seen:
            continue
        cfg, strategy = get_optimization(n).apply(cfg, strategy)
        seen.append(n)
    return cfg, dc_replace(strategy, opts=tuple(seen))


# -- builtins ---------------------------------------------------------------
register_optimization(
    "remat",
    lambda cfg, s: (cfg, dc_replace(s, remat=True)),
    tunable=True,
)
register_optimization(
    "bf16", lambda cfg, s: (cfg, dc_replace(s, dtype="bfloat16"))
)
register_optimization(
    "fp32", lambda cfg, s: (cfg, dc_replace(s, dtype="float32"))
)
register_optimization(
    "int8_mlp", lambda cfg, s: (dc_replace(cfg, int8_mlp=True), s)
)
register_optimization(
    "offload_opt",
    lambda cfg, s: (cfg, dc_replace(s, offload_opt=True)),
)
# overlap-scheduled gradient sync (parallel/grad_sync.py): bucketed
# per-bucket collectives — RS+AG on pure-dp meshes, ZeRO
# reduce-scatter into the fsdp shard layout on dp x fsdp, the
# bucketed dp sync of each tp coordinate's boxes on dp x tp/sp, ZeRO
# on the tp-local leaves on 3D dp x fsdp x tp, the expert and dense
# plans of dp x ep, the per-stage plans of pp x dp after the
# pipeline's drain — and grad_accum syncs once per optimizer step
# instead of per microbatch. Tunable: auto_accelerate's candidate stamping may apply
# it across the whole candidate list; the remaining exotica (pp/ep
# composed with other model axes) fall back to the GSPMD default
# schedule inside the step builders with a once-per-mesh log naming
# the axes.
register_optimization(
    "comm_overlap",
    lambda cfg, s: (cfg, dc_replace(s, comm_overlap=True)),
    tunable=True,
)
# int8-compressed gradient collectives with error feedback; implies
# the explicit sync path (comm_overlap) — quantization needs the
# bucket walk to exist
register_optimization(
    "grad_compress",
    lambda cfg, s: (
        cfg,
        dc_replace(s, comm_overlap=True, grad_compress="int8"),
    ),
    tunable=True,
)
# measured-ratio compression policy: resolve none/int8/int8+topk per
# mesh from the LinkModel's ICI:DCN ratio at plan time
# (grad_sync.resolve_auto_compress); implies the explicit sync path
register_optimization(
    "grad_compress_auto",
    lambda cfg, s: (
        cfg,
        dc_replace(s, comm_overlap=True, grad_compress="auto"),
    ),
    tunable=True,
)
# link-aware bucket sizing: grad_bucket_mb=0 means each bucket targets
# ~topology.BUCKET_TARGET_COMM_MS of wire time on the link it actually
# crosses (measured LinkModel; the DCN leg for multi-slice meshes)
# instead of one global MiB knob; implies the explicit sync path
register_optimization(
    "auto_bucket",
    lambda cfg, s: (
        cfg,
        dc_replace(s, comm_overlap=True, grad_bucket_mb=0),
    ),
)
register_optimization(
    "1f1b", lambda cfg, s: (cfg, dc_replace(s, pp_schedule="1f1b"))
)
register_optimization(
    "interleaved",
    lambda cfg, s: (cfg, dc_replace(s, pp_schedule="interleaved")),
)


def _apply_sp_auto(cfg, s):
    from dlrover_tpu_torch.parallel.sp_select import pick_sp_scheme

    if s.mesh.sp <= 1:
        return cfg, s
    return dc_replace(cfg, sp_scheme=pick_sp_scheme(cfg.max_seq_len)), s


# sequence-parallel candidates carry this by default: the scheme is
# read from the measured kernel-strategy-constant table
# (parallel/sp_select.py) instead of whatever the config hardcodes
register_optimization("sp_auto", _apply_sp_auto, tunable=True)
