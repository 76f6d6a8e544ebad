"""Strategy = the complete recipe for turning a model config into a
sharded train step (a copy of ``dlrover_tpu/accel/strategy.py``, which
imports no JAX; the search that picks one is ``accel/accelerate.py``).

Parity: atorch ``Strategy`` (auto/strategy.py) is an ordered list of
(optimization_name, config, tunable) module transforms. Here the whole
space is four orthogonal knobs; ``to_json``/``from_json`` replace the
reference's pickled strategy files (``load_strategy=`` path,
accelerate.py:246) for caching and for cross-host agreement through the
master KV store.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, replace
from typing import Optional, Tuple

from dlrover_tpu_torch.parallel.mesh import MeshConfig


@dataclass(frozen=True)
class Strategy:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    remat: bool = False
    dtype: str = "bfloat16"
    # >1 runs a pipeline schedule over the mesh's pp axis
    num_microbatches: int = 1
    # >1 splits the batch into K sequential microbatches per optimizer
    # update (models/train.py grad_accum — amortizes the param-sized
    # optimizer pass and enables large global batches)
    grad_accum: int = 1
    # "gpipe", "1f1b", or "interleaved" (parallel/pipeline.py)
    pp_schedule: str = "gpipe"
    pp_virtual: int = 2  # chunks/device when pp_schedule == "interleaved"
    # optimizer state lives in pinned-host memory between steps (the
    # CPU-offload Adam analog — ops/host_offload.py); single-mesh path
    # only (pp>1 keeps its own state layout on device)
    offload_opt: bool = False
    # explicit overlap-scheduled gradient sync (parallel/grad_sync.py):
    # bucketed collectives under shard_map, one sync per optimizer
    # step under grad_accum. Engages where the mesh qualifies
    # (resolve_sync_mode: pure-dp, dp x fsdp ZeRO, dp x tp/sp,
    # dp x ep, dp x fsdp x tp, pp x dp) — the remaining compositions
    # fall back to the GSPMD default schedule with a once-per-mesh
    # log naming the axes.
    comm_overlap: bool = False
    # "none" | "int8" | "int8_topk" | "auto": int8-quantized
    # collective payloads with per-bucket shared scales, int32
    # accumulation and error feedback (implies the explicit sync
    # path). "int8_topk" additionally ships only the top-k
    # highest-magnitude blocks of the cross-slice DCN shard (EF
    # absorbs the rest); "auto" resolves per mesh from the measured
    # ICI:DCN ratio (grad_sync.resolve_auto_compress).
    grad_compress: str = "none"
    # requested DCN block density under int8_topk/auto (fraction of
    # shard blocks shipped per sync; block granularity rounds up)
    grad_topk_density: float = 0.25
    # target bucket size for the sync scheduler, MiB; 0 = auto-size
    # per link from the measured topology.LinkModel (the DCN leg on
    # multi-slice meshes, the ICI ring otherwise)
    grad_bucket_mb: int = 4
    # micro-batch rebalance: rows of zero-weight padding
    # appended to every global batch so it divides over dp*fsdp on an
    # otherwise-indivisible worker count — heavier ranks take one
    # extra micro-batch row instead of surplus ranks idling. The
    # padded rows carry loss weight 0 (models/train.py
    # pad_row_weights), so gradients are bitwise those of the real
    # batch; the dry-runner prices the padded compute against the
    # idle-ranks alternative and the trainer picks the cheaper
    # (accel/dry_runner.price_rebalance_options).
    batch_pad: int = 0
    # named optimization-library entries applied to this strategy
    # (accel/opt_lib.py re-derives the config from these on every host)
    opts: Tuple[str, ...] = ()

    def resolved_pp_schedule(self) -> str:
        """The effective pipeline schedule. The opt registry rewrites
        ``pp_schedule`` only when opts are APPLIED; a strategy that
        hasn't been through ``apply_optimizations`` (candidates, the
        strategy returned by ``auto_accelerate``) carries the schedule
        only in ``opts`` — every consumer must honor either source
        through THIS one helper (describe, the analytic cost estimate,
        the trainer's eval step), or the two sources drift."""
        if "interleaved" in self.opts:
            return "interleaved"
        if "1f1b" in self.opts:
            return "1f1b"
        return self.pp_schedule

    def resolved_comm_overlap(self) -> bool:
        """Whether the explicit gradient-sync scheduler is requested —
        from the field OR the opt names (same dual-source contract as
        ``resolved_pp_schedule``: candidates and the strategy returned
        by ``auto_accelerate`` carry un-applied opt names)."""
        return (
            self.comm_overlap
            or "comm_overlap" in self.opts
            or "grad_compress" in self.opts
            or "grad_compress_auto" in self.opts
        )

    def resolved_grad_compress(self) -> str:
        """Effective gradient-compression mode (field or opt name).
        May return "auto" — plan construction and the cost model
        resolve it per mesh (grad_sync.resolve_auto_compress)."""
        if self.grad_compress != "none":
            return self.grad_compress
        if "grad_compress_auto" in self.opts:
            return "auto"
        return "int8" if "grad_compress" in self.opts else "none"

    def resolved_virtual(self) -> int:
        """Chunks per device of the TRAINING state layout: ``pp_virtual``
        iff the resolved schedule is interleaved ([pp, v, lc] leaves),
        else 1 ([pp, L/pp])."""
        return (
            self.pp_virtual
            if self.resolved_pp_schedule() == "interleaved"
            else 1
        )

    def describe(self) -> str:
        axes = {
            a: s for a, s in self.mesh.axis_sizes().items() if s > 1
        } or {"dp": 1}
        bits = ["x".join(f"{a}{s}" for a, s in axes.items())]
        if self.mesh.dp_slices() > 1:
            # hybrid dp axis: grad sync runs the two-level ICI/DCN
            # schedule over this many DCN slices
            bits.append(f"{self.mesh.dp_slices()}slice")
        if self.num_microbatches > 1:
            bits.append(f"mb{self.num_microbatches}")
        if self.grad_accum > 1:
            bits.append(f"ga{self.grad_accum}")
        sched = self.resolved_pp_schedule()
        if self.mesh.pp > 1 and sched != "gpipe":
            bits.append(
                f"interleaved{self.pp_virtual}"
                if sched == "interleaved"
                else sched
            )
        if self.batch_pad:
            bits.append(f"mbpad{self.batch_pad}")
        if self.remat or "remat" in self.opts:
            bits.append("remat")
        if self.offload_opt and "offload_opt" not in self.opts:
            bits.append("offload_opt")
        if self.comm_overlap and "comm_overlap" not in self.opts:
            bits.append("comm_overlap")
        if (
            self.grad_compress != "none"
            and "grad_compress" not in self.opts
        ):
            bits.append(f"{self.grad_compress}grad")
        bits.append(self.dtype)
        bits.extend(
            o
            for o in self.opts
            if o not in ("remat", "bf16", "fp32", "1f1b", "interleaved")
        )
        return "/".join(bits)

    def to_json(self) -> str:
        d = asdict(self)
        d["mesh"]["dcn_axes"] = list(self.mesh.dcn_axes)
        d["opts"] = list(self.opts)
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Strategy":
        d = json.loads(s)
        mesh_d = d.pop("mesh")
        mesh_d["dcn_axes"] = tuple(mesh_d.get("dcn_axes", ()))
        d["opts"] = tuple(d.get("opts", ()))
        return Strategy(mesh=MeshConfig(**mesh_d), **d)

    def with_remat(self, remat: bool = True) -> "Strategy":
        return replace(self, remat=remat)
