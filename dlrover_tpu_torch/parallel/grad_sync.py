"""Bucketed gradient sync over ``torch.distributed`` (the port of
``dlrover_tpu/parallel/grad_sync.py``).

The planning is the JAX package's, with the same verdicts and byte
counts: ``resolve_sync_mode`` / ``fallback_reason`` gate a mesh,
``plan_buckets`` cuts the gradient leaves (in the JAX package's tree
order, ``Transformer.jax_ordered_parameters()``) into size-targeted
buckets, and ``BucketPlan`` prices them (raw, wire, ring-adjusted and
cross-slice bytes). ``resolve_plan`` is the one gate ``build_train_step``
and the trainer consult.

The sync (``sync_grads``) runs the kinds ``dp`` and ``zero`` on the
groups of ``parallel/mesh.build_mesh``, one bucket at a time through
each leg, every bucket's collective issued ``async_op=True`` on the
leg's group and waited for before the next leg reads it:

- **flat dp** (``_dp_leg_flat``): a reduce-scatter and an all-gather a
  bucket. int8: one shared scale a bucket (a MAX all-reduce of the
  local absmax over the data axes); the int8 codes cross the wire as
  int8 (``_sum_codes``: an all-to-all hands each rank its chunk of every
  rank's codes, summed locally in int32, and the summed chunk is
  all-gathered as int16, |sum| <= 127 x n fitting int16 up to n = 258
  ranks, int32 above; the int16 sums travel as their bytes, since
  neither gloo nor NCCL has an int16 collective), dequantized, and the
  local quantization error carried in the error-feedback residual.
  Integer sums are exact, so the sums are bitwise what an int32
  reduce-scatter gave;
- **two-level** (``_dp_leg_2level``, a hybrid dp axis of ``slices``):
  a slice-local reduce-scatter, a cross-slice all-reduce of the shard
  on the stripe groups, a slice-local all-gather. int8 runs on the
  cross-slice leg (``_sum_codes`` over the stripe group);
  ``int8_topk`` quantizes only the top-k blocks of the shard
  (``TOPK_BLOCK`` elements each, k fixed by the shard's length; the
  codes of the other blocks are 0 and ship as such), the rest rides the
  residual;
- **ZeRO** (``zero``, dp x fsdp): a reduce-scatter over fsdp into this
  rank's shard, then the dp legs above on the 1/fsdp chunk; there is no
  all-gather over fsdp. The port lays a zero bucket out rank-major by
  whole 128-element block rows of each leaf (``BucketPlan.leaf_block``)
  so that a rank's shard is its rows of every leaf, which the per-leaf
  8-bit AdamW updates as the JAX package updates the whole leaf, block
  for block. The JAX package's zero bucket is its leaves back to back;
  the two differ only by that per-leaf block padding;
- **sequence parallelism** (kind ``tp`` with ``auto_axes=("sp",)`` and
  ``model_shard=1``, dp x sp): sp shards no parameter, so every rank's
  gradient is a partial sum over its sequence block. Each bucket is
  first summed over the ``sp`` group (an all-reduce), then takes the dp
  legs above (flat; int8 on them as on a dp plan). A mesh with sp and
  no dp resolves to no plan, as in the JAX package, and the train
  step's default path makes the same sp sum;
- **tensor parallelism** (kind ``tp`` with ``model_shard = tp > 1``,
  dp x tp[, sp]): each tp rank holds its box of every split leaf
  (``parallel/sharding_rules``), so each tp coordinate's dp group syncs
  that rank's tp-local buckets: the dp legs above (and the sp sum
  first), over the groups of its coordinate. The plan's buckets and
  byte counts are the JAX package's, over the global leaves; the port's
  plan also carries ``tp`` and ``leaf_tp_dims``, from which the sync
  cuts each bucket's local leaves (``BucketPlan.local_shape``). int8
  runs on these plans, with one scale a bucket over dp x tp, as the
  JAX package runs it when its residual probe answers True (it does on
  the JAX release here; the port has no residual sharding to probe).
  The JAX tests that pin the opposite are red here for that reason
  (``test_hybrid_sync.py::TestSyncModeGate::test_tp_plan_forces_
  compress_off``, ``test_plan_buckets_rejects_bad_combos``;
  ``test_sparse_sync.py::TestAutoAxisResidualProbe``);
- **3d** (dp x fsdp x tp[, sp]): ZeRO on the tp-local leaves — the
  plan's leaves are the tp-local shapes (the JAX ``_localize_tp``) in
  the port's ZeRO block layout, the reduce-scatter over fsdp and the dp
  legs run over each tp coordinate's groups. 3d plans never compress
  (the JAX gate forces ``none``).

Under tp the grad norm is the whole tree's: the split leaves' squares
summed over tp, the whole leaves' counted once.

The collectives run on CUDA tensors on NCCL and on gloo alike (gloo
takes every one of them on CUDA tensors in the card's torch: the
``dp`` phase of ``chip_smoke.py`` probes it), and on CPU tensors over
gloo.

``BucketPlan.wire_bytes`` prices the compressed legs as they ship (the
int8 codes, plus the all-gather of their int16 sums, which the JAX
package's count leaves out; ``int8_topk`` as the dense int8 shard it
ships); every other byte count is the JAX package's.

``grad_compress="auto"`` (``resolve_auto_compress``) and
``grad_bucket_mb=0`` (``resolve_bucket_bytes``) resolve from the
measured ``LinkModel`` of ``parallel/topology.py`` (observed rail rates
folded in), and ``comm_time_per_device_s`` / ``comm_time_legs_s`` price
a sync's wire time per link from it, as in the JAX package.

- **ep** (dp x ep; ``EPSyncPlan``, the JAX split plan): the expert
  leaves (each ep rank's ``E/ep`` experts, ``expert_leaf_ids`` /
  ``expert_leaf_dims``) and the dense leaves are bucketed apart
  (``expert_plan`` over the ep-local shapes, ``dense_plan``), each
  synced over the rank's dp group by the flat dp legs. The dense grads
  are first summed over ep by the train step (``models/train.py``:
  only ep rank 0 seeds the loss, so the sum selects its grads), and
  the grad norm is ``sqrt(sum_ep(expert squares) + dense squares)``.
  ep plans never compress (the JAX ``_plan_for_ep`` plans none).

- **pp** (pp x dp; ``PPSyncPlan``, the JAX class): ``stage_plan``
  buckets ONE stage's leaves (the stage-local shapes of the stacked
  leaves), which every stage rank walks over its own leaves, and
  ``shared_plan`` the shared leaves (embedding, final norm, head) every
  stage holds; each syncs over the rank's dp group by the dp legs, once
  the pipeline's drain ends (``parallel/pipeline``; the shared grads are
  summed over pp first). pp plans never compress (the JAX
  ``plan_for_pipeline`` plans none).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

# bytes per element of the dtypes a leaf may carry (numpy cannot name
# bfloat16 without ml_dtypes)
_ITEMSIZE = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
}


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


# assumed fraction of sync wire time hidden behind backward compute
# once the sync is bucketed (used by the dry-runner's comm-cost term
# and reported as the analytic ``comm_overlap_pct`` on backends where
# real overlap cannot be measured, e.g. the CPU smoke bench). 0.7 is
# the TorchTitan-reported neighborhood for bucketed DP overlap; the
# timed finalists settle real rankings.
OVERLAP_HIDDEN_FRACTION = 0.7

# int8 payload: 1 byte/element + one fp32 scale per bucket
_INT8_BYTES = 1
_SCALE_BYTES = 4
# the all-gather of summed int8 codes ships int16 while |sum| <= 127 x n
# fits it (n <= 258 ranks summing), int32 above
_CODE_SUM_MAX_RANKS = 32767 // 127


def code_sum_dtype_bytes(n: int) -> int:
    """Bytes an element of the all-gathered sum of ``n`` ranks' int8
    codes: 2 (int16) up to 258 ranks, 4 (int32) above."""
    return 2 if n <= _CODE_SUM_MAX_RANKS else 4

# block top-k sparsification of the DCN shard leg (``int8_topk``):
# the slice-local shard is scored in fixed-size blocks and only the
# top-k highest-|sum| blocks ship across slices (int8 values + one
# int32 block index per block + the shared scale). A FIXED per-bucket
# k — derived from the static shard length, never the values — keeps
# every shape static, so AOT executables, donation and the resize
# compile cache stay valid. Unshipped blocks ride the same
# error-feedback residual as quantization error.
TOPK_BLOCK = 256
_INDEX_BYTES = 4

# modes whose sync carries the error-feedback residual
_EF_MODES = ("int8", "int8_topk")
_COMPRESS_MODES = ("none",) + _EF_MODES

# ``grad_compress="auto"`` policy: measured ICI:DCN bandwidth ratio at
# which each mode starts paying for itself on the leg it compresses.
# At parity (ratio ~1) compression buys nothing but EF noise; the
# fallback LinkModel's 90:12.5 already clears both bars.
AUTO_INT8_RATIO = 2.0
AUTO_TOPK_RATIO = 4.0
AUTO_TOPK_DENSITY = 0.25


@dataclass(frozen=True)
class Bucket:
    """One sync unit: a contiguous run of gradient leaves, flattened
    and padded so the reduce-scatter divides evenly over ``dp``."""

    index: int
    start: int  # [start, stop) over the flattened leaf list
    stop: int
    elems: int  # real elements (pre-padding)
    padded: int  # elems rounded up to a multiple of dp
    raw_bytes: int  # at the leaves' own dtypes (the GSPMD wire cost)


@dataclass(frozen=True)
class SyncMode:
    """Which explicit-sync schedule a mesh qualifies for (the gate's
    verdict, shared by the train step, the trainer and the cost
    model). ``kind``: "dp" (classic pure-DP), "zero" (dp x fsdp —
    reduce-scatter into the fsdp shard layout), "tp" (dp x tp/sp —
    bucketed dp sync under a partial-manual shard_map with the model
    axes left to GSPMD), "ep" (dp x ep — same partial-manual psum
    schedule; expert grads are already 1/ep per device), "3d"
    (dp x fsdp x tp — the ZeRO leg and the tp leg composed under a
    fully-manual sync region), "pp" (pp x dp — per-stage bucketed
    sync scheduled into the pipeline bubble; the plan itself is built
    by ``plan_for_pipeline``)."""

    kind: str
    dp: int
    fsdp: int = 1
    # model axes (>1) left to GSPMD on the "tp"/"ep" paths, and the
    # tp/sp axes of the "3d" path (manual in the sync region, auto in
    # the local-grads region)
    auto_axes: Tuple[str, ...] = ()
    # product of the auto axes' degrees: grads of model-sharded params
    # are already 1/model_shard per device, so per-device wire bytes
    # scale down by it
    model_shard: int = 1
    # pipeline stages ("pp" mode only)
    pp: int = 1
    # expert-parallel degree ("ep" mode only)
    ep: int = 1


def fallback_reason(axis_sizes: dict) -> str:
    """Why ``resolve_sync_mode`` rejected a mesh, naming the EXACT
    axes that disqualified it (a 3D mesh used to be lumped under
    "unsupported mesh"; with pp/ep/3D landing, the remaining
    fallbacks are specific compositions). Empty string when the mesh
    actually qualifies."""
    dp = int(axis_sizes.get("dp", 1))
    fsdp = int(axis_sizes.get("fsdp", 1))
    tp = int(axis_sizes.get("tp", 1))
    sp = int(axis_sizes.get("sp", 1))
    ep = int(axis_sizes.get("ep", 1))
    pp = int(axis_sizes.get("pp", 1))
    if resolve_sync_mode(axis_sizes) is not None:
        return ""
    if pp > 1:
        others = [
            a
            for a, s in (("fsdp", fsdp), ("tp", tp), ("sp", sp), ("ep", ep))
            if s > 1
        ]
        if others:
            return (
                f"pp x {' x '.join(others)} composition: the pipeline "
                f"sync region supports only a dp sub-axis"
            )
        return "pp mesh with dp=1: no data axis to sync"
    if ep > 1:
        others = [
            a
            for a, s in (("fsdp", fsdp), ("tp", tp), ("sp", sp))
            if s > 1
        ]
        if others:
            return (
                f"ep x {' x '.join(others)} composition: the manual "
                f"(dp, ep) sync region admits no other model axis"
            )
        return "ep mesh with dp=1: no data axis to sync"
    if fsdp > 1 and sp > 1 and tp <= 1:
        return (
            "fsdp x sp composition without tp: sp shards no params, "
            "so the 3d region has nothing to localize"
        )
    return "no data axis with degree > 1"


def resolve_sync_mode(axis_sizes: dict) -> Optional[SyncMode]:
    """THE mesh gate (every caller routes through here so the train
    step, trainer and cost model cannot drift): a SyncMode when the
    explicit sync path supports this mesh, else None (GSPMD default
    schedule). Covered: pure-dp, dp x fsdp (ZeRO), dp x tp/sp,
    dp x ep, dp x fsdp x tp[,sp] (3D) and pp x dp. The remaining
    fallbacks (pp or ep composed with any other model axis) stay
    GSPMD; callers that *requested* the explicit path should surface
    the fallback via ``note_gspmd_fallback`` with
    ``fallback_reason``."""
    dp = int(axis_sizes.get("dp", 1))
    fsdp = int(axis_sizes.get("fsdp", 1))
    tp = int(axis_sizes.get("tp", 1))
    sp = int(axis_sizes.get("sp", 1))
    ep = int(axis_sizes.get("ep", 1))
    pp = int(axis_sizes.get("pp", 1))
    if pp > 1:
        # per-stage sync into the bubble: only a dp sub-axis composes
        # (the stage-stacked state layout owns the other axes)
        if fsdp > 1 or tp > 1 or sp > 1 or ep > 1 or dp <= 1:
            return None
        return SyncMode("pp", dp=dp, pp=pp)
    if ep > 1:
        # expert weights are ep-sharded (1/ep per device), dense
        # params ep-replicated with ep-replicated activations — the
        # sync owes only the dp reduction, run FULLY manual over
        # (dp, ep) with the MoE all-to-alls inside the region (a
        # partial-manual region with ep auto hard-crashes the 0.4.x
        # partitioner on the expert einsums). No other model axis
        # composes with that region.
        if fsdp > 1 or tp > 1 or sp > 1 or dp <= 1:
            return None
        return SyncMode("ep", dp=dp, auto_axes=("ep",), ep=ep)
    if fsdp > 1:
        if tp > 1:
            # 3D: the ZeRO reduce-scatter leg and the tp leg compose
            # under a fully-manual sync region (sync_grads buckets
            # each device's tp-local shard); sp may ride along (it
            # shards no params, so there is nothing to localize)
            auto = tuple(
                a for a in ("tp", "sp") if int(axis_sizes.get(a, 1)) > 1
            )
            return SyncMode(
                "3d", dp=dp, fsdp=fsdp, auto_axes=auto, model_shard=tp
            )
        if sp > 1:
            # fsdp x sp WITHOUT tp: no param dim for the 3d region to
            # localize — keep GSPMD (the earlier behavior; named
            # in fallback_reason)
            return None
        return SyncMode("zero", dp=dp, fsdp=fsdp)
    if dp > 1 and (tp > 1 or sp > 1):
        auto = tuple(
            a for a in ("tp", "sp") if int(axis_sizes.get(a, 1)) > 1
        )
        # model_shard counts only axes that shard PARAMS (tp): sp
        # shards activations/sequence, so param grads are replicated
        # over sp and each device still ships the full 1/tp payload
        return SyncMode("tp", dp=dp, auto_axes=auto, model_shard=tp)
    if dp > 1:
        return SyncMode("dp", dp=dp)
    return None


@dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[str, ...]
    dp: int
    compress: str  # "none" | "int8" | "int8_topk"
    # DCN slices the dp axis spans (MeshConfig.dp_slices()); > 1
    # switches sync_grads to the two-level schedule: slice-local
    # reduce-scatter over ICI, cross-slice all-reduce of the
    # slice-accumulated shards over DCN, slice-local all-gather
    slices: int = 1
    # fsdp degree (> 1 = the ZeRO path: buckets are reduce-scattered
    # into the fsdp shard layout first, the dp legs ride the chunk)
    fsdp: int = 1
    # model axes left to GSPMD (the "tp"/"ep" paths: sync_grads runs
    # manual over dp only and each bucket all-reduces with one psum)
    auto_axes: Tuple[str, ...] = ()
    # product of the auto axes' degrees (per-device wire accounting)
    model_shard: int = 1
    # which SyncMode kind planned this ("" on legacy plans — derived
    # from the axis fields). "3d" switches sync_grads to the fully-
    # manual composed schedule below.
    kind: str = ""
    # -- 3D (dp x fsdp x tp) fields ------------------------------------
    # tp degree of the fully-manual sync region; leaf shapes/buckets
    # are planned over each device's tp-LOCAL shard (so ``padded`` is
    # already 1/tp and ``model_shard`` stays 1 on 3d plans)
    tp: int = 1
    # per-leaf index of the tp-sharded dimension (None = replicated
    # over tp) — the reconstruction outside the manual region slices
    # each leaf's tp pieces back along this dim
    leaf_tp_dims: Tuple[Optional[int], ...] = ()
    # -- int8_topk fields ----------------------------------------------
    # requested fraction of DCN shard blocks shipped per sync (the k
    # of each bucket rounds nblk * density to at least one block;
    # ``dcn_density`` is the realized fraction)
    topk_density: float = 1.0
    # elements per scoring block (static — k derives from the shard
    # LENGTH, never the values, so shapes stay AOT-stable)
    topk_block: int = TOPK_BLOCK
    # -- the port's ZeRO layout (0 = the JAX package's: a bucket is its
    # leaves back to back, padded at the end) -------------------------
    # > 0 on "zero" plans: each leaf is padded to fsdp x whole blocks of
    # this many elements (the 8-bit AdamW's quantization block) and its
    # block rows are split evenly over fsdp; the bucket is laid out
    # rank-major (fsdp rank 0's rows of every leaf, then rank 1's, ...),
    # each rank's run padded so the dp legs divide it, so the fsdp
    # reduce-scatter hands each rank exactly the rows it owns
    leaf_block: int = 0

    @property
    def tp_local(self) -> bool:
        """True on a ``tp`` plan over a tp axis: the leaf shapes are the
        global ones (the JAX package's plan) and each rank syncs its
        tp-local boxes of them."""
        return self.kind == "tp" and self.tp > 1

    def local_shape(self, i: int) -> Tuple[int, ...]:
        """Leaf ``i``'s shape on a rank: its tp box on a ``tp_local``
        plan, else the plan's own (3d plans are planned on the tp-local
        shapes)."""
        shape = self.leaf_shapes[i]
        d = self.leaf_tp_dims[i] if self.tp_local else None
        return tuple(n // self.tp if j == d else n for j, n in enumerate(shape))

    def local_padded(self, bucket: "Bucket") -> int:
        """A bucket's length on a rank: ``padded``, or on a ``tp_local``
        plan its local leaves' elements rounded up to a multiple of dp."""
        if not self.tp_local:
            return bucket.padded
        n = sum(_numel(self.local_shape(i)) for i in range(bucket.start, bucket.stop))
        return -(-n // self.dp) * self.dp

    def residual_elems(self, bucket: "Bucket") -> int:
        """Length of a rank's error-feedback residual of ``bucket``: the
        ``shard_elems`` the byte counts price, or the local bucket on a
        ``tp_local`` plan."""
        return self.local_padded(bucket) if self.tp_local else self.shard_elems(bucket)

    def leaf_padded(self, i: int) -> int:
        """Leaf ``i``'s length in the bucket layout (its elements, or on
        a ``leaf_block`` plan its fsdp x whole blocks)."""
        n = _numel(self.leaf_shapes[i])
        if not self.leaf_block:
            return n
        unit = self.fsdp * self.leaf_block
        return -(-n // unit) * unit

    def leaf_shard(self, i: int) -> int:
        """Elements of leaf ``i`` one fsdp rank owns (``leaf_block``
        plans): whole blocks, ``leaf_padded(i) / fsdp``."""
        return self.leaf_padded(i) // self.fsdp

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def compressed(self) -> bool:
        """True when the sync quantizes a leg and carries the
        error-feedback residual (int8 and int8_topk)."""
        return self.compress in _EF_MODES

    @property
    def sparse(self) -> bool:
        return self.compress == "int8_topk"

    @property
    def three_d(self) -> bool:
        return self.kind == "3d"

    @property
    def auto_psum(self) -> bool:
        """dp leg is one bucketed psum (the "tp"/"ep" partial-manual
        paths) rather than RS+AG — true when model axes ride as GSPMD
        auto INSIDE the sync region (the 3d path holds auto_axes too,
        but its sync region is fully manual, so RS+AG apply)."""
        return bool(self.auto_axes) and not self.zero

    @property
    def two_level(self) -> bool:
        return self.slices > 1

    @property
    def zero(self) -> bool:
        return self.fsdp > 1

    @property
    def total(self) -> int:
        """Data degree of the sync (the N the mean divides by)."""
        return self.dp * self.fsdp

    @property
    def stack_axes(self) -> Tuple[str, ...]:
        """Mesh axes the stacked local-grad lead dim is sharded over
        (and the residual's row axis)."""
        return ("dp", "fsdp") if self.zero else ("dp",)

    @property
    def dp_ici(self) -> int:
        """Per-slice dp degree (the ICI factor of the dp axis)."""
        return self.dp // self.slices

    def shard_elems(self, bucket: Bucket) -> int:
        """Per-device length of what this bucket's error-feedback
        residual covers — exactly what int8 quantizes: the fsdp chunk
        on ZeRO plans (the dp legs ride it), narrowed to the
        slice-local DCN shard for two-level, the full padded vector
        for flat pure-DP."""
        base = bucket.padded // self.fsdp
        return base // self.dp_ici if self.two_level else base

    def topk_blocks(self, bucket: Bucket) -> Tuple[int, int]:
        """(block count, shipped k) of this bucket's DCN shard under
        int8_topk — both STATIC (derived from the shard length and the
        plan's density, never the gradient values)."""
        shard = self.shard_elems(bucket)
        nblk = -(-shard // self.topk_block)
        k = max(1, min(nblk, int(round(nblk * self.topk_density))))
        return nblk, k

    @property
    def dcn_density(self) -> float:
        """Realized fraction of DCN shard blocks shipped per sync
        (1.0 on dense plans; block granularity and the >= 1-block
        floor round the requested ``topk_density`` up)."""
        if not self.sparse or not self.buckets:
            return 1.0
        shipped = 0
        total = 0
        for b in self.buckets:
            nblk, k = self.topk_blocks(b)
            shipped += k
            total += nblk
        return shipped / total if total else 1.0

    @property
    def raw_bytes(self) -> int:
        """Wire bytes of one uncompressed sync (what the monolithic
        GSPMD all-reduce moves, ring-factor aside)."""
        return sum(b.raw_bytes for b in self.buckets)

    @property
    def code_ranks(self) -> int:
        """Ranks whose int8 codes one sum adds: the stripe group's
        (``slices``) on two-level plans, else the dp group's."""
        return self.slices if self.two_level else self.dp

    def code_gather_bytes(self, bucket: Bucket) -> int:
        """Bytes of the summed codes one rank hands the all-gather: its
        chunk of the quantized shard, int16 (int32 above 258 ranks)."""
        n = max(self.code_ranks, 1)
        return self.shard_elems(bucket) // n * code_sum_dtype_bytes(n)

    @property
    def wire_bytes(self) -> int:
        """Wire bytes of one sync on THIS plan's path (payload
        accounting — the ratio against ``raw_bytes`` is the
        compression win; ``explicit_wire_bytes`` is the ring-adjusted
        per-device twin). The compressed legs are priced as they ship:
        the int8 shard into the all-to-all, one rank's chunk of its
        int16 sums into the all-gather (``code_gather_bytes``, not in
        the JAX package's count) and the scale; ``int8_topk`` ships
        its shard dense (the unshipped blocks as zero codes), where the
        JAX package prices the k blocks and their indices. The outer
        fp32 legs (two-level, ZeRO) bill at padded x 4."""
        if self.compressed:
            outer = 4 if (self.two_level or self.zero) else 0
            return sum(
                b.padded * outer
                + self.shard_elems(b) * _INT8_BYTES
                + self.code_gather_bytes(b)
                + _SCALE_BYTES
                for b in self.buckets
            )
        return self.raw_bytes

    # -- ring-adjusted per-device accounting ---------------------------
    def gspmd_allreduce_bytes(self) -> int:
        """Per-device ring bytes of the monolithic fp32 all-reduce
        GSPMD's default schedule moves over the data axes per sync —
        the fallback this plan replaces. Model-sharded grads are
        already ``1/model_shard`` per device."""
        N = self.total
        if N <= 1:
            return 0
        ring = 2.0 * (N - 1) / N
        return int(
            sum(ring * b.padded * 4 for b in self.buckets)
            / self.model_shard
        )

    def explicit_wire_bytes(self) -> int:
        """Per-device ring bytes of THIS plan's schedule per sync.
        The ZeRO path is strictly below ``gspmd_allreduce_bytes``: the
        fsdp reduce-scatter has no all-gather twin, and the dp legs
        ride only the ``1/fsdp`` chunk."""
        total = 0.0
        for b in self.buckets:
            payload = b.padded * 4.0 / self.model_shard
            if self.zero:
                F = self.fsdp
                # reduce-scatter into the fsdp shard layout; params /
                # optimizer state are fsdp-sharded, so no gather leg
                total += (F - 1) / F * payload
                payload /= F
            if self.dp <= 1:
                continue
            c = self._dcn_wire_factor(b)
            if self.auto_psum:
                # bucketed per-bucket all-reduce (psum) over dp
                total += 2.0 * (self.dp - 1) / self.dp * payload * c
            elif self.two_level:
                per = self.dp_ici
                total += 2.0 * (per - 1) / per * payload
                total += (
                    2.0 * (self.slices - 1) / self.slices
                    * (payload / per) * c
                )
            else:
                total += 2.0 * (self.dp - 1) / self.dp * payload * c
        return int(total)

    def _dcn_wire_factor(self, b: Bucket) -> float:
        """Bytes shipped per fp32 byte on this bucket's compressed
        leg (the ``c`` of the ring accounting): 1/4 under int8, the
        realized block density (int8 values + one int32 index per
        block) under int8_topk, 1.0 dense."""
        if self.compress == "int8":
            return _INT8_BYTES / 4.0
        if self.sparse:
            nblk, k = self.topk_blocks(b)
            per_block = self.topk_block * _INT8_BYTES + _INDEX_BYTES
            return (k * per_block) / (nblk * self.topk_block * 4.0)
        return 1.0

    # -- cross-slice (DCN) accounting: totals over all devices/sync ----
    def dcn_bytes_flat(self) -> int:
        """Cross-slice bytes the FLAT schedule moves per sync: a ring
        reduce-scatter + all-gather over dp devices laid out as
        ``slices`` contiguous blocks crosses a slice boundary on
        ``slices`` of its dp edges, each of 2(dp-1) rounds carrying
        payload/dp fp32 elements per edge (payload = the fsdp chunk on
        ZeRO plans — the dp legs ride it)."""
        if not self.two_level:
            return 0
        return sum(
            int(
                2 * (self.dp - 1) * self.slices
                * (b.padded // self.fsdp) * 4 / self.dp
            )
            for b in self.buckets
        )

    def dcn_bytes_twolevel(self) -> int:
        """Cross-slice bytes the two-level schedule moves per sync:
        every device all-reduces only its slice-local shard (of the
        fsdp chunk, on ZeRO plans) across slices (ring factor
        2(S-1)/S), int8-compressed when the plan compresses and
        block-sparse on top under int8_topk
        (``dcn_bytes_sparse``)."""
        if not self.two_level:
            return 0
        if self.sparse:
            return self.dcn_bytes_sparse()
        S = self.slices
        per_elem = (
            _INT8_BYTES if self.compress == "int8" else 4
        )
        total = 0
        for b in self.buckets:
            shard = b.padded // self.fsdp // self.dp_ici
            per_dev = 2.0 * (S - 1) / S * shard * per_elem
            if self.compress == "int8":
                per_dev += _SCALE_BYTES
            total += int(per_dev * self.total)
        return total

    def dcn_bytes_sparse(self) -> int:
        """Cross-slice bytes of the int8_topk schedule per sync: each
        device ships its k top blocks (int8 values + one int32 block
        index each) plus the shared fp32 scale at the same 2(S-1)/S
        ring factor. The return path may carry up to the UNION of the
        participants' block sets; the ring accounting here prices the
        per-device contribution, the same convention every other
        accounting method uses."""
        if not self.two_level or not self.sparse:
            return 0
        S = self.slices
        total = 0
        for b in self.buckets:
            nblk, k = self.topk_blocks(b)
            payload = k * (
                self.topk_block * _INT8_BYTES + _INDEX_BYTES
            )
            per_dev = 2.0 * (S - 1) / S * payload + _SCALE_BYTES
            total += int(per_dev * self.total)
        return total

    def describe(self) -> str:
        dens = (
            f" at density {self.dcn_density:.2f}" if self.sparse else ""
        )
        lvl = (
            f", two-level over {self.slices} slices "
            f"(dcn {self.dcn_bytes_twolevel() >> 20} MiB vs flat "
            f"{self.dcn_bytes_flat() >> 20} MiB/sync{dens})"
            if self.two_level
            else ""
        )
        if self.zero:
            tp3 = (
                f" x {self.tp}-way tp (manual, tp-local buckets)"
                if self.three_d
                else ""
            )
            axes = f"{self.dp}-way dp x {self.fsdp}-way fsdp{tp3} " \
                f"(ZeRO reduce-scatter, " \
                f"{self.explicit_wire_bytes() >> 10} " \
                f"KiB/dev vs {self.gspmd_allreduce_bytes() >> 10} KiB " \
                f"all-reduce)"
        elif self.auto_axes:
            axes = (
                f"{self.dp}-way dp under GSPMD "
                f"{'x'.join(self.auto_axes)} (bucketed psum)"
            )
        else:
            axes = f"{self.dp}-way dp"
        return (
            f"{self.num_buckets} buckets over {axes}, "
            f"{self.raw_bytes >> 20} MiB raw -> "
            f"{self.wire_bytes >> 20} MiB wire ({self.compress}){lvl}"
        )


def _leaf_meta(leaves) -> Tuple[Tuple[Tuple[int, ...], ...], Tuple[str, ...]]:
    """Shapes and dtype names of ``leaves``: tensors, arrays, or
    ``(shape, dtype)`` pairs."""
    shapes, dtypes = [], []
    for l in leaves:
        if isinstance(l, tuple) and len(l) == 2 and not hasattr(l, "shape"):
            shape, dt = l
        else:
            shape, dt = l.shape, l.dtype
        shapes.append(tuple(int(d) for d in shape))
        dtypes.append(_dtype_name(dt))
    return tuple(shapes), tuple(dtypes)


def plan_buckets(
    leaves: Sequence,
    dp: int,
    bucket_bytes: int = 4 << 20,
    compress: str = "none",
    slices: int = 1,
    fsdp: int = 1,
    auto_axes: Tuple[str, ...] = (),
    model_shard: int = 1,
    kind: str = "",
    tp: int = 1,
    leaf_tp_dims: Tuple[Optional[int], ...] = (),
    topk_density: float = 1.0,
    topk_block: int = TOPK_BLOCK,
    leaf_block: int = 0,
) -> BucketPlan:
    """Greedy size-targeted partition of the grad leaves (in the JAX
    package's tree flatten order), with the JAX package's checks and
    bucket bounds. A leaf larger than ``bucket_bytes`` gets its own
    bucket; the plan never splits a leaf. ``fsdp > 1`` plans the ZeRO
    schedule (padding covers the fsdp scatter too); ``leaf_block > 0``
    pads each leaf to fsdp x whole blocks instead (the port's ZeRO
    layout, ``BucketPlan.leaf_block``)."""
    if compress not in _COMPRESS_MODES:
        raise ValueError(
            f"unknown grad compression {compress!r} "
            "(expected 'none', 'int8' or 'int8_topk'; 'auto' must be "
            "resolved upstream — resolve_auto_compress)"
        )
    if dp < 1 or fsdp < 1:
        raise ValueError(f"dp/fsdp must be >= 1, got {dp}/{fsdp}")
    if slices < 1 or dp % slices:
        raise ValueError(
            f"slices={slices} must divide dp={dp} (and be >= 1)"
        )
    if compress == "int8_topk":
        if slices <= 1:
            raise ValueError(
                "int8_topk sparsifies the cross-slice DCN leg; a "
                "single-slice plan has no such leg (use 'int8')"
            )
        if not (0.0 < topk_density <= 1.0):
            raise ValueError(
                f"topk_density must be in (0, 1], got {topk_density}"
            )
        if topk_block < 1:
            raise ValueError(
                f"topk_block must be >= 1, got {topk_block}"
            )
    if auto_axes and fsdp > 1 and kind != "3d":
        raise ValueError(
            "a dp x tp/sp plan supports no fsdp leg (only the fully-"
            "manual 3d kind composes them; see resolve_sync_mode)"
        )
    if kind == "3d" and (tp < 2 or not leaf_tp_dims):
        raise ValueError(
            "a 3d plan needs tp >= 2 and per-leaf tp dims (shapes "
            "must be the tp-LOCAL shards — use resolve_plan/"
            "plan_for_mesh, not plan_buckets directly)"
        )
    shapes, dtypes = _leaf_meta(leaves)
    buckets: List[Bucket] = []
    start = 0
    cur_elems = 0
    cur_bytes = 0
    pad_to = dp * fsdp  # every scatter stage must divide evenly
    unit = fsdp * leaf_block

    def _close(stop: int):
        nonlocal start, cur_elems, cur_bytes
        if stop == start:
            return
        if leaf_block:
            # each leaf to fsdp x whole blocks; each rank's run of the
            # bucket (its rows of every leaf) padded so dp divides it
            laid = sum(
                -(-_numel(shapes[i]) // unit) * unit
                for i in range(start, stop)
            )
            chunk = -(-(laid // fsdp) // dp) * dp
            padded = chunk * fsdp
        else:
            padded = -(-cur_elems // pad_to) * pad_to
        buckets.append(
            Bucket(
                index=len(buckets),
                start=start,
                stop=stop,
                elems=cur_elems,
                padded=padded,
                raw_bytes=cur_bytes,
            )
        )
        start = stop
        cur_elems = 0
        cur_bytes = 0

    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        n = _numel(shape)
        nb = n * _ITEMSIZE[dt]
        if cur_bytes and cur_bytes + nb > bucket_bytes:
            _close(i)
        cur_elems += n
        cur_bytes += nb
        if cur_bytes >= bucket_bytes:
            _close(i + 1)
    _close(len(shapes))
    return BucketPlan(
        buckets=tuple(buckets),
        leaf_shapes=shapes,
        leaf_dtypes=dtypes,
        dp=dp,
        compress=compress,
        slices=slices,
        fsdp=fsdp,
        auto_axes=tuple(auto_axes),
        model_shard=model_shard,
        kind=kind,
        tp=tp,
        leaf_tp_dims=tuple(leaf_tp_dims),
        topk_density=float(topk_density),
        topk_block=int(topk_block),
        leaf_block=int(leaf_block),
    )


# once-per-mesh fallback visibility: a mesh that loses the explicit
# path is logged once per process per mesh and recorded as
# ``PipelineStats.grad_sync_path`` by the trainer
_GSPMD_FALLBACK_LOGGED: set = set()


def note_gspmd_fallback(axis_sizes: dict, reason: str = "") -> None:
    """Log ONCE per process per mesh when a strategy that requested
    the explicit sync path runs the default schedule instead (here: one
    all-reduce of the whole grad tree per microbatch)."""
    from dlrover_tpu_torch.common.log import default_logger as logger

    key = tuple(sorted((k, int(v)) for k, v in axis_sizes.items()))
    if key in _GSPMD_FALLBACK_LOGGED:
        return
    _GSPMD_FALLBACK_LOGGED.add(key)
    if not reason:
        reason = fallback_reason(axis_sizes)
    sizes = {k: int(v) for k, v in axis_sizes.items() if int(v) > 1}
    logger.info(
        f"grad_sync: mesh {sizes or {'dp': 1}} keeps the default "
        f"schedule{' (' + reason + ')' if reason else ''}; the explicit "
        f"bucketed path supports dp, dp x fsdp, dp x tp/sp, "
        f"dp x fsdp x tp and pp x dp meshes here (grad_sync_path=gspmd)"
    )


def resolve_auto_compress(
    slices: int = 1,
    whole_dcn: bool = False,
    auto_axes: Tuple[str, ...] = (),
    link_model=None,
) -> str:
    """Concrete compression mode for ``grad_compress="auto"``: pick
    none / int8 / int8+topk for the dp sync from the measured ICI:DCN
    bandwidth ratio (observed rail rates fold into the model, so the
    policy tracks what the links actually deliver):

    - model-sharded plans (``auto_axes``): "none" — the residual gate
      (``supports_auto_axis_residual_shardings``) owns that decision;
    - hybrid dp axis (``slices > 1``): the DCN shard leg exists —
      sparsify it (int8+topk) when DCN is severely outmatched
      (ratio >= ``AUTO_TOPK_RATIO``), quantize it at
      ``AUTO_INT8_RATIO``, ship fp32 near parity;
    - a dp axis WHOLE on DCN (``whole_dcn``): the flat ring rides DCN
      end to end — int8 compresses the whole ring (there is no
      two-level shard to sparsify);
    - pure-ICI meshes: "none" (wire is cheap; EF noise is not free).
    """
    from dlrover_tpu_torch.parallel import topology

    if auto_axes:
        return "none"
    model = link_model or topology.get_link_model()
    ratio = model.ici_gbps / max(model.dcn_gbps, 1e-9)
    if slices > 1:
        if ratio >= AUTO_TOPK_RATIO:
            return "int8_topk"
        if ratio >= AUTO_INT8_RATIO:
            return "int8"
        return "none"
    if whole_dcn and ratio >= AUTO_INT8_RATIO:
        return "int8"
    return "none"


def resolve_bucket_bytes(
    grad_bucket_mb: int,
    dp: int = 1,
    slices: int = 1,
    compress: str = "none",
    link_model=None,
    fsdp: int = 1,
    topk_density: float = 1.0,
) -> int:
    """Bucket-size target in bytes. ``grad_bucket_mb > 0`` is the
    explicit global knob (historical behavior). ``0`` means **auto**:
    size each bucket so its wire time on the link it actually crosses
    is ~``topology.BUCKET_TARGET_COMM_MS`` — the DCN leg for two-level
    plans (a bucket's cross-slice payload is ``1/(fsdp * dp_ici)`` of
    its elements, ``1/4`` again under int8, so the full-bucket target
    scales back up by those factors), the ICI ring otherwise."""
    if grad_bucket_mb > 0:
        return grad_bucket_mb << 20
    from dlrover_tpu_torch.parallel import topology

    model = link_model or topology.get_link_model()
    topology.note_fallback_use(model)
    if slices > 1:
        dcn_payload = topology.bucket_bytes_for(model, "dcn")
        scale = float((dp // slices) * fsdp)
        if compress == "int8":
            scale *= 4  # the DCN shard ships int8, the target is fp32
        elif compress == "int8_topk":
            # the DCN shard ships k/nblk blocks of int8 (+indices) —
            # the full-bucket target scales back up by the inverse
            density = max(float(topk_density), 1e-3)
            scale *= 4.0 / (
                density * (1.0 + _INDEX_BYTES / float(TOPK_BLOCK))
            )
        b = dcn_payload * scale
    else:
        b = topology.bucket_bytes_for(model, "ici")
    return max(
        topology._BUCKET_MIN_BYTES,
        min(topology._BUCKET_MAX_BYTES, int(b)),
    )


def model_leaves(cfg, mesh=None) -> list:
    """The model's parameter leaves in the JAX tree order, on the meta
    device (shapes and dtypes, no storage); with a ``mesh`` of tp > 1 a
    rank's tp-local leaves."""
    import torch

    from dlrover_tpu_torch.models.transformer import Transformer

    with torch.device("meta"):
        return Transformer(cfg, mesh=mesh).jax_ordered_parameters()


def _localize_axis(params_shape, degree: int, cfg, mesh_axis: str):
    """``params_shape`` (leaves in the JAX order) with each
    ``mesh_axis``-sharded leaf dim divided by ``degree`` (a dim the
    degree does not divide stays whole, as the rules leave it). Returns
    the local ``(shape, dtype)`` leaves and the per-leaf dims (None for
    a leaf every rank of the axis holds whole): the JAX package's, by
    which its fully-manual sync regions bucket in local coordinates."""
    from dlrover_tpu_torch.parallel.sharding_rules import jax_order, tp_dims

    named = tp_dims(cfg, 1, mesh_axis)
    dims = [named[n] for n in jax_order(named)]
    shapes, dtypes = _leaf_meta(params_shape)
    if len(dims) != len(shapes):
        raise ValueError(
            f"logical axes tree ({len(dims)} leaves) does not match the "
            f"param tree ({len(shapes)} leaves)"
        )
    out_leaves, out_dims = [], []
    for shape, dt, dim in zip(shapes, dtypes, dims):
        if dim is not None and shape[dim] % degree == 0:
            shape = tuple(d // degree if i == dim else d for i, d in enumerate(shape))
            out_dims.append(dim)
        else:
            out_dims.append(None)
        out_leaves.append((shape, dt))
    return out_leaves, tuple(out_dims)


def _localize_tp(params_shape, tp: int, cfg):
    return _localize_axis(params_shape, tp, cfg, "tp")


def _plan_for_mode(
    cfg, mode: SyncMode, grad_compress: str, grad_bucket_mb: int,
    params_shape=None, slices: int = 1,
    topk_density: float = AUTO_TOPK_DENSITY, whole_dcn: bool = False,
) -> BucketPlan:
    if params_shape is None:
        params_shape = model_leaves(cfg)
    if grad_compress == "auto":
        grad_compress = resolve_auto_compress(
            slices=slices if mode.kind != "tp" else 1,
            whole_dcn=whole_dcn,
            auto_axes=mode.auto_axes,
        )
    if mode.kind == "ep":
        # the fully-manual (dp, ep) path has its own split plan (ep-local
        # expert leaves + dense leaves), never compressed
        return _plan_for_ep(cfg, mode, grad_bucket_mb, params_shape, slices=slices)
    if mode.kind in ("tp", "3d") and grad_compress != "none":
        # the JAX gate: int8 on the tp kind when its residual probe
        # answers True (it does on the JAX release here; tp plans have
        # no DCN shard to sparsify), never on 3d
        grad_compress = "int8" if mode.kind == "tp" else "none"
    if mode.kind == "tp":
        # the sp sum and flat dp legs (the JAX tp path's one flat psum
        # a bucket): no DCN shard leg
        slices = 1
    slices = slices if 1 < slices < mode.dp else 1
    if grad_compress == "int8_topk" and slices <= 1:
        # no cross-slice DCN leg to sparsify — quantization still pays
        grad_compress = "int8"
    kind, tp, model_shard = mode.kind, 1, mode.model_shard
    leaf_tp_dims: Tuple[Optional[int], ...] = ()
    if kind == "3d":
        # planned over each rank's tp-LOCAL leaves, as the JAX package
        # plans it (model_shard 1: nothing left to divide)
        tp, model_shard = mode.model_shard, 1
        params_shape, leaf_tp_dims = _localize_tp(params_shape, tp, cfg)
    elif kind == "tp" and mode.model_shard > 1:
        # the JAX plan over the global leaves; the port's sync reads
        # each rank's boxes of them from these
        tp = mode.model_shard
        leaf_tp_dims = _localize_tp(params_shape, tp, cfg)[1]
    return plan_buckets(
        params_shape,
        dp=mode.dp,
        bucket_bytes=resolve_bucket_bytes(
            grad_bucket_mb, dp=mode.dp, slices=slices,
            compress=grad_compress, fsdp=mode.fsdp,
            topk_density=topk_density,
        ),
        compress=grad_compress,
        slices=slices,
        fsdp=mode.fsdp,
        auto_axes=mode.auto_axes,
        model_shard=model_shard,
        kind=kind,
        tp=tp,
        leaf_tp_dims=leaf_tp_dims,
        topk_density=topk_density,
        topk_block=TOPK_BLOCK,
        leaf_block=ZERO_LEAF_BLOCK if kind in ("zero", "3d") else 0,
    )


# the port's ZeRO layout cuts every leaf into whole blocks of the 8-bit
# AdamW's quantization block (``ops/quantized_optim.BLOCK``)
ZERO_LEAF_BLOCK = 128


@dataclass(frozen=True)
class PPSyncPlan:
    """Per-stage bucketed sync for a pp x dp mesh (SyncMode "pp"; the JAX
    class). ``stage_plan`` buckets ONE stage's leaves (stage-local
    shapes): every stage rank walks it over its own leaves, each
    collective within its stage's dp group. ``shared_plan`` covers the
    embedding / final-norm / head leaves every stage holds (synced
    identically on each stage). Quacks like a ``BucketPlan`` for the
    trainer and the cost model."""

    stage_plan: BucketPlan
    shared_plan: BucketPlan
    pp: int
    dp: int
    schedule: str = "gpipe"
    kind: str = "pp"
    compress: str = "none"

    @property
    def buckets(self) -> Tuple[Bucket, ...]:
        return self.stage_plan.buckets + self.shared_plan.buckets

    @property
    def num_buckets(self) -> int:
        return self.stage_plan.num_buckets + self.shared_plan.num_buckets

    @property
    def two_level(self) -> bool:
        return self.stage_plan.two_level

    @property
    def slices(self) -> int:
        return self.stage_plan.slices

    @property
    def raw_bytes(self) -> int:
        """Per-rank raw bytes of one sync (a rank holds 1/pp of the
        stage leaves plus the shared leaves)."""
        return self.stage_plan.raw_bytes + self.shared_plan.raw_bytes

    @property
    def wire_bytes(self) -> int:
        return self.stage_plan.wire_bytes + self.shared_plan.wire_bytes

    def explicit_wire_bytes(self) -> int:
        return self.stage_plan.explicit_wire_bytes() + self.shared_plan.explicit_wire_bytes()

    def gspmd_allreduce_bytes(self) -> int:
        return self.stage_plan.gspmd_allreduce_bytes() + self.shared_plan.gspmd_allreduce_bytes()

    def describe(self) -> str:
        return (
            f"pp{self.pp} x dp{self.dp} [{self.schedule}] per-stage "
            f"sync: {self.stage_plan.num_buckets} stage buckets + "
            f"{self.shared_plan.num_buckets} shared, "
            f"{self.raw_bytes >> 10} KiB raw -> "
            f"{self.wire_bytes >> 10} KiB wire per device/sync, "
            f"after the pipeline's drain"
        )


def plan_for_pipeline(
    cfg,
    axis_sizes: dict,
    grad_bucket_mb: int = 4,
    slices: int = 1,
    schedule: str = "gpipe",
    virtual: int = 1,
) -> Optional[PPSyncPlan]:
    """Gate + plan for the pipeline step: a ``PPSyncPlan`` when the mesh
    is pp x dp (SyncMode "pp"), else None (also when the model cannot
    pipeline at this degree). int8 is not planned on pipeline plans;
    the dp legs honor ``slices`` (two-level)."""
    from dlrover_tpu_torch.parallel.pipeline import _check_pipeline_cfg, pipeline_leaves

    mode = resolve_sync_mode(axis_sizes)
    if mode is None or mode.kind != "pp":
        return None
    pp, dp = mode.pp, mode.dp
    try:
        _check_pipeline_cfg(cfg, pp, virtual)
    except ValueError:
        # the step builder will reject the strategy; a plan would be
        # fiction
        return None
    slices = slices if 1 < slices < dp else 1
    stage_local, shared = pipeline_leaves(cfg, pp, virtual)
    bucket_bytes = resolve_bucket_bytes(grad_bucket_mb, dp=dp, slices=slices)
    return PPSyncPlan(
        stage_plan=plan_buckets(stage_local, dp=dp, bucket_bytes=bucket_bytes,
                                slices=slices, kind="pp"),
        shared_plan=plan_buckets(shared, dp=dp, bucket_bytes=bucket_bytes,
                                 slices=slices, kind="pp"),
        pp=pp,
        dp=dp,
        schedule=schedule,
    )


@dataclass(frozen=True)
class EPSyncPlan:
    """The dp sync of a dp x ep mesh (SyncMode "ep"; the JAX class):
    ``expert_plan`` buckets the ep-local expert leaves (each rank's
    ``E/ep`` experts), ``dense_plan`` the leaves every ep rank holds
    whole; ``expert_leaf_ids`` / ``expert_leaf_dims`` mark which leaves
    of the JAX flatten order are expert-split, and on which dim. Quacks
    like a ``BucketPlan`` for the trainer and the cost model."""

    expert_plan: BucketPlan
    dense_plan: BucketPlan
    ep: int
    dp: int
    expert_leaf_ids: Tuple[int, ...]
    expert_leaf_dims: Tuple[int, ...]
    kind: str = "ep"
    compress: str = "none"

    @property
    def buckets(self) -> Tuple[Bucket, ...]:
        return self.expert_plan.buckets + self.dense_plan.buckets

    def local_padded(self, bucket: Bucket) -> int:
        return bucket.padded

    @property
    def num_buckets(self) -> int:
        return self.expert_plan.num_buckets + self.dense_plan.num_buckets

    @property
    def two_level(self) -> bool:
        return self.dense_plan.two_level

    @property
    def slices(self) -> int:
        return self.dense_plan.slices

    @property
    def raw_bytes(self) -> int:
        """Per-rank raw bytes of one sync (1/ep of the expert leaves
        plus the dense leaves)."""
        return self.expert_plan.raw_bytes + self.dense_plan.raw_bytes

    @property
    def wire_bytes(self) -> int:
        return self.expert_plan.wire_bytes + self.dense_plan.wire_bytes

    def explicit_wire_bytes(self) -> int:
        return self.expert_plan.explicit_wire_bytes() + self.dense_plan.explicit_wire_bytes()

    def gspmd_allreduce_bytes(self) -> int:
        return self.expert_plan.gspmd_allreduce_bytes() + self.dense_plan.gspmd_allreduce_bytes()

    def describe(self) -> str:
        return (
            f"dp{self.dp} x ep{self.ep} sync: "
            f"{self.expert_plan.num_buckets} expert buckets "
            f"(ep-local) + {self.dense_plan.num_buckets} dense, "
            f"{self.raw_bytes >> 10} KiB raw -> "
            f"{self.wire_bytes >> 10} KiB wire per device/sync; "
            f"dispatch/combine all-to-alls inside the manual region"
        )


def _plan_for_ep(cfg, mode: SyncMode, grad_bucket_mb: int, params_shape=None,
                 slices: int = 1) -> EPSyncPlan:
    """Split the leaves into the ep-local expert leaves and the dense
    ones, each bucketed for the dp legs (the JAX ``_plan_for_ep``)."""
    if params_shape is None:
        params_shape = model_leaves(cfg)
    local, dims = _localize_axis(params_shape, mode.ep, cfg, "ep")
    expert_ids = tuple(i for i, d in enumerate(dims) if d is not None)
    dense_ids = tuple(i for i in range(len(local)) if i not in set(expert_ids))
    slices = slices if 1 < slices < mode.dp else 1
    bucket_bytes = resolve_bucket_bytes(grad_bucket_mb, dp=mode.dp, slices=slices)
    return EPSyncPlan(
        expert_plan=plan_buckets([local[i] for i in expert_ids], dp=mode.dp,
                                 bucket_bytes=bucket_bytes, slices=slices, kind="ep"),
        dense_plan=plan_buckets([local[i] for i in dense_ids], dp=mode.dp,
                                bucket_bytes=bucket_bytes, slices=slices, kind="ep"),
        ep=mode.ep,
        dp=mode.dp,
        expert_leaf_ids=expert_ids,
        expert_leaf_dims=tuple(dims[i] for i in expert_ids),
    )


def tp_axes(dims) -> List[Tuple[str, ...]]:
    """``split_grad_norm``'s axes of leaves by their tp dims (None: a
    leaf every tp rank holds whole)."""
    return [() if d is None else ("tp",) for d in dims]


def split_grad_norm(leaves, split_axes, mesh, zero: bool = False):
    """The whole tree's grad norm from a rank's synced leaves: each
    leaf's squares summed once over the axes that hold it whole.
    ``split_axes``: per leaf the tuple of the mesh axes (of "tp", "ep")
    that cut it into boxes; ``zero``: the leaves are ZeRO shards of the
    rank's boxes (their padding zero), summed over fsdp first. The
    squares of the leaves split by tp are then summed over the tp group,
    those split by ep over the ep group (an ep x tp box over both)."""
    import torch

    classes = ((), ("tp",), ("ep",), ("tp", "ep"))
    ss = torch.zeros(4, dtype=torch.float32, device=leaves[0].device if leaves else None)
    for g, axes in zip(leaves, split_axes):
        # squares summed without a leaf-sized temporary
        ss[classes.index(tuple(axes))] += torch.linalg.vector_norm(g.float()).square()
    if zero and mesh.groups.get("fsdp") is not None:
        _wait([_all_reduce(ss, mesh.groups["fsdp"])])
    for axis, idx in (("tp", [1, 3]), ("ep", [2, 3])):
        group = mesh.groups.get(axis)
        if group is not None:
            part = ss[idx].clone()
            _wait([_all_reduce(part, group)])
            ss[idx] = part
    return torch.sqrt(ss.sum())


def sync_ep_grads(grads: Sequence, mesh, plan: Optional[EPSyncPlan], expert_ids: Sequence[int],
                  n_data: int = 1, units=None, tp_dims: Optional[Sequence] = None):
    """An ep rank's gradients synced: ``grads`` (the JAX flatten order;
    the leaves ``expert_ids`` are its ep-local experts, under tp its tp
    boxes of them; consumed) whose dense leaves are nonzero on ep rank 0
    alone (the loss seed) -> (the synced leaves, the global grad norm).
    The dense leaves are summed over ep (one all-reduce of their f32
    concatenation: the sum selects rank 0's); then, with an
    ``EPSyncPlan`` (dp x ep), the expert and the dense leaves take the
    dp legs of their plans; else the default sync: under ZeRO
    (``units``, the step's ``models/train.ZeroUnits``: ep x fsdp) each
    unit's leaves reduce-scattered over fsdp into this rank's shards and
    summed over dp and sp, else summed in place over the data axes (and
    sp: the replica group), the dense concatenation in one all-reduce,
    each expert leaf in one; both divided by ``n_data`` (dp x fsdp: the
    loss is the sp blocks' sum). The norm is ``split_grad_norm``'s, the
    expert leaves split by ep and, by ``tp_dims`` (each leaf's tp dim or
    None), the tp boxes by tp."""
    import torch

    e_ids = list(expert_ids)
    d_ids = [i for i in range(len(grads)) if i not in set(e_ids)]
    ep_group = mesh.groups.get("ep")
    flat = torch.cat([grads[i].reshape(-1).float() for i in d_ids])
    if ep_group is not None:
        _all_reduce(flat, ep_group).wait()
    synced = list(grads)
    off = 0
    for i in d_ids:
        synced[i] = flat[off:off + grads[i].numel()].view(grads[i].shape)
        off += grads[i].numel()
    for i in e_ids:
        synced[i] = grads[i].float()
    if plan is not None:
        expert, _, gn_e = sync_grads([synced[i] for i in e_ids], mesh, plan.expert_plan)
        dense, _, gn_d = sync_grads([synced[i] for i in d_ids], mesh, plan.dense_plan)
        ss_e = gn_e.square().reshape(1).clone()
        if ep_group is not None:
            _all_reduce(ss_e, ep_group).wait()
        for i, g in list(zip(e_ids, expert)) + list(zip(d_ids, dense)):
            synced[i] = g.to(grads[i].dtype)
        return synced, torch.sqrt(ss_e[0] + gn_d.square())
    if units is not None:
        from dlrover_tpu_torch.models.train import zero_scatter

        done = set()
        for idx, _ in units.units.values():
            # a leaf two units read (a tied table) is scattered once
            idx = [i for i in idx if i not in done]
            if not idx:
                continue
            done.update(idx)
            shards = zero_scatter([synced[i] for i in idx], idx, units, mesh, n_data,
                                   over=("dp", "sp"))
            for i, sh in zip(idx, shards):
                synced[i] = sh
    else:
        group = mesh.groups["replica"] if mesh.config.sp > 1 else mesh.groups["data"]
        if group is not None:  # else no data axis and no sp: nothing to sum
            for t in [flat] + [synced[i] for i in e_ids]:
                _all_reduce(t, group).wait()
                if n_data > 1:
                    t /= n_data
    e_set = set(e_ids)
    axes = [tuple(a for a, on in (("tp", tp_dims is not None and tp_dims[i] is not None),
                                  ("ep", i in e_set)) if on)
            for i in range(len(grads))]
    gnorm = split_grad_norm(synced, axes, mesh, zero=units is not None)
    if units is None:
        synced = [g.to(grads[i].dtype) for i, g in enumerate(synced)]
    return synced, gnorm


def plan_for_mesh(
    cfg,
    mesh,
    grad_compress: str = "none",
    grad_bucket_mb: int = 4,
    params_shape: Optional[Any] = None,
    slices: int = 1,
    grad_topk_density: float = AUTO_TOPK_DENSITY,
) -> Optional[BucketPlan]:
    """Gate + plan from a built mesh (``parallel/mesh.Mesh``, whose
    config carries the slice count; ``slices`` overrides it when > 1)."""
    sizes = mesh.axis_sizes()
    mode = resolve_sync_mode(sizes)
    if mode is None:
        return None
    if mode.kind == "pp":
        # the non-pipeline step asked about a pp mesh: its flat grad list
        # has no stage structure to key buckets on (the pipeline step
        # plans through ``plan_for_pipeline``)
        return None
    slices = slices if slices > 1 else mesh.config.dp_slices()
    if slices > 1 and mode.dp % slices:
        raise ValueError(
            f"slices={slices} does not divide dp={mode.dp}"
        )
    return _plan_for_mode(
        cfg, mode, grad_compress, grad_bucket_mb, params_shape,
        slices=slices, topk_density=grad_topk_density,
    )


def resolve_plan(
    cfg,
    strategy,
    params_shape: Optional[Any] = None,
) -> Optional[BucketPlan]:
    """The single gating decision: a BucketPlan when the explicit sync
    path applies to ``strategy``, else None (the default schedule).

    Engages iff ``comm_overlap`` (or int8 ``grad_compress``, which
    requires the explicit path) is requested AND the mesh qualifies
    (``resolve_sync_mode``). A mesh that resolves to no mode (dp = 1
    and fsdp = 1, for one) keeps the default path with a once-per-mesh
    log naming why; pp x dp returns a ``PPSyncPlan``
    (``plan_for_pipeline``). A hybrid dp axis (``MeshConfig.dp_slices() > 1``)
    plans the two-level schedule on the dp legs."""
    if not strategy.resolved_comm_overlap():
        return None
    sizes = strategy.mesh.axis_sizes()
    mode = resolve_sync_mode(sizes)
    if mode is None:
        note_gspmd_fallback(sizes)
        return None
    if mode.kind == "ep" and strategy.grad_accum > 1:
        # the JAX gate: the ep region syncs per call, so grad_accum keeps
        # the default path (the port's accumulates locally, then one sync)
        note_gspmd_fallback(
            sizes,
            reason=f"ep explicit sync with grad_accum={strategy.grad_accum}: "
            f"the manual region syncs per call",
        )
        return None
    if mode.kind == "pp":
        return plan_for_pipeline(
            cfg,
            sizes,
            grad_bucket_mb=strategy.grad_bucket_mb,
            slices=strategy.mesh.dp_slices(),
            schedule=strategy.resolved_pp_schedule(),
            virtual=strategy.resolved_virtual(),
        )
    slices = strategy.mesh.dp_slices()
    return _plan_for_mode(
        cfg,
        mode,
        strategy.resolved_grad_compress(),
        strategy.grad_bucket_mb,
        params_shape,
        slices=slices,
        topk_density=getattr(
            strategy, "grad_topk_density", AUTO_TOPK_DENSITY
        ),
        whole_dcn=("dp" in strategy.mesh.dcn_axes and slices <= 1),
    )


# -- collectives ------------------------------------------------------------

# every collective issued, by kind, and the bytes of their inputs (tests
# and chip_smoke.py's pp phase count them per step)
issued = {"reduce_scatter": 0, "all_to_all": 0, "all_gather": 0, "all_reduce": 0}
issued_bytes = dict.fromkeys(issued, 0)


def reset_counts() -> None:
    for k in issued:
        issued[k] = 0
        issued_bytes[k] = 0


def _count(kind: str, t) -> None:
    issued[kind] += 1
    issued_bytes[kind] += t.numel() * t.element_size()


def _reduce_scatter(inp, group):
    """(this rank's summed chunk, handle): ``inp`` split in group-size
    equal chunks in group rank order."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = torch.empty(inp.numel() // n, dtype=inp.dtype, device=inp.device)
    _count("reduce_scatter", inp)
    return out, dist.reduce_scatter_tensor(out, inp, group=group, async_op=True)


def _all_gather(inp, group):
    """(the group's chunks concatenated in group rank order, handle)."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = torch.empty(inp.numel() * n, dtype=inp.dtype, device=inp.device)
    _count("all_gather", inp)
    return out, dist.all_gather_into_tensor(out, inp, group=group, async_op=True)


def _all_to_all(inp, group):
    """(this rank's chunk of every group member's ``inp``, in group rank
    order, handle): chunk j of ``inp`` goes to group rank j."""
    import torch
    import torch.distributed as dist

    out = torch.empty_like(inp)
    _count("all_to_all", inp)
    return out, dist.all_to_all_single(out, inp, group=group, async_op=True)


def _sum_codes(q, group):
    """The group's sum of int8 code vectors ``q`` (int16, or int32 above
    258 ranks), on the wire as they are: an all-to-all hands this rank
    chunk r of every rank's codes, summed here in int32, and the summed
    chunks are all-gathered. Integer sums are exact: bitwise what an
    int32 reduce-scatter and all-gather of the same codes give."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    got, h = _all_to_all(q, group)
    h.wait()
    chunk = got.view(n, -1).sum(0, dtype=torch.int32)
    del got
    if code_sum_dtype_bytes(n) == 4:
        full, h = _all_gather(chunk, group)
        h.wait()
        return full
    # int16 sums travel as their bytes: neither gloo nor NCCL has an
    # int16 collective
    full, h = _all_gather(chunk.to(torch.int16).view(torch.uint8), group)
    h.wait()
    return full.view(torch.int16)


def _all_reduce(t, group, op=None):
    """In-place all-reduce of ``t`` (SUM unless ``op``); its handle."""
    import torch.distributed as dist

    _count("all_reduce", t)
    op = dist.ReduceOp.SUM if op is None else op
    return dist.all_reduce(t, op=op, group=group, async_op=True)


def broadcast(t, src: int, group):
    """In-place broadcast of ``t`` from global rank ``src``; its handle."""
    import torch.distributed as dist

    return dist.broadcast(t, src=src, group=group, async_op=True)


def _wait(handles):
    for h in handles:
        h.wait()


# -- bucket layout ----------------------------------------------------------


def _bucket_flat(leaves: Sequence, bucket: Bucket, plan: BucketPlan):
    """One bucket's leaves as one padded f32 vector: back to back (the
    JAX layout; a rank's tp-local leaves on a ``tp_local`` plan), or
    rank-major by block rows on ``leaf_block`` plans."""
    import torch
    import torch.nn.functional as F

    if plan.leaf_block:
        rows = []
        for i in range(bucket.start, bucket.stop):
            l = leaves[i].reshape(-1).float()
            l = F.pad(l, (0, plan.leaf_padded(i) - l.numel()))
            rows.append(l.view(plan.fsdp, -1))
        laid = torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]
        chunk = bucket.padded // plan.fsdp
        return F.pad(laid, (0, chunk - laid.shape[1])).reshape(-1)
    parts = [l.reshape(-1).float() for l in leaves[bucket.start : bucket.stop]]
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    padded = plan.local_padded(bucket)
    if padded != flat.numel():
        flat = F.pad(flat, (0, padded - flat.numel()))
    return flat


def _unflatten_bucket(flat, bucket: Bucket, plan: BucketPlan):
    """A synced bucket back into its leaves at their dtypes: whole
    leaves from a full bucket, or on ``leaf_block`` plans this rank's
    rows of each leaf (``leaf_shard`` elements, 1-D) from its chunk."""
    import torch

    out = []
    off = 0
    for i in range(bucket.start, bucket.stop):
        dt = getattr(torch, plan.leaf_dtypes[i])
        if plan.leaf_block:
            n = plan.leaf_shard(i)
            out.append(flat[off : off + n].to(dt))
        else:
            shape = plan.local_shape(i)
            n = _numel(shape)
            out.append(flat[off : off + n].reshape(shape).to(dt))
        off += n
    return out


def _topk_block_mask(xx, density: float, block: int):
    """0/1 mask over ``xx`` keeping the k highest-|sum| fixed-size
    blocks. k derives from the STATIC length and density (the same
    formula as ``BucketPlan.topk_blocks``), never the values; density
    1.0 returns all-ones and the caller's math reduces bitwise to the
    dense int8 path."""
    import torch
    import torch.nn.functional as F

    n = int(xx.shape[0])
    nblk = -(-n // block)
    k = max(1, min(nblk, int(round(nblk * density))))
    if k >= nblk:
        return torch.ones_like(xx)
    pad = nblk * block - n
    xp = F.pad(xx, (0, pad)) if pad else xx
    score = xp.reshape(nblk, block).abs().sum(dim=1)
    idx = torch.topk(score, k).indices
    blk = torch.zeros(nblk, dtype=torch.float32, device=xx.device)
    blk[idx] = 1.0
    mask = blk.repeat_interleave(block)
    return mask[:n] if pad else mask


def _quantize(xx, scale, rest=None):
    """(int8 codes of ``xx`` at ``scale``, new residual ``rest - codes x
    scale``, ``rest`` defaulting to ``xx``). The residual is one fused
    multiply-add, a single rounding, as XLA contracts the JAX package's
    ``xx - q * scale``."""
    import torch

    q = torch.round(xx / scale).clamp_(-127, 127).to(torch.int8)
    rest = xx if rest is None else rest
    return q, torch.addcmul(rest, q.float(), scale, value=-1.0)


# -- the legs: each runs one stage over every bucket, its collectives
# issued asynchronously and waited for together ---------------------------


def _shared_scales(xs, mesh, plan: BucketPlan):
    """One scale a bucket: the MAX over the stack axes of each rank's
    absmax, / 127, floored at 1e-20. The division is a product with the
    f32 reciprocal of 127, as XLA compiles the JAX package's ``/ 127.0``
    (the two differ in the last bit for about one value in twenty), so
    the codes and the scale are the JAX package's bit for bit."""
    import torch
    import torch.distributed as dist

    amax = [x.abs().max().reshape(1) for x in xs]
    group = mesh.groups["data" if plan.zero else "dp"]
    if group is not None:
        _wait([_all_reduce(a, group, dist.ReduceOp.MAX) for a in amax])
    if plan.tp_local and mesh.groups.get("tp") is not None:
        # the JAX scale is the whole bucket's: every tp rank's boxes
        _wait([_all_reduce(a, mesh.groups["tp"], dist.ReduceOp.MAX) for a in amax])
    return [torch.clamp_min(a * (1.0 / 127.0), 1e-20) for a in amax]


def _dp_leg_flat(xs, residual, mesh, plan: BucketPlan):
    """Flat dp-axis sync of each bucket's per-rank vector: reduce-scatter
    + all-gather. Returns the dp-SUMs and the new residuals."""
    group = mesh.groups["dp"]
    new_res = [None] * len(xs)
    if plan.compress == "int8":
        xx = [x + r if r is not None else x for x, r in zip(xs, residual)]
        scales = _shared_scales(xx, mesh, plan)
        payload = []
        for i, (v, s) in enumerate(zip(xx, scales)):
            q, new_res[i] = _quantize(v, s)
            payload.append(q)
    else:
        payload, scales = xs, None
    if group is None:
        summed = payload
    elif scales is not None:
        # the codes ship as int8, their sums as int16 (one bucket in
        # flight, as below)
        summed = [_sum_codes(p, group) for p in payload]
    else:
        # a bucket's reduce-scatter and all-gather are waited for before
        # the next bucket's are issued: the backend's buffers (gloo's
        # reduce-scatter copies its whole input) and the scattered chunk
        # live for one bucket at a time, and on a stream-ordered backend
        # the host does not block
        summed = []
        for p in payload:
            o, h = _reduce_scatter(p, group)
            h.wait()
            g, h = _all_gather(o, group)
            h.wait()
            summed.append(g)
    if scales is not None:
        summed = [s_.float() * sc for s_, sc in zip(summed, scales)]
    return summed, new_res


def _dp_leg_2level(xs, residual, mesh, plan: BucketPlan, legs: str = "all"):
    """Two-level dp-axis sync for a hybrid dp axis: slice-local
    reduce-scatter, cross-slice all-reduce of the shard (int8 or int8
    top-k there when the plan compresses, carrying error feedback on the
    shard), slice-local all-gather. ``legs="ici"`` skips the cross-slice
    leg (the per-link timing probe); the residual then rides through."""
    ici, dcn = mesh.groups["ici"], mesh.groups["dcn"]
    parts = [_reduce_scatter(x, ici) for x in xs]
    _wait([h for _, h in parts])
    shards = [o for o, _ in parts]
    new_res = list(residual)
    if legs == "ici":
        totals = shards
    elif plan.compress in _EF_MODES:
        xx = [s + r if r is not None else s for s, r in zip(shards, residual)]
        if plan.compress == "int8_topk":
            # each participant ships its own k blocks; what it did not
            # ship lands in the residual with the quantization error
            xx_m = [
                v * _topk_block_mask(v, plan.topk_density, plan.topk_block)
                for v in xx
            ]
        else:
            xx_m = xx
        scales = _shared_scales(xx_m, mesh, plan)
        totals = []
        for i, (v, vm, s) in enumerate(zip(xx, xx_m, scales)):
            q, new_res[i] = _quantize(vm, s, rest=v)
            # int8 codes over the stripe group, their sums as int16
            summed = _sum_codes(q, dcn) if dcn is not None else q
            totals.append(summed.float() * s)
    else:
        totals = shards
        _wait([_all_reduce(t, dcn) for t in totals])
    gathered = [_all_gather(t, ici) for t in totals]
    _wait([h for _, h in gathered])
    return [o for o, _ in gathered], new_res


def _sync_buckets(flats, residual, mesh, plan: BucketPlan, legs: str = "all"):
    """(mean vectors, new residuals, local sum of squares of the means)
    of each bucket: the ZeRO reduce-scatter over fsdp first (no
    all-gather twin), then the dp legs; the mean divides by
    ``plan.total``."""
    import torch

    xs = flats
    if plan.kind in ("tp", "3d") and mesh.groups.get("sp") is not None:
        # sequence parallelism: each rank's grads are a partial sum over
        # its sequence block; the sp sum comes first, a bucket at a time
        for f in flats:
            _all_reduce(f, mesh.groups["sp"]).wait()
    if plan.zero and mesh.groups["fsdp"] is not None:
        # one bucket in flight at a time (see _dp_leg_flat); each flat is
        # dropped once scattered
        xs = []
        for i, f in enumerate(flats):
            o, h = _reduce_scatter(f, mesh.groups["fsdp"])
            h.wait()
            xs.append(o)
            flats[i] = None
    residual = list(residual) if residual is not None else [None] * len(xs)
    if plan.two_level:
        full, new_res = _dp_leg_2level(xs, residual, mesh, plan, legs)
    else:
        full, new_res = _dp_leg_flat(xs, residual, mesh, plan)
    # the sums are this function's own tensors once a collective or the
    # quantizer made them: divided in place (the same quotients)
    owned = plan.zero or plan.compressed or mesh.groups.get("dp") is not None
    means = [f.div_(plan.total) if owned else f / plan.total for f in full]
    sumsq = torch.stack([(m * m).sum() for m in means]).sum() if means else None
    return means, new_res, sumsq


def sync_grads(
    local_grads: Sequence,
    mesh,
    plan: BucketPlan,
    residual: Optional[Tuple] = None,
    _legs: str = "all",
    device_norms: bool = False,
    consume: bool = False,
):
    """Bucketed sync of this rank's local grads -> (synced grads, new
    residual tuple or None, global grad norm).

    ``consume=True`` clears ``local_grads`` (a list) leaf by leaf as
    each bucket is flattened, so that a grad whose flat is a copy (every
    ZeRO bucket, every bucket of several leaves) is freed before the
    next bucket's copy is made. The buckets' collectives run one bucket
    at a time.

    ``local_grads``: this rank's unsynchronized grads, one per leaf in
    the plan's order (full leaf shapes). ``residual``: this rank's
    per-bucket ``(shard_elems,)`` f32 error-feedback rows (the JAX
    package's ``(total, shard_elems)`` state, this rank's lane), or
    None (int8 then runs without error feedback for this call).

    On ZeRO plans each synced leaf comes back as this rank's block rows
    (``plan.leaf_shard(i)`` elements, 1-D): the fsdp all-gather never
    happens. The grad norm falls out of the bucket walk.

    ``device_norms=True`` adds a 4th element: the ``[plan.total]``
    vector of every lane's local (pre-sync) grad norm, in mesh order
    (lane = dp index x fsdp + fsdp index) — the SDC tier-1 fence input.
    """
    import torch
    import torch.distributed as dist

    ef = plan.compressed and residual is not None
    flats = []
    for b in plan.buckets:
        flats.append(_bucket_flat(local_grads, b, plan))
        if consume:
            # the flat holds the bucket's grads now (a copy, or a view
            # that keeps their storage): the caller's references go
            for i in range(b.start, b.stop):
                local_grads[i] = None
    local_ss = None
    if device_norms:
        # pre-sync: this rank's own numbers, before any collective
        # mixes lanes
        local_ss = torch.stack([(f * f).sum() for f in flats]).sum()
    means, new_res, sumsq = _sync_buckets(
        flats, residual if ef else None, mesh, plan, _legs
    )
    out: List = []
    for b, m in zip(plan.buckets, means):
        out.extend(_unflatten_bucket(m, b, plan))
    if plan.tp > 1 and mesh.groups.get("tp") is not None:
        gnorm = split_grad_norm(out, tp_axes(plan.leaf_tp_dims), mesh, zero=plan.zero)
    else:
        if sumsq is None:
            sumsq = torch.zeros((), dtype=torch.float32)
        if plan.zero and mesh.groups["fsdp"] is not None:
            # each rank's sum covers its fsdp chunk; the chunks partition
            # the bucket
            _wait([_all_reduce(sumsq, mesh.groups["fsdp"])])
        gnorm = torch.sqrt(sumsq)
    res_out = tuple(new_res) if ef else None
    if not device_norms:
        return out, res_out, gnorm
    group = mesh.groups["data"]
    if group is None:
        lanes = local_ss.reshape(1)
    else:
        got, h = _all_gather(local_ss.reshape(1), group)
        h.wait()
        # group rank order is sorted rank order; the lanes go in mesh
        # order
        order = sorted(mesh.ranks["data"])
        lanes = got[[order.index(r) for r in mesh.ranks["data"]]]
    return out, res_out, gnorm, torch.sqrt(lanes)


# -- error-feedback state ---------------------------------------------------


def zero_residual(plan: BucketPlan, device=None) -> Tuple:
    """Fresh error-feedback state for this rank: one ``(shard_elems,)``
    f32 zeros per bucket (its lane of the JAX package's
    ``(total, shard_elems)``)."""
    import torch

    return tuple(
        torch.zeros(plan.residual_elems(b), dtype=torch.float32, device=device)
        for b in plan.buckets
    )


def ensure_residual(state, plan: Optional[BucketPlan], device=None):
    """``state`` with the error-feedback residual attached when the plan
    compresses (idempotent). The residual is not part of checkpoints:
    dropping it costs one step without error feedback."""
    if plan is None or getattr(plan, "compress", "none") not in _EF_MODES:
        return state
    if getattr(state, "grad_residual", None) is None:
        state.grad_residual = zero_residual(plan, device)
    return state


def strip_residual(state):
    """``state``'s tree without the residual (checkpoint trees never
    carry it)."""
    if getattr(state, "grad_residual", None) is None:
        return state
    from dataclasses import replace as dc_replace

    return dc_replace(state, grad_residual=None)


def residual_element_ids(plan: BucketPlan, bucket: Bucket, jax_layout: bool = False):
    """``[total, shard_elems]`` int64: for each lane (mesh order) and
    residual slot, the element of the bucket it stands for, as an index
    into the JAX package's flat bucket (its leaves back to back), or -1
    for padding. ``jax_layout`` gives the JAX package's own assignment,
    else this plan's. Error feedback is per element and per replica (the
    dp index on flat plans, the slice on two-level ones), so state moves
    between the two layouts element for element."""
    F, dp = plan.fsdp, plan.dp
    per = plan.dp_ici if plan.two_level else 1
    if plan.leaf_block and not jax_layout:
        # this plan's rank-major block rows: rank f's chunk is its rows
        # of each leaf, then its padding
        chunk = bucket.padded // F
        lay = -np.ones((F, chunk), np.int64)
        base = 0
        col = 0
        for i in range(bucket.start, bucket.stop):
            n, sh = _numel(plan.leaf_shapes[i]), plan.leaf_shard(i)
            for f in range(F):
                lo, hi = f * sh, min((f + 1) * sh, n)
                if hi > lo:
                    lay[f, col : col + hi - lo] = base + np.arange(lo, hi)
            base += n
            col += sh
    else:
        padded = (
            bucket.padded
            if not plan.leaf_block
            else -(-bucket.elems // (dp * F)) * (dp * F)
        )
        flat = np.arange(padded)
        flat[bucket.elems:] = -1
        lay = flat.reshape(F, -1)
    chunk = lay.shape[1]
    shard = chunk // per
    ids = np.empty((plan.total, shard), np.int64)
    for d in range(dp):
        j = d % per
        for f in range(F):
            ids[d * F + f] = lay[f, j * shard : (j + 1) * shard]
    return ids


def residual_replica(plan: BucketPlan, lane: int) -> int:
    """The replica a lane's error feedback belongs to: its dp index, or
    its slice on a two-level plan."""
    d = lane // plan.fsdp
    return d // plan.dp_ici if plan.two_level else d


def residual_from_jax(plan: BucketPlan, jax_rows: Sequence, lane: int, device=None) -> Tuple:
    """This lane's residual tuple from the JAX package's per-bucket
    ``(total, shard_elems)`` arrays (its ``TrainState.grad_residual``),
    element for element into this plan's layout."""
    import torch

    out = []
    rep = residual_replica(plan, lane)
    for b, rows in zip(plan.buckets, jax_rows):
        rows = np.asarray(rows, np.float32)
        jids = residual_element_ids(plan, b, jax_layout=True)
        mine = residual_element_ids(plan, b)[lane]
        value = np.zeros(b.elems + 1, np.float32)  # the last slot: padding
        for ln in range(plan.total):
            if residual_replica(plan, ln) == rep:
                m = jids[ln] >= 0
                value[jids[ln][m]] = rows[ln][m]
        row = value[np.where(mine >= 0, mine, b.elems)]
        out.append(torch.from_numpy(row).to(device))
    return tuple(out)


def residual_to_jax(plan: BucketPlan, lane_rows: Sequence[Sequence]) -> List[np.ndarray]:
    """The JAX package's per-bucket ``(total, shard_elems)`` arrays
    from every lane's residual tuple (``lane_rows[lane][bucket]``, mesh
    order)."""
    reps = plan.slices if plan.two_level else plan.dp
    out = []
    for bi, b in enumerate(plan.buckets):
        mine = residual_element_ids(plan, b)
        jids = residual_element_ids(plan, b, jax_layout=True)
        value = np.zeros((reps, b.elems + 1), np.float32)
        for ln in range(plan.total):
            row = np.asarray(lane_rows[ln][bi], np.float32).reshape(-1)
            m = mine[ln] >= 0
            value[residual_replica(plan, ln), mine[ln][m]] = row[m]
        arr = np.stack([
            value[residual_replica(plan, ln), np.where(jids[ln] >= 0, jids[ln], b.elems)]
            for ln in range(plan.total)
        ])
        out.append(arr)
    return out


# -- observability ----------------------------------------------------------

_COMPRESS_MODE_CODES = {"none": 0.0, "int8": 1.0, "int8_topk": 2.0}


def export_compress_metrics(plan, registry=None) -> None:
    """Gauges for the resolved compression mode and the realized DCN
    block density. ``plan`` may be None (the default schedule)."""
    if registry is None:
        from dlrover_tpu_torch.obs.metrics import default_registry

        registry = default_registry()
    mode = (
        getattr(plan, "compress", "none") if plan is not None else "none"
    )
    density = (
        getattr(plan, "dcn_density", 1.0) if plan is not None else 1.0
    )
    registry.gauge(
        "dlrover_grad_compress_mode",
        "resolved gradient compression mode "
        "(0=none, 1=int8, 2=int8_topk; parallel/grad_sync.py)",
    ).set(_COMPRESS_MODE_CODES.get(mode, 0.0))
    registry.gauge(
        "dlrover_grad_sync_dcn_density",
        "realized fraction of DCN shard blocks shipped per sync "
        "(1.0 = dense; parallel/grad_sync.py)",
    ).set(float(density))


# -- cost model / measurement ----------------------------------------------


def comm_bytes_per_device(
    n_param_bytes: float,
    strategy,
    grad_itemsize: int = 4,
    compress: Optional[str] = None,
) -> float:
    """Per-device wire bytes of ONE gradient sync under ``strategy``
    (ring all-reduce factor 2(N-1)/N over the data axes; int8
    compression scales the payload by its wire ratio) — the JAX
    package's pricing, for every mesh kind; ``compress="auto"``
    resolves from the measured link model."""
    m = strategy.mesh
    n = m.dp * m.fsdp
    if n <= 1:
        return 0.0
    payload = float(n_param_bytes)
    if m.pp > 1:
        payload /= m.pp
    mode = resolve_sync_mode(m.axis_sizes())
    explicit = mode is not None and strategy.resolved_comm_overlap()
    if compress is None:
        compress = strategy.resolved_grad_compress()
    if compress == "auto":
        slices = m.dp_slices()
        compress = resolve_auto_compress(
            slices=slices,
            whole_dcn=("dp" in m.dcn_axes and slices <= 1),
            auto_axes=mode.auto_axes if mode else (),
        )
    if explicit and mode.kind in ("tp", "ep"):
        ring = 2.0 * (mode.dp - 1) / mode.dp
        return ring * payload / mode.model_shard  # never compressed
    c = 1.0
    if compress in _EF_MODES:
        c = _INT8_BYTES / float(grad_itemsize)
    if explicit and mode.kind in ("zero", "3d"):
        F = mode.fsdp
        if mode.kind == "3d":
            payload /= mode.model_shard  # tp-local buckets
            c = 1.0  # 3d plans never compress
        total = (F - 1) / F * payload  # ZeRO RS, fp32, no gather
        if mode.dp > 1:
            total += 2.0 * (mode.dp - 1) / mode.dp * (payload / F) * c
        return total
    if explicit and mode.kind == "pp":
        ring = 2.0 * (mode.dp - 1) / mode.dp
        return ring * payload  # pipeline plans never compress
    ring = 2.0 * (n - 1) / n
    return ring * payload * c


def comm_time_per_device_s(
    n_param_bytes: float,
    strategy,
    link_model=None,
    grad_itemsize: int = 4,
    compress: Optional[str] = None,
) -> float:
    """Seconds of gradient-sync wire time per device per sync — the
    sum of the per-interconnect split :func:`comm_time_legs_s` prices.
    Priced per link from the measured ``topology.LinkModel`` instead
    of one flat ICI constant:

    - hybrid dp axis (``dp_slices() > 1``, explicit two-level path):
      the slice-local RS + AG legs ride ICI at the ring factor over
      the per-slice degree, and only the ``1/dp_ici`` shard crosses
      DCN (int8-compressed when the plan compresses);
    - a data axis listed whole in ``dcn_axes``: the flat ring rides
      DCN end to end (the honest worst case the two-level schedule
      exists to beat);
    - otherwise: the flat ring at the measured ICI rate.

    - dp x fsdp (explicit ZeRO path): the fsdp reduce-scatter (no
      gather twin) rides ICI at that axis's measured rate, then the
      dp legs — flat, compressed, or two-level — ride the ``1/fsdp``
      chunk;
    - dp x tp/sp and dp x ep (explicit paths): the bucketed dp
      all-reduce moves grads that are already ``1/model_shard``
      per device (tp; ep's dense-majority payload bills whole);
    - dp x fsdp x tp (explicit 3d path): the ZeRO legs on the
      tp-local (``1/model_shard``) payload;
    - pp x dp: each device's 1/pp stage share rides the dp legs,
      under either schedule (the explicit path's win — the bubble
      overlap — is the dry-runner's exposure credit, not a wire
      discount).

    Per-collective latency (one ring's worth of hops) is added from
    the model so tiny syncs don't price as free."""
    ici_s, dcn_s = comm_time_legs_s(
        n_param_bytes,
        strategy,
        link_model=link_model,
        grad_itemsize=grad_itemsize,
        compress=compress,
    )
    return ici_s + dcn_s


def comm_time_legs_s(
    n_param_bytes: float,
    strategy,
    link_model=None,
    grad_itemsize: int = 4,
    compress: Optional[str] = None,
) -> Tuple[float, float]:
    """``(ici_s, dcn_s)`` — :func:`comm_time_per_device_s` itemized by
    the interconnect each leg rides. The step auditor's budget side
    (``obs.audit.StepBudget``) prices ``ici_sync`` and ``dcn_sync``
    separately from this split, so a drifted or regressed sync
    attributes to the link that actually moved the bytes instead of to
    "comm"."""
    from dlrover_tpu_torch.parallel import topology

    m = strategy.mesh
    n = m.dp * m.fsdp
    if n <= 1:
        return 0.0, 0.0
    model = link_model or topology.get_link_model()
    topology.note_fallback_use(model)
    payload = float(n_param_bytes)
    if m.pp > 1:
        payload /= m.pp  # stage-sharded grads under either schedule
    slices = m.dp_slices()
    if compress is None:
        compress = strategy.resolved_grad_compress()
    if compress == "auto":
        sizes0 = m.axis_sizes()
        mode0 = resolve_sync_mode(sizes0)
        compress = resolve_auto_compress(
            slices=slices,
            whole_dcn=("dp" in m.dcn_axes and slices <= 1),
            auto_axes=mode0.auto_axes if mode0 else (),
            link_model=model,
        )
    if compress == "int8_topk" and slices <= 1:
        compress = "int8"  # plan construction downgrades the same way
    if compress == "int8":
        c = _INT8_BYTES / float(grad_itemsize)
    elif compress == "int8_topk":
        # the DCN shard ships k/nblk int8 blocks plus indices — the
        # compressed-leg byte factor scales by the requested density
        density = max(
            float(
                getattr(
                    strategy, "grad_topk_density", AUTO_TOPK_DENSITY
                )
            ),
            1e-3,
        )
        c = (
            density
            * (_INT8_BYTES + _INDEX_BYTES / float(TOPK_BLOCK))
            / float(grad_itemsize)
        )
    else:
        c = 1.0
    # same gate as the step builder: the explicit schedule only runs
    # when comm_overlap resolved on AND the mesh qualifies
    # (resolve_sync_mode) — a comm_overlap=False hybrid mesh runs
    # GSPMD's monolithic all-reduce and must be billed as the flat
    # ring over DCN (the honest worst case), not the cheap two-level
    # cost it never gets
    mode = resolve_sync_mode(m.axis_sizes())
    explicit = mode is not None and strategy.resolved_comm_overlap()

    def _axis_rate(axis: str):
        """(sec/byte, latency, rides_dcn) of one collective over
        ``axis`` — an axis listed WHOLE in dcn_axes rides DCN (the
        hybrid dp case, dp_slices() > 1, is handled by the two-level
        split below, not here), everything else its measured ICI
        rate."""
        whole_dcn = axis in m.dcn_axes and not (
            axis == "dp" and slices > 1
        )
        if whole_dcn:
            return model.sec_per_dcn_byte(), model.dcn_lat_s, True
        return model.sec_per_axis_byte(axis), model.ici_lat_s, False

    def _dp_legs(chunk: float, dp: int) -> Tuple[float, float]:
        """(ici_s, dcn_s) of the dp-axis sync of a per-device
        ``chunk``."""
        if dp <= 1:
            return 0.0, 0.0
        if slices > 1:
            per = dp // slices
            # ICI legs stay full precision; only the DCN shard
            # compresses
            return (
                2.0 * (per - 1) / per * chunk
                * model.sec_per_axis_byte("dp")
                + 2 * per * model.ici_lat_s,
                2.0 * (slices - 1) / slices * (chunk / per) * c
                * model.sec_per_dcn_byte()
                + 2 * slices * model.dcn_lat_s,
            )
        rate, lat, dcn = _axis_rate("dp")
        t = 2.0 * (dp - 1) / dp * chunk * c * rate + 2 * dp * lat
        return (0.0, t) if dcn else (t, 0.0)

    if explicit and mode.kind in ("zero", "3d"):
        F = mode.fsdp
        if mode.kind == "3d":
            payload /= mode.model_shard  # tp-local buckets
            c = 1.0  # 3d plans never compress
        rate, lat, dcn = _axis_rate("fsdp")
        fsdp_s = (F - 1) / F * payload * rate + F * lat
        dp_ici, dp_dcn = _dp_legs(payload / F, mode.dp)
        if dcn:
            return dp_ici, fsdp_s + dp_dcn
        return fsdp_s + dp_ici, dp_dcn
    if explicit and mode.kind in ("tp", "ep"):
        # tp/ep plans never compress and sync with one flat psum per
        # bucket over the WHOLE dp axis — if dp spans DCN anywhere
        # (whole-axis or hybrid), that ring crosses it and must be
        # billed at DCN rate (there is no two-level split on these
        # paths; plans force slices=1)
        dp = mode.dp
        if "dp" in m.dcn_axes:
            rate, lat, dcn = (
                model.sec_per_dcn_byte(), model.dcn_lat_s, True,
            )
        else:
            rate, lat, dcn = _axis_rate("dp")
        # ep modes carry model_shard=1 (dense-majority payload whole)
        t = (
            2.0 * (dp - 1) / dp * (payload / mode.model_shard) * rate
            + 2 * dp * lat
        )
        return (0.0, t) if dcn else (t, 0.0)
    if explicit and mode.kind == "pp":
        # per-stage dp legs on the stage share (flat or two-level;
        # payload is already /pp above), never compressed
        c = 1.0
        return _dp_legs(payload, mode.dp)
    if explicit and slices > 1:
        return _dp_legs(payload, mode.dp)
    ring = 2.0 * (n - 1) / n
    crosses_dcn = any(a in m.dcn_axes for a in ("dp", "fsdp"))
    sec_per_byte = (
        model.sec_per_dcn_byte()
        if crosses_dcn
        else model.sec_per_ici_byte()
    )
    lat = model.dcn_lat_s if crosses_dcn else model.ici_lat_s
    if explicit:
        payload *= c  # flat explicit path compresses the whole ring
    t = ring * payload * sec_per_byte + 2 * n * lat
    return (0.0, t) if crosses_dcn else (t, 0.0)


def estimate_overlap_pct(strategy) -> Optional[float]:
    """Analytic hidden-fraction of sync wire time (documented model
    constant)."""
    if not strategy.resolved_comm_overlap():
        return None
    return round(100.0 * OVERLAP_HIDDEN_FRACTION, 2)


def _measure_sync(plan: BucketPlan, mesh, iters: int, legs: str, device=None) -> float:
    """Median ms of one standalone sync over zero grads, after one
    warm-up; on the card timed by CUDA events around each sync (every
    rank of the mesh must call this together)."""
    import torch

    if isinstance(plan, EPSyncPlan):  # its expert and dense plans, one after the other
        return sum(_measure_sync(p, mesh, iters, legs, device)
                   for p in (plan.expert_plan, plan.dense_plan))
    if isinstance(plan, PPSyncPlan):  # the stage walk, then the shared one
        return sum(_measure_sync(p, mesh, iters, legs, device)
                   for p in (plan.stage_plan, plan.shared_plan))
    device = torch.device(device) if device is not None else torch.device("cpu")
    grads = [
        torch.zeros(plan.local_shape(i), dtype=getattr(torch, dt), device=device)
        for i, dt in enumerate(plan.leaf_dtypes)
    ]
    res = zero_residual(plan, device) if plan.compressed else None
    sync_grads(grads, mesh, plan, residual=res, _legs=legs)
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sync_grads(grads, mesh, plan, residual=res, _legs=legs)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            sync_grads(grads, mesh, plan, residual=res, _legs=legs)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def measure_sync_ms(plan: BucketPlan, mesh, iters: int = 5, device=None) -> float:
    """Wall-clock of one standalone bucketed sync over zero grads
    (median of ``iters`` after a warm-up) — the ``grad_sync_ms`` stat,
    the sync's roofline (the in-step cost is this minus what overlaps)."""
    from dlrover_tpu_torch.obs.trace import span

    with span("grad_sync_probe", buckets=plan.num_buckets):
        return _measure_sync(plan, mesh, iters, "all", device)


def measure_sync_legs_ms(plan: BucketPlan, mesh, iters: int = 5, device=None) -> Tuple[float, float]:
    """(ici_ms, dcn_ms): the full sync minus a slice-local-legs-only run
    isolates the cross-slice leg. Flat plans are all-ICI."""
    from dlrover_tpu_torch.obs.trace import span

    if not plan.two_level:
        with span("grad_sync_ici", buckets=plan.num_buckets):
            ici = _measure_sync(plan, mesh, iters, "all", device)
        return ici, 0.0
    with span("grad_sync_ici", buckets=plan.num_buckets):
        ici = _measure_sync(plan, mesh, iters, "ici", device)
    with span("grad_sync_dcn", slices=plan.slices):
        total = _measure_sync(plan, mesh, iters, "all", device)
    return ici, max(0.0, total - ici)
