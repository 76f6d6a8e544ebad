#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dlrover_tpu_torch``) on one card.

    python3 chip_smoke.py [--profile] [--phase flash_ckpt|evict|dp|llama|accel|peak_memory|resize|sp|tp|ep|pp|ckpt7b [--no-persist]|sparse_tiers|serve]

(``--profile`` adds a torch.profiler window of a few more steps to the
per-leaf gpt2_small path and to the full-size sparse path; ``--phase
flash_ckpt`` builds the kernels and runs that phase alone, ``--phase
evict`` its uninterrupted run and the eviction drill alone, ``--phase
dp`` the data-parallel phase alone, ``--phase llama`` the Llama-2-7B
phase alone, ``--phase accel`` the strategy-search phase alone,
``--phase resize`` the elastic-resize phase alone, ``--phase sp`` the
sequence-parallel phase alone, ``--phase tp`` the tensor-parallel one
and ``--phase ep`` the expert-parallel one (each at 4 layers and 3
steps), ``--phase pp`` the pipeline-parallel one (3 steps, interleaved
and pp 2 x dp 2 included), ``--phase sparse_tiers`` the three-tier
store at the sparse slice's size (the slice itself beside it),
``--phase serve`` the attention kernels at ragged lengths, the full
run's ``serve`` line, co-located serving beside ``ElasticTrainer`` and
Llama-2-7B serving, without the contract's closing lines; ``--phase peak_memory`` holds the static
peak model to the card, a phase the full run does not take.
``--dp-worker SPEC RANK`` is one rank of the dp phase, ``--llama-worker
OUT [--search-only]`` the llama phase's full model (its search first),
``--accel-worker OUT`` the accel phase's link model and offload and
``--peak-worker OUT CASE`` one case of the peak_memory phase, each
started by its phase; the resize phase's C3 runs are ``--dp-worker``
jobs.)

1. device: the card's name, power limit and count; builds the CUDA
   kernels from the checkout's sources (one nvcc for each ``.cu``, and
   g++ for the embedding store's ``kv_store.cc``, all started together);
2. kernels: every hand-written kernel against its plain PyTorch version
   on the card, at the main paths' shapes (and the streaming attention
   contracts' shapes: Llama-2 width, GQA, a key offset, offsets that are
   no multiple of a tile, no mask; and at lengths that are no multiple
   of a tile, 95 and 1151, ``ragged_attention``), with error, time, plain time, library
   time, the bound from shapes, achieved TFLOP/s and the share of the
   bound; nvcc's register and spill report is printed and held to 0
   spill bytes and no serialized wgmma for the three attention kernels,
   and Triton's register and spill counts are printed beside the 8-bit
   AdamW's checks: attention in bf16, the 8-bit AdamW on a packed
   group (B6) and on gpt2_small's ``wte`` leaf (B7), the embedding row
   gather/scatter on a 4 GiB table (B8/B9, bitwise);
3. paths, each driven with the launch counts set to 0 just before it and
   read just after:
   - ``llama``, run before item 2 (the full model needs the card nearly
     to itself): first ``auto_accelerate`` for Llama-2-7B with the
     card's memory as the budget (the plain candidate refused by the
     static memory gate, the remat one timed on a state drawn on the
     card and picked; its static peak within ``STATIC_PEAK_RTOL`` of the
     measured one), then, with that winner as the trainer's strategy,
     Llama-2-7B at full width and depth (32 x 4096, 32 heads of 128,
     SwiGLU 11008, vocab 32000, untied head), f32 params, bf16 compute,
     remat, ``adamw_8bit_flat``, batch 1 x seq 4096, 6 steps under
     ``ElasticTrainer`` in a process of its own (the allocator's
     expandable segments on): losses, median step, tokens/s, MFU and HFU
     against 989 TFLOP/s, the peak against the card's memory, the
     launches (``fa_fwd`` 64 a step: the recompute runs the forward
     again, ``fa_bwd_dq`` / ``fa_bwd_dkdv`` 32, ``adam8_flat`` one a
     group); the flat 8-bit AdamW's kernel on one of its packed groups;
     remat off and on at Llama width, 4 layers, T=4096 (losses and the
     first grad norm bitwise, the peak lower); gpt2_small 5 steps on the
     list layout and on ``scan_layers`` (losses within
     ``LOSS_MATCH_RTOL``), then with ``agd`` and with ``adamw_4bit``;
   - ``ElasticTrainer(gpt2_small(), build_optimizer("adamw_8bit_flat"),
     ...).train(10)`` at batch 8 x seq 1024 (no strategy: the trainer's
     search picks one; its launches on a line of their own, the step
     auditor's budget, drift and alarms after the run), plus one small model's loss
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
   - ``serve`` (after the slice): gpt2_small (f32 params, bf16
     activations, seed 0) published through a ``ShmHandler`` of its own
     rank and polled by a ``ShmSubscriber``: the frame's records share
     the segment's memory, a commit inside a ``serve.stale_read`` delay
     is caught and the next poll adopts it, a flipped byte's frame is
     skipped; ``ServingEngine.try_swap`` then one greedy batch (16
     prompts of 16-256 tokens, 64 new, 8 slots) bitwise equal to
     ``continuous_generate`` over a direct ``load_records(copy=True)``
     restore, every emitted token's decode logprob within
     ``DECODE_LOGP_TOL`` of ``sequence_logprobs`` (the flash kernels)
     and a cache written one position late beyond it by
     ``DECODE_FAULT_RATIO``; ``ElasticTrainer._settle`` while another
     thread holds a CUDA graph capture open (``capture_vs_settle``:
     both succeed); a ``RewardModel`` 3 steps on seeded pairs,
     then ``RLHFEngine`` 2 iterations (8 prompts of 64, 32 new,
     temperature 0.8, top-k 50; scoring at 95 and 96 rows): every
     metric finite, the first minibatch at ratio 1, the launches
     reckoned, the first update's loss at 2 layers against the CPU;
     with ``--phase serve`` also ``serve_colocated`` (gpt2_small 8 x
     1024 with a memory save every 2 steps, 12 steps alone and with a
     ``ServingEngine`` thread following the commits: losses bitwise,
     swaps with the weight step rising, ``serving_soak`` booked) and
     ``serve_7b`` (Llama-2-7B at full size published, swapped in and
     served greedy and sampled: 32 prompts of 128-1024, 128 new, 16
     slots; the decode-vs-scoring limit and the planted late cache on
     4 greedy prompts), then ``capture_vs_bare_sync`` (the settle
     check's planted fault: a bare card-wide synchronize during a
     capture; no gate);
   - ``sparse_tiers``: ``three_tier_embedding`` (the card, the host
     store, the native spill logs on disk) on that stream under
     ``SparseTrainer.run`` with the checkpoint cadence every 5 steps
     (``flush()``, ``evict_to_host()``, ``evict_cold`` of rows untouched
     since the previous cadence point, ``IncrementalCheckpointManager.
     save`` with a full every second save; a chunked delta begun and
     aborted before the second save): spills, evictions to disk and
     faults back from disk all happen; after each flush the host tiers
     hold each distinct id once; each save's chain restores into a fresh
     store bitwise; a second card run ends bitwise equal and a run with
     the device tier on the CPU within ``SPILL_STATE_TOL``; the launches
     are the count reckoned from the tier's stats. ``--phase
     sparse_tiers`` runs it at the sparse slice's stream on a 256 MiB
     device tier (8 shards, the cadence every 10 steps, a full every
     third save, one chunked delta drained by ``advance`` a step and
     committed at the next cadence point, one aborted), without the CPU
     run, after the slice and the row kernels at the tier's table. The
     spill logs and chains live in temp dirs that the run removes;
   - ``dp``: data parallelism (``parallel/grad_sync.py``), in three
     starts of rank processes: which collectives gloo takes on CUDA
     tensors (all of them, or the phase fails: the sync has no
     host-staged branch); gpt2_small at its full width, the global
     batch of 8 x 1024 split over two ranks on the one card over gloo,
     6 steps at dp=2 with the bucketed sync uncompressed and int8
     (residual carried) and 4 at ZeRO dp=1 x fsdp=2 with the per-leaf
     8-bit AdamW, each against this process fed the same global batches
     in two microbatches of the ranks' rows (losses: ``LOSS_MATCH_RTOL``,
     int8 ``DP_INT8_RTOL``; the first step's synced grad norm:
     ``DP_GNORM_RTOL``, int8 within the ranks' residual norms), a run
     with a planted fault (an all-gather that returns the local chunk)
     that the norm check must catch, with each rank's step ms,
     ``grad_sync_ms``, buckets, raw and wire bytes, kernel launches,
     collectives and own peak and resident bytes; a memory save at step
     4, both ranks SIGKILLed after step 5, and a fresh pair restoring it
     from this process's saver's shm, its losses the uninterrupted
     run's bit for bit; one rank on NCCL (``init_elastic`` and a trainer
     whose ``comm_overlap`` resolves to the default path at dp=1, then
     ``sync_grads`` on the lone-rank NCCL group);
   - ``accel``: the link model probed on the card (pinned H2D / D2H
     rates, the link between cards unprobed at world size 1, a second
     call from the cache touching no card) and gpt2_xl with AdamW at 4
     x 1024, 3 steps resident and with ``Strategy(offload_opt=True)``
     (bitwise, the state in pinned host memory, the peak lower by at
     least ``OFFLOAD_SAVING_SHARE`` of the state, either static peak
     within ``PEAK_CAL_RTOL`` of its measured one), in a process of its
     own; beside it the Llama-2-7B search (in the llama worker), the
     two-rank search (an ``accel`` job in the dp phase's first start:
     the link model on the dp group, ``grad_compress="auto"`` and
     ``grad_bucket_mb=0`` resolved from it, ``agree_strategy`` through a
     master of this process) and the slice's auditor;
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
   - ``resize``: two ``--nnodes=1:2`` launchers (node 0 hosts the
     master, node 1 joins it; a socket dir and a shm node rank each, as
     two hosts have) train gpt2_small at dp=2 over gloo on the one card
     with ``adamw_8bit_flat``; node 1's worker kills its launcher's
     group after step 6 (the memory save of step 4 on disk); node 0's
     agent relaunches its worker at world 1, which derives its strategy
     from the staged one (from the strategy cache, filled by the world-2
     worker's speculative derivation), restores step 4 from its shm and
     trains on, saves to disk at step 8 and holds; node 1 starts again,
     and both restart at world 2 and restore step 8 from storage. Each
     landing's state digests as the staged one did; a ``resize`` line a
     transition splits the time from the death or the join to the first
     loss (detection, rendezvous with its lastcall window, worker start,
     strategy, restore, first step) beside ``last_resize`` and the pids
     holding the card. Then C3: Llama-2 width, 4 layers, 1 x 4096 a
     rank, two gloo ranks, dp=2 then ZeRO dp=1 x fsdp=2 (``resize_c3``:
     the peaks, the static figures within ``PEAK_CAL_RTOL``, the losses
     bitwise, the saving against what PERF.md reckoned). In the full run
     the tp and ep processes run beside the drill, their pair then runs
     C3 at 2 steps (``C3_RUNS``), and the lines say ``timing_grade:
     false``: the resize timings come from ``--phase resize``;
   - ``sp`` (last; alone with ``--phase sp`` at 4 layers x 3 steps, in
     the full run at 2 x 2): each attention kernel under each declared
     mask (``KeyIntervals``: prefix, window, packed documents a batch
     row, empty rows) at gpt2_small's shape, Llama-2 width with GQA and
     a ring hop's offsets, by the per-tile rule (``sp_masks``, and the
     ``masked`` entries of the ``kernels`` line); a callable mask must
     raise on the card. Each kernel at the sp path's own shapes (the
     ring's hops at 16384 rows, 32768 rows for Ulysses and sp = 1)
     against the plain version on three heads. Then ``ElasticTrainer``
     at Llama-2 width, 1 x 32768 tokens, bf16, remat, ``adamw_8bit``:
     one process at sp = 1, then two gloo ranks on the one card at sp =
     2 with the ring and with Ulysses, the same seeded weights and data,
     the sp = 2 losses within ``SP_LOSS_TOL`` of sp = 1's and the first
     step's gradients within ``SP_GRAD_TOL`` (``sp_train``: losses, step
     ms, each rank's peak, the sp transport's ms a step, the kernels'
     launches a step), and a ring with its remote hop dropped that the
     two gates must refuse; last, the ``sp_select`` table's device
     times;
   - ``tp`` (alone with ``--phase tp`` at 4 layers x 3 steps; in the
     full run at 2 x 2, its processes beside the resize phase): the per-leaf 8-bit AdamW's kernel at a
     tp-local leaf's shape (w_gate's box at tp = 2); then
     ``ElasticTrainer`` at Llama-2 width, 1 x 4096 tokens, bf16, remat,
     ``adamw_8bit``: one process at tp = 1 beside two gloo ranks on the
     one card at tp = 2, the same seeded weights and data, tp = 2's
     losses within ``TP_LOSS_TOL`` of tp = 1's, the first step's
     gradients (gathered to whole leaves) within ``TP_GRAD_TOL`` and
     each rank's peak within ``PEAK_CAL_RTOL`` of ``static_peak_bytes``
     (``tp_train``: losses, step ms, peaks, the tp all-reduces' number
     and host ms a step, the launches a step); then one step in the
     same ranks with layer 0's ``copy_to_tp`` stripped of its backward
     all-reduce, which the two gates together must refuse;
   - ``ep`` (in the full run in tp's three processes, after tp, at 2
     layers x 2 steps, the processes beside the resize phase; alone with
     ``--phase ep`` at 4 x 3): the per-leaf
     8-bit AdamW's kernel at an expert box's shape (w_up's 4 of 8
     experts); then ``ElasticTrainer`` on a MoE model at Llama-2 width
     (8 experts, top-2, in every second block, capacity factor 1.25),
     1 x 4096 tokens, bf16, remat, ``adamw_8bit``: one process at ep = 1
     beside two gloo ranks on the one card at dp 1 x ep 2, the same
     seeded weights and data, ep = 2's losses within ``EP_LOSS_TOL`` of
     ep = 1's, the first step's gradients (the experts gathered to
     whole leaves) within ``EP_GRAD_TOL``, step 1's per-expert load and
     drop rate within ``EP_ROUTE_TOL``, 6 all-to-alls a MoE layer a
     step, each rank's peak within ``PEAK_CAL_RTOL`` of
     ``static_peak_bytes`` (``ep_train``: losses, step ms, peaks, the
     all-to-alls' number and host ms a step, the routing, the launches a
     step); then one step in the same ranks with the first MoE layer's
     return exchange stripped of its backward, which the two gates
     together must refuse;
   - ``pp`` (in the full run in tp's three processes, after ep and C3,
     at 2 steps, GPipe and 1F1B; alone with ``--phase pp`` at 3 steps,
     with interleaved 1F1B and pp 2 x dp 2): each attention kernel
     against its plain version at the pp path's microbatch (2 x 1024, 12
     heads of 64) and the per-leaf 8-bit AdamW's kernel at a stage row's
     shape (``stages.mlp.w_up`` at pp = 2); then ``ElasticTrainer`` on
     gpt2_small at full width and depth, 8 x 1024 in 4 microbatches,
     bf16, remat, ``adamw_8bit``: one process at pp = 1 with
     ``grad_accum=4`` beside two gloo ranks on the one card at pp = 2,
     the same seeded weights and data, pp = 2's losses within
     ``PP_LOSS_TOL`` of pp = 1's, the first step's gradients (the stage
     rows gathered into whole layers, the shared leaves) within
     ``PP_GRAD_TOL``, the eval loss through the stages, each rank's peak
     within ``PEAK_CAL_RTOL`` of ``static_peak_bytes``, the launches a
     step the reckoned ones (``pp_train``: losses, step ms, peaks, the
     hops' number and host ms a step, the busy share beside the clock's
     bubble); then one step in the same ranks with the last stage's
     cotangents to stage 0 replaced by zeros, which the two gates
     together must refuse; with ``--phase pp`` four gloo ranks at pp 2
     x dp 2 with ``comm_overlap``, each step's reduce-scatters and
     all-gathers the ``PPSyncPlan``'s buckets and bytes, its losses pp 2
     x dp 1's. Then pp composed with tp and fsdp (``pp3d_train``): each
     attention kernel against its plain version at pp x tp's microbatch
     (2 x 1024, 6 heads of 64) and pp x fsdp's (1 x 1024, 12 heads),
     ``adam8_leaf`` at a stage row's tp box; four gloo ranks at pp 2 x
     tp 2 (GPipe and 1F1B, ``--phase pp`` adds interleaved) and pp 2 x
     fsdp 2 (GPipe, ``--phase pp`` adds 1F1B), each held to the pp = 1
     job's losses (``PP3D_LOSS_TOL``) and first-step gradients, the tp
     boxes and ZeRO shards gathered (``PP3D_GRAD_TOL``), the eval loss,
     each rank's peak within ``PEAK_CAL_RTOL``, the launches and the
     collectives a step (tp all-reduces; ZeRO's all-gathers and
     reduce-scatters) the reckoned ones, and each composition's control
     (stage 1's first ``copy_to_tp`` without its backward sum; stage 1's
     blocks' reduce-scatter unsummed) refused; ``--phase pp`` adds pp 2
     x dp 2 x tp 2 over eight gloo ranks against pp = 1's losses. In
     the full run the four ranks are a group of their own, started with
     the tp / ep / pp pair beside the resize drill.
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
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
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
EMB_REPEATS = 7  # B8/B9 and their library calls, timed interleaved
FIRST_LOSS_TOL = 1e-3  # the sparse slice's first loss against ln 2


T0 = time.perf_counter()


# (phase, t_s) of every line so far: the timing line's ``lines``
EMITTED = []


def emit(phase, **kv):
    """One phase's JSON line; ``t_s``: seconds since the script started."""
    t = time.perf_counter() - T0
    EMITTED.append((phase, round(t, 1)))
    print(json.dumps({"phase": phase, **kv, "t_s": t}), flush=True)


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
    mask leaves empty are floored at 1e-3 of the tensor's rms. A length
    that is no multiple of 64 ends in a shorter tile of its own."""
    ref, got = ref.float(), got.float()
    T, floor = ref.shape[-2], 1e-3 * ref.square().mean().sqrt()
    worst = 0.0
    for lo, n in ((0, T - T % rows), (T - T % rows, T % rows)):
        if not n:
            continue
        r, g = ref[..., lo:lo + n, :], got[..., lo:lo + n, :]
        tiles = max(n // rows, 1)
        shape = r.shape[:-2] + (tiles, n // tiles * r.shape[-1])
        err = (g - r).abs().reshape(shape).amax(-1)
        rms = r.reshape(shape).square().mean(-1).sqrt()
        worst = max(worst, (err / rms.clamp_min(floor)).max().item())
    return worst


def visible_pairs(Tq, Tk, q_off, k_off, causal=True, mask=None, B=1):
    """(q, k) pairs the mask leaves visible for these offsets, summed over
    ``B`` batch rows (a ``KeyIntervals`` ``mask``: counted from its
    bounds)."""
    if mask is not None:
        n = mask.visible(q_off, Tq, k_off, Tk).sum(1)
        return int(n.sum() if mask.batch > 1 else n.sum() * B)
    if not causal:
        return B * Tq * Tk
    rows = q_off + np.arange(Tq) - k_off + 1
    return B * int(np.clip(rows, 0, Tk).sum())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def check_attention(torch, fa, label, B, H, Hkv, T, D, q_off=0, k_off=0,
                    causal=True, probe=False, graph=False, seed=0, mask=None):
    """Kernels against the plain f32 result at one shape, then their
    times (``graph``: from a replayed CUDA graph, for shapes whose kernels
    run for tens of µs). ``probe`` (the main shape) also reads the limit's
    power: the plain output with each query of the last tile missing its
    own key, a diagonal-tile bug, must fail ``ATTN_TOL``. ``mask``: a
    ``KeyIntervals`` over the global rows (the kernels' interval path)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((B, H, T, D), generator=g, device=dev, dtype=bf)
    k = torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=bf)
    v = torch.randn((B, Hkv, T, D), generator=g, device=dev, dtype=bf)
    do = torch.randn((B, H, T, D), generator=g, device=dev, dtype=bf)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, layout="bhtd", mask_fn=mask)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()

    # plain f32 result on the same inputs (autograd through the
    # materialized reference), TF32 off
    qf, kf, vf = (x.float().transpose(1, 2).requires_grad_() for x in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_reference(
        qf, kf, vf, causal=causal, q_offset=q_off, k_offset=k_off,
        return_residuals=True, mask_fn=mask,
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
               mask=None if mask is None else mask.name,
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
    res.update(time_attention(torch, fa, q, k, v, o, lse, do, q_off, k_off, causal, graph, mask))
    if probe:  # every SDPA backend once at the main shape (fwd, bwd ms)
        res["library_by_backend"] = {
            name: time_sdpa(torch, q, k, v, do, (name,))[:2]
            for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")}
    emit("kernel_check", label=label, **res)
    if not ok:
        raise RuntimeError(f"{label}: kernel disagrees with the plain version")
    return res, abs_err


def time_attention(torch, fa, q, k, v, o, lse, do, q_off, k_off, causal, graph, mask=None):
    """Kernel, plain and library times at these inputs, the bounds, and
    from them each kernel's achieved TFLOP/s and share of its bound (the
    operations count the visible pairs)."""
    B, H, T, D = q.shape
    scale = D**-0.5
    pairs = visible_pairs(T, T, q_off, k_off, causal, mask, B) * H
    delta = (do.float() * o.float()).sum(-1)
    # the kernels read lse and delta padded to whole 64-row tiles
    lse_p = fa._pad_rows(lse.float(), fa.NEG_INF).contiguous()
    delta_p = fa._pad_rows(delta, 0.0).contiguous()
    # the gradients' dtypes on the path: bf16, and dk/dv f32 per q head
    # under GQA
    gdt = torch.bfloat16 if k.shape[1] == H else torch.float32
    dk = torch.empty((B, H, T, D), dtype=gdt, device=q.device)
    dv, dq = torch.empty_like(dk), torch.empty_like(q)
    args = (q, k, v, do, lse_p, delta_p, scale, causal, q_off, k_off, mask)
    timer = graph_ms if graph else time_ms
    if mask is not None:  # the tables are cached before a capture
        for dkv in (False, True):
            fa._iv_args(mask, q.device, q_off, T, k_off, T, dkv)
    t = {
        "fa_fwd": timer(torch, lambda: fa._fwd_cuda(q, k, v, scale, causal, q_off, k_off, mask)),
        "fa_bwd_dkdv": timer(torch, lambda: fa._bwd_launch("fa_bwd_dkdv", (dk, dv), *args)),
        "fa_bwd_dq": timer(torch, lambda: fa._bwd_launch("fa_bwd_dq", (dq,), *args)),
    }
    qb, kb, vb = (x.transpose(1, 2) for x in (q, k, v))
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        qb, kb, vb, causal=causal, q_offset=q_off, k_offset=k_off,
        return_residuals=True, mask_fn=mask), iters=5)
    plain_bwd = time_ms(torch, lambda: fa._bwd_plain(
        q, k, v, do, lse, delta, scale, causal, mask, q_off, k_off), iters=5)
    lib_mask = None
    pos = torch.arange(T, device=q.device)
    if mask is not None:
        # SDPA takes a declared mask as a boolean one ([B,1,Tq,Tk] for a
        # per-batch-row mask), which its flash backend does not take
        lib_mask = mask((q_off + pos)[:, None], (k_off + pos)[None, :])
        lib_mask = lib_mask[:, None] if lib_mask.dim() == 3 else lib_mask
    elif causal and q_off != k_off:
        # SDPA has no offsets: the same function is one call with a
        # boolean mask, which its flash backend does not take
        lib_mask = (q_off + pos)[:, None] >= (k_off + pos)[None, :]
    # a masked library call is timed eagerly: its capture fails, and a
    # failed capture leaves the default CUDA generator unusable; so is
    # one at a length no multiple of a tile, whose backward's capture
    # failed too (after twelve such failures the full run's sp ranks
    # found the card full: a failed capture may keep its memory pool)
    eager_lib = lib_mask is not None or T % fa._TILE != 0
    lib_fwd, lib_bwd, lib_backend, lib_timed = time_sdpa(
        torch, q, k, v, do, causal=causal, mask=lib_mask,
        timer=time_ms if eager_lib else timer,
        backends=("EFFICIENT_ATTENTION", "MATH") if lib_mask is not None
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


def check_adam8(torch, qo, cfg, label="B6 adam8_flat gpt2_small group"):
    """B6: the first packed group of ``cfg``'s flat layout (the layout
    from the model's leaves on the meta device), wide ``[R//128, 128]``
    scales."""
    from dlrover_tpu_torch.parallel.grad_sync import model_leaves

    leaves = model_leaves(cfg)
    n_params = sum(p.numel() for p in leaves)
    layout = qo._flat_layout(leaves, 4096, 1 << 27)
    total = sum(g.total for g in layout.groups)
    R = layout.groups[0].total // qo.BLOCK

    def wide(x, signed):
        c, s = qo._quant_block_math_wide(x, signed)
        return c, s.contiguous()

    return adam8_contract(
        torch, qo, label, R, wide, "adam8_flat", 1,
        params=n_params, group_elems=R * qo.BLOCK, groups=len(layout.groups),
        packed_total=total)


def check_adam8_leaf(torch, qo, cfg, shape=None, label="B7 adam8_leaf gpt2_small wte"):
    """B7, the per-leaf route, on gpt2_small's ``wte`` leaf: 50257 x 768
    = 301,542 rows of 128, no multiple of the 8-row tile, with ``[R]``
    scales; or on a leaf of ``shape``."""
    shape = shape or (cfg.vocab_size, cfg.model_dim)
    R = int(np.prod(shape)) // qo.BLOCK

    def per_row(x, signed):
        c, s = qo._sqrt_map_quant(x, signed, 127.0)
        return c.to(torch.int8), s.view(R).contiguous()

    return adam8_contract(
        torch, qo, label, R, per_row, "adam8_leaf", 2,
        rows=R, tile_rows=qo._TILE_ROWS, tail_rows=R % qo._TILE_ROWS, leaf_shape=list(shape))


# ---------------------------------------------------------------------------
# embedding rows (B8 / B9)
# ---------------------------------------------------------------------------
def check_embedding_rows(torch, er, cap=4 << 20, label="B8/B9 emb rows, 4 GiB table"):
    """``emb_gather`` / ``emb_scatter`` on the sparse slice's 4 GiB table
    ([4,194,305, 256] f32: 4,194,304 rows of dim 128 + one adagrad slot,
    and the scratch row; ``--phase sparse_tiers`` also on its 256 MiB
    tier's 262,145 rows) with n = 32,768 sorted unique slots spread over
    it (the bucket of the slice's ~17k unique ids a step), against their
    plain versions, BITWISE; then a padded call whose last 15,000 entries
    all name the scratch row with identical values. Times: CUDA events
    around a replayed CUDA graph (``graph_ms``); library:
    ``torch.index_select`` / ``Tensor.index_copy_``."""
    dev = torch.device("cuda")
    rf, n = 256, 32768
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
    # device times from graph replay, the kernel and its library call
    # interleaved ``EMB_REPEATS`` times (their medians and spread); the
    # eager times (one call after another, host overhead included)
    # beside them
    t = {}
    for name, (k, p, lib) in fns.items():
        ks, ls = [], []
        for _ in range(EMB_REPEATS):
            ks.append(graph_ms(torch, k))
            ls.append(graph_ms(torch, lib))
        t[name] = dict(
            ms=float(statistics.median(ks)), plain_ms=graph_ms(torch, p),
            library_ms=float(statistics.median(ls)), bound_ms=b_ms, bound_by=b_by,
            eager_ms=[time_ms(torch, f) for f in (k, p, lib)],
            ms_repeats=ks, library_ms_repeats=ls,
            ms_spread=[min(ks), max(ks)], library_ms_spread=[min(ls), max(ls)],
            slower_than_library_beyond_spread=min(ks) > max(ls))
    emit("kernel_check", label=label, table=[cap + 1, rf], n=n,
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

    fa.reset_launch_counts()
    qo.reset_launch_counts()
    # no strategy: the trainer searches, as a user's does
    trainer = ElasticTrainer(
        gpt2_small(), build_optimizer(opt, lr=3e-4),
        RandomTokens(seq=T), TrainerConfig(batch_size=B, seq_len=T),
        metrics_hook=hook,
    )
    best = trainer.accel.reports[0]
    emit("slice_search", model="gpt2_small", optimizer=opt, strategy=trainer.strategy.describe(),
         picked_is_the_world_1_candidate=trainer.strategy == picked_strategy(gpt2_small()),
         measured_step_s=best.step_s, est_step_s=best.est_step_s, search_s=trainer.accel.search_s,
         launches={**fa.launch_counts, **qo.launch_counts})
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
    audit = audit_line(trainer, f"gpt2_small {opt}, {steps} steps") if opt == "adamw_8bit_flat" else None
    if opt == "adamw_8bit_flat":
        ledger_vs_profile(torch, trainer, steps, med * 1e3)
    elif profile:
        profile_steps(torch, f"gpt2_small {opt}", lambda: trainer.train(steps + 3),
                      med * 1e3, 3)
    trainer.close()
    del trainer, inner
    torch.cuda.empty_cache()
    return counts, losses[:steps], audit  # not the profiled steps' losses


# ---------------------------------------------------------------------------
# the llama phase: Llama-2-7B under remat, the layer layouts, the optimizers
# ---------------------------------------------------------------------------
LLAMA_SEQ = 4096
LLAMA_STEPS = 6  # the full model's steps under ElasticTrainer
LLAMA_REMAT_LAYERS = 4  # remat on vs off at Llama width
LLAMA_REMAT_STEPS = 3
SMALL_STEPS = 5  # gpt2_small with scan_layers, agd and adamw_4bit


def step_flops(cfg, T, remat):
    """(model FLOPs, hardware FLOPs) of one training step over T tokens
    (batch 1). Model: 2 a weight a token forward and 4 backward, for the
    blocks' and the lm head's matmuls, plus causal attention (QK^T and
    PV, T^2/2 pairs a head) forward and twice that backward. Hardware
    adds what runs again: under remat each block's forward once more,
    and the backward kernels' own recompute (fa_bwd_dkdv: S, dP, dV, dK;
    fa_bwd_dq: S, dP, dQ: 7 products a pair where the model counts 4)."""
    D, F, L, V = cfg.model_dim, cfg.ffn_dim, cfg.num_layers, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    block_w = D * D * 2 + D * kv * 2 + (3 if cfg.swiglu else 2) * D * F
    attn_fwd = 2 * 2 * (T * T / 2) * D  # two products, 2 ops a multiply-add
    fwd = 2 * T * (L * block_w + D * V) + L * attn_fwd
    model = 3 * fwd
    hw = model + (2 * T * L * block_w + L * attn_fwd if remat else 0) + L * attn_fwd * 1.5
    return model, hw


def picked_strategy(cfg):
    """The strategy the trainer's search picks at world size 1 (its one
    candidate, dp=1 in the config's dtype, with the config's remat as an
    optimization): phases that check something other than the search
    pass it, the reference's ``load_strategy`` path."""
    from dlrover_tpu_torch.accel.strategy import Strategy

    return Strategy(dtype=cfg.dtype, opts=("remat",) if cfg.remat else ())


def _trainer_run(torch, fa, qo, cfg, opt, steps, data, batch, inspect=None, keep=False,
                 strategy=None, tcfg=None, prepare=None, on_step=None, device_sync=True):
    """``ElasticTrainer(cfg, build_optimizer(opt), data, strategy=...)
    .train(steps)`` (``strategy``: ``picked_strategy(cfg)`` unless given)
    with every launch count set to 0 just before and read just after;
    returns the losses, grad norms, launch counts, median step ms (the
    first step, with its warm-up, left out), the run's own peak bytes
    (over what was allocated before its trainer) and ``inspect(trainer)``'s
    keys, and closes the trainer (``keep``: returns it open as well).
    ``tcfg``: more ``TrainerConfig`` fields; ``prepare(trainer)`` runs
    once the trainer is built, ``on_step(step, loss, trainer)`` after
    each step's stamp. ``device_sync=False`` stamps a step once the
    trainer's stream is done, not the whole card (whose synchronize
    would also wait for a serving thread's work beside it)."""
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    losses, norms, stamps = [], [], []

    def hook(step, metrics):
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if device_sync:
            torch.cuda.synchronize()
        else:
            torch.cuda.current_stream().synchronize()
        stamps.append(time.perf_counter())
        if on_step is not None:
            on_step(step, losses[-1], trainer)

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = ElasticTrainer(
        cfg, build_optimizer(opt, lr=3e-4), data,
        TrainerConfig(batch_size=batch, seq_len=data.data.shape[1] - 1, **(tcfg or {})),
        metrics_hook=hook, strategy=strategy or picked_strategy(cfg),
    )
    init_s = time.perf_counter() - t0
    if prepare is not None:
        prepare(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train(steps)
    counts = {**fa.launch_counts, **qo.launch_counts}
    step_s = np.diff([t0] + stamps)[1:]
    # copies: the hook goes on recording any later (profiled) steps
    res = dict(losses=losses[:], grad_norms=norms[:], launches=counts,
               median_step_ms=float(statistics.median(step_s)) * 1e3 if len(step_s) else None,
               peak_bytes=torch.cuda.max_memory_allocated() - base, init_s=init_s,
               **(inspect(trainer) if inspect else {}))
    if keep:
        return res, trainer
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _expected(cfg, steps, remat, flat_groups=0, leaf_launches=0):
    L = cfg.num_layers
    return {"fa_fwd": L * steps * (2 if remat else 1), "fa_bwd_dkdv": L * steps,
            "fa_bwd_dq": L * steps, "adam8_flat": flat_groups * steps,
            "adam8_leaf": leaf_launches * steps}


def _flat_groups(trainer):
    return {"groups": len(trainer.state.opt_state.opt.layout.groups)}


def static_cost(cfg, opt, batch, seq, strategy):
    """``dry_runner.compiled_cost`` of ``strategy`` on one card with the
    card's memory as the budget: the static tier the search's memory
    gate reads (nothing is allocated)."""
    import torch

    from dlrover_tpu_torch.accel.dry_runner import compiled_cost
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    budget = torch.cuda.get_device_properties(0).total_memory
    return compiled_cost(strategy, cfg, build_optimizer(opt, lr=3e-4), batch, seq, 1, budget)


def llama_search(torch, fa, qo, cfg):
    """``auto_accelerate`` for Llama-2-7B at full width and depth (batch
    1 x ``LLAMA_SEQ``, ``adamw_8bit_flat``) with the card's memory as the
    budget: the plain candidate's static figure first (no allocation),
    then the search, which must refuse it by the static gate, retry with
    remat and time the remat candidate (a state drawn on the card); the
    timed run's peak beside the remat candidate's static figure."""
    from dlrover_tpu_torch.accel import auto_accelerate
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    tx = build_optimizer("adamw_8bit_flat", lr=3e-4)
    budget = torch.cuda.get_device_properties(0).total_memory
    plain = static_cost(cfg, "adamw_8bit_flat", 1, LLAMA_SEQ, picked_strategy(cfg))
    remat = static_cost(cfg, "adamw_8bit_flat", 1, LLAMA_SEQ,
                        Strategy(dtype=cfg.dtype, opts=("remat",)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    t0 = time.perf_counter()
    acc = auto_accelerate(cfg, tx, 1, LLAMA_SEQ, device="cuda", hbm_budget=budget)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated() - base
    best = acc.reports[0]
    return dict(
        budget_bytes=budget, plain_static_bytes=plain.mem_bytes, plain_fits=plain.fits,
        plain_ok=plain.ok, remat_static_bytes=remat.mem_bytes, remat_fits=remat.fits,
        remat_est_step_s=remat.est_step_s, measured_peak_bytes=measured_peak,
        static_vs_measured=remat.mem_bytes / measured_peak - 1 if measured_peak else None,
        winner=acc.strategy.to_json(), winner_describe=acc.strategy.describe(),
        winner_remat=acc.cfg.remat, measured_step_s=best.step_s, est_step_s=best.est_step_s,
        est_source=best.est_source, host_exposed_s=best.host_exposed_s,
        host_hidden_measured=best.host_hidden_measured, reports=[
            dict(strategy=r.strategy.describe(), ok=r.ok, fits=r.fits, mem_bytes=r.mem_bytes,
                 step_s=r.step_s, est_step_s=r.est_step_s, host_exposed_s=r.host_exposed_s,
                 host_hidden_measured=r.host_hidden_measured, error=r.error)
            for r in acc.reports],
        search_s=acc.search_s, wall_s=wall, launches={**fa.launch_counts, **qo.launch_counts})


# Flash Checkpoint of the Llama-2-7B state (ROADMAP A18)
CKPT7B_AT = 4  # the memory save's step; step 5's optimizer waits on its copies
CKPT7B_ALLOC_BOUND = 64 << 20  # what the stage may allocate on the card
CKPT7B_PERSIST_WAIT_S = 900.0  # --phase ckpt7b: the persist's time limit
# written before the first run on the card (H100 80GB HBM3, 700 W), from
# the gpt2_xl stage's 42-51 GB/s and its 6.2 s pin of 9.4 GB
CKPT7B_PREDICTED = dict(d2h_s=[0.8, 1.0], fence_hold_s=[0.2, 0.4], pin_s=27.0,
                        crc_s=3.4, restore_h2d_s=1.0)


def _state_digest(torch, tensors, chunk=16 << 20):
    """A digest of tensors on the card, computed there: per tensor, per
    ``chunk`` bytes, the sum of its bytes and their sum weighted by
    position (int64, wrapping). Equal states give equal digests; a flipped
    or moved byte changes one."""
    out = []
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.uint8)
        s1 = torch.zeros((), dtype=torch.int64, device=b.device)
        s2 = torch.zeros((), dtype=torch.int64, device=b.device)
        for lo in range(0, b.numel(), chunk):
            x = b[lo:lo + chunk].to(torch.int64)
            s1 += x.sum()
            x *= torch.arange(lo, lo + x.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
            s2 += x.sum()
            del x
        out.append((int(s1), int(s2)))
    return out


class Ckpt7b:
    """A memory save of the Llama-2-7B state beside a training step and
    its restore into the live trainer, through the real paths:
    ``ElasticTrainer(ckpt_dir=...)`` talks to a saver this process hosts
    (as ``tests/test_torch_flash_checkpoint.py``'s ``saver`` fixture
    does), ``_maybe_save`` stages step ``CKPT7B_AT`` (the pinned segment,
    the side stream's copies, step 5's optimizer fenced, the crcs on
    ``CRC_THREADS`` threads), ``wait_for_checkpoint`` commits it, and
    after the run ``_maybe_restore`` (the restart path's restore) puts the
    staged state back into the trainer that trained on past it. With
    ``persist`` the saver persists the step as it persists every staged
    step (``--phase ckpt7b``); without it (the full run) the step counts
    as persisted and no byte goes to disk."""

    def __init__(self, torch, persist):
        import resource
        import tempfile

        from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

        self.torch = torch
        self.persist = persist
        os.environ["DLROVER_TPU_JOB_NAME"] = f"ck7b{os.getpid()}"
        os.environ["DLROVER_TPU_SOCKET_DIR"] = self.sock = tempfile.mkdtemp(prefix="dlr")
        self.dir = tempfile.mkdtemp(prefix="ckpt7b_")
        AsyncCheckpointSaver.reset()
        self.saver = AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
        if not persist:
            self.saver._persisted_step = CKPT7B_AT
        self.df_before = subprocess.run(["df", "-B1", self.dir], capture_output=True,
                                        text=True).stdout.strip()
        self.memlock = resource.getrlimit(resource.RLIMIT_MEMLOCK)
        self.stamps, self.losses, self.begin, self.begins = {}, {}, {}, []
        self.events, self.dispatch_t = [], []
        self.median_dev_ms = None
        self.digest_staged = None
        self.digest_s = None

    def tcfg(self):
        return dict(ckpt_dir=self.dir, save_memory_interval=CKPT7B_AT,
                    save_storage_interval=10 ** 9)

    def prepare(self, trainer):
        """Wrap the checkpointer's ``begin_chunked_save`` (its wall time
        on the loop thread, and every byte allocated on the card while
        it queued the stage: the allocator's cumulative counter) and the
        trainer's step function (two CUDA events around each step: its
        device time, the fence's wait before the optimizer included)."""
        torch, ckptr = self.torch, trainer._ckptr
        real = ckptr.begin_chunked_save
        step_fn = trainer._step_fn

        def timed_step(*a, **k):
            self.dispatch_t.append(time.perf_counter())
            b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            b.record()
            out = step_fn(*a, **k)
            e.record()
            self.events.append((b, e))
            return out

        trainer._step_fn = timed_step

        def begin(*a, **k):
            stats0 = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
            live0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            st = real(*a, **k)
            # the compute stream's next command once begin has returned
            after = torch.cuda.Event(enable_timing=True)
            after.record()
            self.begins.append(dict(
                wall_s=time.perf_counter() - t0, t_end=time.perf_counter(), stager=st,
                after_event=after,
                allocated_during_begin=torch.cuda.memory_stats()["allocated_bytes.all.allocated"] - stats0,
                live_growth=torch.cuda.memory_allocated() - live0,
                host_mem_available=_meminfo("MemAvailable")))
            if not self.begin:  # the measured save's
                self.begin.update(self.begins[0])
            return st

        ckptr.begin_chunked_save = begin

    def on_step(self, step, loss, trainer):
        self.stamps.setdefault(step, []).append(time.perf_counter())
        self.losses.setdefault(step, []).append(loss)
        if step == CKPT7B_AT and self.digest_staged is None:
            # the state the save at this step stages (the hook runs
            # before ``_maybe_save``)
            t0 = time.perf_counter()
            self.digest_staged = _state_digest(self.torch, self._tensors(trainer))
            self.digest_s = time.perf_counter() - t0
        if step == CKPT7B_AT + 1:  # no other save after it
            trainer.tcfg.save_memory_interval = 10 ** 9

    @staticmethod
    def _tensors(trainer):
        from dlrover_tpu_torch.ckpt.sharding import flatten_state

        return [v for _, v in flatten_state(trainer._ckpt_state()["train"])
                if hasattr(v, "data_ptr")]

    def _bytes_on_disk(self):
        n = 0
        for root, _, files in os.walk(self.dir):
            for f in files:
                try:
                    n += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        return n

    def finish(self, trainer, res):
        """Commit, wait for the persist (when asked), restore, digest,
        one step; the ``ckpt_7b`` record."""
        from dlrover_tpu_torch.parallel import transfer_sched

        torch = self.torch
        t0 = time.perf_counter()
        trainer.wait_for_checkpoint()
        commit_wait_s = time.perf_counter() - t0
        save = next((s for s in trainer.save_log if s["step"] == CKPT7B_AT), {})
        persist = dict(asked=self.persist, df_before=self.df_before)
        if self.persist and save.get("ok"):
            deadline = time.time() + CKPT7B_PERSIST_WAIT_S
            while (not any(st == CKPT7B_AT for st, _, _ in self.saver.persist_log)
                   and time.time() < deadline):
                time.sleep(0.5)
            log = [dict(step=st, s=sec, outcome=oc) for st, sec, oc in self.saver.persist_log]
            persist.update(log=log, bytes_on_disk=self._bytes_on_disk(),
                           finished=any(x["step"] == CKPT7B_AT for x in log),
                           ok=any(x["step"] == CKPT7B_AT and x["outcome"] == "ok" for x in log),
                           waited_s=time.perf_counter() - t0 - commit_wait_s)
        elif self.persist:
            persist.update(finished=False, note="no staged step to persist")
        else:
            persist.update(finished=False, bytes_on_disk=self._bytes_on_disk(),
                           note="not in this run: the step counts as persisted "
                                "(python3 chip_smoke.py --phase ckpt7b persists it)")
        # the restart path's restore into the trainer that trained past it,
        # its parts timed: the storage step's verification, the shm read
        # (with its crc check), the rest (the copies onto the card)
        engine = trainer._ckptr.engine
        parts = {"verify_storage_s": 0.0, "shm_read_verify_s": 0.0}

        def timed(name, fn):
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    parts[name] += time.perf_counter() - t
            return call

        engine.latest_verified_step = timed("verify_storage_s", engine.latest_verified_step)
        engine._shm.load_records = timed("shm_read_verify_s", engine._shm.load_records)
        step_before = trainer.global_step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._maybe_restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del engine.latest_verified_step, engine._shm.load_records
        restored = dict(step=trainer.restored_step, source=trainer.restore_source,
                        bytes=engine.last_load_bytes, restore_s=restore_s,
                        trainer_restore_s=trainer.restore_s, from_step=step_before, **parts,
                        copy_onto_card_s=restore_s - sum(parts.values()))
        digest = _state_digest(torch, self._tensors(trainer))
        trainer.train(CKPT7B_AT + 1)
        first_loss_after = self.losses.get(CKPT7B_AT + 1, [None, None])[-1]
        uninterrupted = res["losses"][CKPT7B_AT] if len(res["losses"]) > CKPT7B_AT else None
        steps = sorted(self.stamps)
        t_first = [self.stamps[s][0] for s in steps]
        step_ms = {s: (t_first[i] - t_first[i - 1]) * 1e3 for i, s in enumerate(steps) if i}
        # device ms of steps 1..LLAMA_STEPS (the fenced one is CKPT7B_AT + 1),
        # then the step after the restore
        dev_ms = [b.elapsed_time(e) for b, e in self.events]
        fenced = dev_ms[CKPT7B_AT] if len(dev_ms) > CKPT7B_AT else None
        others = [v for i, v in enumerate(dev_ms[1:LLAMA_STEPS], 1) if i != CKPT7B_AT]
        median = self.median_dev_ms = float(statistics.median(others)) if others else None
        begin_ms = self.begin.get("wall_s", 0.0) * 1e3
        t_end = self.begin.get("t_end")
        after = [t for t in self.dispatch_t if t_end and t > t_end]
        # host ms from the end of the stage's begin to the next dispatch
        gap_ms = (after[0] - t_end) * 1e3 if after else None
        # the card's timeline from the stage's first copy: its last copy,
        # the compute stream past begin, the fenced step's two events
        st = self.begin.get("stager")
        timeline = {}
        if st is not None and st._copy_start is not None and len(self.events) > CKPT7B_AT:
            c0 = st._copy_start
            b5, e5 = self.events[CKPT7B_AT]
            timeline = dict(copies_done_ms=c0.elapsed_time(st.copy_done),
                            compute_past_begin_ms=c0.elapsed_time(self.begin["after_event"]),
                            fenced_step_begin_ms=c0.elapsed_time(b5),
                            fenced_step_end_ms=c0.elapsed_time(e5))
        # the hold on the card's timeline: from the stage's first copy to
        # the fenced step's end, over a step without a save (a hold before
        # the step's own first event counts too)
        fence_hold = (timeline["fenced_step_end_ms"] - median
                      if timeline and median else None)
        arb = transfer_sched.get_arbiter().stats()
        out = dict(
            model="llama2_7b", state_bytes=save.get("bytes"), save_step=CKPT7B_AT,
            save_record=save, pin_s=save.get("pin_s"), d2h_ms=save.get("d2h_ms"),
            d2h_GBps=(save["bytes"] / save["d2h_ms"] / 1e6) if save.get("d2h_ms") else None,
            crc_s=save.get("crc_s"), crc_threads=_crc_threads(), block_ms=save.get("block_ms"),
            begin_ms=begin_ms, commit_wait_s=commit_wait_s, digest_s=self.digest_s,
            host_step_ms=step_ms, device_step_ms=dev_ms, fenced_step_device_ms=fenced,
            other_steps_device_median_ms=median,
            fenced_step_device_delta_ms=(fenced - median) if fenced is not None and median else None,
            fence_hold_ms=fence_hold,
            fenced_step_host_extra_ms=(step_ms[CKPT7B_AT + 1] - begin_ms - (self.digest_s or 0) * 1e3
                                       - float(statistics.median(
                                           [v for k, v in step_ms.items() if k != CKPT7B_AT + 1])))
            if CKPT7B_AT + 1 in step_ms else None,
            begin_to_next_dispatch_ms=gap_ms, card_timeline_ms=timeline,
            fenced_steps=trainer.pipeline_stats.fenced_steps,
            allocated_during_stage=self.begin.get("allocated_during_begin"),
            live_growth_during_stage=self.begin.get("live_growth"),
            alloc_bound=CKPT7B_ALLOC_BOUND, host_mem_available_at_save=self.begin.get("host_mem_available"),
            memlock_rlimit=list(self.memlock), ckpt_stage_link=arb["streams"].get("ckpt_stage"),
            arbiter_enabled=arb["enabled"],
            restored=restored, digest_equal=digest == self.digest_staged,
            tensors_digested=len(digest), first_loss_after_restore=first_loss_after,
            uninterrupted_loss=uninterrupted, persist=persist, predicted=CKPT7B_PREDICTED)
        # each figure against its written prediction (reported, not gated)
        p = CKPT7B_PREDICTED
        d2h_s = (save.get("d2h_ms") or 0) / 1e3 or None
        hold_s = None if fence_hold is None else fence_hold / 1e3
        out["vs_prediction"] = dict(
            d2h_s=[d2h_s, p["d2h_s"], d2h_s is not None and p["d2h_s"][0] <= d2h_s <= p["d2h_s"][1]],
            fence_hold_s=[hold_s, p["fence_hold_s"],
                          hold_s is not None and p["fence_hold_s"][0] <= hold_s <= p["fence_hold_s"][1]],
            pin_s=[save.get("pin_s"), p["pin_s"]], crc_s=[save.get("crc_s"), p["crc_s"]],
            restore_h2d_s=[restored["copy_onto_card_s"], p["restore_h2d_s"]])
        out["checks"] = dict(
            staged_and_committed=bool(save.get("ok")) and save.get("kind") == "memory",
            pinned_not_sync_fallback=save.get("pin_s") is not None,
            restored_from_memory=(restored["step"], restored["source"]) == (CKPT7B_AT, "memory"),
            restored_bitwise_by_digest=out["digest_equal"] and self.digest_staged is not None,
            first_loss_after_restore_equal=first_loss_after is not None
            and first_loss_after == uninterrupted,
            alloc_within_64MB=(self.begin.get("allocated_during_begin") or 0) <= CKPT7B_ALLOC_BOUND
            and bool(self.begin),
            # the next step's work ran beside the copies: the compute
            # stream passed begin before the copies' last tenth
            compute_stream_not_held=bool(timeline)
            and timeline["compute_past_begin_ms"] < 0.9 * timeline["copies_done_ms"],
        )
        out["ok"] = all(out["checks"].values())
        return out

    def overlap_probe(self, trainer):
        """Whether a stage's copies hold the compute stream (PERF.md §6-§7),
        under the trainer's own conditions (its process, allocator and
        pinned segment), after ``finish``: a second save through the train
        loop; the trainer's checkpointer's stage called outside the loop
        right after a scalar's ``item()`` (as the loop reads its metrics)
        and right after a kernel; the stage's bare copies (no stager, so no
        tick) right after an ``item()``, without and with one kernel
        between. Nothing more goes to disk."""
        self.saver._persisted_step = 10 ** 9
        out = dict(second_save=self._probe_save(trainer),
                   stager_after_item=self._probe_stager(trainer, "item"),
                   stager_after_kernel=self._probe_stager(trainer, "kernel"),
                   copies_after_item=self._probe_copies(trainer, kernel=False),
                   copies_after_item_and_kernel=self._probe_copies(trainer, kernel=True))
        out["held"] = {k: v["held"] for k, v in out.items()}
        # every stage leaves the compute stream free; the bare copies
        # show what the stager's tick prevents
        out["ok"] = not any(out["held"][k] for k in
                            ("second_save", "stager_after_item", "stager_after_kernel"))
        return out

    @staticmethod
    def _held(row):
        """The compute stream waited for the copies: it passed the point
        after begin only in the copies' last tenth."""
        row["held"] = row["compute_past_begin_ms"] >= 0.9 * row["copies_done_ms"]
        return row

    def _wait_lock(self, engine):
        deadline = time.time() + 60.0  # the saver gives the shard lock back
        while not engine._lock.acquire(blocking=False):
            if time.time() > deadline:
                raise RuntimeError("the shard lock stayed held after the last save")
            time.sleep(0.01)
        engine._lock.force_release()

    def _probe_save(self, trainer):
        """One save through the train loop at the next step, the step
        after it fenced."""
        torch = self.torch
        self._wait_lock(trainer._ckptr.engine)
        step0, n_ev, n_begin = trainer.global_step, len(self.events), len(self.begins)
        trainer.tcfg.save_memory_interval = step0 + 1
        trainer.train(step0 + 2)
        trainer.tcfg.save_memory_interval = 10 ** 9
        trainer.wait_for_checkpoint()
        torch.cuda.synchronize()
        b = self.begins[n_begin]
        st = b["stager"]
        if st is None or st._copy_start is None:
            raise RuntimeError(f"the probe's save at step {step0 + 1} staged nothing on the card")
        c0 = st._copy_start
        _, e = self.events[n_ev + 1]
        row = dict(step=step0 + 1, d2h_ms=st.timings.get("d2h_ms"), begin_ms=b["wall_s"] * 1e3,
                   copies_done_ms=c0.elapsed_time(st.copy_done),
                   compute_past_begin_ms=c0.elapsed_time(b["after_event"]),
                   fenced_step_end_ms=c0.elapsed_time(e))
        row["fence_hold_ms"] = row["fenced_step_end_ms"] - self.median_dev_ms
        return self._held(row)

    def _probe_stager(self, trainer, before):
        """The trainer's checkpointer's stage of its state called outside
        the train loop, right after ``before`` on the compute stream (a
        scalar's ``item()``, or a kernel), a matmul queued right after it
        returns."""
        torch = self.torch
        self._wait_lock(trainer._ckptr.engine)
        x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        if before == "item":
            (x[0, 0] * 2).float().item()
        st = trainer._ckptr.begin_chunked_save(trainer.global_step + 100, trainer._ckpt_state(),
                                               chunk_bytes=trainer.tcfg.stage_chunk_mb << 20)
        after = torch.cuda.Event(enable_timing=True)
        after.record()
        x @ x
        mm = torch.cuda.Event(enable_timing=True)
        mm.record()
        st.commit()
        torch.cuda.synchronize()
        c0 = st._copy_start
        return self._held(dict(before=before, copies_done_ms=c0.elapsed_time(st.copy_done),
                               compute_past_begin_ms=c0.elapsed_time(after),
                               matmul_end_ms=c0.elapsed_time(mm)))

    def _probe_copies(self, trainer, kernel):
        """The stage's device copies alone (every CUDA tensor of the
        trainer's state into the pinned segment on the engine's side
        stream, as ``_place`` queues them, but no tick) right after a
        scalar's ``item()`` on the compute stream, with ``kernel`` one
        kernel between, a matmul queued on the compute stream right after
        the copies."""
        torch = self.torch
        engine = trainer._ckptr.engine
        dst = engine._shm.host_tensor()
        srcs = [t for t in self._tensors(trainer) if t.is_cuda]
        side = engine._side_stream(srcs[0].device)
        x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        (x[0, 0] * 2).float().item()
        if kernel:
            x[0, 0] += 0
        c0 = torch.cuda.Event(enable_timing=True)
        c0.record()
        side.wait_event(c0)
        with torch.cuda.stream(side):
            off = 0
            for t in srcs:
                v = t.reshape(-1).view(torch.uint8)
                dst[off:off + v.numel()].copy_(v, non_blocking=True)
                off += v.numel()
            done = torch.cuda.Event(enable_timing=True)
            done.record()
        after = torch.cuda.Event(enable_timing=True)
        after.record()
        x @ x
        mm = torch.cuda.Event(enable_timing=True)
        mm.record()
        torch.cuda.synchronize()
        engine._shm._meta.update({"valid": False})  # its bytes are no checkpoint now
        return self._held(dict(kernel_between=kernel, copies_done_ms=c0.elapsed_time(done),
                               compute_past_begin_ms=c0.elapsed_time(after),
                               matmul_end_ms=c0.elapsed_time(mm)))

    def close(self):
        import shutil

        from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

        AsyncCheckpointSaver.reset()
        shutil.rmtree(self.dir, ignore_errors=True)
        shutil.rmtree(self.sock, ignore_errors=True)


def _meminfo(key):
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _crc_threads():
    from dlrover_tpu_torch.ckpt.engine import CRC_THREADS

    return CRC_THREADS


def llama_worker(out_path, profile=False, search_only=False, persist=False, search=True):
    """Llama-2-7B at full width and depth (``chip_smoke.py --llama-worker
    OUT``, started by the llama phase with the allocator's expandable
    segments): first ``llama_search`` (the strategy search with the
    card's memory as the budget), then ``ElasticTrainer`` with the
    search's winner as its explicit strategy: f32 params, bf16 compute,
    remat, ``adamw_8bit_flat``, batch 1 x seq 4096, random weights from
    seed 0 (drawn on the CPU by the port's ``init_params`` and moved),
    ``LLAMA_STEPS`` steps (``search_only``: no trainer). Writes its result
    to OUT."""
    import torch

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo

    cfg = llama2_7b()
    if search:
        search = llama_search(torch, fa, qo, cfg)
        winner = Strategy.from_json(search["winner"])
    else:  # --phase ckpt7b: the search's winner, remat, named
        search, winner = None, Strategy(dtype=cfg.dtype, opts=("remat",))
    gc.collect()
    torch.cuda.empty_cache()
    if search_only:
        with open(out_path, "w") as f:
            json.dump(dict(search=search), f)
        return
    data = RandomTokens(n=64, seq=LLAMA_SEQ, vocab=cfg.vocab_size)
    ck = Ckpt7b(torch, persist)
    try:
        res, trainer = _trainer_run(torch, fa, qo, cfg, "adamw_8bit_flat", LLAMA_STEPS, data, 1,
                                    _flat_groups, keep=True, strategy=winner, tcfg=ck.tcfg(),
                                    prepare=ck.prepare, on_step=ck.on_step)
        res["ckpt_7b"] = ck.finish(trainer, res)
        if not search:  # --phase ckpt7b
            res["stage_overlap"] = ck.overlap_probe(trainer)
    except BaseException:
        ck.close()
        raise
    res["search"] = search
    res["trainer_remat"] = trainer.cfg.remat
    inner = trainer.state.opt_state.opt
    groups = res["groups"]
    n_params = sum(p.numel() for p in trainer.state.params.jax_ordered_parameters())
    state_bytes = sum(t.numel() * t.element_size() for q in inner.mu + inner.nu
                      for t in (q.codes, q.scales)) + 2 * inner.mu_small.numel() * 4
    prof = None
    if profile:
        prof = profile_steps(torch, "llama2_7b remat adamw_8bit_flat",
                             lambda: trainer.train(LLAMA_STEPS + 2), res["median_step_ms"], 2)
    res.update(groups=groups, params=n_params, opt_state_bytes=state_bytes,
               max_memory_reserved=torch.cuda.max_memory_reserved(),
               total_memory=torch.cuda.get_device_properties(0).total_memory,
               alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""),
               expected_launches=_expected(cfg, LLAMA_STEPS, True, groups),
               profile=prof)
    with open(out_path, "w") as f:
        json.dump(res, f)
    trainer.close()
    ck.close()


def _worker_start(torch, flag, label, extra=(), timeout=900):
    """This script with ``flag OUT`` started in a process of its own (a
    fresh allocator with expandable segments); the returned
    ``finish(abort=False)`` waits for it (``abort``: kills it first) and
    returns its JSON result and wall seconds, and prints its JSON lines."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix=f"{label}_")
    out = os.path.join(d, "result.json")
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    cmd = [sys.executable, os.path.abspath(__file__), flag, out, *extra]
    t0 = time.perf_counter()
    # its output to files: nothing reads a pipe while the caller works
    with open(os.path.join(d, "stdout"), "w") as o, open(os.path.join(d, "stderr"), "w") as e:
        p = subprocess.Popen(cmd, env=env, stdout=o, stderr=e, text=True)

    def finish(abort=False):
        if abort:
            p.kill()
        try:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        if abort:
            return None, wall
        with open(os.path.join(d, "stdout")) as o, open(os.path.join(d, "stderr")) as e:
            stdout, stderr = o.read(), e.read()
        if p.returncode != 0:
            raise RuntimeError(f"{label} worker exited {p.returncode}:\n{stdout[-3000:]}\n{stderr[-6000:]}")
        for line in stdout.splitlines():  # the worker's own lines
            if line.startswith("{"):
                print(line, flush=True)
        with open(out) as f:
            return json.load(f), wall

    return finish


def _worker(torch, flag, label, extra=(), timeout=900):
    """``_worker_start``'s process, waited for."""
    return _worker_start(torch, flag, label, extra, timeout)()


def check_llama_search(search, trainer_remat=True):
    """The Llama-2-7B search's line: the plain candidate refused by the
    static gate, the remat winner timed, its static peak within
    ``STATIC_PEAK_RTOL`` of the timed run's measured peak."""
    ok = (search["plain_ok"] and search["plain_fits"] is False and search["remat_fits"] is True
          and search["winner_remat"] and trainer_remat
          and search["measured_step_s"] is not None
          and search["measured_peak_bytes"] < search["budget_bytes"]
          and abs(search["static_vs_measured"]) <= STATIC_PEAK_RTOL)
    emit("accel_llama_search", model="llama2_7b", batch=1, seq=LLAMA_SEQ,
         optimizer="adamw_8bit_flat", **search, static_peak_rtol=STATIC_PEAK_RTOL,
         trainer_remat=trainer_remat, card=card_line(), ok=ok)
    if not ok:
        raise RuntimeError("the Llama-2-7B search did not refuse plain, time remat and pick it")
    return search


def run_llama_full(torch, profile=False):
    """The full model in a process of its own (a fresh allocator, with
    expandable segments: at ~70 GB of 80 fragmentation matters), its
    checks here; the search's line first."""
    from dataclasses import replace

    from dlrover_tpu_torch.models import llama2_7b

    gc.collect()
    torch.cuda.empty_cache()
    parent = dict(allocated=torch.cuda.memory_allocated(), reserved=torch.cuda.memory_reserved())
    r, wall = _worker(torch, "--llama-worker", "llama", ["--profile"] if profile else [])
    check_llama_search(r["search"], r["trainer_remat"])
    cfg = replace(llama2_7b(), remat=True)
    med = r["median_step_ms"] / 1e3
    model_flops, hw_flops = step_flops(cfg, LLAMA_SEQ, remat=True)
    losses = r["losses"]
    ok = (len(losses) == LLAMA_STEPS and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) <= 1.0
          and r["launches"] == r["expected_launches"]
          and r["peak_bytes"] < r["total_memory"])
    res = dict(model="llama2_7b", layers=cfg.num_layers, width=cfg.model_dim, heads=cfg.num_heads,
               head_dim=cfg.head_dim, ffn=cfg.ffn_dim, vocab=cfg.vocab_size, remat=True,
               optimizer="adamw_8bit_flat", batch=1, seq=LLAMA_SEQ, steps=LLAMA_STEPS,
               params=r["params"], flat_groups=r["groups"], losses=losses,
               first_loss_vs_ln_vocab=losses[0] - math.log(cfg.vocab_size),
               grad_norms=r["grad_norms"], median_step_ms=r["median_step_ms"],
               tokens_per_s=LLAMA_SEQ / med,
               model_flops_per_step=model_flops, hw_flops_per_step=hw_flops,
               mfu=model_flops / med / BF16_OPS, hfu=hw_flops / med / BF16_OPS,
               peak_ops=BF16_OPS, launches=r["launches"], expected_launches=r["expected_launches"],
               launches_per_step={k: v / LLAMA_STEPS for k, v in r["launches"].items()},
               max_memory_allocated_bytes=r["peak_bytes"],
               max_memory_reserved_bytes=r["max_memory_reserved"],
               total_memory_bytes=r["total_memory"], opt_state_bytes=r["opt_state_bytes"],
               alloc_conf=r["alloc_conf"], init_s=r["init_s"], worker_wall_s=wall,
               parent_bytes_at_start=parent,
               card=card_line(), ok=ok)
    emit("llama2_7b", **res)
    if not ok:
        raise RuntimeError("llama2_7b's training run failed its checks")
    ckpt_7b_line(r["ckpt_7b"])
    res["search"] = r["search"]
    return res


def ckpt_7b_line(c):
    """The ``ckpt_7b`` line (``Ckpt7b.finish``'s record), the card beside
    it; raises when a check failed."""
    emit("ckpt_7b", **c, card=card_line())
    if not c["ok"]:
        raise RuntimeError(f"the 7 B Flash Checkpoint failed: "
                           f"{[k for k, v in c['checks'].items() if not v]}")
    return c


def run_ckpt7b(torch):
    """``--phase ckpt7b``: the Llama-2-7B worker without its search (the
    winner, remat, named) and with the saver persisting the staged step
    (``CKPT7B_PERSIST_WAIT_S`` at most; not with ``--no-persist``), then
    the restore, which verifies the persisted step on disk before it
    reads shm."""
    persist = "--no-persist" not in sys.argv
    r, wall = _worker(torch, "--llama-worker", "ckpt7b",
                      ["--no-search"] + (["--ckpt7b-persist"] if persist else []),
                      timeout=CKPT7B_PERSIST_WAIT_S + 900)
    c = dict(r["ckpt_7b"], worker_wall_s=wall, losses=r["losses"],
             median_step_ms=r["median_step_ms"])
    ckpt_7b_line(c)
    # whether a stage's copies hold the compute stream, probed in the
    # trainer's process after the measured save (``Ckpt7b.overlap_probe``)
    emit("stage_overlap", **r["stage_overlap"], card=card_line())
    if not r["stage_overlap"]["ok"]:
        raise RuntimeError(f"a stage held the compute stream: {r['stage_overlap']['held']}")
    return c


def run_llama_remat_pair(torch, fa, qo):
    """Remat off, then on, at Llama width (4096, 32 heads of 128, SwiGLU
    11008, vocab 32000) and ``LLAMA_REMAT_LAYERS`` layers, T=4096, the
    same weights and batches: losses and grad norms equal bit for bit,
    and the peak lower with remat."""
    from dataclasses import replace

    from dlrover_tpu_torch.models import llama2_7b

    runs = {}
    for remat in (False, True):
        cfg = replace(llama2_7b(), num_layers=LLAMA_REMAT_LAYERS, remat=remat)
        data = RandomTokens(n=16, seq=LLAMA_SEQ, vocab=cfg.vocab_size, seed=1)
        r = _trainer_run(torch, fa, qo, cfg, "adamw_8bit_flat", LLAMA_REMAT_STEPS, data, 1,
                         _flat_groups)
        r["expected_launches"] = _expected(cfg, LLAMA_REMAT_STEPS, remat, r["groups"])
        runs["on" if remat else "off"] = r
    off, on = runs["off"], runs["on"]
    ok = (on["losses"] == off["losses"] and on["grad_norms"][0] == off["grad_norms"][0]
          and all(math.isfinite(x) for x in on["losses"])
          and on["peak_bytes"] < off["peak_bytes"]
          and all(r["launches"] == r["expected_launches"] for r in runs.values()))
    emit("llama_remat", layers=LLAMA_REMAT_LAYERS, seq=LLAMA_SEQ, steps=LLAMA_REMAT_STEPS,
         losses_off=off["losses"], losses_on=on["losses"],
         grad_norm_off=off["grad_norms"][0], grad_norm_on=on["grad_norms"][0],
         bitwise=on["losses"] == off["losses"] and on["grad_norms"] == off["grad_norms"],
         peak_bytes_off=off["peak_bytes"], peak_bytes_on=on["peak_bytes"],
         peak_drop_bytes=off["peak_bytes"] - on["peak_bytes"],
         peak_drop_per_block=(off["peak_bytes"] - on["peak_bytes"]) / (LLAMA_REMAT_LAYERS - 1),
         median_step_ms_off=off["median_step_ms"], median_step_ms_on=on["median_step_ms"],
         launches_off=off["launches"], launches_on=on["launches"], ok=ok)
    if not ok:
        raise RuntimeError("remat changed the losses, the grad norm or the launches, or saved no memory")
    return runs


def run_small_variants(torch, fa, qo):
    """gpt2_small at batch 8 x seq 1024 for ``SMALL_STEPS`` steps: the
    flat 8-bit AdamW on the list layout and on ``scan_layers`` (stacked
    leaves; the [12, 768] norm scales cross ``min_quantized_size`` and
    become 8-bit, so the losses agree within ``LOSS_MATCH_RTOL``, not
    bitwise), then ``agd`` and ``adamw_4bit`` (no kernel of their own:
    only the attention kernels launch)."""
    from dataclasses import replace

    from dlrover_tpu_torch.models import gpt2_small

    base = gpt2_small()
    data = RandomTokens(seq=1024)
    runs = {}
    for name, cfg, opt in (
        ("list", base, "adamw_8bit_flat"),
        ("scan", replace(base, scan_layers=True), "adamw_8bit_flat"),
        ("agd", base, "agd"),
        ("adamw_4bit", base, "adamw_4bit"),
    ):
        def inspect(trainer, opt=opt):
            inner = trainer.state.opt_state.opt
            if opt == "adamw_4bit":
                return {"groups": 0, "quantized_leaves": sum(
                    isinstance(m, qo.Quantized4) for m in inner.adam_state.mu)}
            return _flat_groups(trainer) if opt == "adamw_8bit_flat" else {"groups": 0}

        r = _trainer_run(torch, fa, qo, cfg, opt, SMALL_STEPS, data, 8, inspect)
        r["expected_launches"] = _expected(cfg, SMALL_STEPS, False, r["groups"])
        runs[name] = r
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["scan"]["losses"], runs["list"]["losses"])]
    ln_v = math.log(base.vocab_size)
    ok = (max(rel) <= LOSS_MATCH_RTOL
          and all(len(r["losses"]) == SMALL_STEPS and all(math.isfinite(x) for x in r["losses"])
                  and abs(r["losses"][0] - ln_v) <= 1.0 and r["launches"] == r["expected_launches"]
                  for r in runs.values()))
    emit("small_variants", model="gpt2_small", batch=8, seq=1024, steps=SMALL_STEPS,
         scan_vs_list_max_rel=max(rel), tol=LOSS_MATCH_RTOL,
         runs={k: {kk: v for kk, v in r.items() if kk != "grad_norms"} for k, r in runs.items()},
         ok=ok)
    if not ok:
        raise RuntimeError("a gpt2_small variant failed its checks")
    return runs


def run_llama(torch, fa, qo, profile=False):
    """The llama phase: the full model (``run_llama_full``), Llama-2-7B's
    flat 8-bit AdamW group checked and timed, remat on vs off
    (``run_llama_remat_pair``) and the gpt2_small variants. It runs
    before any other phase of this process: the full model needs ~70 of
    the card's 80 GB, and this process's allocator keeps every segment
    that a live tensor still uses (~22 GB after the kernel checks, on an
    H100 80GB HBM3)."""
    from dlrover_tpu_torch.models import llama2_7b

    t0 = time.perf_counter()
    full = run_llama_full(torch, profile)  # first: the card nearly to itself
    group, _ = check_adam8(torch, qo, llama2_7b(), "B6 adam8_flat llama2_7b group")
    remat = run_llama_remat_pair(torch, fa, qo)
    small = run_small_variants(torch, fa, qo)
    emit("llama", seconds=time.perf_counter() - t0, ok=True)
    return dict(full=full, remat=remat, small=small, adam8_group=group)


# ---------------------------------------------------------------------------
# the accel phase: the link model, offload, the searches, the auditor
# ---------------------------------------------------------------------------
STATIC_PEAK_RTOL = 0.02  # the remat winner's static peak against its timed run's
PEAK_CAL_RTOL = 0.05  # any other run's static peak against its measured one
OFFLOAD_SAVING_SHARE = 0.8  # the peak falls by at least this share of the state
OFFLOAD_STEPS = 3
OFFLOAD_BATCH = 4  # gpt2_xl at 4 x 1024


def link_model_check(torch):
    """``probe_link_model`` on the card, into a cache dir of its own:
    the measured pinned host-to-card and card-to-host rates, the link
    between cards left unprobed at world size 1 (flagged), the cache
    written; then a second call that reads the cache and touches no
    device (the timing functions are made to fail)."""
    import tempfile

    from dlrover_tpu_torch.parallel import topology

    d = tempfile.mkdtemp(prefix="linkmodel_")
    topology.reset_link_model()
    t0 = time.perf_counter()
    first = topology.probe_link_model(devices="cuda", cache_dir=d)
    first_s = time.perf_counter() - t0
    written = os.path.exists(topology.cache_path(first.fingerprint, d))

    def touched(*a, **k):
        raise RuntimeError("a cached probe touched the card")

    saved = topology._time_host_link, topology._time_allreduce
    topology._time_host_link = topology._time_allreduce = touched
    try:
        t0 = time.perf_counter()
        second = topology.probe_link_model(devices="cuda", cache_dir=d)
        second_s = time.perf_counter() - t0
    finally:
        topology._time_host_link, topology._time_allreduce = saved
    topology.note_fallback_use(first)
    res = dict(model=json.loads(first.to_json()), first_call_s=first_s, second_call_s=second_s,
               cache_written=written, cache_hit=second.to_json() == first.to_json(),
               h2d_gbps=first.host_h2d_gbps, d2h_gbps=first.host_d2h_gbps,
               intra_node_probed=bool(first.ici_axis_gbps), unprobed_flagged=topology._FALLBACK_WARNED)
    res["ok"] = (first.source == "measured-host" and not first.ici_axis_gbps and written
                 and res["cache_hit"] and first.host_h2d_gbps > 0 and first.host_d2h_gbps > 0
                 and res["unprobed_flagged"])
    return res


def offload_run(torch, fa, qo):
    """gpt2_xl with ``adamw`` (f32 moments, ~12.5 GB) at
    ``OFFLOAD_BATCH`` x 1024, ``OFFLOAD_STEPS`` steps resident and
    offloaded (``Strategy(offload_opt=True)``) from the same weights and
    batches: losses and params bitwise, the state in pinned host memory,
    the offloaded peak lower by at least ``OFFLOAD_SAVING_SHARE`` of the
    state's bytes, both step times and the bytes a step streams."""
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import gpt2_xl

    cfg = gpt2_xl()
    data = RandomTokens(n=64, seq=1024, vocab=cfg.vocab_size)

    def inspect(trainer):
        inner = trainer.state.opt_state.opt
        io = getattr(inner, "offload", None)
        tensors = [t for st in inner.state.values() for k, t in st.items() if k != "step"]
        return dict(
            state_bytes=sum(t.numel() * t.element_size() for t in tensors),
            state_pinned=all(t.device.type == "cpu" and t.is_pinned() for t in tensors),
            slot_bytes=io.slot_bytes if io else 0,
            streamed_bytes_per_step=io.bytes_streamed / max(io.updates, 1) if io else 0,
            units=len(io.units) if io else 0)

    static = {off: static_cost(cfg, "adamw", OFFLOAD_BATCH, 1024,
                               Strategy(dtype=cfg.dtype, offload_opt=off)).mem_bytes
              for off in (False, True)}
    res, trainer = _trainer_run(torch, fa, qo, cfg, "adamw", OFFLOAD_STEPS, data, OFFLOAD_BATCH,
                                inspect, keep=True, strategy=Strategy(dtype=cfg.dtype))
    params = [p.detach().clone() for p in trainer.state.params.jax_ordered_parameters()]
    trainer.close()
    del trainer
    off, trainer = _trainer_run(torch, fa, qo, cfg, "adamw", OFFLOAD_STEPS, data, OFFLOAD_BATCH,
                                inspect, keep=True,
                                strategy=Strategy(dtype=cfg.dtype, offload_opt=True))
    bitwise = all(torch.equal(a, b) for a, b in zip(params, trainer.state.params.jax_ordered_parameters()))
    trainer.close()
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    saving = res["peak_bytes"] - off["peak_bytes"]
    out = dict(model="gpt2_xl", optimizer="adamw", batch=OFFLOAD_BATCH, seq=1024,
               steps=OFFLOAD_STEPS, losses=res["losses"], offload_losses=off["losses"],
               bitwise=bitwise and res["losses"] == off["losses"],
               state_bytes=res["state_bytes"], offload_state_pinned=off["state_pinned"],
               resident_state_pinned=res["state_pinned"],
               peak_bytes=res["peak_bytes"], offload_peak_bytes=off["peak_bytes"],
               peak_saving_bytes=saving, peak_saving_share=saving / res["state_bytes"],
               static_peak_bytes=static[False], offload_static_peak_bytes=static[True],
               static_vs_measured=static[False] / res["peak_bytes"] - 1,
               offload_static_vs_measured=static[True] / off["peak_bytes"] - 1,
               static_rtol=PEAK_CAL_RTOL,
               slot_bytes=off["slot_bytes"], units=off["units"],
               streamed_bytes_per_step=off["streamed_bytes_per_step"],
               median_step_ms=res["median_step_ms"], offload_median_step_ms=off["median_step_ms"],
               launches=res["launches"], offload_launches=off["launches"])
    out["ok"] = (out["bitwise"] and out["offload_state_pinned"]
                 and out["peak_saving_share"] >= OFFLOAD_SAVING_SHARE
                 and abs(out["static_vs_measured"]) <= PEAK_CAL_RTOL
                 and abs(out["offload_static_vs_measured"]) <= PEAK_CAL_RTOL
                 and all(math.isfinite(x) for x in out["losses"]))
    return out


def accel_worker(out_path):
    """The accel phase's own process (``chip_smoke.py --accel-worker
    OUT``): the link model, then offload at full width."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo

    torch.backends.cuda.matmul.allow_tf32 = False
    link = link_model_check(torch)
    offload = offload_run(torch, fa, qo)
    with open(out_path, "w") as f:
        json.dump(dict(link=link, offload=offload), f)


def audit_line(trainer, label):
    """The step auditor of a trainer's run: the per-component budget,
    the drift factors and the alarms (a healthy run raises none)."""
    aud = trainer._auditor
    aud.collect()
    res = dict(run=label, steps_audited=aud.steps_audited, budget=aud.budget().as_dict(),
               drift_factors=aud.drift_factors(), alarms=aud.alarms_total(),
               alarm_components=aud.alarm_components())
    res["ok"] = aud.steps_audited > 0 and not any(res["alarms"].values())
    emit("accel_audit", **res, card=card_line())
    if not res["ok"]:
        raise RuntimeError(f"the step auditor raised an alarm on a healthy run: {res['alarms']}")
    return res


def run_accel(torch, llama_search_res=None, dp_accel=None, audit=None, worker=None):
    """The accel phase: the link model and offload (a process of its
    own; ``worker``: that process's ``finish``, started earlier: the
    full run starts it beside the dp phase, whose ranks then share the
    card and the host link with it, so its step and link figures are
    not timing-grade there), beside the Llama-2-7B search
    (``llama_search``, in the llama worker), the two-rank search
    (``_dp_accel``, in the dp phase's first start) and the auditor of
    the gpt2_small slice; run alone (``--phase accel``) it starts each
    of those itself."""
    t0 = time.perf_counter()
    r, wall = (worker or _worker_start(torch, "--accel-worker", "accel"))()
    link, off = r["link"], r["offload"]
    emit("accel_link_model", **link, card=card_line())
    emit("accel_offload", **off, card=card_line())
    if llama_search_res is None:
        s, _ = _worker(torch, "--llama-worker", "llama_search", ["--search-only"])
        llama_search_res = check_llama_search(s["search"])
    if dp_accel is None:
        jobs = [_dp_accel_job()]
        master = with_master(jobs)
        try:
            dp_accel = check_dp_accel(_dp_spawn("accel", 2, jobs))
        finally:
            master.stop()
    if audit is None:
        audit = audit_run(torch)
    ok = link["ok"] and off["ok"]
    emit("accel", seconds=time.perf_counter() - t0, worker_wall_s=wall,
         link_ok=link["ok"], offload_ok=off["ok"], llama_winner=llama_search_res["winner_describe"],
         dp_winner=dp_accel["winner"], audit_alarms=audit["alarms"], card=card_line(), ok=ok)
    if not ok:
        raise RuntimeError("the accel phase failed its checks (link model or offload)")


def audit_run(torch):
    """gpt2_small, 8 steps under the trainer's own search, for the
    auditor's line (``--phase accel`` alone)."""
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    trainer = ElasticTrainer(gpt2_small(), build_optimizer("adamw_8bit_flat", lr=3e-4),
                             RandomTokens(seq=1024), TrainerConfig(batch_size=8, seq_len=1024))
    trainer.train(8)
    res = audit_line(trainer, "gpt2_small adamw_8bit_flat, 8 steps")
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the peak_memory phase: the static peak model against the card
# ---------------------------------------------------------------------------
PEAK_STEPS = 2  # after one warm-up step
# name -> (model, layers or None, remat, optimizer, batch, seq). Llama-2
# width at 4, 8 and 16 layers and gpt2 without remat, 4 layers with it,
# and Llama-2-7B without remat, which the static gate refuses and the
# card cannot hold. (Llama-2-7B with remat is the accel phase's search,
# gpt2_xl with its state offloaded the accel phase's offload run.)
PEAK_CASES = {
    "llama_w4": ("llama2_7b", 4, False, "adamw_8bit_flat", 1, LLAMA_SEQ),
    "llama_w4_remat": ("llama2_7b", 4, True, "adamw_8bit_flat", 1, LLAMA_SEQ),
    "llama_w8": ("llama2_7b", 8, False, "adamw_8bit_flat", 1, LLAMA_SEQ),
    "llama_w16": ("llama2_7b", 16, False, "adamw_8bit_flat", 1, LLAMA_SEQ),
    "llama_32": ("llama2_7b", None, False, "adamw_8bit_flat", 1, LLAMA_SEQ),
    "gpt2_small": ("gpt2_small", None, False, "adamw_8bit_flat", 8, 1024),
    "gpt2_xl_adamw": ("gpt2_xl", None, False, "adamw", 4, 1024),
}


def peak_worker(case, out_path):
    """One case of the peak_memory phase (``chip_smoke.py --peak-worker
    OUT CASE``, a process of its own): the static figure, then the state
    of ``dry_runner._build`` drawn on the card from a device generator,
    one warm-up step and ``PEAK_STEPS`` steps of one seeded batch, and
    the peak ``max_memory_allocated`` over them above what was allocated
    before the state. Running out of memory is a result (``oom``)."""
    from dataclasses import replace

    import torch

    from dlrover_tpu_torch import models
    from dlrover_tpu_torch.accel import dry_runner
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    model, layers, remat, opt, batch, seq = PEAK_CASES[case]
    cfg = getattr(models, model)()
    if layers:
        cfg = replace(cfg, num_layers=layers)
    strategy = Strategy(dtype=cfg.dtype, opts=("remat",) if remat else ())
    cost = static_cost(cfg, opt, batch, seq, strategy)
    res = dict(case=case, model=model, layers=cfg.num_layers, remat=remat, optimizer=opt,
               batch=batch, seq=seq, static_bytes=cost.mem_bytes, fits=cost.fits,
               budget_bytes=torch.cuda.get_device_properties(0).total_memory, oom=False)
    _, _, step_fn, init_fn, make_batch, _ = dry_runner._build(
        strategy, cfg, build_optimizer(opt, lr=3e-4), "cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    try:
        state = init_fn(0, device_generator=True)
        x, y = make_batch(batch, seq)
        for _ in range(PEAK_STEPS + 1):
            state, m = step_fn(state, x, y)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        res.update(oom=True, error=str(e)[:300])
    res.update(peak_bytes=torch.cuda.max_memory_allocated() - base, losses=losses)
    with open(out_path, "w") as f:
        json.dump(res, f)


def run_peak_memory(torch):
    """The peak_memory phase (``--phase peak_memory``; not part of the
    full run): each of ``PEAK_CASES`` in a process of its own (a fresh
    allocator with expandable segments). A case that fits the static
    gate must run, its static peak within ``PEAK_CAL_RTOL`` of the
    measured one; a case the gate refuses must run out of the card's
    memory."""
    t0 = time.perf_counter()
    ok_all = True
    for case in PEAK_CASES:
        r, wall = _worker(torch, "--peak-worker", f"peak_{case}", [case])
        if r["fits"] is True:
            rel = r["static_bytes"] / r["peak_bytes"] - 1
            ok = not r["oom"] and abs(rel) <= PEAK_CAL_RTOL and all(
                math.isfinite(x) for x in r["losses"])
        else:
            rel = None
            ok = r["fits"] is False and r["oom"]
        ok_all = ok_all and ok
        emit("peak_memory_case", **r, static_vs_measured=rel, rtol=PEAK_CAL_RTOL, wall_s=wall,
             card=card_line(), ok=ok)
    emit("peak_memory", cases=len(PEAK_CASES), seconds=time.perf_counter() - t0,
         card=card_line(), ok=ok_all)
    if not ok_all:
        raise RuntimeError("the static peak model disagrees with the card")


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


def sparse_stream(full, extra=0):
    """The sparse paths' ``(ids, labels)`` steps, labels ``ids % 2``: the
    slice's (60 x 65,536 ids, MLPerf DLRM-DCNv2's global batch, zipf 1.1
    over 10,000,000, seed 0; ``extra`` more steps from the same
    generator) or the spilling tier's (bench.py's: 20 x 4,096, zipf 1.6
    over 50,000, seeded per step)."""
    if full:
        rng = np.random.default_rng(0)
        steps = [np.minimum(rng.zipf(1.1, 65536), 10_000_000).astype(np.int64)
                 for _ in range(60 + extra)]
    else:
        steps = [np.minimum(np.random.default_rng(11 * 100_000 + s).zipf(1.6, 4096), 50_000)
                 .astype(np.int64) for s in range(20)]
    return [(ids, (ids % 2).astype(np.float32)) for ids in steps]


def run_sparse_full(torch, er, profile=False):
    """The sparse slice at the size a recommender job gives one card: a
    4 GiB hot tier (4,194,304 rows of dim 128 + one adagrad slot), 60
    steps of 65,536 ids (the MLPerf DLRM-DCNv2 global batch), zipf 1.1
    over 10,000,000 ids from seed 0, labels ``ids % 2``. The tier holds
    every id this stream brings (~477 k), so nothing is evicted."""
    from dlrover_tpu_torch.ops.embedding import (
        DeviceSparseEmbedding, ShardedKvEmbedding,
    )
    from dlrover_tpu_torch.trainer.sparse import SparseTrainer

    steps, n_ids = 60, 65536
    data = sparse_stream(True, extra=5)
    data, extra = data[:steps], data[steps:]
    distinct = int(len(np.unique(np.concatenate([ids for ids, _ in data]))))
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
            iter(extra), overlapped=False),
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

    def run(devices):
        host = ShardedKvEmbedding(4, 128, num_slots=1, seed=0)
        emb = DeviceSparseEmbedding(host, capacity=1024, sparse_optimizer="adagrad",
                                    lr=0.1, devices=devices)
        trainer = SparseTrainer(emb, torch.zeros(128, device="cuda"),
                                logistic_dense_step(torch))
        t0 = time.perf_counter()
        losses = [m["loss"] for m in trainer.run(iter(sparse_stream(False)), overlapped=True)]
        emb.flush()
        wall = time.perf_counter() - t0
        state = host.export_state()
        order = np.argsort(state["keys"])
        spills = emb.stats.spill_rows
        emb.close()
        return state["keys"][order], state["rows"][order], losses, spills, wall

    from dlrover_tpu_torch.parallel import transfer_sched

    # the first card run under an arbiter of its own: its streams' record
    arbiter = transfer_sched.TransferArbiter()
    transfer_sched.set_arbiter(arbiter)
    try:
        k1, r1, l1, s1, w1 = run("cuda")
    finally:
        transfer_sched.set_arbiter(None)
    link = arbiter.stats()
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
    return link


# the three-tier store under the checkpoint cadence: (full run, --phase sparse_tiers)
TIERS_RUNS = {
    # run_sparse_spill's stream and tier, with a disk tier under the host;
    # under ``pressure`` the tier is small enough that LRU victims trained
    # since the last flush drain to the host mid-period
    False: dict(shards=4, size=dict(capacity=1024), pressure=dict(capacity=640), lr=0.1,
                every=5, full_every=2, abort_at=10, chunked_at=None, restore_at=(5, 10, 15, 20)),
    # run_sparse_full's stream on a 256 MiB device tier (262,144 rows of
    # 1 KiB against the stream's ~477 k distinct ids)
    True: dict(shards=8, size=dict(hbm_budget_bytes=256 << 20), lr=0.05, every=10,
               full_every=3, abort_at=20, chunked_at=30, restore_at=(40, 60)),
}
TIERS_ADVANCE_S = 0.01  # the chunked save's budget a step


def _sorted_state(host):
    st = host.export_state()
    order = np.argsort(st["keys"], kind="stable")
    return st["keys"][order], st["rows"][order]


def _tiers_run(torch, data, devices, full, er=None, size=None):
    """One run of ``three_tier_embedding`` (dim 128, one adagrad slot, the
    native cold tier in a temp dir the run removes) under
    ``SparseTrainer.run``, with the checkpoint cadence every ``every``
    steps: ``flush()``, ``evict_to_host()``, ``evict_cold(ts_limit)`` with
    ``ts_limit`` the store's clock second read at the previous cadence
    point, then ``IncrementalCheckpointManager.save(step)``. The store's
    clock is a step clock for the run: one second a step and one at each
    cadence point, so that the rows no step touched since the last point
    are the same rows in every run, whatever the host's speed. At
    ``abort_at`` a chunked delta is begun and aborted before the save; at
    ``chunked_at`` the save is a chunked one instead, drained by
    ``advance(TIERS_ADVANCE_S)`` as the row pipeline takes each step's
    ids and committed at the next cadence point. At each ``restore_at``
    the chain restores into a fresh store, held to the live state
    bitwise. ``size`` replaces the device tier's size. Returns the final
    state and the run's figures."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.ops.embedding import IncrementalCheckpointManager, three_tier_embedding
    from dlrover_tpu_torch.ops.embedding import store as kv_store
    from dlrover_tpu_torch.trainer.sparse import SparseTrainer

    cfg = TIERS_RUNS[full]
    d = tempfile.mkdtemp(prefix="dlr_tiers_")

    def make(tag):
        return three_tier_embedding(cfg["shards"], 128, os.path.join(d, tag), num_slots=1, seed=0,
                                    sparse_optimizer="adagrad", lr=cfg["lr"], devices=devices,
                                    **(size or cfg["size"]))

    emb = make("cold")
    host, ckpt_dir = emb.host, os.path.join(d, "ckpt")
    mgr = IncrementalCheckpointManager(host, ckpt_dir, full_every=cfg["full_every"])
    stamps = []
    trainer = SparseTrainer(emb, torch.zeros(128, device="cuda"),
                            logistic_dense_step(torch, stamps=stamps))
    r = dict(saves=[], evicted=[], restores=[], advance_ms=[], host_len=[], flush_launches=0,
             step_ms=[], step_ms_draining=[], cadence_s=[])
    seen = np.empty(0, np.int64)
    stager = None
    failures = []
    real_now, clock = kv_store._now, [kv_store._now()]
    kv_store._now = lambda: clock[0]
    try:
        if er is not None:
            er.reset_launch_counts()
        if devices != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ts_limit = kv_store._now()
        t_run = time.perf_counter()
        for c0 in range(0, len(data), cfg["every"]):
            chunk = data[c0:c0 + cfg["every"]]

            def feed(chunk=chunk, st=stager):
                for item in chunk:
                    clock[0] += 1  # read by this step's prepare (this thread)
                    if st is not None and not st.done:
                        a = time.perf_counter()
                        st.advance(budget_s=TIERS_ADVANCE_S)
                        r["advance_ms"].append((time.perf_counter() - a) * 1e3)
                    yield item

            n0 = len(stamps)
            trainer.run(feed(), overlapped=True)
            (r["step_ms_draining"] if stager is not None else r["step_ms"]).extend(
                (np.diff(stamps[n0:]) * 1e3).tolist())
            for ids, _ in chunk:
                seen = np.union1d(seen, ids)
            step = c0 + len(chunk)
            # the cadence
            clock[0] += 1
            a = time.perf_counter()
            r["flush_launches"] += emb.flush() > 0
            b = time.perf_counter()
            r["host_len"].append([len(host), len(seen)])
            if len(host) != len(seen):
                failures.append(f"step {step}: the host tiers hold {len(host)} rows, "
                                f"{len(seen)} distinct ids seen")
            c = time.perf_counter()
            emb.evict_to_host()
            e = time.perf_counter()
            r["evicted"].append(host.evict_cold(ts_limit))
            ts_limit = kv_store._now()
            r["cadence_s"].append(dict(step=step, flush=b - a, evict_to_host=e - c,
                                       evict_cold=time.perf_counter() - e))
            if stager is not None:  # begun at the previous cadence point
                a = time.perf_counter()
                stager.commit()
                r["saves"].append(dict(step=stager.step, chunked=True, commit_s=time.perf_counter() - a,
                                       **_last_save(mgr)))
                stager = None
            if step == cfg["abort_at"]:
                a = time.perf_counter()
                st = mgr.begin_chunked_save(step=step)
                st.advance(budget_s=0.0)
                st.abort()
                r["aborted_s"] = time.perf_counter() - a
            a = time.perf_counter()
            if step == cfg["chunked_at"]:
                stager = mgr.begin_chunked_save(step=step)
                r["chunked_begin_s"] = time.perf_counter() - a
            else:
                mgr.save(step=step)
                r["saves"].append(dict(step=step, s=time.perf_counter() - a, **_last_save(mgr)))
            if step in cfg["restore_at"]:
                fresh = make(f"fresh{step}")
                a = time.perf_counter()
                got = IncrementalCheckpointManager(fresh.host, ckpt_dir).restore()
                secs = time.perf_counter() - a
                a = time.perf_counter()
                lk, lr = _sorted_state(host)  # a full export of both host tiers, sorted
                export_s = time.perf_counter() - a
                fk, fr = _sorted_state(fresh.host)
                ok = (got == step and len(np.unique(lk)) == len(lk) and np.array_equal(lk, fk)
                      and np.array_equal(lr, fr))
                r["restores"].append(dict(step=step, restored_step=got, rows=len(fk), s=secs,
                                          live_export_sorted_s=export_s, bitwise=ok))
                if not ok:
                    failures.append(f"step {step}: the restored chain differs from the live state")
                fresh.close()
                fresh.host.close()
                del fresh, lk, lr, fk, fr
        if devices != "cpu":
            torch.cuda.synchronize()
            r["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        r["wall_s"] = time.perf_counter() - t_run
        if er is not None:
            r["launches"] = dict(er.launch_counts)
        st = emb.stats
        r.update(steps=len(data), distinct_ids=len(seen), spill_rows=st.spill_rows,
                 faults=st.faults, fault_batches=st.fault_batches,
                 scatter_drains=st.scatter_drains, faulted_from_disk=host.faulted_rows,
                 evicted_to_disk=int(sum(r["evicted"])), resident=len(emb.hot),
                 capacity=emb.hot.capacity, hit_pct=st.hit_pct)
        r["expected_launches"] = {"emb_gather": 2 * len(data) + st.scatter_drains + r["flush_launches"],
                                  "emb_scatter": len(data) + st.fault_batches}
        keys, rows = _sorted_state(host)
    finally:
        kv_store._now = real_now
        emb.close()
        host.close()
        shutil.rmtree(d, ignore_errors=True)
    if r["spill_rows"] <= 0 or r["evicted_to_disk"] <= 0 or r["faulted_from_disk"] <= 0:
        failures.append("the run did not spill, evict to disk and fault back from disk")
    r["failures"] = failures
    return keys, rows, r


def _last_save(mgr):
    e = mgr._read_manifest()[-1]
    return dict(kind=e["kind"], rows=e["rows"], bytes=e["nbytes"])


def run_sparse_tiers(torch, er, full=False):
    """The three-tier store (card, host, disk) under the checkpoint
    cadence (``_tiers_run``): a first card run with the launches counted,
    a second card run that must end bitwise equal, and in the small run
    a run with the device tier on the CPU (the logistic head on the card,
    as in ``run_sparse_spill``) within ``SPILL_STATE_TOL`` and a card run
    on a 640-row tier, whose LRU drains must run and whose state must end
    bitwise equal (where a row lives never changes its values). Every
    check of every run must hold, the runs of one tier size must move the
    same rows between the tiers, and the kernels' launches must be the
    count reckoned from the tier's stats."""
    data = sparse_stream(full)
    k1, r1, a = _tiers_run(torch, data, None, full, er=er)
    k2, r2, b = _tiers_run(torch, data, None, full)
    bitwise = bool(np.array_equal(k1, k2) and np.array_equal(r1, r2))
    del k2, r2
    res = dict(launches=a["launches"], expected_launches=a["expected_launches"],
               card_repeat_bitwise=bitwise)
    fails = a["failures"] + b["failures"]
    if not bitwise:
        fails.append("a second card run differs")
    if a["launches"] != a["expected_launches"]:
        fails.append("the kernels' launches are not the count reckoned from the tier's stats")
    if not full:
        k0, r0, c = _tiers_run(torch, data, "cpu", full)
        same = bool(np.array_equal(k0, k1))
        err = float(np.abs(r1 - r0).max() / np.abs(r0).max()) if same else math.inf
        res.update(cpu_same_keys=same, cpu_rel_err=err, tol=SPILL_STATE_TOL,
                   cpu_rows_not_bitwise=int((r1 != r0).any(axis=1).sum()) if same else -1)
        fails += c["failures"]
        if not (same and err <= SPILL_STATE_TOL):
            fails.append("the tier on the CPU disagrees")
        kp, rp, p = _tiers_run(torch, data, None, full, size=TIERS_RUNS[full]["pressure"])
        res.update(pressure_bitwise=bool(np.array_equal(kp, k1) and np.array_equal(rp, r1)),
                   pressure_drains=p["scatter_drains"])
        fails += p["failures"]
        if not res["pressure_bitwise"] or p["scatter_drains"] <= 0:
            fails.append("the 640-row tier did not drain, or its state differs")
    runs = [a, b] + ([c] if not full else [])
    moves = [(x["spill_rows"], x["evicted"], x["faulted_from_disk"]) for x in runs]
    runs += [p] if not full else []
    if any(m != moves[0] for m in moves):
        fails.append(f"the runs spilled, evicted to disk or faulted back other rows: {moves}")
    for x in runs:
        x.pop("launches", None)
        x.pop("expected_launches", None)
    if full:
        fulls = [s["bytes"] for s in a["saves"] if s["kind"] == "full"]
        deltas = [s["bytes"] for s in a["saves"] if s["kind"] == "delta"]
        med = float(statistics.median(a["step_ms"]))
        res.update(median_step_ms=med, ids_per_s=65536 / (med / 1e3),
                   median_step_ms_draining=(float(statistics.median(a["step_ms_draining"]))
                                            if a["step_ms_draining"] else None),
                   delta_bytes_over_full=(statistics.mean(deltas) / statistics.mean(fulls)
                                          if deltas and fulls else None),
                   advance_ms_median=(float(statistics.median(a["advance_ms"]))
                                      if a["advance_ms"] else None))
    emit("sparse_tiers", size="full" if full else "small", **res, runs=runs,
         failures=fails, ok=not fails)
    if fails:
        raise RuntimeError(f"the three-tier store failed its checks: {fails}")
    return res["launches"]


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
            arbiter=last("arbiter", {}),
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
        "--link-holder", background=True, env={"DLROVER_TPU_EVICTION_DEADLINE_S": str(EVICT_GRACE_S)})
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
    arb = ew.get("arbiter", {})
    line = dict(
        card=card_line(), grace_s=EVICT_GRACE_S, signal_after_step=EVICT_AFTER_STEP,
        drain_ms=ev.get("drain_ms"), emergency_stage_ms=ev.get("stage_ms"),
        # the host link: the emergency save's class and its grant's wait
        # while the drill's background stream held the card-to-host rail
        emergency_priority=ev.get("priority"), emergency_grant_wait_ms=ev.get("grant_wait_ms"),
        background_holder_yields=arb.get("holder_yields"),
        arbiter_preemptions=arb.get("preemptions"), arbiter_enabled=arb.get("enabled"),
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
        "e_emergency_class": ev.get("priority") == "EMERGENCY" and arb.get("scheduling") is True,
        "e_background_holder_preempted": (arb.get("holder_yields") or 0) >= 1
        and (arb.get("preemptions") or 0) >= 1,
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


def link_calibration(torch):
    """The arbiter's hidden-fraction calibration on the card. The
    trainer's: ``ensure_calibrated`` at its link probe, with the JAX
    package's default wire (``_sleep_wire``: sleeps stand in for compute
    and for each chunk), read back from its cache file under the device
    fingerprint. Beside it, one taken through the API's own ``wire=``
    with real pinned copies of a stage chunk (64 MiB) for each host rail,
    compute still a sleep: whether the emulator's figure holds for PCIe.
    The trainer keeps the first."""
    from dlrover_tpu_torch.parallel import transfer_sched as ts

    if os.getenv(ts.ENV_CALIBRATE, "1").strip().lower() in ("0", "false", "no", "off"):
        emit("link_calibration", status="disabled", env=ts.ENV_CALIBRATE, ok=False)
        raise RuntimeError(f"arbiter calibration disabled by {ts.ENV_CALIBRATE}")
    fp = ts._current_fingerprint()
    cal = ts.get_calibration() or ts.ensure_calibrated()
    on_disk = ts.load_calibration(fp)
    chunk, compute_s = 64 << 20, 0.02
    dev = torch.empty(chunk, dtype=torch.uint8, device="cuda")
    host = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
    side = torch.cuda.Stream()
    copy_s = {"host_d2h": [], "host_h2d": []}

    def wire_for(rail):
        def wire(seconds):
            if seconds >= compute_s:  # the compute step
                time.sleep(seconds)
                return
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                if rail == "host_h2d":
                    dev.copy_(host, non_blocking=True)
                else:
                    host.copy_(dev, non_blocking=True)
            side.synchronize()
            copy_s[rail].append(time.perf_counter() - t0)
        return wire

    pcie = {}
    for rail in ("host_d2h", "host_h2d"):
        c = ts.calibrate_hidden_fraction(rails=(rail,), compute_s=compute_s, force=True,
                                         save=False, wire=wire_for(rail))
        pcie.update(c.hidden_fraction)
    ts.set_calibration(cal)
    del dev, host
    res = dict(
        fingerprint=fp, cache_file=ts.calibration_path(fp),
        cache_fingerprint=on_disk.fingerprint if on_disk else None,
        trainer_wire="_sleep_wire", hidden_fraction=cal.hidden_fraction if cal else None,
        measured_at=cal.measured_at if cal else None,
        pcie_wire_hidden_fraction=pcie, pcie_chunk_bytes=chunk, compute="sleep",
        pcie_copy_ms_median={k: float(statistics.median(v)) * 1e3 for k, v in copy_s.items() if v},
        pcie_copy_GBps={k: chunk / statistics.median(v) / 1e9 for k, v in copy_s.items() if v},
        process_keeps="trainer's", card=card_line())
    res["ok"] = (cal is not None and on_disk is not None and on_disk.fingerprint == fp
                 and set(cal.hidden_fraction) == {"host_d2h", "host_h2d"}
                 and set(pcie) == {"host_d2h", "host_h2d"})
    emit("link_calibration", **res)
    if not res["ok"]:
        raise RuntimeError("the arbiter's calibration is missing or was not cached")
    return res


def link_arbiter_line(flash=None, spill=None):
    """The ``link_arbiter`` line: per stream of the flash_ckpt phase's
    workers and of the spilling tier, grants, bytes, wait ms (median,
    max) and yields; preemptions and striped chunks. One host admits one
    card-to-host and one host-to-card rail, so no stripe runs (two rails
    of a direction are needed). An arbiter disabled by its switch is
    reported as disabled and fails the line."""
    from dlrover_tpu_torch.parallel import transfer_sched as ts

    runs = {**{f"flash_ckpt/{k}": v for k, v in (flash or {}).items()},
            **({"sparse_spill": spill} if spill else {})}
    stripes = sum(r.get("stripe_chunks", 0) for st in runs.values()
                  for r in st.get("rails", {}).values())
    enabled = bool(runs) and all(st.get("enabled") and st.get("scheduling") for st in runs.values())
    streams = {k: st.get("streams", {}) for k, st in runs.items()}
    checks = {"enabled": enabled}
    if flash:
        checks["ckpt_stage_granted"] = streams.get("flash_ckpt/U1", {}).get(
            "ckpt_stage", {}).get("grants", 0) > 0
        checks["emergency_preempted_background"] = (
            runs.get("flash_ckpt/E", {}).get("preemptions", 0) >= 1)
    if spill:
        sp = streams["sparse_spill"]
        checks["emb_fault_granted"] = sp.get("emb_fault:t0", {}).get("grants", 0) > 0
        checks["emb_spill_granted"] = sp.get("emb_spill:t0", {}).get("grants", 0) > 0
    res = dict(status="scheduling" if enabled else "disabled",
               local_rails={d: ts.local_rails(d) for d in ("d2h", "h2d")},
               stripes_ran=stripes > 0, striped_chunks=stripes,
               why_no_stripe=None if stripes else "one card-to-host rail on this host",
               streams=streams,
               preemptions={k: st.get("preemptions") for k, st in runs.items()},
               forced_grants={k: st.get("forced_grants") for k, st in runs.items()},
               card=card_line(), checks=checks, ok=all(checks.values()))
    emit("link_arbiter", **res)
    if not res["ok"]:
        raise RuntimeError(f"link_arbiter: {[k for k, v in checks.items() if not v]}")
    return res


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
    # the host-link arbiter's record in U1 (beside the smoke's saver) and
    # in E (the drain's EMERGENCY save against a background stream)
    e_procs = launched["E"]["procs"]
    res["arbiter"] = {"U1": runs["U1"].get("arbiter", {}),
                      "E": e_procs[0].get("arbiter", {}) if e_procs else {}}
    if not res["ok"]:
        for w in runs.values():
            print(w["label"], w["stderr"], file=sys.stderr)
        for r in launched.values():
            print(r["label"], r["log"], file=sys.stderr)
        raise RuntimeError(f"{phase} failed: {[k for k, v in checks.items() if not v]}")
    return res


# ---------------------------------------------------------------------------
# the dp phase: data parallelism on the card
# ---------------------------------------------------------------------------
DP_B, DP_T = 8, 1024  # the global batch, split over the ranks
DP_STEPS = 6  # dp=2 runs and their one-process reference
DP_ZERO_STEPS = 4  # the ZeRO run and its reference
DP_CKPT_AT = 4  # the drill's memory save; both ranks die after the next step
DP_INT8_RTOL = 2e-3  # int8 with error feedback against the f32 one-process run
# the first step's synced grad norm against one process on the same
# batch (the same params: nothing amplifies the sync's error there)
DP_GNORM_RTOL = 1e-5
DP_COLLECTIVES = ("all_reduce", "all_reduce_max", "all_reduce_int32", "reduce_scatter_tensor",
                  "reduce_scatter_tensor_int32", "all_gather_into_tensor", "broadcast",
                  "all_to_all_int8", "all_gather_uint8")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_worker(spec_path, rank):
    """One rank of the dp phase (``chip_smoke.py --dp-worker SPEC RANK``),
    on cuda:0: ranks of a world above 1 join over gloo (two ranks share
    the one card; NCCL cannot put two ranks on one device). Runs the
    spec's jobs in order and writes their results to ``SPEC.RANK``."""
    import torch
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    os.environ.update(DLROVER_TPU_PROCESS_ID=str(rank), DLROVER_TPU_NUM_PROCESSES=str(world),
                      DLROVER_TPU_LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    if spec.get("backend"):
        dist.init_process_group(spec["backend"], init_method=f"tcp://127.0.0.1:{spec['port']}",
                                rank=rank, world_size=world)
    out = {}
    for job in spec["jobs"]:
        fn = {"probe": _dp_probe, "train": _dp_train, "nccl": _dp_nccl,
              "accel": _dp_accel, "c3": _dp_c3, "sp": _dp_sp, "tp": _dp_tp,
              "pp": _dp_pp}[job["kind"]]
        if job.get("die_after"):  # the hook writes what ran before it dies
            job["prior"] = out
        out[job["name"]] = fn(torch, job, rank, world, spec_path)
        with open(f"{spec_path}.{rank}", "w") as f:
            json.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _dp_probe(torch, job, rank, world, spec_path):
    """Which collectives gloo takes on CUDA tensors (the package's sync
    has no host-staged branch: each must be taken)."""
    import torch.distributed as dist

    res = {}
    cases = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(8, device="cuda")),
        "all_reduce_max": lambda: dist.all_reduce(torch.ones(8, device="cuda"), op=dist.ReduceOp.MAX),
        "all_reduce_int32": lambda: dist.all_reduce(torch.ones(8, device="cuda", dtype=torch.int32)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device="cuda"), torch.ones(8, device="cuda")),
        "reduce_scatter_tensor_int32": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device="cuda", dtype=torch.int32),
            torch.ones(8, device="cuda", dtype=torch.int32)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device="cuda"), torch.ones(8, device="cuda")),
        "broadcast": lambda: dist.broadcast(torch.ones(8, device="cuda"), src=0),
        # the int8 sync's wire: the codes' all-to-all, their int16 sums'
        # all-gather as bytes
        "all_to_all_int8": lambda: dist.all_to_all_single(
            torch.empty(8 * world, device="cuda", dtype=torch.int8),
            torch.ones(8 * world, device="cuda", dtype=torch.int8)),
        "all_gather_uint8": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device="cuda", dtype=torch.uint8),
            torch.ones(8, device="cuda", dtype=torch.uint8)),
    }
    for name in DP_COLLECTIVES:
        try:
            cases[name]()
            torch.cuda.synchronize()
            res[name] = "ok"
        except RuntimeError as e:  # recorded and failed on by the phase
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return dict(backend=dist.get_backend(), ops=res)


def _local_all_gather(torch, real):
    """A planted fault: an all-gather that hands back the local chunk in
    its own slot and zeros elsewhere (a collective that silently did not
    run), issued through the real one so the ranks stay in step."""

    def gather(inp, group):
        import torch.distributed as dist

        out, h = real(inp, group)
        h.wait()
        r, n = dist.get_rank(group), inp.numel()
        out.zero_()[r * n:(r + 1) * n].copy_(inp)
        return out, h

    return gather


def _dp_train(torch, job, rank, world, spec_path):
    """``ElasticTrainer`` on gpt2_small at the job's strategy: losses and
    synced grad norms, step times, the sync's plan and probe, the
    kernels' launches, the residual's norm after the first step; a job
    with ``die_after`` commits its memory save and SIGKILLs itself, one
    with ``fault`` runs with a planted sync fault."""
    import signal

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    losses, gnorms, stamps, first_res = [], [], [], []
    trainer = None

    def res_norm():
        res = trainer.state.grad_residual
        return None if res is None else float(torch.sqrt(sum((r.double() ** 2).sum() for r in res)))

    def hook(step, metrics):
        if "loss" not in metrics:
            return
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if len(losses) == 1:
            first_res.append(res_norm())
        if step == job.get("die_after"):
            trainer.wait_for_checkpoint()
            with open(f"{spec_path}.{rank}", "w") as f:
                json.dump({**job["prior"], job["name"]: dict(losses=losses)}, f)
            os.kill(os.getpid(), signal.SIGKILL)

    real_gather = grad_sync._all_gather
    if job.get("fault") == "local_all_gather":
        grad_sync._all_gather = _local_all_gather(torch, real_gather)
    kw = {"min_quantized_size": 4096} if job["optimizer"] == "adamw_8bit" else {}
    gc.collect()  # what earlier jobs of this process left is not this job's
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = ElasticTrainer(
            gpt2_small(), build_optimizer(job["optimizer"], lr=3e-4, **kw), RandomTokens(seq=DP_T),
            TrainerConfig(batch_size=DP_B, seq_len=DP_T, report_metrics=False,
                          log_interval=job["steps"], **job.get("trainer", {})),
            strategy=Strategy(mesh=MeshConfig(**job["mesh"])), metrics_hook=hook,
        )
        stats = trainer.pipeline_stats
        plan = trainer._grad_sync_plan
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        qo.reset_launch_counts()
        grad_sync.reset_counts()
        t0 = time.perf_counter()
        trainer.train(job["steps"])
    finally:
        grad_sync._all_gather = real_gather
    launches = {**fa.launch_counts, **qo.launch_counts}
    step_ms = [x * 1e3 for x in np.diff([t0] + stamps)]
    res = dict(
        losses=losses, grad_norms=gnorms, step_ms=step_ms,
        median_step_ms=float(statistics.median(step_ms[1:] or step_ms)),
        launches=launches, collectives=dict(grad_sync.issued),
        grad_sync_path=stats.grad_sync_path, grad_sync_ms=stats.grad_sync_ms,
        comm_overlap_pct=stats.comm_overlap_pct,
        grad_bytes_raw=stats.grad_bytes_raw, grad_bytes_wire=stats.grad_bytes_wire,
        buckets=None if plan is None else plan.num_buckets,
        plan=None if plan is None else plan.describe(),
        restored_step=trainer.restored_step, restore_source=trainer.restore_source,
        first_residual_norm=first_res[0] if first_res else None, residual_norm=res_norm(),
        # this job's own bytes: its peak, and what its trainer holds
        # between steps (under ZeRO: shards only)
        peak_bytes=torch.cuda.max_memory_allocated() - base,
        resident_bytes=torch.cuda.memory_allocated() - base,
    )
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _dp_nccl(torch, job, rank, world, spec_path):
    """One rank on NCCL: ``init_elastic`` on the card and a trainer whose
    ``comm_overlap`` resolves to the default path at dp = 1; then
    ``sync_grads`` called on a lone-rank NCCL group with dp = fsdp = 1
    plans (every leg forced onto the world group, so each collective
    runs on NCCL), against its own local grads."""
    import torch.distributed as dist

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.elastic.distributed import init_elastic
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    ctx = init_elastic()
    losses = []
    trainer = ElasticTrainer(
        gpt2_small(), build_optimizer("adamw_8bit_flat", lr=3e-4), RandomTokens(seq=DP_T),
        TrainerConfig(batch_size=DP_B, seq_len=DP_T, report_metrics=False, log_interval=2,
                      comm_overlap=True),
        strategy=Strategy(mesh=MeshConfig(dp=1)),
        metrics_hook=lambda s, m: losses.append(float(m["loss"])) if "loss" in m else None,
    )
    trainer.train(2)
    path = trainer.pipeline_stats.grad_sync_path
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{job['port']}", rank=0,
                            world_size=1)
    mesh = build_mesh(MeshConfig(), "cuda")
    for name in ("dp", "data"):
        mesh.groups[name] = dist.group.WORLD
    leaves = grad_sync.model_leaves(gpt2_small())
    g = torch.Generator(device="cuda").manual_seed(0)
    grads = [torch.randn(p.shape, device="cuda", generator=g) for p in leaves]
    out = {}
    for compress in ("none", "int8"):
        plan = grad_sync.plan_buckets(leaves, dp=1, fsdp=1, compress=compress, bucket_bytes=4 << 20)
        res = grad_sync.zero_residual(plan, "cuda") if plan.compressed else None
        grad_sync.reset_counts()
        synced, new_res, gnorm, lanes = grad_sync.sync_grads(grads, mesh, plan, residual=res,
                                                             device_norms=True)
        torch.cuda.synchronize()
        issued = dict(grad_sync.issued)
        scales = [r.abs().max() for r in new_res] if new_res is not None else []
        err = max(float((a - b).abs().max()) for a, b in zip(synced, grads))
        # one sync, f32: the mean over one lane is the grad itself; int8:
        # within half a code step of it, the error carried in the residual
        bound = 0.0 if compress == "none" else float(max(
            torch.cat([x.reshape(-1) for x in grads]).abs().max() / 127.0 / 2 * 1.0001, 1e-30))
        ms = grad_sync.measure_sync_ms(plan, mesh, iters=3, device="cuda")
        out[compress] = dict(buckets=plan.num_buckets, collectives=issued, max_err=err, bound=bound,
                             residual_max=float(max(scales)) if scales else 0.0,
                             gnorm=float(gnorm), lane_norm=float(lanes[0]), sync_ms=ms,
                             ok=err <= bound and sum(issued.values()) > 0)
    backend = dist.get_backend()
    dist.destroy_process_group()
    return dict(init_elastic_world=ctx.num_processes, trainer_losses=losses,
                trainer_grad_sync_path=path, backend=backend, sync=out)


def _dp_accel_job():
    """The two-rank search's job; the master its ``agree_strategy`` goes
    through is the caller's (``with_master``)."""
    import tempfile

    return dict(kind="accel", name="accel", cache_dir=tempfile.mkdtemp(prefix="dp_links_"))


def _dp_accel(torch, job, rank, world, spec_path):
    """The multi-rank search (a job of ``--dp-worker``): the link model
    probed on the ranks' dp group (gloo's all-reduce of CUDA tensors);
    ``grad_compress="auto"`` and ``grad_bucket_mb=0`` resolved from it;
    then ``agree_strategy`` over gpt2_small's candidates at batch 8 x
    1024 with the per-leaf 8-bit AdamW, through the master (rank 0's
    winner published in its KV store and adopted by the other rank)."""
    from dlrover_tpu_torch.accel import accelerate as acc_mod
    from dlrover_tpu_torch.accel.dry_runner import _mesh_for
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.parallel import grad_sync, topology
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    topology.reset_link_model()
    mesh = _mesh_for(MeshConfig(dp=world), "cuda")
    t0 = time.perf_counter()
    model = topology.probe_link_model(devices="cuda", mesh=mesh, force=True,
                                      cache_dir=job["cache_dir"])
    probe_s = time.perf_counter() - t0
    cfg = gpt2_small()
    plan = grad_sync.resolve_plan(cfg, Strategy(mesh=MeshConfig(dp=world), comm_overlap=True,
                                                grad_compress="auto", grad_bucket_mb=0))
    captured = {}
    real = acc_mod.auto_accelerate

    def capture(*a, **k):
        captured["result"] = real(*a, **k)
        return captured["result"]

    acc_mod.auto_accelerate = capture
    client = MasterClient(job["master"], node_id=rank)
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        strategy = acc_mod.agree_strategy(
            client, cfg, build_optimizer("adamw_8bit", lr=3e-4, min_quantized_size=4096),
            DP_B, DP_T, device="cuda", max_timed=2)
    finally:
        acc_mod.auto_accelerate = real
        client.close()
    wall = time.perf_counter() - t0
    res = captured["result"]
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        link=json.loads(model.to_json()), probe_s=probe_s,
        auto_compress=grad_sync.resolve_auto_compress(link_model=model),
        auto_bucket_bytes=grad_sync.resolve_bucket_bytes(0, dp=world, link_model=model),
        plan=plan.describe(), plan_compress=plan.compress, plan_buckets=plan.num_buckets,
        strategy=strategy.to_json(), describe=strategy.describe(),
        own_pick=res.strategy.to_json(), search_s=res.search_s, wall_s=wall,
        reports=[dict(strategy=r.strategy.describe(), ok=r.ok, fits=r.fits, mem_bytes=r.mem_bytes,
                      step_s=r.step_s, est_step_s=r.est_step_s, host_exposed_s=r.host_exposed_s,
                      host_hidden_measured=r.host_hidden_measured, error=r.error)
                 for r in res.reports],
        launches={**fa.launch_counts, **qo.launch_counts})


def with_master(jobs):
    """A local master serving the jobs' ``agree_strategy`` (its address
    in each accel job); returns the master, to be stopped."""
    from dlrover_tpu_torch.master.local_master import start_local_master

    master = start_local_master()
    for j in jobs:
        if j["kind"] == "accel":
            j["master"] = master.addr
    return master


def check_dp_accel(ranks):
    """The two-rank search's line: one strategy on both ranks (rank 0's,
    through the master), the link model probed on the dp group, the
    auto knobs' choices, the ``max_timed`` best estimates timed, and
    every candidate priced: the pipeline candidates (gpt2_small is deep
    enough for pp = 2) build since the pp slice."""
    a = [r["accel"] for r in ranks]
    timed = [r for r in a[0]["reports"] if r["ok"] and r["step_s"] is not None]
    pp = [r for r in a[0]["reports"] if r["strategy"].startswith("pp")]
    ok = (a[0]["strategy"] == a[1]["strategy"] == a[0]["own_pick"] == a[1]["own_pick"]
          and a[0]["link"]["source"] == "measured" and len(timed) >= 2
          and bool(pp) and all(r["ok"] for r in pp)
          and not any("ROADMAP" in (r["error"] or "") for r in a[0]["reports"]))
    emit("accel_dp_search", world=2, backend="gloo", model="gpt2_small", batch=DP_B, seq=DP_T,
         optimizer="adamw_8bit", winner=a[0]["describe"], strategies=[x["strategy"] for x in a],
         link=a[0]["link"], probe_s=[x["probe_s"] for x in a], auto_compress=a[0]["auto_compress"],
         auto_bucket_bytes=a[0]["auto_bucket_bytes"], plan=a[0]["plan"],
         plan_compress=a[0]["plan_compress"], reports=a[0]["reports"],
         search_s=[x["search_s"] for x in a], wall_s=[x["wall_s"] for x in a],
         launches=[x["launches"] for x in a], card=card_line(), ok=ok)
    if not ok:
        raise RuntimeError("the two ranks' search failed its checks")
    return dict(winner=a[0]["describe"])


def _dp_spawn(label, world, jobs, backend="gloo", timeout=900.0, expect_kill=False):
    """Start ``world`` ranks of ``jobs`` (this script, ``--dp-worker``)
    and return each rank's results; a rank that fails raises with its
    output (a job with ``die_after`` is expected to die by SIGKILL)."""
    return _dp_start(label, world, jobs, backend, timeout, expect_kill)()


def _dp_start(label, world, jobs, backend="gloo", timeout=900.0, expect_kill=False):
    """``_dp_spawn``'s ranks, started; the returned function waits for
    them and returns their results."""
    import tempfile

    d = tempfile.mkdtemp(prefix=f"dp_{label}_")
    spec = os.path.join(d, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(world=world, backend=backend, port=_free_port(), jobs=jobs), f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", spec, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def finish():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            killed = expect_kill and p.returncode == -9
            if p.returncode != 0 and not killed:
                raise RuntimeError(f"dp {label}: rank {r} exited {p.returncode}:\n{outs[r][-4000:]}")
        res = []
        for r in range(world):
            with open(f"{spec}.{r}") as f:
                res.append(json.load(f))
        return res

    return finish


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def run_dp(torch):
    """Data parallelism on the card: which collectives gloo takes on CUDA
    tensors; gpt2_small at dp=2 (two ranks on cuda:0 over gloo, each on
    half of the global batch) with the bucketed sync uncompressed and
    int8 with error feedback, and ZeRO (dp=1 x fsdp=2) with the per-leaf
    8-bit AdamW, each against one process on the card (this one) fed the
    same global batches in two microbatches of the ranks' rows: the
    losses, and the first step's synced grad norm, which a planted fault (an all-gather that returns the local
    chunk) must fail; a memory save at dp=2 at step 4, both ranks
    SIGKILLed after step 5, and a fresh pair restoring it from the
    saver's shm (this process hosts the saver) whose next losses equal
    the uninterrupted run's bit for bit; and one rank over NCCL. Three
    starts of rank processes: the dp=2 jobs, the resume, the NCCL rank."""
    import tempfile

    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

    t0 = time.perf_counter()
    flat, leaf = "adamw_8bit_flat", "adamw_8bit"
    # one process on the global batch in two microbatches of the ranks'
    # rows: the same local grads as the two ranks', so the sync's error
    # is all that parts the runs
    ref = {name: _dp_train(torch, dict(name=name, mesh={}, optimizer=opt, steps=n,
                                       trainer=dict(grad_accum=2)), 0, 1, None)
           for name, opt, n in (("flat", flat, DP_STEPS), ("leaf", leaf, DP_ZERO_STEPS))}
    smoke_job = f"smokedp{os.getpid()}"
    os.environ["DLROVER_TPU_JOB_NAME"] = smoke_job
    os.environ["DLROVER_TPU_SOCKET_DIR"] = tempfile.mkdtemp(prefix="dlr")
    ckpt_dir = tempfile.mkdtemp(prefix="dp_ckpt_")
    AsyncCheckpointSaver.reset()
    AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=2)
    ck = dict(ckpt_dir=ckpt_dir, comm_overlap=True, save_memory_interval=DP_CKPT_AT,
              save_storage_interval=1000)
    # the accel phase's two-rank search rides this start, through a
    # master of this process
    accel_job = _dp_accel_job()
    master = with_master([accel_job])
    # the hook runs before the step's own save: after step 5's loss the
    # stage of step 4 is committed, then both ranks die
    two = _dp_spawn("dp2", 2, [
        dict(kind="probe", name="probe"),
        dict(kind="train", name="none", mesh=dict(dp=2), optimizer=flat, steps=DP_STEPS,
             trainer=dict(comm_overlap=True)),
        dict(kind="train", name="int8", mesh=dict(dp=2), optimizer=flat, steps=DP_STEPS,
             trainer=dict(comm_overlap=True, grad_compress="int8")),
        dict(kind="train", name="zero", mesh=dict(fsdp=2), optimizer=leaf, steps=DP_ZERO_STEPS,
             trainer=dict(comm_overlap=True)),
        dict(kind="train", name="fault", mesh=dict(dp=2), optimizer=flat, steps=1,
             trainer=dict(comm_overlap=True), fault="local_all_gather"),
        accel_job,
        dict(kind="train", name="first", mesh=dict(dp=2), optimizer=flat, steps=DP_STEPS,
             die_after=DP_CKPT_AT + 1, trainer=ck),
    ], expect_kill=True)
    master.stop()
    dp_accel = check_dp_accel(two)
    refused = sorted({k for r in two for k, v in r["probe"]["ops"].items() if v != "ok"})
    emit("dp_gloo_cuda", backend=two[0]["probe"]["backend"], ops=two[0]["probe"]["ops"],
         refused=refused, host_staged=0, ok=not refused)
    if refused:
        raise RuntimeError(f"gloo refuses {refused} on CUDA tensors; the sync has no host-staged branch")
    resumed = _dp_spawn("ckpt_resume", 2, [dict(kind="train", name="resume", mesh=dict(dp=2),
                                                optimizer=flat, steps=DP_STEPS, trainer=ck)])
    AsyncCheckpointSaver.reset()
    nccl = _dp_spawn("nccl", 1, [dict(kind="nccl", name="nccl", port=_free_port())],
                     backend="")[0]["nccl"]

    fails = []
    for name, rname, tol in (("none", "flat", LOSS_MATCH_RTOL), ("int8", "flat", DP_INT8_RTOL),
                             ("zero", "leaf", LOSS_MATCH_RTOL)):
        want = ref[rname]["losses"]
        per_rank = [r[name] for r in two]
        rel = [_rel(r["losses"], want) for r in per_rank]
        same = per_rank[0]["losses"] == per_rank[1]["losses"]
        # the first step's synced norm against the one process's: f32
        # syncs to DP_GNORM_RTOL; int8 within the norm of the ranks' mean
        # quantization error (synced = exact mean - mean residual, so
        # the norms differ by at most the mean of the residuals' norms)
        g_ref = ref[rname]["grad_norms"][0]
        g_diff = max(abs(r["grad_norms"][0] - g_ref) for r in per_rank)
        g_tol = DP_GNORM_RTOL * g_ref
        if name == "int8":
            g_tol += statistics.mean(r["first_residual_norm"] for r in per_rank)
        L = 12  # gpt2_small's layers
        expect_fa = L * len(want)
        ok = (all(len(r["losses"]) == len(want) for r in per_rank) and max(rel) <= tol and same
              and g_diff <= g_tol
              and all(r["grad_sync_path"] == "explicit" for r in per_rank)
              and all(r["launches"]["fa_fwd"] == expect_fa for r in per_rank))
        emit("dp_train", run=name, world=2, mesh=dict(dp=2) if name != "zero" else dict(fsdp=2),
             optimizer=leaf if name == "zero" else flat,
             batch=DP_B, rows_per_rank=DP_B // 2, seq=DP_T, losses=per_rank[0]["losses"],
             reference_losses=want, reference_median_step_ms=ref[rname]["median_step_ms"],
             max_rel_diff=max(rel), tol=tol, ranks_agree=same,
             first_grad_norm=[r["grad_norms"][0] for r in per_rank],
             reference_first_grad_norm=g_ref, first_grad_norm_abs_diff=g_diff,
             first_grad_norm_tol=g_tol,
             first_residual_norm=[r["first_residual_norm"] for r in per_rank],
             median_step_ms=[r["median_step_ms"] for r in per_rank],
             grad_sync_ms=[r["grad_sync_ms"] for r in per_rank],
             comm_overlap_pct=per_rank[0]["comm_overlap_pct"], buckets=per_rank[0]["buckets"],
             plan=per_rank[0]["plan"], grad_bytes_raw=per_rank[0]["grad_bytes_raw"],
             grad_bytes_wire=per_rank[0]["grad_bytes_wire"],
             residual_norm=[r["residual_norm"] for r in per_rank],
             launches=[r["launches"] for r in per_rank],
             collectives=[r["collectives"] for r in per_rank],
             peak_bytes=[r["peak_bytes"] for r in per_rank],
             resident_bytes=[r["resident_bytes"] for r in per_rank],
             reference_peak_bytes=ref[rname]["peak_bytes"],
             reference_resident_bytes=ref[rname]["resident_bytes"], ok=ok)
        if not ok:
            fails.append(name)
    # the planted fault must fail the first-step norm check
    g_ref = ref["flat"]["grad_norms"][0]
    f_diff = max(abs(r["fault"]["grad_norms"][0] - g_ref) for r in two)
    caught = f_diff > DP_GNORM_RTOL * g_ref
    emit("dp_fault", fault="all-gather returns the local chunk", run="none", steps=1,
         first_grad_norm=[r["fault"]["grad_norms"][0] for r in two], reference_first_grad_norm=g_ref,
         abs_diff=f_diff, tol=DP_GNORM_RTOL * g_ref, caught=caught, ok=caught)
    if not caught:
        fails.append("fault")
    uninterrupted = two[0]["none"]["losses"]
    ck_ok = (all(r["first"]["losses"][:DP_CKPT_AT] == uninterrupted[:DP_CKPT_AT] for r in two)
             and all(r["resume"]["restored_step"] == DP_CKPT_AT for r in resumed)
             and all(r["resume"]["restore_source"] == "memory" for r in resumed)
             and all(r["resume"]["losses"] == uninterrupted[DP_CKPT_AT:] for r in resumed))
    emit("dp_ckpt", world=2, saved_at=DP_CKPT_AT, killed="SIGKILL both ranks after step 5",
         restored=[r["resume"]["restored_step"] for r in resumed],
         source=[r["resume"]["restore_source"] for r in resumed],
         resumed_losses=resumed[0]["resume"]["losses"],
         uninterrupted_losses=uninterrupted[DP_CKPT_AT:], bitwise=ck_ok, ok=ck_ok)
    if not ck_ok:
        fails.append("ckpt")
    n_ok = (nccl["backend"] == "nccl" and nccl["init_elastic_world"] == 1
            and nccl["trainer_grad_sync_path"] == "gspmd" and len(nccl["trainer_losses"]) == 2
            and all(math.isfinite(x) for x in nccl["trainer_losses"])
            and all(v["ok"] for v in nccl["sync"].values()))
    emit("dp_nccl", world=1, trainer=dict(strategy="dp=1", comm_overlap=True,
                                          grad_sync_path=nccl["trainer_grad_sync_path"],
                                          note="dp = 1: the plan resolves to the default path",
                                          losses=nccl["trainer_losses"]),
         backend=nccl["backend"], sync=nccl["sync"], ok=n_ok)
    if not n_ok:
        fails.append("nccl")
    emit("dp", seconds=time.perf_counter() - t0, host_staged=0, never_on_a_card=[
        "NCCL at world size > 1", "two-level plans (a hybrid dp axis) across real nodes"],
        ok=not fails)
    if fails:
        raise RuntimeError(f"the dp phase failed: {fails}")
    return dp_accel


# -- the resize phase (ROADMAP A8, C3) -------------------------------------------
# Llama-2 width (ATorch's Llama-2 throughput config); (layers, steps):
# --phase resize / c3, and the full run (in the tp / ep pair; the depth
# stays, as the static figures' gate was calibrated at 4 layers: on the
# H100 80GB HBM3 at 700 W dp=2's peak after 2 steps read 0.4 % below
# its peak after 3, ZeRO's the same)
C3_RUNS = {"phase": (4, 3), "full": (4, 2)}
C3_SEQ = 4096  # batch 1 x 4096 a rank
C3_PARAMS_SAVING_SHARE = 0.9  # of the params saving PERF.md reckoned before the run
RESIZE_LASTCALL_S = 5.0  # --rdzv-waiting-timeout of the drill's launchers (its default)
RESIZE_SAVE_AT = 4  # the memory save world 2 makes before node 1 dies
RESIZE_KILL_AFTER = 6  # node 1's worker kills its launcher's group after this step
RESIZE_DISK_AT = 8  # the world-1 worker's disk save before the grow
RESIZE_HOLD_AFTER = 9  # the world-1 worker holds here until the grow
RESIZE_STEPS = 12
RESIZE_LAUNCHER_ARGS = []  # a CPU rehearsal adds --device-spec cpu
RESIZE_RUN = ["--model", "gpt2_small", "--steps", str(RESIZE_STEPS), "--batch", "8", "--seq", "1024",
              "--prefetch", "2", "--save-memory-interval", str(RESIZE_SAVE_AT),
              "--save-storage-interval", str(RESIZE_DISK_AT), "--log-interval", "4",
              "--comm-overlap", "--derive-strategy",
              "--digest-steps", f"{RESIZE_SAVE_AT},{RESIZE_DISK_AT}", "--scale-candidates", "1,2",
              "--kill-after-step", str(RESIZE_KILL_AFTER), "--kill-group", "--kill-rank", "1",
              "--hold-at-world", "1", "--hold-after-step", str(RESIZE_HOLD_AFTER)]


def _dp_c3(torch, job, rank, world, spec_path):
    """ZeRO's params sharded through the step (C3) against dp=2 on the
    card: Llama-2 width at ``job["layers"]`` layers, 1 x ``C3_SEQ`` a rank,
    per-leaf ``adamw_8bit``, ``job["steps"]`` steps of seeded batches, the
    weights from a seeded generator on the card (the same on every rank
    and in both runs). Returns the losses, the peak over the steps and
    the resident bytes (this job's own), and the static figure."""
    from dataclasses import replace

    from dlrover_tpu_torch.accel.accelerate import auto_accelerate
    from dlrover_tpu_torch.accel.dry_runner import _apply_strategy, static_peak_bytes
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, batch_sharding
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    cfg = replace(llama2_7b(), num_layers=job["layers"])
    tx = build_optimizer("adamw_8bit", lr=3e-4, min_quantized_size=4096)
    strategy = Strategy(mesh=MeshConfig(**job["mesh"]), comm_overlap=True)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    res = auto_accelerate(cfg, tx, world, C3_SEQ, device="cuda", strategy=strategy, donate=False)
    state = res.init_fn(0, device_generator=True)
    cfg2, applied = _apply_strategy(res.strategy, cfg)
    static = static_peak_bytes(cfg2, applied, tx, world, C3_SEQ)
    torch.cuda.synchronize()
    resident0 = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    if job.get("trace"):
        torch.cuda.memory._record_memory_history(max_entries=200000)
    rng = np.random.default_rng(0)
    rows = batch_sharding(res.mesh, world)
    losses, step_ms = [], []
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    for _ in range(job["steps"]):
        x = rng.integers(0, cfg.vocab_size, (world, C3_SEQ + 1)).astype(np.int64)[rows]
        t = torch.from_numpy(x).cuda()
        t0 = time.perf_counter()
        _, m = res.step_fn(state, t[:, :-1].contiguous(), t[:, 1:].contiguous())
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    live_at_peak = None
    if job.get("trace"):
        live_at_peak = _live_at_peak(torch.cuda.memory._snapshot())
        torch.cuda.memory._record_memory_history(enabled=None)
    out = dict(live_at_peak=live_at_peak, losses=losses, step_ms=step_ms,
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               resident_bytes=torch.cuda.memory_allocated() - base, resident_before=resident0,
               static_bytes=static, zero=state.shards is not None,
               largest_unit_bytes=state.units.largest_unit_bytes() if state.units else None,
               launches={**fa.launch_counts, **qo.launch_counts})
    del state, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _live_at_peak(snapshot, top=14):
    """From an allocator history (``torch.cuda.memory._snapshot()``):
    the blocks allocated at the moment the recorded allocations peaked,
    summed by the innermost frame of this repository's code that
    allocated them (bytes, count), largest first."""
    events = [e for dev in snapshot["device_traces"] for e in dev]
    live, total, best, best_live = {}, 0, -1, {}
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            total -= live.pop(e["addr"])["size"]
        if total > best:
            best, best_live = total, dict(live)

    def site(e):
        for f in e.get("frames", []):
            if "dlrover_tpu_torch" in f["filename"] or "chip_smoke" in f["filename"]:
                return f"{f['filename'].split('/repo/')[-1]}:{f['line']} {f['name']}"
        return "other"

    groups = {}
    for e in best_live.values():
        g = groups.setdefault(site(e), [0, 0])
        g[0] += e["size"]
        g[1] += 1
    return dict(recorded_peak_bytes=best, sites=sorted(
        ([k, v[0], v[1]] for k, v in groups.items()), key=lambda x: -x[1])[:top])


def _c3_jobs(full, trace=False):
    """C3's two runs in order, dp=2 then ZeRO dp=1 x fsdp=2, at
    ``C3_RUNS``' depth."""
    layers, steps = C3_RUNS["full" if full else "phase"]
    job = dict(kind="c3", layers=layers, steps=steps, trace=trace)
    return [dict(job, name="dp2", mesh=dict(dp=2)), dict(job, name="zero", mesh=dict(fsdp=2))]


def run_c3(torch, trace=False):
    """C3 on the card (``--phase c3`` and ``--phase resize``): two gloo
    ranks of their own; ``trace`` (``--phase c3``) records the
    allocator's history and prints what was live at each run's peak
    (``_live_at_peak``)."""
    return _c3_line(_dp_spawn("c3", 2, _c3_jobs(False, trace)), False, trace)


def _c3_line(ranks, full, trace=False, beside=()):
    """C3's gates on the two ranks' results: the ZeRO peak must sit below
    dp=2's by half the 8-bit state plus ``C3_PARAMS_SAVING_SHARE`` of
    the reckoned params saving, each static figure within
    ``PEAK_CAL_RTOL`` of its peak, the losses bitwise."""
    from dataclasses import replace

    from dlrover_tpu_torch.accel.dry_runner import _opt_state_bytes
    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.trainer.elastic.trainer import build_optimizer

    # what PERF.md reckoned before the run: half the 8-bit state, and half
    # the f32 params less the largest unit gathered at once (one block)
    layers, steps = C3_RUNS["full" if full else "phase"]
    cfg = replace(llama2_7b(), num_layers=layers)
    leaves = grad_sync.model_leaves(cfg)
    params = sum(p.numel() for p in leaves)
    block = (params - 2 * cfg.vocab_size * cfg.model_dim) / layers
    state_half = _opt_state_bytes(
        build_optimizer("adamw_8bit", lr=3e-4, min_quantized_size=4096), leaves)[0] / 2
    reckoned = 4.0 * params / 2 - 4.0 * block
    dp2, zero = ranks[0]["dp2"], ranks[0]["zero"]
    if trace:
        emit("resize_c3_trace", dp2=dp2["live_at_peak"], zero=zero["live_at_peak"])
    saving = dp2["peak_bytes"] - zero["peak_bytes"]
    want = state_half + C3_PARAMS_SAVING_SHARE * reckoned
    rel = {k: r["static_bytes"] / r["peak_bytes"] - 1 for k, r in (("dp2", dp2), ("zero", zero))}
    bitwise = all(r["dp2"]["losses"] == r["zero"]["losses"] for r in ranks) and (
        ranks[0]["zero"]["losses"] == ranks[1]["zero"]["losses"])
    ok = (bitwise and saving >= want and all(abs(v) <= PEAK_CAL_RTOL for v in rel.values())
          and all(math.isfinite(x) for x in dp2["losses"]))
    emit("resize_c3", model=f"llama2_7b width, {layers} layers", batch_per_rank=f"1 x {C3_SEQ}",
         optimizer="adamw_8bit", world=2, backend="gloo", steps=steps,
         losses=dict(dp2=dp2["losses"], zero=zero["losses"]), bitwise=bitwise,
         peak_bytes=[[r["dp2"]["peak_bytes"], r["zero"]["peak_bytes"]] for r in ranks],
         resident_bytes=dict(dp2=dp2["resident_bytes"], zero=zero["resident_bytes"]),
         static_bytes=dict(dp2=dp2["static_bytes"], zero=zero["static_bytes"]),
         static_vs_peak=rel, tol=PEAK_CAL_RTOL, saving_bytes=saving, want_saving_bytes=want,
         reckoned_state_half_bytes=state_half, reckoned_params_saving_bytes=reckoned,
         largest_unit_bytes=zero["largest_unit_bytes"],
         step_ms=dict(dp2=dp2["step_ms"], zero=zero["step_ms"]),
         launches=dict(dp2=dp2["launches"], zero=zero["launches"]), card=card_line(),
         timing_grade=not beside, beside=list(beside), ok=ok)
    if not ok:
        raise RuntimeError("C3: the ZeRO peak, its static figure or its losses failed")
    return dict(saving_bytes=saving, static_vs_peak=rel)


def resize_launcher(label, node, job, ckpt_dir, evdir, cache_dir, master_addr=""):
    """One node of the resize drill: a ``--nnodes=1:2`` launcher in a
    session of its own, with a socket dir and a shm node rank of its
    own (two nodes on one host), its workers joining over gloo."""
    import tempfile

    ev = os.path.join(evdir, f"{label}.jsonl")
    log_path = os.path.join(evdir, f"{label}.launcher.log")
    log = open(log_path, "w")
    env = {**os.environ, **run_files(evdir, label), "PYTHONPATH": REPO,
           "DLROVER_TPU_NODE_RANK": str(node),
           "DLROVER_TPU_SOCKET_DIR": tempfile.mkdtemp(prefix="dlr"),
           "DLROVER_TPU_DIST_BACKEND": "gloo", "DLROVER_TPU_COMPILE_CACHE": cache_dir}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.run", "--nnodes=1:2",
         "--nproc-per-node=1", f"--node-rank={node}", "--monitor-interval=0.5",
         f"--rdzv-waiting-timeout={RESIZE_LASTCALL_S}", f"--job-name={job}",
         f"--log-dir={os.path.join(evdir, label + '_workers')}", *RESIZE_LAUNCHER_ARGS,
         *([f"--master-addr={master_addr}"] if master_addr else []),
         CKPT_WORKER, *RESIZE_RUN, "--ckpt-dir", ckpt_dir, "--events", ev],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
    )
    return dict(label=label, proc=proc, ev=ev, log_path=log_path, log=log, t0=time.time(),
                holders=CardHolders(proc.pid))


def _finish_launcher(n, timeout):
    try:
        n["rc"] = n["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        n["rc"] = "timeout"
    try:  # nothing of the group may outlive the run
        os.killpg(n["proc"].pid, 9)
    except ProcessLookupError:
        pass
    n["proc"].wait()
    n["cards"] = n["holders"].stop()
    n["log"].close()
    with open(n["log_path"]) as f:
        n["text"] = f.read()
    n["lines"] = launcher_log(n["text"])
    n["events"] = []
    if os.path.exists(n["ev"]):
        with open(n["ev"]) as f:
            n["events"] = [json.loads(line) for line in f]
    return n


def _incarnations(events):
    """A node's workers in order: each from its ``start`` event to the
    next, with its restored event, digests, losses and kill."""
    out = []
    for e in events:
        if e["event"] == "start":
            out.append(dict(start=e, restored=None, digests={}, losses={}, loss_t={}, kill=None,
                            warm={}))
        elif out:
            w = out[-1]
            if e["event"] == "warm":
                w["warm"] = e
            elif e["event"] == "restored":
                w["restored"] = e
            elif e["event"] == "digest":
                w["digests"][e["step"]] = e["crc"]
            elif e["event"] == "loss":
                w["losses"][e["step"]] = e["loss"]
                w["loss_t"][e["step"]] = e["t"]
            elif e["event"] == "kill":
                w["kill"] = e
    return out


def _transition(label, t_cause, cause, n0_lines, landed, staged_digest, want_step, want_source,
                cause_log):
    """One transition's line: the time from ``cause`` (a node's death or
    join) to the first loss at the new world, split by the launcher's
    log and the landed worker's events."""
    def after(fragment):
        return next((t for t, msg in n0_lines if fragment in msg and t >= t_cause - 0.5), None)

    r = landed["restored"] or {}
    lr = r.get("last_resize") or {}
    t_detect = after(cause_log)
    t_rdzv = next((t for t, msg in n0_lines if "joined round" in msg and t_detect is not None
                   and t >= t_detect), None)
    steps = sorted(landed["loss_t"])
    t_first = landed["loss_t"][steps[0]] if steps else None
    ctor_start = r["t"] - lr.get("downtime_ms", 0) / 1e3 if r else None
    ok = (bool(r) and r.get("step") == want_step and r.get("source") == want_source
          and r.get("digest") == staged_digest and staged_digest is not None
          and len(steps) > 0 and all(math.isfinite(x) for x in landed["losses"].values())
          and lr.get("compile_cache_hit") is True)
    rec = dict(
        transition=label, cause=cause, lastcall_window_s=RESIZE_LASTCALL_S,
        cause_to_first_loss_s=None if t_first is None else t_first - t_cause,
        detection_s=None if t_detect is None else t_detect - t_cause,
        rendezvous_s=None if t_rdzv is None or t_detect is None else t_rdzv - t_detect,
        worker_start_s=None if ctor_start is None or t_rdzv is None else ctor_start - t_rdzv,
        import_s=landed["start"].get("import_s"),
        cuda_context_s=landed["warm"].get("cuda_context_s"),
        kernel_load_s=landed["warm"].get("kernel_load_s"),
        strategy_ms=lr.get("build_ms"), compile_cache_hit=lr.get("compile_cache_hit"),
        state_init_ms=lr.get("state_init_ms"), setup_ms=lr.get("setup_ms"),
        restore_ms=lr.get("restore_ms"), restore_source=r.get("source"),
        first_step_s=None if t_first is None or not r else t_first - r["t"],
        restored_step=r.get("step"), want_step=want_step, world=r.get("world"),
        strategy=r.get("strategy"), digest=r.get("digest"), staged_digest=staged_digest,
        losses=landed["losses"],
        last_resize={k: v for k, v in lr.items() if k != "fallback_paths"},
        fallback_leaves=len(lr.get("fallback_paths") or []), ok=ok)
    return rec


def run_resize_drill(torch, beside=()):
    """Shrink 2 -> 1 and grow 1 -> 2 through the launcher: two
    ``--nnodes=1:2`` launchers (node 0 hosts the master), gpt2_small at
    dp=2 over gloo on the one card. World 2 saves to memory at step
    ``RESIZE_SAVE_AT``; node 1's worker kills its launcher's group after
    ``RESIZE_KILL_AFTER`` (once that save is on disk); node 0's agent
    relaunches its worker at world 1, which derives its strategy (a
    cache hit: world 2 derived it speculatively), restores the step from
    its shm, trains on, saves to disk at ``RESIZE_DISK_AT`` and holds
    after ``RESIZE_HOLD_AFTER``; node 1 starts again, and on the
    membership change both restart at world 2 and restore that step
    from storage. Each landing's restored state must digest as the
    staged one did."""
    import tempfile

    from dlrover_tpu_torch.ckpt.shm_handler import shard_shm_name

    t_phase = time.perf_counter()
    evdir = tempfile.mkdtemp(prefix="resize_")
    ckpt_dir = tempfile.mkdtemp(prefix="resize_ckpt_")
    cache_dir = tempfile.mkdtemp(prefix="resize_cc_")
    job = f"smokerz{os.getpid()}"
    nodes = []
    try:
        n0 = resize_launcher("rz_n0", 0, job, ckpt_dir, evdir, cache_dir)
        nodes.append(n0)
        addr, deadline = "", time.time() + 60
        while not addr and time.time() < deadline and n0["proc"].poll() is None:
            with open(n0["log_path"]) as f:
                m = re.search(r"spawned local master at (\S+)", f.read())
            addr = m.group(1) if m else ""
            time.sleep(0.1)
        if not addr:
            raise RuntimeError("the drill's master did not start")
        n1 = resize_launcher("rz_n1", 1, job, ckpt_dir, evdir, cache_dir, addr)
        nodes.append(n1)
        _finish_launcher(n1, 300)  # its worker kills the group
        hold = wait_for_event(n0["ev"], "hold", n0["proc"], timeout=300)
        if hold is None:
            raise RuntimeError("the world-1 worker never reached its hold")
        # the dead node's agent left its segment in /dev/shm
        os.environ.update(DLROVER_TPU_JOB_NAME=job, DLROVER_TPU_NODE_RANK="1")
        try:
            seg = "/dev/shm/" + shard_shm_name(0)
            if os.path.exists(seg):
                os.unlink(seg)
        finally:
            os.environ.pop("DLROVER_TPU_NODE_RANK", None)
        t_join = time.time()
        n1b = resize_launcher("rz_n1b", 1, job, ckpt_dir, evdir, cache_dir, addr)
        nodes.append(n1b)
        _finish_launcher(n1b, 400)
        _finish_launcher(n0, 120)
    finally:
        for n in nodes:
            if "rc" not in n:
                _finish_launcher(n, 1)
    a0, b, c = (_incarnations(n0["events"]) + [None, None, None])[:3]
    a1 = (_incarnations(n1["events"]) or [None])[0]
    d = (_incarnations(n1b["events"]) or [None])[0]
    if None in (a0, a1, b, c, d):
        for n in nodes:
            print(f"--- {n['label']} rc={n['rc']}\n{n['text'][-4000:]}", flush=True)
        raise RuntimeError("the drill's incarnations are missing")
    kill = a1["kill"]
    staged4 = a0["digests"].get(RESIZE_SAVE_AT)
    staged8 = b["digests"].get(RESIZE_DISK_AT)
    shrink = _transition("2->1", kill["t"] if kill else t_join, "node 1 SIGKILLed (launcher group)",
                         n0["lines"], b, staged4, RESIZE_SAVE_AT, "memory", "worker failure")
    grow = [_transition("1->2", t_join, "node 1 joins again", n0["lines"], w, staged8,
                        RESIZE_DISK_AT, "storage", "membership change") for w in (c, d)]
    digests_agree = a0["digests"].get(RESIZE_SAVE_AT) == a1["digests"].get(RESIZE_SAVE_AT)
    for rec in [shrink] + grow:
        emit("resize", **rec, card_holders={n["label"]: n["cards"] for n in nodes},
             launcher_rc={n["label"]: n["rc"] for n in nodes}, card=card_line(),
             timing_grade=not beside, beside=list(beside))
    ok = (shrink["ok"] and all(g["ok"] for g in grow) and digests_agree and kill is not None
          and n0["rc"] == 0 and n1b["rc"] == 0
          and not any(n["cards"]["control_plane_holds_card"] for n in nodes))
    if not ok:
        for n in nodes:
            print(f"--- {n['label']} rc={n['rc']}\n{n['text'][-3000:]}", flush=True)
    return dict(ok=ok, seconds=time.perf_counter() - t_phase,
                shrink_s=shrink["cause_to_first_loss_s"],
                grow_s=[g["cause_to_first_loss_s"] for g in grow])


def run_resize(torch, side=None):
    """The resize phase (``--phase resize``, and in the full run after the
    flash_ckpt phase): the drill's shrink and grow, then C3. ``side``:
    the full run's tp / ep processes (``start_tp_ep``), started before
    the drill, whose pair also runs C3 at ``C3_RUNS``' full depth; the
    drill's and C3's lines then say that their times are not
    timing-grade, which only ``--phase resize`` gives. Returns what
    ``side`` returned."""
    t0 = time.perf_counter()
    beside = ("tp_train", "ep_train", "pp_train", "resize_c3") if side else ()
    try:
        drill = run_resize_drill(torch, beside)
    finally:
        res = side() if side else None
    if res:
        c3 = _c3_line(res.pop("c3"), True, beside=("resize", "tp_train", "ep_train", "pp_train"))
    else:
        c3 = run_c3(torch)
    emit("resize_phase", seconds=time.perf_counter() - t0, drill=drill, c3=c3,
         timing_grade=not beside, beside=list(beside),
         never_on_a_card=["NCCL at world size > 1", "a resize across real nodes",
                          "ranks left idle by a degraded world (CPU tests only)",
                          "the micro-batch rebalance at a changed world (CPU tests only)",
                          "the master's scale candidates reaching the trainer"],
         ok=drill["ok"])
    if not drill["ok"]:
        raise RuntimeError("the resize drill failed its checks")
    return res


# ---------------------------------------------------------------------------
# the sp phase: the declared masks through the kernels, sequence-parallel
# training, the scheme table
# ---------------------------------------------------------------------------
def mask_families(fa, T, B=1, seed=0):
    """The ``KeyIntervals`` families at length ``T``: a GLM prefix, a
    sliding window, packed documents (one layout a batch row when ``B >
    1``), and the prefix with a run of rows that see nothing."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(1, T), size=5, replace=False))
        docs.append(np.searchsorted(cuts, np.arange(T), side="right"))
    return {
        "prefix": fa.KeyIntervals.prefix(T, T // 4 + 40),
        "window": fa.KeyIntervals.window(T, T // 8 + 24),
        "documents": fa.KeyIntervals.documents(np.stack(docs)),
        "empty_rows": fa.KeyIntervals.prefix(T, T // 4).without_rows(range(T // 2, T // 2 + 136)),
    }


def run_masks(torch, fa):
    """Each attention kernel under each mask family, against the plain f32
    result by the per-tile error rule: at the main attention shape
    (gpt2_small's), at Llama-2 width (GQA 32 / 8), and at a ring hop's
    offsets (queries 4096-8191 of an 8192-row mask against keys 0-4095
    and against their own block). Per family: each kernel's ms, tile
    error and the launches of one differentiable ``flash_attention``
    call under it (reset just before); a callable that is no
    ``KeyIntervals`` must raise on the card."""
    t0 = time.perf_counter()
    out = {}
    cases = [("gpt2_small", 8, 12, 12, 1024, 64, 0, 0, mask_families(fa, 1024, 8)),
             ("llama2_7b gqa", 1, 32, 8, 4096, 128, 0, 0, mask_families(fa, 4096))]
    hop = fa.KeyIntervals.documents(np.repeat([0, 1, 2], [3000, 3500, 1692]))
    cases += [("ring hop k<q", 1, 32, 32, 4096, 128, 4096, 0, {"documents_hop": hop}),
              ("ring hop diagonal", 1, 32, 32, 4096, 128, 4096, 4096, {"documents_hop": hop})]
    for shape, B, H, Hkv, T, D, qo, ko, fams in cases:
        for fam, iv in fams.items():
            res, abs_err = check_attention(torch, fa, f"masked {fam} {shape}", B, H, Hkv, T, D,
                                           q_off=qo, k_off=ko, mask=iv, graph=T <= 1024)
            # one differentiable call through the public entry
            dev = torch.device("cuda")
            g = torch.Generator(device=dev).manual_seed(1)
            x = torch.randn((B, T, H, D), generator=g, device=dev, dtype=torch.bfloat16,
                            requires_grad=True)
            kv = torch.randn((B, T, Hkv, D), generator=g, device=dev, dtype=torch.bfloat16,
                             requires_grad=True)
            fa.reset_launch_counts()
            o = fa.flash_attention(x, kv, kv, mask_fn=iv, q_offset=qo, k_offset=ko)
            o.float().sum().backward()
            torch.cuda.synchronize()
            launches = dict(fa.launch_counts)
            entry = out.setdefault(fam, {})
            entry[shape] = {
                name: {"ms": res["ms"][name], "tile_err": max(res["tile_err"][x] for x in es),
                       "bound_ms": res["bound"][name][0], "plain_ms": res["plain_ms"][name],
                       "library_ms": res["library_ms"][name], "launches": launches[name],
                       "max_abs_err": max(abs_err[x] for x in es)}
                for name, e, es in (("fa_fwd", "o", ("o",)), ("fa_bwd_dq", "dq", ("dq",)),
                                    ("fa_bwd_dkdv", "dk", ("dk", "dv")))
            }
            del x, kv, o
    x = torch.zeros((1, 128, 2, 64), device="cuda", dtype=torch.bfloat16)
    try:
        fa.flash_attention(x, x, x, mask_fn=lambda a, b: a >= b)
        raised = None
    except NotImplementedError as e:
        raised = str(e)[:120]
    emit("sp_masks", seconds=time.perf_counter() - t0, callable_mask_raises=raised,
         ok=raised is not None)
    if raised is None:
        raise RuntimeError("a callable mask ran on the card")
    return out


RAGGED_T = (95, 1151)  # lengths that are no multiple of a 64-row tile


def ragged_attention_checks(torch, fa):
    """B1-B5 at lengths that are no multiple of a tile (``RAGGED_T``; the
    RLHF scoring's ``P + N - 1`` and the critic's ``P + N`` cannot both
    be multiples of 64): the fused contract's shape (gpt2_small's heads),
    the streaming one's (Llama-2 width with GQA), not causal, a declared
    mask (a GLM prefix) and a ring hop's offsets (the queries after every
    key, and the hop's own block), each kernel against the plain f32
    result by the per-tile rule (the last, shorter tile by itself), with
    its ms, plain ms, library ms and bound."""
    t0 = time.perf_counter()
    out = {}
    for T in RAGGED_T:
        cases = [
            ("B1/B2 fused shape", 2, 12, 12, 64, {}),
            ("B3-B5 streaming gqa", 1, 32, 8, 128, {}),
            ("B3-B5 not causal", 2, 12, 12, 64, {"causal": False}),
            ("B3-B5 prefix intervals", 2, 12, 12, 64,
             {"mask": fa.KeyIntervals.prefix(2 * T, T // 3 + 5)}),
            ("B3-B5 ring hop k<q", 1, 8, 8, 128, {"q_off": T, "k_off": 0}),
            ("B3-B5 ring hop diagonal", 1, 8, 8, 128, {"q_off": T, "k_off": T}),
        ]
        for label, B, H, Hkv, D, kw in cases:
            res, abs_err = check_attention(torch, fa, f"ragged {label} T={T}", B, H, Hkv, T, D,
                                           graph=True, **kw)
            out[f"{label} T={T}"] = {
                name: {"ms": res["ms"][name], "plain_ms": res["plain_ms"][name],
                       "bound_ms": res["bound"][name][0], "library_ms": res["library_ms"][name],
                       "tile_err": max(res["tile_err"][x] for x in es),
                       "max_abs_err": max(abs_err[x] for x in es)}
                for name, es in (("fa_fwd", ("o",)), ("fa_bwd_dq", ("dq",)),
                                 ("fa_bwd_dkdv", ("dk", "dv")))}
    emit("ragged_attention", seconds=time.perf_counter() - t0, lengths=list(RAGGED_T),
         cases=sorted(out), ok=True)
    return out


def check_attention_path(torch, fa, label, H, T, q_off=0, k_off=0, D=128, seed=0):
    """The kernels at one of the sp path's shapes (one row, causal, the
    ``bthd`` layout the ring and Ulysses hand them), held to the plain
    f32 result by the per-tile rule on three heads. All heads' plain
    result at these lengths would take tens of GB; with no GQA on the
    path a head's outputs depend on its own head alone, so each checked
    head's reference is computed by itself."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((1, T, H, D), generator=g, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, q_offset=q_off, k_offset=k_off)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for x in (o, lse, dq, dk, dv):
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{label}: non-finite kernel output")
    heads = sorted({0, H // 2, H - 1})
    tile = dict.fromkeys(("o", "dq", "dk", "dv"), 0.0)
    abs_err = dict(tile)
    lse_err = 0.0
    for h in heads:
        one = slice(h, h + 1)
        qf, kf, vf = (x[:, :, one].float().requires_grad_() for x in (q, k, v))
        o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_residuals=True, **kw)
        gq, gk, gv = torch.autograd.grad(o_ref, (qf, kf, vf), do[:, :, one].float())
        for name, got, ref in (("o", o, o_ref.detach()), ("dq", dq, gq), ("dk", dk, gk),
                               ("dv", dv, gv)):
            got = got[:, :, one]
            tile[name] = max(tile[name], tile_err(got.transpose(1, 2), ref.transpose(1, 2)))
            abs_err[name] = max(abs_err[name], (got.float() - ref).abs().max().item())
        lse_err = max(lse_err, (lse[:, one] - lse_ref.detach()).abs().max().item())
        del qf, kf, vf, o_ref, lse_ref, gq, gk, gv
        torch.cuda.empty_cache()
    ok = all(r <= ATTN_TOL for r in tile.values()) and lse_err <= LSE_TOL
    emit("kernel_check", label=label, shape=[1, H, H, T, D], offsets=[q_off, k_off], causal=True,
         heads_checked=heads, tile_err=tile, tol=ATTN_TOL, max_abs_err=abs_err,
         lse_abs_err=lse_err, lse_tol=LSE_TOL, ok=ok)
    del q, k, v, do, o, lse, dq, dk, dv
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"{label}: kernel disagrees with the plain version")
    return tile


SP_SEQ = 32768  # batch 1 x 32768 tokens
SP_RUNS = {"phase": (4, 3), "full": (2, 2)}  # (layers, steps): --phase sp, the full run
# the sp = 2 losses against sp = 1's, absolute (bf16 GEMMs on half the
# rows, the ring's f32 merges where one kernel runs the whole row), and
# the first step's gradients against sp = 1's (``_grad_err``). On the
# H100 80GB HBM3 at 700 W, 4 layers: the sound ring and Ulysses read
# 1.68e-4 / 4.1e-5 and 0.016 / 0.0030; a ring that drops its remote hop
# (the control, ``run_sp``) 8.6e-4 and 1.30. Each limit sits between the
# two (PERF.md): the loss's 2.4x above the sound spread and 2.2x below
# the fault, the gradients' 6x above and 13x below.
SP_LOSS_TOL = 4e-4
SP_GRAD_TOL = 0.1
SP_SELECT = dict(sp=4, H=16, D=128, seqs=(4096, 8192))
SP_PROJ = 16  # seeded random projections of each gradient tensor (``_grad_prints``)


def sp_path_shapes(heads=32, sp=2, seq=SP_SEQ):
    """(label, H, T, q_off, k_off) of each attention call on the sp
    phase's path: the ring's two hops of the last block (keys before
    the queries, and the diagonal), Ulysses' whole sequence on H / sp
    heads, and sp = 1's."""
    T = seq // sp
    return [("sp path ring hop k<q", heads, T, T, 0),
            ("sp path ring hop diagonal", heads, T, T, T),
            ("sp path ulysses", heads // sp, seq, 0, 0),
            ("sp path sp=1", heads, seq, 0, 0)]


def _grad_prints(torch, grads, start=0):
    """Each gradient tensor's norm and its dot products with
    ``SP_PROJ`` seeded normal vectors: two runs' prints give an
    estimate of each tensor's ``|g_a - g_b| / |g_b|`` (``_grad_err``)
    without moving the gradients off the card. ``start``: the index of
    the first tensor in the whole list (the seeds follow the index)."""
    out = []
    for i, g in enumerate(grads, start):
        g = g.float().reshape(-1)
        gen = torch.Generator(device=g.device).manual_seed(7919 * i + 1)
        proj = [float(torch.dot(g, torch.randn(g.numel(), generator=gen, device=g.device)))
                for _ in range(SP_PROJ)]
        out.append((float(g.norm()), proj))
    return out


def _grad_errs(prints, ref):
    """Per tensor, the projections' rms difference over the reference
    tensor's norm (an estimate of ``|g - g_ref| / |g_ref|``: a projection
    on a standard normal vector has variance ``|d|^2``)."""
    return [float(np.sqrt(np.mean(np.square(np.subtract(p, r)))) / max(nr, 1e-30))
            for (_, p), (nr, r) in zip(prints, ref)]


def _grad_err(prints, ref):
    """The largest of ``_grad_errs`` and its tensor's index."""
    errs = _grad_errs(prints, ref)
    i = int(np.argmax(errs))
    return errs[i], i


def _dp_sp(torch, job, rank, world, spec_path):
    """``ElasticTrainer`` at Llama-2 width (d 4096, 32 heads of 128, ffn
    11008, vocab 32000), ``job["layers"]`` layers, batch 1 x ``SP_SEQ``,
    bf16, remat, per-leaf ``adamw_8bit``, on a mesh of ``job["sp"]``
    sequence ranks running ``job["scheme"]``; the weights from the
    trainer's seeded CPU generator (the same in every run). Returns the
    losses, step ms, this rank's peak, the sp transport's ms a step and
    the kernels' launches a step."""
    from dataclasses import replace

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.parallel import ring_attention, ulysses
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    cfg = replace(llama2_7b(), num_layers=job["layers"], max_seq_len=SP_SEQ,
                  sp_scheme=job["scheme"])
    losses, stamps = [], []

    def hook(step, metrics):
        if "loss" in metrics:
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    # the gradients' sum over sp (the default path's one all-reduce of
    # the tree), timed on the host with the card idle before and after
    from dlrover_tpu_torch.models import train as mtrain

    grad_sum = {"ms": 0.0}
    real_sum = mtrain._flat_all_reduce_mean

    def timed_sum(grads, group, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_sum(grads, group, n)
        torch.cuda.synchronize()
        grad_sum["ms"] += (time.perf_counter() - t) * 1e3
        return out

    mtrain._flat_all_reduce_mean = timed_sum
    real_visible = ring_attention._tile_visible
    if job.get("fault") == "drop_remote_hop":
        # the gates' control, planted here only: the ring skips every
        # hop but its own block's, forward and backward
        ring_attention._tile_visible = (lambda causal, mask, qo, tq, ko, tk:
                                        qo == ko and real_visible(causal, mask, qo, tq, ko, tk))
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    trainer = ElasticTrainer(
        cfg, build_optimizer("adamw_8bit", lr=3e-4, min_quantized_size=4096),
        RandomTokens(n=8, seq=SP_SEQ, vocab=cfg.vocab_size),
        TrainerConfig(batch_size=1, seq_len=SP_SEQ, report_metrics=False, log_interval=1),
        strategy=Strategy(mesh=MeshConfig(sp=job["sp"]), remat=True, opts=("bf16",)),
        metrics_hook=hook,
    )
    # the first step's gradients, read just before its update
    opt, prints = trainer.state.opt_state, []
    real_step = opt.step

    def step_and_print():
        if not prints:
            prints.extend(_grad_prints(
                torch, [p.grad for p in trainer.state.params.jax_ordered_parameters()]))
        return real_step()

    opt.step = step_and_print
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    for m in (ring_attention, ulysses):
        m.reset_comm()
    grad_sum["ms"] = 0.0
    t0 = time.perf_counter()
    try:
        trainer.train(job["steps"])
    finally:
        mtrain._flat_all_reduce_mean = real_sum
        ring_attention._tile_visible = real_visible
        opt.step = real_step
    steps = job["steps"]
    step_ms = [x * 1e3 for x in np.diff([t0] + stamps)]
    comm = ring_attention.comm if job["scheme"] == "ring" else ulysses.comm
    res = dict(
        sp=job["sp"], scheme=job["scheme"], layers=job["layers"], fault=job.get("fault"),
        losses=losses, grad_prints=prints,
        step_ms=step_ms, peak_bytes=torch.cuda.max_memory_allocated() - base,
        sp_comm_ms_per_step=comm["ms"] / steps, sp_transfers_per_step=comm["calls"] / steps,
        grad_sum_ms_per_step=grad_sum["ms"] / steps,
        sp_staged_through_host=comm["staged"] > 0,
        launches_per_step={k: v / steps for k, v in {**fa.launch_counts, **qo.launch_counts}.items()},
        launches={**fa.launch_counts, **qo.launch_counts},
    )
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sp_select_measure(torch, fa):
    """Per-device attention forward ms of each scheme, compute only (the
    device's time, from a replayed CUDA graph), at ``SP_SELECT``'s shape
    (causal, one row): the ring's busiest rank
    (the last sequence block: all ``sp`` hops, each one ``fa_fwd`` at its
    offsets, merged in f32 by ``merge_partials``) and Ulysses' one
    ``fa_fwd`` over the whole sequence for H / sp heads."""
    sp, H, D = SP_SELECT["sp"], SP_SELECT["H"], SP_SELECT["D"]
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    table = {}
    for S in SP_SELECT["seqs"]:
        T = S // sp
        q = torch.randn((1, T, H, D), generator=g, device=dev, dtype=bf)
        kv = [torch.randn((1, T, H, D), generator=g, device=dev, dtype=bf) for _ in range(2 * sp)]
        me = sp - 1

        def ring():
            o_acc = torch.zeros((1, T, H, D), dtype=torch.float32, device=dev)
            lse_acc = torch.full((1, H, T), fa.NEG_INF, dtype=torch.float32, device=dev)
            for j in range(sp):
                blk = (me - j) % sp
                o, lse = fa.flash_attention_fwd(q, kv[2 * blk], kv[2 * blk + 1], causal=True,
                                                q_offset=me * T, k_offset=blk * T)
                o_acc, lse_acc = fa.merge_partials(o_acc, lse_acc, o.float(), lse)
            return o_acc

        qu = torch.randn((1, S, H // sp, D), generator=g, device=dev, dtype=bf)
        ku = torch.randn((1, S, H // sp, D), generator=g, device=dev, dtype=bf)
        vu = torch.randn((1, S, H // sp, D), generator=g, device=dev, dtype=bf)
        # device time (a replayed CUDA graph): the ring's eager hops are
        # host-bound at these shapes, which is the wrapper, not the card
        table[S] = {"ring": graph_ms(torch, ring),
                    "ulysses": graph_ms(torch, lambda: fa.flash_attention_fwd(qu, ku, vu, causal=True))}
    return table


def run_sp(torch, fa, full=False):
    """The sp phase (``--phase sp``, and in the full run at fewer layers
    and steps): (a) the declared masks through the kernels
    (``run_masks``); (b) Llama-2 width training at 1 x ``SP_SEQ`` tokens,
    one process at sp = 1, then two gloo ranks on the one card at sp = 2
    with the ring and with Ulysses, the losses held to sp = 1's within
    ``SP_LOSS_TOL`` and the first step's gradients within
    ``SP_GRAD_TOL``, and a ring with a planted fault (its remote hop
    dropped, one step) that the gates must refuse; (c) the ``sp_select``
    table's measurement. Before (b), each kernel at the path's own
    shapes against the plain version (``check_attention_path``)."""
    t0 = time.perf_counter()
    masks = run_masks(torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    path = {label: check_attention_path(torch, fa, label, H, T, qo, ko)
            for label, H, T, qo, ko in sp_path_shapes()}
    layers, steps = SP_RUNS["full" if full else "phase"]
    job = dict(kind="sp", layers=layers, steps=steps)
    free_before = torch.cuda.mem_get_info()[0]  # what the runs' processes find
    sp2_jobs = [dict(job, name="ring", sp=2, scheme="ring"),
                dict(job, name="ulysses", sp=2, scheme="ulysses"),
                dict(job, name="ring_drop_hop", sp=2, scheme="ring", steps=1, fault="drop_remote_hop")]
    one = _dp_start("sp1", 1, [dict(job, name="sp1", sp=1, scheme="ring")], backend=None)
    if full:
        # the full run starts the pair beside sp = 1 (its step times are
        # then not timing-grade; ``--phase sp`` runs them apart)
        two = _dp_start("sp2", 2, sp2_jobs)
        try:
            one = one()[0]["sp1"]
        finally:
            two = two()
    else:
        one = one()[0]["sp1"]
        two = _dp_spawn("sp2", 2, sp2_jobs)
    ref = one.pop("grad_prints")
    runs = {"sp1": one}
    checks = {}
    for scheme in ("ring", "ulysses", "ring_drop_hop"):
        per_rank = [r[scheme] for r in two]
        prints = [r.pop("grad_prints") for r in per_rank]
        runs[scheme] = per_rank
        want = 1 if scheme == "ring_drop_hop" else steps
        diff = max(abs(a - b) for r in per_rank for a, b in zip(r["losses"], one["losses"]))
        grad_err, worst = _grad_err(prints[0], ref)
        same = all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
        finite = all(np.isfinite(r["losses"]).all() and len(r["losses"]) == want for r in per_rank)
        launched = all(r["launches"][k] > 0 for r in per_rank for k in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkdv"))
        passes = diff <= SP_LOSS_TOL and grad_err <= SP_GRAD_TOL
        checks[scheme] = dict(max_abs_loss_diff_vs_sp1=diff, tol=SP_LOSS_TOL,
                              first_step_grad_rel_err_vs_sp1=grad_err, worst_tensor=worst,
                              grad_tol=SP_GRAD_TOL, ranks_agree=same,
                              ranks_grads_agree=prints[1] == prints[0], passes_gates=passes,
                              ok=finite and same and launched and passes)
    # the control: the gates must refuse a ring that drops its remote hop
    fault = checks.pop("ring_drop_hop")
    fault["ok"] = not fault["passes_gates"]
    fault["loss_gate_alone_refuses"] = fault["max_abs_loss_diff_vs_sp1"] > SP_LOSS_TOL
    first_ok = abs(one["losses"][0] - float(np.log(32000))) <= 1.0
    table = sp_select_measure(torch, fa)
    from dlrover_tpu_torch.parallel import sp_select

    ok = first_ok and all(c["ok"] for c in checks.values()) and fault["ok"]
    emit("sp_train", seconds=time.perf_counter() - t0, seq=SP_SEQ, layers=layers, steps=steps,
         runs=runs, checks=checks, planted_fault=fault, path_shapes_tile_err=path,
         card_free_bytes_before_runs=free_before, sp1_beside_the_pair=full,
         first_loss_near_ln_vocab=first_ok,
         sp_select_measured_ms=table, sp_select_table_in_code=sp_select.MEASURED_MS,
         sp_select_picks={S: sp_select.pick_sp_scheme(S) for S in SP_SELECT["seqs"]},
         never_on_a_card=["NCCL sp hops", "sp > 2", "sp x dp"], ok=ok)
    if not ok:
        raise RuntimeError(f"the sp runs failed their checks: {checks}, the control: {fault}")
    return dict(masks=masks, runs=runs, table=table)


TP_SEQ = 4096  # batch 1 x 4096 tokens
TP_RUNS = {"phase": (4, 3), "full": (2, 2)}  # (layers, steps): --phase tp, the full run
# tp = 2's losses against tp = 1's, absolute, and the first step's
# gradients, gathered to whole leaves, against tp = 1's (``_grad_err``).
# On the H100 80GB HBM3 at 700 W, 4 layers x 3 steps: the sound run's
# first loss 5.6e-4 off tp = 1's (bf16 partial sums, each rounded once
# before the tp sum where tp = 1's GEMM rounds the whole sum once), its
# third 1.48e-2 off: from the second update on, the 8-bit AdamW's
# early steps (about lr x sign(g) an element) turn bf16 rounding into a
# different trajectory, as they do between bf16 and f32 runs of one
# layout (PERF.md). Its gradients 0.029 off (0.020 at 2 layers x 2
# steps); the control (layer 0's ``copy_to_tp`` without its backward
# sum) 0.87 off (0.66), its loss the sound run's (the forward is
# unchanged). So the loss gate sits 2x above the sound spread and
# refuses only gross errors; the gradient gate 3.4x above the sound run
# and 6.6x below the fault refuses the control.
TP_LOSS_TOL = 3e-2
TP_GRAD_TOL = 0.1
# one tp-local leaf the per-leaf 8-bit AdamW updates on the tp path:
# w_gate's box at Llama-2 width, tp = 2
TP_ADAM_SHAPE = (4096, 5504)


# the ep phase: Llama-2-7B's widths with Mixtral-8x7B's routing (8
# experts, top-2) in every second block, the JAX defaults' capacity
# factor 1.25, at EP_RUNS' depth
EP_SEQ = 4096  # batch 1 x 4096 tokens
EP_RUNS = {"phase": (4, 3), "full": (2, 2)}  # (layers, steps): --phase ep, the full run
EP_MOE = dict(num_experts=8, moe_top_k=2, moe_every=2, capacity_factor=1.25)
# ep = 2's losses against ep = 1's, absolute, and the first step's
# gradients (the experts gathered to whole leaves) against ep = 1's
# (``_grad_err``). ep = 2 runs ep = 1's products on the same rows: on the
# H100 80GB HBM3 at 700 W the sound runs read bitwise (losses 0.0 apart,
# gradients 0.0, at 4 layers x 3 steps and 2 x 2), the control (the
# first MoE layer's return exchange without its backward) 0.98-1.01. The
# gradient gate sits at 1e-4, far below the control and above an f32
# reordering's ~1e-6, so a partial exchange fault (a few misrouted
# slots, one expert's rows out of order) fails it. The loss gate stays
# tp's: past the first update the 8-bit AdamW's early steps turn any
# rounding difference into another trajectory.
EP_LOSS_TOL = 3e-2
EP_GRAD_TOL = 1e-4
# step 1's per-expert load and drop rate against ep = 1's: the first MoE
# layer's gating sees bitwise ep = 1's input; a later one's input may
# differ by the expert products' rounding, by a few tokens' routing
EP_ROUTE_TOL = 4.0 / EP_SEQ
# one expert box the per-leaf 8-bit AdamW updates on the ep path: w_up's
# 4 of 8 experts at Llama-2 width, ep = 2
EP_ADAM_SHAPE = (4, 4096, 11008)

# ROADMAP A19 on the card: MoE and ep composed with tp, fsdp and sp, four
# gloo ranks on the one card (``--phase ep``; the full run checks the
# kernels at their shapes, ``ep3d_kernel_checks``), each held to one
# ep = 1 process with the same gating: ep x tp and dp x tp
# route the same tokens as ep = 1 (tokens are replicated over tp);
# ep x fsdp and dp x tp run a row a data rank, as ep = 1 with
# ``grad_accum=2`` over the same two rows (each microbatch one shard's
# rows); ep x sp gates each half of a row on its own, which changes no
# routing at a capacity factor of E / k (``EP_SP_CAPACITY``: no token
# can drop), but its balance loss is the mean of the halves' terms.
EP3D_STEPS = 2
EP_SP_CAPACITY = float(EP_MOE["num_experts"] // EP_MOE["moe_top_k"])
# name: (mesh, rows, layers, the ep = 1 reference job, its control, more
# job fields, which the reference shares). Four ranks of ep x fsdp or ep x
# sp at 4 layers (17.6 / 18.5 GB each by the static model) ran the card
# out of memory (ep x fsdp in its reduce-scatter, ep x sp in its dense
# grads' ep sum): those runs, and their references, take 2 layers (one
# MoE layer). ``ep2_tp2_cap4`` is ep x tp's second witness: at the
# capacity of no drops (no token's slot can move) and on data seed 1,
# against an ep = 1 run of the same
EP3D = {
    "ep2_tp2": (dict(ep=2, tp=2), 1, 4, "ep1", "drop_moe_reduce_bwd", {}),
    "ep2_fsdp2": (dict(ep=2, fsdp=2), 2, 2, "ep1_accum", "unsummed_expert_rs", {}),
    "ep2_sp2": (dict(ep=2, sp=2), 1, 2, "ep1_cap4", "skip_expert_sp_sum",
                dict(capacity=EP_SP_CAPACITY)),
    "dp2_tp2": (dict(dp=2, tp=2), 2, 2, "ep1_accum", "drop_moe_reduce_bwd", {}),
    "ep2_tp2_cap4": (dict(ep=2, tp=2), 1, 2, "ep1_cap4_seed1", None,
                     dict(capacity=EP_SP_CAPACITY, seed=1)),
}
# the gates, by composition, against the reference job: the losses
# (absolute) and the first step's whole-leaf gradients (``_grad_err``),
# set from the first complete run (an H100 80GB HBM3 at 700 W; PERF.md):
# ep x tp read 6.96e-4 / 0.163 (a MoE gate: bf16 partial sums, a few
# tokens routed apart), its control 1.08; dp x tp 2.2e-3 / 0.127; ep x
# fsdp bitwise (each rank's row is a microbatch of the reference, the
# two summed in f32 in the same order), its control 0.775; ep x sp
# 3.0e-3 / 0.057 (the ring's merges, and the balance loss a mean of the
# two halves' terms), its control 0.777. Each gradient gate sits 2.5-3.5x
# above its sound reading and below its control; each loss gate 4-5x
# above its reading (two runs read the same digits), ep x fsdp's at 1e-4
# as ep = 2's. A control runs one step, whose loss precedes any update:
# only the gradient gate can refuse it. dp x tp's control and ep x tp's
# second witness (``ep2_tp2_cap4``, its gates tp's loss gate and ep x
# tp's gradient gate) were added after those runs: PERF.md gives their
# readings
EP3D_LOSS_TOL = {"ep2_tp2": 3e-3, "ep2_fsdp2": 1e-4, "ep2_sp2": 1.5e-2, "dp2_tp2": 1e-2,
                 "ep2_tp2_cap4": 3e-2}
EP3D_GRAD_TOL = {"ep2_tp2": 0.4, "ep2_fsdp2": 1e-4, "ep2_sp2": 0.2, "dp2_tp2": 0.4,
                 "ep2_tp2_cap4": 0.4}
# step 1's routing against the reference's, ``EP_ROUTE_TOL`` unless named:
# the second witness's first run (an H100 80GB HBM3 at 700 W) routed 5
# tokens of 4096 apart (per-expert load 1.22e-3), past the shared 4, its
# drop rates both 0: its gate was set from that reading
EP3D_ROUTE_TOL = {"ep2_tp2_cap4": 8.0 / EP_SEQ}
# the ep x tp expert box the per-leaf 8-bit AdamW updates: w_up's 4 of 8
# experts, 5504 of 11008 columns
EP_TP_ADAM_SHAPE = (4, 4096, 5504)
# one leaf the 4-bit AdamW (PyTorch, no kernel) updates, timed alone: an
# expert's w_up at Llama-2 width
ADAM4_SHAPE = (4096, 11008)


def _ep3d_faults(torch, job):
    """Plant ``job["fault"]``, a composed mesh's control (planted here
    only, on every rank), and return the function that takes it out:
    ``drop_moe_reduce_bwd``, the first MoE layer's ``reduce_from_tp``
    loses its backward (its forward is the tp sum; no gradient reaches
    the layer's experts, gate or tokens through it; the aux losses
    summed tp times, ``moe._tp_once`` an identity, change about 1 % of
    the gate's gradient at Llama-2 width: the CPU tests' f32 gate
    refuses that variant, the card's bf16 spread would not);
    ``unsummed_expert_rs``, the reduce-scatter of the first unit holding
    expert leaves (the first MoE layer) hands each fsdp rank its own
    unsummed rows; ``skip_expert_sp_sum``, the expert leaves' sum over
    the replica group (under ep x sp, the sp sum) is skipped."""
    from dlrover_tpu_torch.models import train as mt
    from dlrover_tpu_torch.models import transformer as tfm
    from dlrover_tpu_torch.parallel import grad_sync

    fault = job.get("fault")
    real_zs, real_sync = mt.zero_scatter, grad_sync.sync_ep_grads
    real_rs, real_ar = grad_sync._reduce_scatter, grad_sync._all_reduce
    real_reduce, real_moe = tfm.reduce_from_tp, tfm._moe_block
    if fault == "drop_moe_reduce_bwd":
        class NoBackward(torch.autograd.Function):
            """The tp sum forward, no gradient backward."""

            @staticmethod
            def forward(ctx, x, group):
                return tfm._tp_sum(x, group)

            @staticmethod
            def backward(ctx, g):
                return torch.zeros_like(g), None

        first = []

        def faulty_moe(h, params, cfg, mesh=None):
            if first and params is not first[0]:
                return real_moe(h, params, cfg, mesh)
            first[:1] = [params]
            tfm.reduce_from_tp = lambda x, group: NoBackward.apply(x, group)
            try:
                return real_moe(h, params, cfg, mesh)
            finally:
                tfm.reduce_from_tp = real_reduce

        tfm._moe_block = faulty_moe
    if fault == "unsummed_expert_rs":
        done = []

        def zero_scatter(grads, idx, units, mesh, n_data, over=("dp",)):
            leaves = units.state.params.jax_ordered_parameters()
            names = {id(p): n for n, p in units.state.params.named_parameters()}
            expert = any(".moe.w_" in names[id(leaves[i])] for i in idx)
            if not expert or done:
                return real_zs(grads, idx, units, mesh, n_data, over)
            done.append(True)

            class Done:
                def wait(self):
                    pass

            def own_rows(inp, group):
                n = torch.distributed.get_world_size(group)
                return inp.view(n, -1)[torch.distributed.get_rank(group)].clone(), Done()

            grad_sync._reduce_scatter = own_rows
            try:
                return real_zs(grads, idx, units, mesh, n_data, over)
            finally:
                grad_sync._reduce_scatter = real_rs

        mt.zero_scatter = zero_scatter
    if fault == "skip_expert_sp_sum":
        def sync_ep_grads(grads, mesh, plan, expert_ids, *a, **kw):
            # the expert leaves are summed in place (f32 grads: the same
            # storage): skip the all-reduces of that storage
            experts = {grads[i].data_ptr() for i in expert_ids}

            class Done:
                def wait(self):
                    pass

            def all_reduce(t, group, op=None):
                return Done() if t.data_ptr() in experts else real_ar(t, group, op)

            grad_sync._all_reduce = all_reduce
            try:
                return real_sync(grads, mesh, plan, expert_ids, *a, **kw)
            finally:
                grad_sync._all_reduce = real_ar

        grad_sync.sync_ep_grads = sync_ep_grads

    def undo():
        mt.zero_scatter, grad_sync.sync_ep_grads = real_zs, real_sync
        grad_sync._reduce_scatter, grad_sync._all_reduce = real_rs, real_ar
        tfm.reduce_from_tp, tfm._moe_block = real_reduce, real_moe

    return undo


def _dp_tp(torch, job, rank, world, spec_path):
    """``ElasticTrainer`` at Llama-2 width (d 4096, 32 heads of 128, kv
    32, ffn 11008, vocab 32000), ``job["layers"]`` layers, batch
    ``job["rows"]`` (default 1) x ``TP_SEQ``, bf16, remat, per-leaf
    ``adamw_8bit``, on a mesh of ``job["tp"]`` tensor-parallel ranks, or
    with ``job["ep"]`` of a MoE model (``EP_MOE``, its capacity factor
    ``job["capacity"]`` when given) on ``job["ep"]`` expert-parallel
    ranks, or on the composed mesh ``job["mesh"]`` (a MoE model, ROADMAP
    A19: ep x tp, ep x fsdp, ep x sp, dp x tp), with
    ``job["grad_accum"]``; the weights from the trainer's seeded CPU
    generator (one process's weights, each rank keeping its boxes).
    Returns the losses, step ms, this rank's peak beside its static
    figure, the tp all-reduces' and the ep all-to-alls' number and host
    ms a step, the first step's gradient prints of the whole leaves
    (gathered over fsdp, tp and ep), a MoE model's routing stats of each
    step, and the kernels' launches a step. ``job["fault"]``: the gates'
    control, planted here only: ``drop_copy_bwd``, layer 0's attention
    ``copy_to_tp`` loses its backward all-reduce (its forward is the
    identity either way); ``drop_return_bwd``, the first MoE layer's
    return all-to-all loses its backward exchange (each rank keeps its
    own gradient rows); the composed meshes' (``_ep3d_faults``)."""
    from dataclasses import replace

    from dlrover_tpu_torch.accel.dry_runner import _apply_strategy, static_peak_bytes
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.models import transformer as tfm
    from dlrover_tpu_torch.models.convert import _splits, whole_leaf
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.parallel import moe
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    moe_run = "ep" in job or "mesh" in job
    mesh_sizes = job.get("mesh") or ({"ep": job["ep"]} if "ep" in job else {"tp": job["tp"]})
    seq = EP_SEQ if moe_run else TP_SEQ
    rows, ga = job.get("rows", 1), job.get("grad_accum", 1)
    moe_cfg = dict(EP_MOE, capacity_factor=job.get("capacity", EP_MOE["capacity_factor"]))
    cfg = replace(llama2_7b(), num_layers=job["layers"], max_seq_len=seq,
                  **(moe_cfg if moe_run else {}))
    tx = build_optimizer("adamw_8bit", lr=3e-4, min_quantized_size=4096)
    strategy = Strategy(mesh=MeshConfig(**mesh_sizes), remat=True, opts=("bf16",),
                        grad_accum=ga)
    losses, stamps, routes = [], [], []

    def hook(step, metrics):
        if "loss" in metrics:
            losses.append(float(metrics["loss"]))
            if "moe_expert_load" in metrics:
                routes.append(dict(load=metrics["moe_expert_load"].tolist(),
                                   drop_rate=float(metrics["moe_drop_rate"]),
                                   balance=float(metrics["moe_balance_loss"]),
                                   z=float(metrics["moe_z_loss"])))
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    trainer = ElasticTrainer(
        cfg, tx, RandomTokens(n=8 * rows, seq=seq, vocab=cfg.vocab_size, seed=job.get("seed", 0)),
        TrainerConfig(batch_size=rows, seq_len=seq, grad_accum=ga, report_metrics=False,
                      log_interval=1),
        strategy=strategy, metrics_hook=hook,
    )
    cfg2, applied = _apply_strategy(trainer.strategy, cfg)
    static = static_peak_bytes(cfg2, applied, tx, rows, seq)
    mesh = trainer.mesh
    real_block, real_moe = tfm._attention_block, tfm._moe_block
    first = trainer.state.params.layers[0]
    first_moe = next((l.moe for l in trainer.state.params.layers if hasattr(l, "moe")), None)
    if job.get("fault") == "drop_copy_bwd":
        def faulty_block(x, layer, cfg, positions, mesh=None):
            if layer is not first:
                return real_block(x, layer, cfg, positions, mesh)
            real_copy = tfm.copy_to_tp
            tfm.copy_to_tp = lambda h, group: h  # the forward's identity, no backward sum
            try:
                return real_block(x, layer, cfg, positions, mesh)
            finally:
                tfm.copy_to_tp = real_copy

        tfm._attention_block = faulty_block
    if job.get("fault") == "drop_return_bwd":
        from dlrover_tpu_torch.parallel.collectives import all_to_all

        class NoBackward(torch.autograd.Function):
            """The return exchange, its backward the identity."""

            @staticmethod
            def forward(ctx, x, group):
                return all_to_all(x.contiguous(), group, moe.comm)

            @staticmethod
            def backward(ctx, g):
                return g, None

        def faulty_moe(h, params, cfg, mesh=None):
            if params is not first_moe:
                return real_moe(h, params, cfg, mesh)
            real_a2a, calls = moe._EpAllToAll, []

            class Swap:
                """The layer's second exchange (the return) without its
                backward; the forward's and the recompute's alike."""

                @staticmethod
                def apply(x, group):
                    calls.append(1)
                    return (NoBackward if len(calls) == 2 else real_a2a).apply(x, group)

            moe._EpAllToAll = Swap
            try:
                return real_moe(h, params, cfg, mesh)
            finally:
                moe._EpAllToAll = real_a2a

        tfm._moe_block = faulty_moe
    undo_faults = _ep3d_faults(torch, job)
    # the first step's gradients, gathered leaf by leaf to whole leaves
    # just before its update (from the ZeRO shards' grads under ep x
    # fsdp); the peak is read around the gathering (its transient copies
    # are not the step's)
    opt, prints, peaks, leaf_names = trainer.state.opt_state, [], [], []
    real_step = opt.step

    def step_and_print():
        if not prints:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            state = trainer.state
            model = state.params
            names = {id(p): n for n, p in model.named_parameters()}
            params = model.jax_ordered_parameters()
            holders = state.shards if state.shards is not None else params
            splits = _splits(model, mesh)
            leaf_names.extend(names[id(p)] for p in params)
            for i, (p, h) in enumerate(zip(params, holders)):
                g = whole_leaf(h.grad.float(), names[id(p)], model, mesh, splits)
                prints.extend(_grad_prints(torch, [g], start=i))
                del g
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if job.get("trace"):  # from here on: the step's own allocations
                torch.cuda.memory._record_memory_history(max_entries=200000)
        return real_step()

    opt.step = step_and_print
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    tfm.reset_tp_comm()
    moe.reset_comm()
    t0 = time.perf_counter()
    try:
        trainer.train(job["steps"])
    finally:
        tfm._attention_block, tfm._moe_block = real_block, real_moe
        undo_faults()
        opt.step = real_step
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated() - base)
    live_at_peak = None
    if job.get("trace"):
        live_at_peak = _live_at_peak(torch.cuda.memory._snapshot())
        torch.cuda.memory._record_memory_history(enabled=None)
    steps = job["steps"]
    res = dict(
        live_at_peak=live_at_peak, resident_bytes=torch.cuda.memory_allocated() - base,
        layers=job["layers"], fault=job.get("fault"), losses=losses,
        grad_prints=prints, leaf_names=leaf_names,
        step_ms=[x * 1e3 for x in np.diff([t0] + stamps)],
        peak_bytes=max(peaks), peaks_before_and_after_prints=peaks, static_peak_bytes=static,
        static_vs_measured=static / max(peaks) - 1, mesh=mesh_sizes, rows=rows, grad_accum=ga,
        coords=dict(mesh.coords), zero=trainer.state.shards is not None,
        backend=None if world == 1 else torch.distributed.get_backend(),
        launches_per_step={k: v / steps for k, v in {**fa.launch_counts, **qo.launch_counts}.items()},
        launches={**fa.launch_counts, **qo.launch_counts},
        tp_allreduces_per_step=tfm.tp_comm["calls"] / steps,
        tp_allreduces_ms_per_step=tfm.tp_comm["ms"] / steps,
        ep_alltoalls_per_step=moe.comm["calls"] / steps,
        ep_alltoalls_ms_per_step=moe.comm["ms"] / steps,
        **{a: n for a, n in mesh_sizes.items()},
    )
    if moe_run:
        res.update(routing=routes, ep_alltoalls_staged=moe.comm["staged"],
                   capacity_factor=cfg.capacity_factor)
    trainer.close()
    del trainer, opt, first, first_moe
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tp_jobs(full):
    layers, steps = TP_RUNS["full" if full else "phase"]
    job = dict(kind="tp", layers=layers, steps=steps)
    # ``--phase tp`` records what is live at each run's peak
    return ([dict(job, name="tp1", tp=1, trace=not full)],
            [dict(job, name="tp2", tp=2, trace=not full),
             dict(job, name="tp2_drop_copy_bwd", tp=2, steps=1, fault="drop_copy_bwd")])


def _ep_jobs(full):
    """(the ep = 1 process's jobs, the pair's): ep = 1, and under
    ``--phase ep`` the references at the capacity of no drops (``EP3D``:
    ep x sp's, ep x tp's second witness's); ep = 2 and its control. ``_ep_accum_job`` is the other
    reference, run alone (33 GB: beside the pair's 2 x 18.5 GB it ran
    the card out of memory)."""
    layers, steps = EP_RUNS["full" if full else "phase"]
    job = dict(kind="tp", layers=layers, steps=steps)
    one = [dict(job, name="ep1", ep=1, trace=not full)]
    if not full:
        # the references at the capacity of no drops
        one += [dict(job, name=ref, ep=1, layers=layers, steps=EP3D_STEPS, **extra)
                for _, _, layers, ref, _, extra in EP3D.values() if "capacity" in extra]
    return (one,
            [dict(job, name="ep2", ep=2, trace=not full),
             dict(job, name="ep2_drop_return_bwd", ep=2, steps=1, fault="drop_return_bwd")])


def _ep_accum_job():
    """ep x fsdp's and dp x tp's reference (``EP3D``): ep = 1 over two rows
    in two microbatches (``grad_accum=2``), each microbatch one data
    rank's row."""
    return dict(kind="tp", name="ep1_accum", ep=1, layers=EP3D["ep2_fsdp2"][2],
                steps=EP3D_STEPS, rows=2, grad_accum=2)


def _ep3d_jobs():
    """The four ranks' jobs (``EP3D``, ROADMAP A19): each composition at
    its depth, ``EP3D_STEPS`` steps, then its control (one step)."""
    jobs = []
    for name, (mesh, rows, layers, _, fault, extra) in EP3D.items():
        job = dict(kind="tp", name=name, mesh=mesh, rows=rows, layers=layers, steps=EP3D_STEPS,
                   **extra)
        jobs.append(job)
        if fault:
            jobs.append(dict(job, name=f"{name}_{fault}", steps=1, fault=fault))
    return jobs


def _split_checks(one, two, axis, steps, loss_tol, grad_tol, kernels):
    """The tp (ep) runs' gates: each two-rank run's losses against the
    one-process run's within ``loss_tol``, its first step's gradients
    within ``grad_tol`` (``_grad_err``), the ranks agreeing, the kernels
    launched, each rank's peak within ``PEAK_CAL_RTOL`` of its static
    figure; the planted fault's run must fail the two gates together."""
    ref = one.pop("grad_prints")
    one.pop("leaf_names")
    runs = {f"{axis}1": one}
    checks = {}
    for name in two[0]:
        per_rank = [r[name] for r in two]
        prints = [r.pop("grad_prints") for r in per_rank]
        for r in per_rank:
            r.pop("leaf_names")
        runs[name] = per_rank
        want = 1 if per_rank[0]["fault"] else steps
        diff = max(abs(a - b) for r in per_rank for a, b in zip(r["losses"], one["losses"]))
        grad_err, worst = _grad_err(prints[0], ref)
        same = all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
        finite = all(np.isfinite(r["losses"]).all() and len(r["losses"]) == want for r in per_rank)
        launched = all(r["launches"].get(k, 0) > 0 for r in per_rank for k in kernels)
        peaks_ok = all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL for r in per_rank)
        passes = diff <= loss_tol and grad_err <= grad_tol
        checks[name] = {f"max_abs_loss_diff_vs_{axis}1": diff, "tol": loss_tol,
                        f"first_loss_diff_vs_{axis}1": abs(per_rank[0]["losses"][0]
                                                          - one["losses"][0]),
                        f"first_step_grad_rel_err_vs_{axis}1": grad_err, "worst_tensor": worst,
                        "grad_tol": grad_tol, "ranks_agree": same,
                        "ranks_grads_agree": prints[1] == prints[0], "passes_gates": passes,
                        "peaks_within_static": peaks_ok,
                        "ok": finite and same and launched and passes and peaks_ok}
    fault = checks.pop(next(n for n in runs if n != f"{axis}1" and runs[n][0]["fault"]))
    fault["ok"] = not fault["passes_gates"]
    fault["loss_gate_alone_refuses"] = fault[f"max_abs_loss_diff_vs_{axis}1"] > loss_tol
    return runs, checks, fault


def _tp_line(t0, one, two, adam, free_before, full):
    layers, steps = TP_RUNS["full" if full else "phase"]
    runs, checks, fault = _split_checks(one, two, "tp", steps, TP_LOSS_TOL, TP_GRAD_TOL,
                                        ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkdv", "adam8_leaf"))
    first_ok = abs(one["losses"][0] - float(np.log(32000))) <= 1.0
    one_peak_ok = abs(one["static_vs_measured"]) <= PEAK_CAL_RTOL
    same_launches = all(r["launches_per_step"] == one["launches_per_step"] for r in runs["tp2"])
    ok = (first_ok and one_peak_ok and same_launches and all(c["ok"] for c in checks.values())
          and fault["ok"] and adam["ok"])
    emit("tp_train", seconds=time.perf_counter() - t0, seq=TP_SEQ, layers=layers, steps=steps,
         runs=runs, checks=checks, planted_fault=fault, peak_cal_rtol=PEAK_CAL_RTOL,
         tp1_peak_within_static=one_peak_ok, launches_as_tp1=same_launches,
         card_free_bytes_before_runs=free_before, tp1_beside_the_pair=True,
         first_loss_near_ln_vocab=first_ok, adam8_leaf_tp_local=adam,
         transport="gloo all_reduce of CUDA tensors in f32, staged by gloo through pinned host "
                   "memory (two ranks share the one card)",
         never_on_a_card=["tp over NCCL", "tp > 2", "dp x tp", "sp x tp", "3d (dp x fsdp x tp)"],
         ok=ok)
    if not ok:
        raise RuntimeError(f"the tp runs failed their checks: {checks}, the control: {fault}")
    return dict(runs=runs, adam=adam)


def _ep_line(t0, one, two, adam, free_before, full):
    layers, steps = EP_RUNS["full" if full else "phase"]
    runs, checks, fault = _split_checks(one, two, "ep", steps, EP_LOSS_TOL, EP_GRAD_TOL,
                                        ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkdv", "adam8_leaf"))
    first_ok = abs(one["losses"][0] - float(np.log(32000))) <= 1.0
    one_peak_ok = abs(one["static_vs_measured"]) <= PEAK_CAL_RTOL
    same_launches = all(r["launches_per_step"] == one["launches_per_step"] for r in runs["ep2"])
    # step 1's routing: the gating is replicated over ep
    r1 = one["routing"][0]
    route_diff = max(max(abs(a - b) for a, b in zip(r["routing"][0]["load"], r1["load"]))
                     for r in runs["ep2"])
    drop_diff = max(abs(r["routing"][0]["drop_rate"] - r1["drop_rate"]) for r in runs["ep2"])
    route_ok = route_diff <= EP_ROUTE_TOL and drop_diff <= EP_ROUTE_TOL
    # 2 exchanges forward, their 2 transposes, and under remat the
    # recompute's 2 again: 6 a MoE layer a step
    from dlrover_tpu_torch.models.config import num_moe_layers
    from dlrover_tpu_torch.models import llama2_7b
    from dataclasses import replace

    n_moe = num_moe_layers(replace(llama2_7b(), num_layers=layers, **EP_MOE))
    a2a_ok = all(r["ep_alltoalls_per_step"] == 6 * n_moe for r in runs["ep2"])
    ok = (first_ok and one_peak_ok and same_launches and route_ok and a2a_ok
          and all(c["ok"] for c in checks.values()) and fault["ok"] and adam["ok"])
    emit("ep_train", seconds=time.perf_counter() - t0, seq=EP_SEQ, layers=layers, steps=steps,
         moe=EP_MOE, moe_layers=n_moe, runs=runs, checks=checks, planted_fault=fault,
         peak_cal_rtol=PEAK_CAL_RTOL, ep1_peak_within_static=one_peak_ok,
         launches_as_ep1=same_launches, step1_load_max_diff_vs_ep1=route_diff,
         step1_drop_rate_diff_vs_ep1=drop_diff, route_tol=EP_ROUTE_TOL,
         alltoalls_per_step_expected=6 * n_moe, alltoalls_ok=a2a_ok,
         card_free_bytes_before_runs=free_before, ep1_beside_the_pair=True,
         first_loss_near_ln_vocab=first_ok, adam8_leaf_expert_box=adam,
         transport="gloo all_to_all_single of CUDA tensors, staged by gloo through host memory "
                   "(two ranks share the one card)",
         never_on_a_card=["NCCL all-to-all", "ep > 2", "dp > 1 x ep", "ep x fsdp / tp / sp"],
         ok=ok)
    if not ok:
        raise RuntimeError(f"the ep runs failed their checks: {checks}, the control: {fault}")
    return dict(runs=runs, adam=adam)


def _ep3d_line(t0, refs, four, kernels, free_before):
    """The composed meshes' gates (``EP3D``): each run's losses against
    its ep = 1 reference's within ``EP3D_LOSS_TOL``, its first step's
    whole-leaf gradients (the ZeRO shards, tp and ep boxes gathered)
    within ``EP3D_GRAD_TOL``, step 1's routing (per-expert load, drop
    rate) within ``EP_ROUTE_TOL``, the ranks agreeing, each rank's peak
    within ``PEAK_CAL_RTOL`` of ``static_peak_bytes``, the kernels
    launched, and the collectives a step the reckoned ones: 6 ep
    all-to-alls a MoE layer and microbatch (remat) under ep, and under
    tp 5 all-reduces a layer, 1 more a MoE layer (the gate's), 4 around
    the split vocab. Each control must fail the two gates together."""
    from dataclasses import replace

    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.models.config import num_moe_layers

    runs, checks, faults = {}, {}, {}
    kernel_names = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkdv", "adam8_leaf")
    for name in four[0]:
        per_rank = [r[name] for r in four]
        fault = per_rank[0]["fault"]
        base = name[:-len(fault) - 1] if fault else name
        mesh, rows, _, ref_name, _, _ = EP3D[base]
        ref = refs[ref_name]
        layers = per_rank[0]["layers"]
        n_moe = num_moe_layers(replace(llama2_7b(), num_layers=layers, **EP_MOE))
        prints = [r.pop("grad_prints") for r in per_rank]
        runs[name] = per_rank
        want = 1 if fault else EP3D_STEPS
        n = min(len(per_rank[0]["losses"]), len(ref["losses"]))
        diff = max(abs(a - b) for r in per_rank for a, b in zip(r["losses"][:n], ref["losses"][:n]))
        errs = _grad_errs(prints[0], ref["grad_prints"])
        grad_err = max(errs)
        # the five leaves furthest from the reference's, by name
        names = [r.pop("leaf_names") for r in per_rank][0]
        top = sorted(zip(errs, names), reverse=True)[:5]
        r1, w1 = per_rank[0]["routing"][0], ref["routing"][0]
        route_diff = max(abs(a - b) for a, b in zip(r1["load"], w1["load"]))
        drop_diff = abs(r1["drop_rate"] - w1["drop_rate"])
        ga = per_rank[0]["grad_accum"]
        a2a_want = 6 * n_moe * ga if mesh.get("ep", 1) > 1 else 0
        tp_want = ga * (5 * layers + n_moe + 4) if mesh.get("tp", 1) > 1 else 0
        comm_ok = all(r["ep_alltoalls_per_step"] == a2a_want
                      and r["tp_allreduces_per_step"] == tp_want for r in per_rank)
        passes = diff <= EP3D_LOSS_TOL[base] and grad_err <= EP3D_GRAD_TOL[base]
        route_tol = EP3D_ROUTE_TOL.get(base, EP_ROUTE_TOL)
        c = {"max_abs_loss_diff_vs_ref": diff, "reference": ref_name,
             "tol": EP3D_LOSS_TOL[base], "first_loss_diff_vs_ref":
                 abs(per_rank[0]["losses"][0] - ref["losses"][0]),
             "first_step_grad_rel_err_vs_ref": grad_err,
             "furthest_leaves": [[n, e] for e, n in top],
             "grad_tol": EP3D_GRAD_TOL[base], "passes_gates": passes,
             "step1_load_max_diff_vs_ref": route_diff, "step1_drop_rate_diff_vs_ref": drop_diff,
             "balance_vs_ref": [r1["balance"], w1["balance"]],
             "alltoalls_per_step": [r["ep_alltoalls_per_step"] for r in per_rank],
             "tp_allreduces_per_step": [r["tp_allreduces_per_step"] for r in per_rank],
             "reckoned": dict(alltoalls=a2a_want, tp_allreduces=tp_want)}
        if fault:
            c["ok"] = not passes
            c["loss_gate_alone_refuses"] = diff > EP3D_LOSS_TOL[base]
            faults[name] = c
            continue
        c.update(
            ranks_agree=all(r["losses"] == per_rank[0]["losses"] for r in per_rank),
            ranks_grads_agree=all(p == prints[0] for p in prints),
            route_ok=max(route_diff, drop_diff) <= route_tol, route_tol=route_tol,
            comm_ok=comm_ok,
            peaks_within_static=all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL
                                    for r in per_rank),
            launched=all(r["launches"].get(k, 0) > 0 for r in per_rank for k in kernel_names))
        finite = all(np.isfinite(r["losses"]).all() and len(r["losses"]) == want
                     for r in per_rank)
        c["ok"] = (finite and passes and c["ranks_agree"] and c["ranks_grads_agree"]
                   and c["route_ok"] and comm_ok and c["peaks_within_static"] and c["launched"])
        checks[name] = c
    refs_ok = all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL for r in refs.values())
    ok = (all(c["ok"] for c in checks.values()) and all(c["ok"] for c in faults.values())
          and refs_ok and kernels["ok"])
    emit("ep3d_train", seconds=time.perf_counter() - t0, seq=EP_SEQ, steps=EP3D_STEPS,
         moe=EP_MOE, sp_capacity=EP_SP_CAPACITY, runs=runs, checks=checks,
         planted_faults=faults, peak_cal_rtol=PEAK_CAL_RTOL, route_tol=EP_ROUTE_TOL,
         references={k: dict(losses=v["losses"], routing=v["routing"][:1],
                             peak_bytes=v["peak_bytes"], static_vs_measured=v["static_vs_measured"],
                             step_ms=v["step_ms"])
                     for k, v in refs.items()},
         references_peaks_within_static=refs_ok, kernels=kernels,
         card_free_bytes_before_runs=free_before,
         transport="gloo all_reduce / all_to_all_single / reduce_scatter of CUDA tensors, "
                   "staged through host memory (four ranks share the one card)",
         never_on_a_card=["NCCL at world > 1", "any link between cards", "ep x tp x fsdp",
                          "ep x sp x tp", "ep x sp under Ulysses", "MoE at dp x sp", "ep > 2",
                          "tp > 2 with MoE", "an ep x tp or ep x fsdp checkpoint or resize",
                          "moe_rebalance_interval", "the 3d / tp plans with MoE"],
         ok=ok)
    if not ok:
        raise RuntimeError(f"the composed MoE runs failed their checks: {checks}, "
                           f"the controls: {faults}")
    return dict(runs=runs, checks=checks)


def ep3d_kernel_checks(torch, fa, qo, full=False):
    """The kernels at the composed meshes' shapes: the attention kernels
    on a tp rank's 16 of 32 heads at 1 x 4096 (ep x tp, dp x tp), on the
    ring's blocks of 2048 rows under ep x sp (``--phase ep``: the hop of
    earlier keys and the diagonal), ``adam8_leaf`` at the ep x tp expert
    box (``EP_TP_ADAM_SHAPE``), and (``--phase ep``) the 4-bit AdamW's
    update on one leaf (``ADAM4_SHAPE``), timed alone."""
    tp_heads, errs = check_attention(torch, fa, "B3-B5 Llama-2 width, 16 tp-local heads (ep x tp)",
                                     1, 16, 16, EP_SEQ, 128)
    out = dict(tp_heads=dict(ms=tp_heads["ms"], plain_ms=tp_heads["plain_ms"],
                             bound=tp_heads["bound"], library_ms=tp_heads["library_ms"],
                             max_abs_err=errs))
    ok = tp_heads["ok"]
    if not full:
        half = EP_SEQ // 2
        for key, k_off in (("ring_hop_earlier_keys", 0), ("ring_diagonal", half)):
            r, e = check_attention(torch, fa, f"B3-B5 ep x sp {key} ({half} rows)",
                                   1, 32, 32, half, 128, q_off=half, k_off=k_off)
            out[key] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bound=r["bound"],
                            library_ms=r["library_ms"], max_abs_err=e)
            ok = ok and r["ok"]
    adam, _ = check_adam8_leaf(torch, qo, None, EP_TP_ADAM_SHAPE,
                               "B7 adam8_leaf ep x tp expert box w_up (ep=2 x tp=2)")
    out["adam8_ep_tp_box"] = {k: adam[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    ok = ok and adam["ok"]
    if not full:
        out["adam4_leaf"] = time_adam4_leaf(torch, qo, ADAM4_SHAPE)
    gc.collect()
    torch.cuda.empty_cache()
    out["ok"] = ok
    return out


def time_adam4_leaf(torch, qo, shape):
    """The 4-bit AdamW's update (``_adam4_update_plain``, PyTorch: the
    JAX package has no Pallas kernel for it) on one leaf of ``shape``,
    timed alone, and its byte bound: the f32 gradient read, the nibble
    first moment and int8 second moment read and written, the f32 delta
    written, two scales a block read and written."""
    dev = torch.device("cuda")
    R = int(np.prod(shape)) // qo.BLOCK
    g = torch.Generator(device=dev).manual_seed(5)
    grads = torch.randn((R, qo.BLOCK), generator=g, device=dev) * 1e-3
    mq = qo.Quantized4(torch.full((R, qo.BLOCK // 2), 0x88, dtype=torch.uint8, device=dev),
                       torch.zeros((R,), device=dev), (R * qo.BLOCK,), True)
    vq = qo.Quantized8(torch.zeros((R, qo.BLOCK), dtype=torch.int8, device=dev),
                       torch.zeros((R,), device=dev), (R * qo.BLOCK,), False)
    scalars = (3e-4 / (1 - 0.9), 1 / (1 - 0.999), 1e-8)
    delta = qo._adam4_update_plain(grads, mq, vq, scalars, 0.9, 0.999, True)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(delta).all())
    ms = time_ms(torch, lambda: qo._adam4_update_plain(grads, mq, vq, scalars, 0.9, 0.999, True),
                 iters=10)
    n = R * qo.BLOCK
    nbytes = n * (4 + 1 + 2 + 4) + 4 * R * 4
    b_ms, b_by = bound(nbytes, 60 * n, F32_OPS)
    res = dict(shape=list(shape), ms=ms, bound_ms=b_ms, bound_by=b_by, finite=finite,
               route="pytorch (no Pallas site)")
    emit("adam4_leaf", **res)
    del grads, mq, vq, delta
    torch.cuda.empty_cache()
    if not finite:
        raise RuntimeError("the 4-bit AdamW's update is not finite")
    return res


def _split_runs(torch, label, one_jobs, two_jobs):
    """One process of ``one_jobs`` beside two gloo ranks of
    ``two_jobs`` on the one card; each's results by job name."""
    free_before = torch.cuda.mem_get_info()[0]
    one = _dp_start(f"{label}1", 1, one_jobs, backend=None)
    two = _dp_start(f"{label}2", 2, two_jobs)
    try:
        one = one()[0]
    finally:
        two = two()
    return one, two, free_before


def run_tp(torch, qo, full=False):
    """The tp phase (``--phase tp``): ``adam8_leaf`` against its plain
    version at a tp-local leaf's shape (``TP_ADAM_SHAPE``), then Llama-2
    width training at 1 x ``TP_SEQ`` tokens, one process at tp = 1 beside
    two gloo ranks on the one card at tp = 2 (the same seeded weights and
    data): tp = 2's losses within ``TP_LOSS_TOL`` of tp = 1's and the
    first step's whole-leaf gradients within ``TP_GRAD_TOL``, each
    rank's peak within ``PEAK_CAL_RTOL`` of ``static_peak_bytes``; then,
    in the same two ranks, one step with a planted fault (layer 0's
    ``copy_to_tp`` without its backward all-reduce) that the two gates
    together must refuse."""
    t0 = time.perf_counter()
    adam, _ = check_adam8_leaf(torch, qo, None, TP_ADAM_SHAPE,
                               "B7 adam8_leaf tp-local w_gate (tp=2)")
    gc.collect()
    torch.cuda.empty_cache()
    one_jobs, two_jobs = _tp_jobs(full)
    one, two, free = _split_runs(torch, "tp", one_jobs, two_jobs)
    return _tp_line(t0, one["tp1"], [{k: v for k, v in r.items()} for r in two], adam, free, full)


def run_ep(torch, fa, qo, full=False):
    """The ep phase (``--phase ep``): ``adam8_leaf`` against its plain
    version at an expert box's shape (``EP_ADAM_SHAPE``) and the composed
    meshes' kernel checks (``ep3d_kernel_checks``), then a MoE
    model at Llama-2 width (``EP_MOE``: 8 experts, top-2, every second
    block) at 1 x ``EP_SEQ`` tokens, one process at ep = 1 beside two
    gloo ranks on the one card at dp 1 x ep 2 (the same seeded weights
    and data): ep = 2's losses within ``EP_LOSS_TOL`` of ep = 1's, the
    first step's whole-leaf gradients within ``EP_GRAD_TOL``, step 1's
    routing stats within ``EP_ROUTE_TOL``, 6 ep all-to-alls a MoE layer
    a step (remat), each rank's peak within ``PEAK_CAL_RTOL`` of
    ``static_peak_bytes``; then, in the same two ranks, one step with
    the first MoE layer's return exchange stripped of its backward,
    which the two gates together must refuse. The ep = 1 process also
    runs the references at the capacity of no drops (``_ep_jobs``); once
    it and the pair are done, one process runs the two-row reference
    (``_ep_accum_job``),
    then four gloo ranks run ROADMAP A19's meshes (``EP3D``:
    ep 2 x tp 2, ep 2 x fsdp 2, ep 2 x sp 2, MoE at dp 2 x tp 2, each
    with its control, and ep x tp's second witness) under
    ``_ep3d_line``'s gates."""
    t0 = time.perf_counter()
    adam, _ = check_adam8_leaf(torch, qo, None, EP_ADAM_SHAPE,
                               "B7 adam8_leaf expert box w_up (ep=2)")
    kernels3d = ep3d_kernel_checks(torch, fa, qo)
    gc.collect()
    torch.cuda.empty_cache()
    # every process of the phase on expandable segments: beside the pair
    # the ep = 1 runs read 79 of the card's 85 GB in nvidia-smi (blocks
    # reserved, split by the jobs before)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        one_jobs, two_jobs = _ep_jobs(full)
        one, two, free = _split_runs(torch, "ep", one_jobs, two_jobs)
        accum = _dp_spawn("ep1_accum", 1, [_ep_accum_job()], backend=None)[0]
        # the four ranks alone on the card
        free4 = torch.cuda.mem_get_info()[0]
        four = _dp_spawn("ep3d", 4, _ep3d_jobs(), timeout=2400.0)
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    refs = dict(one, ep1_accum=accum["ep1_accum"])
    ep3d = _ep3d_line(t0, refs, four, kernels3d, free4)
    ep = _ep_line(t0, one["ep1"], two, adam, free, full)
    return dict(ep, ep3d=ep3d, kernels3d=kernels3d)


# ---------------------------------------------------------------------------
# the pp phase: pipeline parallelism (parallel/pipeline.py)
# ---------------------------------------------------------------------------
# gpt2_small at its full width and depth, the global batch of 8 x 1024 in
# PP_M microbatches of 2 x 1024: one process at pp = 1 with grad_accum =
# PP_M (the same microbatches) beside two gloo ranks on the one card at
# pp = 2 (6 blocks a stage; 3 a chunk interleaved)
PP_SEQ = 1024
PP_BATCH = 8
PP_M = 4
PP_STEPS = {"phase": 3, "full": 2}  # --phase pp, the full run
PP_SCHEDULES = {"phase": ("gpipe", "1f1b", "interleaved"), "full": ("gpipe", "1f1b")}
# pp = 2's losses against pp = 1's, absolute, and the first step's
# gradients (the stage leaves gathered over pp into whole layers, the
# shared leaves) against pp = 1's (``_grad_err``). On the H100 80GB HBM3 at
# 700 W, 3 steps: the first loss bitwise (the same microbatch products;
# the 1/M seed is a power of two), the later ones 5.1e-5 to 8.1e-5 off;
# the gradients 1.9e-3 off, in the learned positions (stage 0's f32
# scatter-add of the rows against autograd's bf16 embedding backward);
# the control (zero cotangents into stage 0) 1.52 off, its loss the sound
# one (the forward is unchanged). So the loss gate sits 6x above the
# sound spread, the gradient gate 5x above it and 150x below the fault.
PP_LOSS_TOL = 5e-4
PP_GRAD_TOL = 1e-2
# pp 2 x dp 2 against pp 2 x dp 1: each rank's microbatch is one row
# instead of two, so the bf16 GEMMs round by another shape (1.27e-3 off
# over 3 steps on the same card)
PP_DP_LOSS_TOL = 5e-3
# the kernels the pp path launches in every stage
PP_KERNELS = ("fa_fwd", "fa_bwd_dkdv", "fa_bwd_dq", "adam8_leaf")
# one stage leaf the per-leaf 8-bit AdamW updates on the pp path:
# stages.mlp.w_up's row at pp = 2 (6 blocks of 768 x 3072)
PP_ADAM_SHAPE = (1, 6, 768, 3072)
# pp composed with tp and fsdp: four gloo ranks on the one card, each
# run held to the pp = 1 job's losses and first-step gradients. The
# schedules of --phase pp and the full run; the full run adds its four
# ranks as a second group started beside the tp / ep / pp pair
PP3D_SCHEDULES = {"phase": {"tp": ("gpipe", "1f1b", "interleaved"), "fsdp": ("gpipe", "1f1b")},
                  "full": {"tp": ("gpipe", "1f1b"), "fsdp": ("gpipe",)}}
# The gates against pp = 1, set from the H100 80GB HBM3 at 700 W (3
# steps; PERF.md §6). pp x tp: losses 4.0e-5 off (a tp rank's bf16
# GEMMs over half the heads and columns, the halves summed in f32), the
# eval loss 8e-6, the first step's gradients 0.043 off (layer 9's wq);
# its control (stage 1's first copy_to_tp without its backward sum) 0.67
# off. pp x fsdp: one row a microbatch a rank, so the bf16 GEMMs and the
# bias sums round by another shape: losses 1.19e-3 off, the eval loss
# 3.7e-3 (after 3 steps), the gradients 0.072 (layer 3's b_down); its
# control (stage 1's blocks' reduce-scatter unsummed) 1.12 off. Each
# gradient gate sits 3.5x above its sound reading and 4.4x below its
# control; the losses 12x (tp) and 2.7x (fsdp, its eval) above theirs
PP3D_LOSS_TOL = {"tp": 5e-4, "fsdp": 1e-2}
PP3D_GRAD_TOL = {"tp": 0.15, "fsdp": 0.25}
# pp 2 x dp 2 x tp 2 (--phase pp, eight gloo ranks) against pp = 1: a
# rank's microbatch is one row, as pp 2 x dp 2's (1.13e-3 off)
PP3D_DP_LOSS_TOL = 5e-3
# the tp box of a stage row the per-leaf 8-bit AdamW updates at pp 2 x tp
# 2: stages.mlp.w_up's 1536 of 3072 columns
PP3D_ADAM_SHAPE = (1, 6, 768, 1536)


def _pp_whole_grads(torch, trainer):
    """The gradients of the step about to update, as whole layers in the
    list layout's JAX order (a stage rank's boxes gathered over fsdp
    from its ZeRO shards, over tp and over pp, and split into layers;
    the shared leaves whole), f32. Every rank of the mesh calls it."""
    from dlrover_tpu_torch.models.convert import _splits, whole_leaf
    from dlrover_tpu_torch.parallel import pipeline as pl
    from dlrover_tpu_torch.parallel.sharding_rules import jax_order

    state, mesh = trainer.state, trainer.mesh
    model = state.params
    shard = {}
    if state.shards is not None:
        shard = {id(p): s for p, s in zip(model.jax_ordered_parameters(), state.shards)}
    splits = _splits(model, mesh)
    out = {}
    for name, p in model.named_parameters():
        g = whole_leaf((shard[id(p)].grad if shard else p.grad).float(), name, model, mesh, splits)
        if name.startswith("stages."):
            full = pl._dechunk_leaf(g, model.virtual)
            for i in range(full.shape[0]):
                out[f"layers.{i}.{name[len('stages.'):]}"] = full[i]
        else:
            out[name] = g
    return [out[n] for n in jax_order(out)]


def _pp_faults(torch, job, trainer):
    """Plant ``job["fault"]`` (the gates' controls, planted here only) and
    return the function that takes it out: ``zero_cotangent``, the last
    stage sends zeros for every cotangent to the stage before it;
    ``drop_copy_bwd``, stage 1's first block's attention ``copy_to_tp``
    loses its backward all-reduce (both tp ranks of the stage: the
    forward is the identity either way); ``unsummed_shard``, stage 1's
    first reduce-scatter (its blocks' gradients, the first sync unit)
    hands each fsdp rank its own unsummed rows."""
    from dlrover_tpu_torch.models import transformer as tfm
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.parallel import pipeline as pl

    fault, mesh = job.get("fault"), trainer.mesh
    stage, pp = mesh.stage, mesh.config.pp
    real_exchange, real_block = pl._Link.exchange, tfm._attention_block
    real_rs = grad_sync._reduce_scatter
    if fault == "zero_cotangent" and stage == pp - 1:
        def exchange(self, sends, recvs):
            return real_exchange(self, [(torch.zeros_like(t) if tag == pl._GRAD else t, peer, tag)
                                        for t, peer, tag in sends], recvs)

        pl._Link.exchange = exchange
    if fault == "drop_copy_bwd" and stage == 1:
        first = trainer.state.params.stages.attn["wq"]

        def faulty_block(x, layer, cfg, positions, mesh=None):
            if layer.attn["wq"].data_ptr() != first.data_ptr():
                return real_block(x, layer, cfg, positions, mesh)
            real_copy = tfm.copy_to_tp
            tfm.copy_to_tp = lambda h, group: h  # the forward's identity, no backward sum
            try:
                return real_block(x, layer, cfg, positions, mesh)
            finally:
                tfm.copy_to_tp = real_copy

        tfm._attention_block = faulty_block
    if fault == "unsummed_shard" and stage == 1:
        calls = []

        class Done:
            def wait(self):
                pass

        def own_rows(inp, group):
            if calls:
                return real_rs(inp, group)
            calls.append(True)
            n = torch.distributed.get_world_size(group)
            return inp.view(n, -1)[torch.distributed.get_rank(group)].clone(), Done()

        grad_sync._reduce_scatter = own_rows

    def undo():
        pl._Link.exchange, tfm._attention_block = real_exchange, real_block
        grad_sync._reduce_scatter = real_rs

    return undo


def _dp_pp(torch, job, rank, world, spec_path):
    """``ElasticTrainer`` on gpt2_small (12 x 768, vocab 50257, tied),
    batch ``PP_BATCH`` x ``PP_SEQ``, bf16, remat, per-leaf ``adamw_8bit``:
    at pp = 1 with ``grad_accum=PP_M``, or on a mesh of ``job["pp"]`` (x
    ``job["dp"]``, ``job["tp"]``, ``job["fsdp"]``) under
    ``job["schedule"]`` with ``PP_M`` microbatches (``job["overlap"]``:
    the ``PPSyncPlan``); the weights from the trainer's seeded CPU
    generator. Returns the losses, step ms, this rank's peak beside its
    static figure, the hops' number and host ms a step, the tp
    all-reduces' number and host ms a step, the collectives each step
    issued, the busy share of the step (ticks with a slot, each synced)
    beside the clock's bubble, the first step's gradient prints (whole
    layers), the launches and the collectives a step beside the reckoned
    ones, the eval loss through the stages, and under a plan the plan's
    buckets and bytes. ``job["fault"]``: a control (``_pp_faults``)."""
    from dataclasses import replace

    from dlrover_tpu_torch.accel.dry_runner import _apply_strategy, static_peak_bytes
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.models import transformer as tfm
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.parallel import grad_sync
    from dlrover_tpu_torch.parallel import pipeline as pl
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    pp, dp, steps = job.get("pp", 1), job.get("dp", 1), job["steps"]
    tp, fsdp = job.get("tp", 1), job.get("fsdp", 1)
    sched = job.get("schedule", "gpipe")
    cfg = replace(gpt2_small(), max_seq_len=PP_SEQ)
    tx = build_optimizer("adamw_8bit", lr=3e-4, min_quantized_size=4096)
    strategy = Strategy(mesh=MeshConfig(pp=pp, dp=dp, tp=tp, fsdp=fsdp), remat=True,
                        opts=("bf16",), num_microbatches=PP_M if pp > 1 else 1,
                        pp_schedule=sched, pp_virtual=2, comm_overlap=bool(job.get("overlap")))
    losses, stamps, issued, busy, tp_calls, tp_ms = [], [], [], [], [], []

    def hook(step, metrics):
        if "loss" in metrics:
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            busy.append(pl.comm["busy_ms"])
            issued.append(dict(count=dict(grad_sync.issued), bytes=dict(grad_sync.issued_bytes)))
            grad_sync.reset_counts()
            tp_calls.append(tfm.tp_comm["calls"])
            tp_ms.append(tfm.tp_comm["ms"])
            tfm.reset_tp_comm()

    # cuBLAS's workspaces (allocated at a process's first GEMMs and kept)
    # before the base: the peak is the job's own
    for dt in (torch.bfloat16, torch.float32):
        w = torch.ones((64, 64), device="cuda", dtype=dt, requires_grad=True)
        torch.nn.functional.linear(w, w, w[0]).sum().backward()
    del w
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    trainer = ElasticTrainer(
        cfg, tx, RandomTokens(n=64, seq=PP_SEQ, vocab=cfg.vocab_size),
        TrainerConfig(batch_size=PP_BATCH, seq_len=PP_SEQ, report_metrics=False, log_interval=1,
                      grad_accum=1 if pp > 1 else PP_M),
        strategy=strategy, metrics_hook=hook,
        eval_dataset=RandomTokens(n=PP_BATCH, seq=PP_SEQ, vocab=cfg.vocab_size, seed=5),
    )
    cfg2, applied = _apply_strategy(trainer.strategy, cfg)
    mesh = trainer.mesh
    stage = mesh.stage
    static = static_peak_bytes(cfg2, applied, tx, PP_BATCH, PP_SEQ, stage=stage)
    undo = _pp_faults(torch, job, trainer)
    # the first step's gradients as whole layers, gathered just before
    # its update; the peak is read around the gathering
    opt, prints, peaks = trainer.state.opt_state, [], []
    real_step = opt.step

    def step_and_print():
        if not prints:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            counts = dict(grad_sync.issued), dict(grad_sync.issued_bytes)
            if pp > 1:
                grads = _pp_whole_grads(torch, trainer)
            else:  # the list layout's JAX order, as the pp ranks give theirs
                from dlrover_tpu_torch.parallel.sharding_rules import jax_order

                named = dict(trainer.state.params.named_parameters())
                grads = [named[n].grad for n in jax_order(named)]
            prints.extend(_grad_prints(torch, grads))
            grad_sync.issued.update(counts[0])
            grad_sync.issued_bytes.update(counts[1])
            del grads
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if job.get("trace"):  # from here on: the step's own allocations
                torch.cuda.memory._record_memory_history(max_entries=200000)
        return real_step()

    opt.step = step_and_print
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    qo.reset_launch_counts()
    pl.reset_comm()
    tfm.reset_tp_comm()
    pl.comm["time_slots"] = pp > 1
    grad_sync.reset_counts()
    t0 = time.perf_counter()
    try:
        trainer.train(steps)
    finally:
        undo()
        pl.comm["time_slots"] = False
        opt.step = real_step
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated() - base)
    live_at_peak = None
    if job.get("trace"):
        live_at_peak = _live_at_peak(torch.cuda.memory._snapshot())
        torch.cuda.memory._record_memory_history(enabled=None)
    launches = {**fa.launch_counts, **qo.launch_counts}
    hops = dict(pl.comm)
    step_ms = [x * 1e3 for x in np.diff([t0] + stamps)]
    eval_loss = None if job.get("fault") else trainer.evaluate(1)["eval_loss"]
    # reckoned: under remat each block's forward runs twice a microbatch
    # (GPipe: the forward and the checkpoint's recompute, or under fsdp
    # the unit's recompute; 1F1B: the forward tick and the stage's
    # recompute), its backward once
    v = applied.resolved_virtual()
    blocks = cfg.num_layers // pp
    leaf = sum(getattr(p, "leaf_numel", p.numel()) >= 4096
               for p in trainer.state.params.jax_ordered_parameters())
    reckoned = {"fa_fwd": 2 * blocks * PP_M, "fa_bwd_dkdv": blocks * PP_M,
                "fa_bwd_dq": blocks * PP_M, "adam8_leaf": leaf}
    collectives = None
    if pp > 1 and (tp > 1 or fsdp > 1):
        # the tp all-reduces: a block's two forward sums in each forward
        # run (GPipe's checkpoint recompute stops before the MLP's: one),
        # its two backward ones; gpt2's odd vocab is whole on every tp
        # rank (no vocab-parallel sums). fsdp: the blocks gathered before
        # each chunk forward and each backward, the embedding (stage 0)
        # and the head (the last stage) a microbatch; one reduce-scatter
        # a sync unit (the stage's leaves, the shared ones)
        per = 5 if sched == "gpipe" else 6
        collectives = {
            "tp_all_reduce": blocks * PP_M * per if tp > 1 else 0,
            "all_gather": (2 * v * PP_M + PP_M * (stage == 0) + PP_M * (stage == pp - 1))
            if fsdp > 1 else 0,
            "reduce_scatter": 2 if fsdp > 1 else 0,
        }
    if pp > 1 and sched != "gpipe":
        _, busy_slots, total_slots = pl.schedule_occupancy(pp, PP_M, v)
        bubble = 1 - busy_slots / total_slots
    else:
        bubble = (pp - 1) / (PP_M + pp - 1)
    plan = trainer._grad_sync_plan
    res = dict(
        live_at_peak=live_at_peak, resident_bytes=torch.cuda.memory_allocated() - base,
        pp=pp, dp=dp, tp=tp, fsdp=fsdp, schedule=sched if pp > 1 else None, virtual=v,
        stage=stage, coords=dict(mesh.coords),
        fault=job.get("fault"), losses=losses, eval_loss=eval_loss, grad_prints=prints,
        step_ms=step_ms, peak_bytes=max(peaks), peaks_before_and_after_prints=peaks,
        static_peak_bytes=static, static_vs_measured=static / max(peaks) - 1,
        backend=None if mesh.groups.get("pp") is None else torch.distributed.get_backend(
            mesh.groups["pp"]),
        launches_per_step={k: v_ / steps for k, v_ in launches.items()},
        launches_reckoned_per_step=reckoned,
        hops_per_step=hops["hops"] / steps, hop_host_ms_per_step=hops["ms"] / steps,
        hops_staged=hops["staged"],
        tp_all_reduces_per_step=tp_calls, tp_host_ms_per_step=tp_ms,
        collectives_reckoned_per_step=collectives,
        busy_ms_per_step=list(np.diff([0.0] + busy)),
        bubble_share_of_the_clock=bubble,
        # the last step's: the first pays one-time costs
        bubble_share_measured=(1 - (busy[-1] - (busy[-2] if steps > 1 else 0.0)) / step_ms[-1])
        if pp > 1 else None,
        issued_per_step=issued,
        plan=None if plan is None else dict(
            kind=plan.kind, buckets=plan.num_buckets, padded=sum(b.padded for b in plan.buckets),
            raw_bytes=plan.raw_bytes, wire_bytes=plan.wire_bytes, describe=plan.describe()),
    )
    trainer.close()
    del trainer, opt
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _pp_jobs(full):
    """(the pp = 1 job, the pair's jobs): the schedules at
    ``PP_STEPS``' depth, then the control (one GPipe step)."""
    steps = PP_STEPS["full" if full else "phase"]
    job = dict(kind="pp", steps=steps, trace=not full)
    return ([dict(job, name="pp1", pp=1)],
            [dict(job, name=f"pp2_{s}", pp=2, schedule=s)
             for s in PP_SCHEDULES["full" if full else "phase"]]
            + [dict(job, name="pp2_zero_cotangent", pp=2, steps=1, trace=False,
                    fault="zero_cotangent")])


def _pp3d_jobs(full):
    """The four ranks' jobs: pp 2 x tp 2 and pp 2 x fsdp 2 under
    ``PP3D_SCHEDULES`` at ``PP_STEPS``' depth, each composition then its
    control (one GPipe step)."""
    key = "full" if full else "phase"
    job = dict(kind="pp", pp=2, steps=PP_STEPS[key], trace=not full)
    jobs = []
    for axis, fault in (("tp", "drop_copy_bwd"), ("fsdp", "unsummed_shard")):
        jobs += [dict(job, name=f"pp2_{axis}2_{s}", schedule=s, **{axis: 2})
                 for s in PP3D_SCHEDULES[key][axis]]
        jobs.append(dict(job, name=f"pp2_{axis}2_{fault}", steps=1, trace=False, fault=fault,
                         **{axis: 2}))
    return jobs


def _pp3d_line(t0, one, four, kernels, adam, free_before, full, eight=None):
    """The pp x tp and pp x fsdp runs' gates: each run's losses against
    pp = 1's within ``PP3D_LOSS_TOL``, its first step's whole-layer
    gradients (the tp boxes and ZeRO shards gathered too) within
    ``PP3D_GRAD_TOL``, the eval loss through the stages, the ranks
    agreeing, each rank's peak within ``PEAK_CAL_RTOL`` of its static
    figure, the launches and the collectives a step the reckoned ones
    (the tp all-reduces; ZeRO's all-gathers and reduce-scatters); each
    composition's control must fail the two gates together. ``eight``:
    pp 2 x dp 2 x tp 2's ranks, its losses within ``PP3D_DP_LOSS_TOL``
    of pp = 1's."""
    steps = PP_STEPS["full" if full else "phase"]
    ref = one["grad_prints"]
    runs, checks, faults = {}, {}, {}
    for name in four[0]:
        ranks = [r[name] for r in four]
        prints = [r.pop("grad_prints") for r in ranks]
        runs[name] = ranks
        axis = "tp" if ranks[0]["tp"] > 1 else "fsdp"
        fault = bool(ranks[0]["fault"])
        want = 1 if fault else steps
        diff = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], one["losses"]))
        grad_err, worst = _grad_err(prints[0], ref)
        passes = diff <= PP3D_LOSS_TOL[axis] and grad_err <= PP3D_GRAD_TOL[axis]
        same = all(r["losses"] == ranks[0]["losses"] for r in ranks)
        finite = all(np.isfinite(r["losses"]).all() and len(r["losses"]) == want for r in ranks)
        launches_ok = all(r["launches_per_step"].get(k, 0) == r["launches_reckoned_per_step"][k]
                          for r in ranks for k in PP_KERNELS)
        coll = [dict(tp_all_reduce=r["tp_all_reduces_per_step"][k],
                     all_gather=r["issued_per_step"][k]["count"]["all_gather"],
                     reduce_scatter=r["issued_per_step"][k]["count"]["reduce_scatter"])
                for r in ranks for k in range(len(r["losses"]))]
        reckoned = [r["collectives_reckoned_per_step"] for r in ranks
                    for _ in range(len(r["losses"]))]
        coll_ok = coll == reckoned
        peaks_ok = all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL for r in ranks)
        eval_ok = fault or all(abs(r["eval_loss"] - one["eval_loss"]) <= PP3D_LOSS_TOL[axis]
                               for r in ranks)
        check = {"max_abs_loss_diff_vs_pp1": diff, "tol": PP3D_LOSS_TOL[axis],
                 "first_loss_diff_vs_pp1": abs(ranks[0]["losses"][0] - one["losses"][0]),
                 "first_step_grad_rel_err_vs_pp1": grad_err, "worst_tensor": worst,
                 "grad_tol": PP3D_GRAD_TOL[axis], "ranks_agree": same,
                 "ranks_grads_agree": all(p == prints[0] for p in prints),
                 "passes_gates": passes, "launches_as_reckoned": launches_ok,
                 "collectives_as_reckoned": coll_ok, "peaks_within_static": peaks_ok,
                 "static_vs_measured": [r["static_vs_measured"] for r in ranks],
                 "eval_loss_vs_pp1": None if fault else max(
                     abs(r["eval_loss"] - one["eval_loss"]) for r in ranks),
                 "ok": finite and same and passes and launches_ok and coll_ok and peaks_ok
                 and eval_ok}
        if fault:
            check["ok"] = not passes
            check["loss_gate_alone_refuses"] = diff > PP3D_LOSS_TOL[axis]
            faults[name] = check
        else:
            checks[name] = check
    dp_check = None
    if eight is not None:
        ranks = [r["pp2_dp2_tp2_1f1b"] for r in eight]
        for r in ranks:
            r.pop("grad_prints")
        diff = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], one["losses"]))
        coll_ok = all(r["tp_all_reduces_per_step"][k]
                      == r["collectives_reckoned_per_step"]["tp_all_reduce"]
                      for r in ranks for k in range(len(r["losses"])))
        peaks_ok = all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL for r in ranks)
        dp_check = dict(runs=ranks, max_abs_loss_diff_vs_pp1=diff, tol=PP3D_DP_LOSS_TOL,
                        ranks_agree=all(r["losses"] == ranks[0]["losses"] for r in ranks),
                        collectives_as_reckoned=coll_ok, peaks_within_static=peaks_ok,
                        ok=diff <= PP3D_DP_LOSS_TOL and coll_ok and peaks_ok
                        and all(len(r["losses"]) == steps for r in ranks))
    ok = (all(c["ok"] for c in checks.values()) and len(faults) == 2
          and all(f["ok"] for f in faults.values()) and adam["ok"] and kernels["ok"]
          and (dp_check is None or dp_check["ok"]))
    emit("pp3d_train", seconds=time.perf_counter() - t0, model="gpt2_small", batch=PP_BATCH,
         seq=PP_SEQ, microbatches=PP_M, steps=steps, runs=runs, checks=checks,
         planted_faults=faults, pp2_dp2_tp2=dp_check, peak_cal_rtol=PEAK_CAL_RTOL,
         card_free_bytes_before_runs=free_before, kernels_at_the_microbatch=kernels,
         adam8_leaf_tp_box=adam, card=card_line(),
         transport="hops: batch_isend_irecv over gloo, staged through pinned host buffers; "
                   "tp sums and ZeRO's collectives: gloo, staged by gloo through host memory "
                   "(four ranks share the one card)",
         never_on_a_card=["pp x tp over NCCL", "pp x tp across cards", "pp x fsdp over NCCL",
                          "pp x fsdp x tp", "interleaved pp x fsdp"]
         + ([] if eight is not None else ["interleaved pp x tp (--phase pp only)",
                                          "pp x fsdp under 1F1B (--phase pp only)",
                                          "pp x dp x tp (--phase pp only)"]),
         ok=ok)
    if not ok:
        raise RuntimeError(f"the pp x tp / pp x fsdp runs failed their checks: {checks}, "
                           f"the controls: {faults}, pp x dp x tp: {dp_check}")
    return dict(runs=runs, adam=adam, kernels=kernels)


def _pp_line(t0, one, two, kernels, adam, free_before, full, dp_run=None):
    """The pp runs' gates: each schedule's losses against pp = 1's within
    ``PP_LOSS_TOL``, its first step's whole-layer gradients within
    ``PP_GRAD_TOL``, the eval loss through the stages, the ranks
    agreeing, each rank's peak within ``PEAK_CAL_RTOL`` of its static
    figure, the launches a step the reckoned ones; the control must fail
    the two gates together. ``dp_run``: pp 2 x dp 2's ranks, its losses
    against pp 2 x dp 1's (GPipe) and each step's reduce-scatters and
    all-gathers the plan's buckets and bytes."""
    steps = PP_STEPS["full" if full else "phase"]
    ref = one.pop("grad_prints")
    runs = {"pp1": one}
    checks = {}
    for name in two[0]:
        ranks = [r[name] for r in two]
        prints = [r.pop("grad_prints") for r in ranks]
        runs[name] = ranks
        fault = bool(ranks[0]["fault"])
        want = 1 if fault else steps
        diff = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], one["losses"]))
        grad_err, worst = _grad_err(prints[0], ref)
        passes = diff <= PP_LOSS_TOL and grad_err <= PP_GRAD_TOL
        same = all(r["losses"] == ranks[0]["losses"] for r in ranks)
        finite = all(np.isfinite(r["losses"]).all() and len(r["losses"]) == want for r in ranks)
        launches_ok = all(r["launches_per_step"].get(k, 0) == r["launches_reckoned_per_step"][k]
                          for r in ranks for k in PP_KERNELS)
        peaks_ok = all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL for r in ranks)
        eval_ok = fault or all(abs(r["eval_loss"] - one["eval_loss"]) <= PP_LOSS_TOL
                               for r in ranks)
        checks[name] = {"max_abs_loss_diff_vs_pp1": diff, "tol": PP_LOSS_TOL,
                        "first_loss_diff_vs_pp1": abs(ranks[0]["losses"][0] - one["losses"][0]),
                        "first_step_grad_rel_err_vs_pp1": grad_err, "worst_tensor": worst,
                        "grad_tol": PP_GRAD_TOL, "ranks_agree": same,
                        "ranks_grads_agree": prints[1] == prints[0], "passes_gates": passes,
                        "launches_as_reckoned": launches_ok, "peaks_within_static": peaks_ok,
                        "eval_loss_vs_pp1": None if fault else max(
                            abs(r["eval_loss"] - one["eval_loss"]) for r in ranks),
                        "ok": finite and same and passes and launches_ok and peaks_ok and eval_ok}
    fault = checks.pop("pp2_zero_cotangent")
    fault["ok"] = not fault["passes_gates"]
    fault["loss_gate_alone_refuses"] = fault["max_abs_loss_diff_vs_pp1"] > PP_LOSS_TOL
    first_ok = abs(one["losses"][0] - float(np.log(50257))) <= 1.0
    one_peak_ok = abs(one["static_vs_measured"]) <= PEAK_CAL_RTOL
    one_launch_ok = all(one["launches_per_step"].get(k, 0) == n
                        for k, n in one["launches_reckoned_per_step"].items())
    dp_check = None
    if dp_run is not None:
        ranks = [r["pp2_dp2"] for r in dp_run]
        plan = ranks[0]["plan"]
        per_step = [s for r in ranks for s in r["issued_per_step"]]
        issued_ok = all(s["count"]["reduce_scatter"] == s["count"]["all_gather"] == plan["buckets"]
                        and s["bytes"]["reduce_scatter"] == 4 * plan["padded"]
                        and s["bytes"]["all_gather"] == 4 * plan["padded"] // 2
                        for s in per_step)
        diff = max(abs(a - b) for r in ranks for a, b in zip(r["losses"],
                                                             runs["pp2_gpipe"][0]["losses"]))
        for r in ranks:
            r.pop("grad_prints")
        peaks_ok = all(abs(r["static_vs_measured"]) <= PEAK_CAL_RTOL for r in ranks)
        dp_check = dict(runs=ranks, plan=plan, issued_as_planned=issued_ok,
                        max_abs_loss_diff_vs_pp2_dp1=diff, tol=PP_DP_LOSS_TOL,
                        peaks_within_static=peaks_ok,
                        ok=plan["kind"] == "pp" and issued_ok and diff <= PP_DP_LOSS_TOL
                        and peaks_ok)
    # pp = 1's peak is reported beside its static figure, not gated: the
    # dense model leaves out grad_accum's f32 accumulators and prices the
    # head's logits above what the card holds (PERF.md §7)
    ok = (first_ok and one_launch_ok and all(c["ok"] for c in checks.values())
          and fault["ok"] and adam["ok"] and kernels["ok"] and (dp_check is None or dp_check["ok"]))
    emit("pp_train", seconds=time.perf_counter() - t0, model="gpt2_small", batch=PP_BATCH,
         seq=PP_SEQ, microbatches=PP_M, steps=steps, runs=runs, checks=checks,
         planted_fault=fault, pp2_dp2=dp_check, peak_cal_rtol=PEAK_CAL_RTOL,
         pp1_peak_within_static=one_peak_ok, pp1_launches_as_reckoned=one_launch_ok,
         card_free_bytes_before_runs=free_before, pp1_beside_the_pair=True,
         first_loss_near_ln_vocab=first_ok, kernels_at_the_microbatch=kernels,
         adam8_leaf_stage_row=adam, card=card_line(),
         transport="batch_isend_irecv over gloo, CUDA tensors staged through pinned host "
                   "buffers (two ranks share the one card)",
         never_on_a_card=["NCCL pp hops", "pp across cards", "pp > 2", "pp x dp over NCCL"]
         + ([] if dp_run is not None else ["pp x dp (--phase pp only)",
                                           "interleaved (--phase pp only)"]),
         ok=ok)
    if not ok:
        raise RuntimeError(f"the pp runs failed their checks: {checks}, the control: {fault}, "
                           f"pp x dp: {dp_check}")
    return dict(runs=runs, adam=adam, kernels=kernels)


def _pp_launches(pp, name):
    """A kernel's launches a step on each pp = 2 rank (stage order, then
    the mesh's other coordinates), by run; the controls left out."""
    return {run[len("pp2_"):]: [r["launches_per_step"].get(name, 0)
                                for r in sorted(ranks, key=lambda r: (r["stage"], sorted(r["coords"].items())))]
            for run, ranks in pp["runs"].items()
            if run.startswith("pp2_") and not ranks[0]["fault"]}


def pp3d_kernel_checks(torch, fa, qo):
    """Each attention kernel against its plain version at the pp x tp
    path's microbatch (2 x 1024, 6 heads of 64 a tp rank) and the pp x
    fsdp path's (1 x 1024, 12 heads), and ``adam8_leaf`` at a stage
    row's tp box (``PP3D_ADAM_SHAPE``)."""
    res, errs = check_attention(torch, fa, "B1/B2 gpt2_small pp x tp microbatch",
                                PP_BATCH // PP_M, 6, 6, PP_SEQ, 64)
    res_f, errs_f = check_attention(torch, fa, "B1/B2 gpt2_small pp x fsdp microbatch",
                                    PP_BATCH // PP_M // 2, 12, 12, PP_SEQ, 64)
    adam, _ = check_adam8_leaf(torch, qo, None, PP3D_ADAM_SHAPE,
                               "B7 adam8_leaf stage row's tp box stages.mlp.w_up (pp=2 x tp=2)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels = dict(ms=res["ms"], plain_ms=res["plain_ms"], bound=res["bound"],
                   tile_err=res["tile_err"], max_abs_err=errs,
                   fsdp=dict(ms=res_f["ms"], plain_ms=res_f["plain_ms"], bound=res_f["bound"],
                             tile_err=res_f["tile_err"], max_abs_err=errs_f),
                   ok=res["ok"] and res_f["ok"])
    return kernels, adam


def pp_kernel_checks(torch, fa, qo):
    """Each attention kernel against its plain version at the pp path's
    microbatch (2 x 1024, 12 heads, D 64), and ``adam8_leaf`` at a stage
    row's shape (``PP_ADAM_SHAPE``)."""
    res, errs = check_attention(torch, fa, "B1/B2 gpt2_small pp microbatch", PP_BATCH // PP_M,
                                12, 12, PP_SEQ, 64)
    adam, _ = check_adam8_leaf(torch, qo, None, PP_ADAM_SHAPE,
                               "B7 adam8_leaf stage row stages.mlp.w_up (pp=2)")
    gc.collect()
    torch.cuda.empty_cache()
    kernels = dict(ms=res["ms"], plain_ms=res["plain_ms"], bound=res["bound"],
                   tile_err=res["tile_err"], max_abs_err=errs, ok=res["ok"])
    return kernels, adam


def run_pp(torch, fa, qo):
    """The pp phase (``--phase pp``): the kernels at the pp path's shapes
    (``pp_kernel_checks``), then gpt2_small training at ``PP_BATCH`` x
    ``PP_SEQ`` in ``PP_M`` microbatches: one process at pp = 1 with
    ``grad_accum=PP_M`` beside two gloo ranks on the one card at pp = 2
    under GPipe, 1F1B and interleaved 1F1B (v = 2), then the control;
    then four gloo ranks at pp 2 x dp 2 with ``comm_overlap`` (the
    ``PPSyncPlan``). The gates are ``_pp_line``'s."""
    t0 = time.perf_counter()
    kernels, adam = pp_kernel_checks(torch, fa, qo)
    kernels3d, adam3d = pp3d_kernel_checks(torch, fa, qo)
    one_jobs, two_jobs = _pp_jobs(False)
    one, two, free = _split_runs(torch, "pp", one_jobs, two_jobs)
    dp_run = _dp_spawn("pp_dp", 4, [dict(kind="pp", name="pp2_dp2", pp=2, dp=2, schedule="gpipe",
                                         overlap=True, steps=PP_STEPS["phase"], trace=True)])
    four = _dp_spawn("pp3d", 4, _pp3d_jobs(False))
    eight = _dp_spawn("pp3d_dp", 8, [dict(kind="pp", name="pp2_dp2_tp2_1f1b", pp=2, dp=2, tp=2,
                                          schedule="1f1b", steps=PP_STEPS["phase"])])
    pp3d = _pp3d_line(t0, one["pp1"], four, kernels3d, adam3d, free, False, eight)
    pp = _pp_line(t0, one["pp1"], two, kernels, adam, free, False, dp_run)
    return dict(pp, pp3d=pp3d)


def start_tp_ep(torch, fa, qo):
    """The full run's tp, ep and pp phases in the same three processes
    (one process at tp = 1, ep = 1, then pp = 1, beside a gloo pair at tp
    = 2, ep = 2, C3's two runs, then pp = 2 under GPipe and 1F1B and the
    pp control), at ``TP_RUNS`` / ``EP_RUNS`` / ``C3_RUNS`` /
    ``PP_STEPS``' full depth: the kernel checks, then the processes
    started; the returned function waits for them, prints the tp, ep and
    pp lines and returns ``{"tp", "ep", "pp", "c3"}`` (C3's results per
    rank). The full run starts them before the resize drill, whose
    launchers mostly wait, so they run side by side (the steps' times
    are then not timing-grade; ``--phase tp`` / ``ep`` / ``pp`` /
    ``resize`` run alone)."""
    t0 = time.perf_counter()
    tp_adam, _ = check_adam8_leaf(torch, qo, None, TP_ADAM_SHAPE,
                                  "B7 adam8_leaf tp-local w_gate (tp=2)")
    ep_adam, _ = check_adam8_leaf(torch, qo, None, EP_ADAM_SHAPE,
                                  "B7 adam8_leaf expert box w_up (ep=2)")
    pp_kernels, pp_adam = pp_kernel_checks(torch, fa, qo)
    pp3d_kernels, pp3d_adam = pp3d_kernel_checks(torch, fa, qo)
    ep3d_kernels = ep3d_kernel_checks(torch, fa, qo, full=True)
    gc.collect()
    torch.cuda.empty_cache()
    tp1, tp2 = _tp_jobs(True)
    ep1, ep2 = _ep_jobs(True)
    pp1, pp2 = _pp_jobs(True)
    free = torch.cuda.mem_get_info()[0]
    one = _dp_start("tp_ep1", 1, tp1 + ep1 + pp1, backend=None)
    two = _dp_start("tp_ep2", 2, tp2 + ep2 + _c3_jobs(True) + pp2)
    # a group of its own: the pair's two-rank jobs keep their world, and
    # these four ranks run while the drill's launchers mostly wait. The
    # composed MoE meshes (ROADMAP A19) run under --phase ep alone: four
    # more Llama-width ranks here took the machine past its 96 GiB of host
    # memory, and run after this group they would add ~80 s to a run
    # whose time has no room
    four = _dp_start("pp3d", 4, _pp3d_jobs(True))

    def finish():
        try:
            res1 = one()[0]
        finally:
            try:
                res2 = two()
            finally:
                res4 = four()
        tp_names, ep_names = [j["name"] for j in tp2], [j["name"] for j in ep2]
        tp = _tp_line(t0, res1["tp1"], [{k: r[k] for k in tp_names} for r in res2], tp_adam,
                      free, True)
        ep = _ep_line(t0, res1["ep1"], [{k: r[k] for k in ep_names} for r in res2], ep_adam,
                      free, True)
        pp3d = _pp3d_line(t0, res1["pp1"], res4, pp3d_kernels, pp3d_adam, free, True)
        pp = _pp_line(t0, res1["pp1"], [{j["name"]: r[j["name"]] for j in pp2} for r in res2],
                      pp_kernels, pp_adam, free, True)
        return dict(tp=tp, ep=dict(ep, kernels3d=ep3d_kernels), pp=dict(pp, pp3d=pp3d),
                    c3=[{k: r[k] for k in ("dp2", "zero")} for r in res2])

    return finish


# ---------------------------------------------------------------------------
# serving and RLHF (ROADMAP A14): the publication, the serving engine, the
# reward model and PPO; with --phase serve co-located and 7 B serving
# ---------------------------------------------------------------------------
SERVE_RANK = 7  # the publication's shm rank: a rank of its own
SERVE_GREEDY = dict(n=16, lens=(16, 256), max_new=64, slots=8)
# The decode's logprob of each emitted token against the teacher-forced
# scoring of the same tokens (``sequence_logprobs``: the flash kernels),
# |difference| in nats, every emitted token within the limit. Both paths
# run bf16 activations and bf16 GEMMs; the decode keeps f32 scores and
# probabilities, the kernels round p to bf16 before P V. A cache written
# one position late (``late_cache_fault``) attends the previous token in
# the place of each token, and must exceed the limit by
# ``DECODE_FAULT_RATIO``, at both sizes. Stated before the first chip
# run as a mean of 0.04; on the H100 (gpt2_small, the 16 greedy prompts'
# 1024 tokens) the late cache read a mean of 0.212 (5.3x: too weak a
# gate), so the gate became the per-token bound. Its readings on an
# H100 80GB HBM3 at 700 W: the sound decode's max 0.0316 (gpt2_small)
# and 0.0626 (Llama-2-7B, 4 prompts' 512 tokens), the late cache's max
# 1.95 and 2.69 (means 0.212-0.224 and 0.623).
DECODE_LOGP_TOL = 0.1
DECODE_FAULT_RATIO = 10.0
RLHF_RUN = dict(prompts=8, prompt_len=64, max_new=32, temperature=0.8, top_k=50,
                iterations=2, ppo_epochs=2, minibatch=8, rm_steps=3, rm_len=96)
RLHF_RATIO_TOL = 1e-4  # approx_kl and clip_frac of the first minibatch
RLHF_CPU_TOL = 2e-2  # the first update's loss on the card against the CPU plain path
# --phase serve: co-located gpt2_small (as the slice: 8 x 1024) with a
# memory save every 2 steps, and the dedicated Llama-2-7B serving
COLOC_STEPS, COLOC_SAVE_EVERY, COLOC_BATCH, COLOC_SEQ = 12, 2, 8, 1024
COLOC_SERVING = dict(n=8, lens=(16, 64), max_new=16, slots=8)
COLOC_SWAP_WAIT_S = 1.0  # before each batch, how long to try for a newer frame
# the JAX bench's serve-while-training gates (bench.py:4171-4172): the
# co-located step may lose at most 10 % and the goodput 1 point
JAX_BENCH_STEP_LOSS, JAX_BENCH_GOODPUT_POINTS = 0.10, 1.0
SERVE_7B = dict(n=32, lens=(128, 1024), max_new=128, slots=16, checked=4,
                temperature=0.8, top_k=50, top_p=0.95)


class _Env:
    """Job name and socket dir of a phase of its own, put back after."""

    def __init__(self, job):
        import tempfile

        self.keys = ("DLROVER_TPU_JOB_NAME", "DLROVER_TPU_SOCKET_DIR")
        self.saved = {k: os.environ.get(k) for k in self.keys}
        os.environ["DLROVER_TPU_JOB_NAME"] = f"{job}{os.getpid()}"
        os.environ["DLROVER_TPU_SOCKET_DIR"] = self.sock = tempfile.mkdtemp(prefix="dlr")

    def close(self):
        import shutil

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(self.sock, ignore_errors=True)


def publish_params(torch, handler, step, model, threads=8):
    """A model's params into ``handler``'s segment as a writer publishes
    them (``begin_save``, each record's crc taken before its bytes enter
    the segment, ``commit_save``): each leaf copied off the card in turn,
    its crc and its write on a pool of threads (at most ``2 threads``
    leaves on the host at once)."""
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.ckpt.sharding import host_shard_plan
    from dlrover_tpu_torch.ckpt.shm_handler import data_crc32
    from dlrover_tpu_torch.models.convert import param_state

    plan = host_shard_plan(param_state(model))
    metas = handler.layout_records([r for r, _ in plan])
    handler.begin_save(metas[-1].offset + metas[-1].nbytes)

    def write(m, arr):
        m.crc32 = data_crc32(arr)
        handler.write_chunk(m.offset, arr)

    with ThreadPoolExecutor(threads) as ex:
        pending = []
        for (_, src), m in zip(plan, metas):
            pending.append(ex.submit(write, m, src.detach().to("cpu").contiguous().numpy()))
            if len(pending) >= 2 * threads:
                pending.pop(0).result()
        for f in pending:
            f.result()
    handler.commit_save(step, metas, {})
    return sum(m.nbytes for m in metas)


def prompt_queue(n, lens, vocab, seed):
    """``n`` right-padded prompts of lengths drawn uniformly in ``lens``."""
    rng = np.random.default_rng(seed)
    lo, hi = lens
    plens = rng.integers(lo, hi + 1, size=n).astype(np.int64)
    toks = np.zeros((n, hi), np.int64)
    for i, ln in enumerate(plens):
        toks[i, :ln] = rng.integers(1, vocab, size=ln)
    return toks, plens


def decode_vs_scoring(torch, model, cfg, tokens, logps, out_lens, plens, rows):
    """|decode logprob - teacher-forced logprob| of every emitted token
    of ``rows``: the teacher-forced ones from ``sequence_logprobs`` (the
    flash kernels) on each row's own tokens. Returns (mean, max, tokens
    compared, the sequence lengths scored)."""
    from dlrover_tpu_torch.rl.generation import sequence_logprobs

    diffs, lengths = [], []
    with torch.no_grad():
        for i in rows:
            n, p = int(out_lens[i]), int(plens[i])
            row = tokens[i:i + 1, :n].long()
            tf = sequence_logprobs(model, row, cfg, p)[0]
            diffs.append((logps[i, :n - p].float() - tf.float()).abs())
            lengths.append(n - 1)
    d = torch.cat(diffs)
    return float(d.mean()), float(d.max()), int(d.numel()), lengths


def late_cache_fault(ttr):
    """Patch the decode to write each token's K/V one position late (the
    planted fault the decode-vs-scoring limit must catch); returns the
    undo."""
    real = ttr._cached_decode_layer

    def late(x, lw, kc, vc, *, positions, mask, key_len, cfg, write_kv):
        import torch

        pos = (positions[:, -1] + 1).clamp_max(kc.shape[2] - 1)

        def write_late(c, val):
            c[torch.arange(c.shape[0], device=c.device), :, pos] = val[:, -1].to(c.dtype)

        return real(x, lw, kc, vc, positions=positions, mask=mask, key_len=key_len, cfg=cfg,
                    write_kv=write_late)

    ttr._cached_decode_layer = late
    return lambda: setattr(ttr, "_cached_decode_layer", real)


def capture_vs_settle(torch, locked=True):
    """A CUDA graph capture held open ~0.2 s in a thread of its own (as
    the serving thread captures its decode graphs), and a card-wide
    synchronize in this thread while it is open: ``locked``,
    ``ElasticTrainer._settle`` (through ``cuda_sync``, which waits for the
    capture); else the planted fault, a bare ``torch.cuda.synchronize()``
    (the port's syncs before ``cuda_sync``). Returns the errors each side
    met (none expected when ``locked``) and the seconds the synchronize
    took."""
    import contextlib
    from types import SimpleNamespace

    from dlrover_tpu_torch.common import cuda_sync
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    x = torch.randn(1024, 1024, device="cuda")
    opened, errors = threading.Event(), {}

    def capture():
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                x @ x  # warm-up off the capture
            s.synchronize()
            with cuda_sync.capturing() if locked else contextlib.nullcontext():
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, capture_error_mode="thread_local"):
                    y = x @ x
                    opened.set()
                    time.sleep(0.2)
            g.replay()
            torch.cuda.current_stream().synchronize()
            if not torch.allclose(y, x @ x):
                errors["capture"] = "the replay disagrees with eager"
        except Exception as e:  # noqa: BLE001 - the check's verdict
            errors["capture"] = repr(e)[:300]
        finally:
            opened.set()

    th = threading.Thread(target=capture)
    th.start()
    opened.wait(30)
    t0 = time.perf_counter()
    try:
        if locked:
            stub = SimpleNamespace(device=torch.device("cuda"), state=None,
                                   _book_compute=lambda wait: None)
            ElasticTrainer._settle(stub)
        else:
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the check's verdict
        errors["synchronize"] = repr(e)[:300]
    sync_s = time.perf_counter() - t0
    th.join(60)
    try:  # a failed capture leaves nothing queued behind it
        torch.cuda.current_stream().synchronize()
    except Exception as e:  # noqa: BLE001
        errors.setdefault("after", repr(e)[:300])
    return dict(locked=locked, errors=errors, synchronize_s=sync_s,
                thread_alive=th.is_alive())


def run_serve(torch, fa):
    """The full run's serving and RLHF paths (gpt2_small at full width and
    depth, f32 params, bf16 activations, seed 0), in this process: the
    publication and its subscriber (zero-copy, a torn frame, a rotten
    frame), greedy serving held bitwise to a direct restore and to the
    teacher-forced scoring, then the reward model and PPO. Returns the
    ``serve`` line's dict (with each path's attention launches)."""
    from dlrover_tpu_torch.ckpt.shm_handler import ShmHandler, ShmSubscriber
    from dlrover_tpu_torch.common import faults
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.models import transformer as ttr
    from dlrover_tpu_torch.rl.continuous_batching import continuous_generate
    from dlrover_tpu_torch.serve import ServingConfig, ServingEngine

    t0 = time.perf_counter()
    cfg = gpt2_small()
    env = _Env("serve")
    res = {}
    writer = sub = None
    try:
        model = ttr.Transformer(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
        writer = ShmHandler(SERVE_RANK, create=True)
        sub = ShmSubscriber(SERVE_RANK)
        tp = time.perf_counter()
        nbytes = publish_params(torch, writer, 1, model)
        publish_s = time.perf_counter() - tp
        frame = sub.poll()
        seg = np.frombuffer(sub.handler._shm.buf, dtype=np.uint8)
        zero_copy = frame is not None and all(np.shares_memory(r.data, seg) for r in frame.records)
        del frame, seg
        # a commit inside the serve.stale_read delay: dropped, then adopted
        publish_params(torch, writer, 2, model)
        mapped = threading.Event()
        real_load = sub.handler.load_records

        def load_then_signal(*a, **kw):
            out = real_load(*a, **kw)
            mapped.set()
            return out

        sub.handler.load_records = load_then_signal
        racer = threading.Thread(target=lambda: mapped.wait(60) and publish_params(
            torch, writer, 3, model))
        faults.configure("serve.stale_read:delay:1.0")
        try:
            racer.start()
            torn = sub.poll()
        finally:
            faults.reset()
            racer.join(120)
            sub.handler.load_records = real_load
        after_torn = sub.poll()
        torn_ok = torn is None and sub.torn_retries >= 1 and after_torn is not None \
            and after_torn.step == 3 and not racer.is_alive()
        del torn, after_torn
        # a flipped byte in flight: the generation is skipped
        faults.configure("ckpt.shm_stage:bit_flip:@1:7")
        try:
            publish_params(torch, writer, 4, model)
        finally:
            faults.reset()
        rotten = sub.poll()
        crc_ok = rotten is None and sub.crc_retries >= 1
        publish_params(torch, writer, 5, model)

        # greedy serving through the engine against a direct copy restore
        g = SERVE_GREEDY
        eng = ServingEngine(cfg, sub, ttr.Transformer(cfg, device="cuda"),
                            ServingConfig(max_new_tokens=g["max_new"], slots=g["slots"],
                                          soak="always"))
        swapped = eng.try_swap()
        toks, plens = prompt_queue(g["n"], g["lens"], cfg.vocab_size, seed=0)
        prompts, lens = torch.from_numpy(toks).cuda(), torch.from_numpy(plens).cuda()
        st = {}
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        tb = time.perf_counter()
        got = eng.serve_batch(prompts, lens, stats=st)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - tb
        serve_launches = dict(fa.launch_counts)
        from dlrover_tpu_torch.ckpt.sharding import restore_state
        from dlrover_tpu_torch.models.convert import param_state

        _, recs, _ = writer.load_records(copy=True)
        direct = ttr.Transformer(cfg, device="cuda")
        by = {}
        for r in recs:
            by.setdefault(r.path, []).append(r)
        restore_state(param_state(direct), lambda p: by.get(p, []))
        del recs, by
        want = continuous_generate(direct, prompts, lens, None, cfg, max_new_tokens=g["max_new"],
                                   slots=g["slots"], greedy=True)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        weights_equal = all(torch.equal(a, b) for a, b in
                            zip(eng.params.parameters(), model.parameters()))
        del direct, want
        fa.reset_launch_counts()
        mean_d, max_d, n_tok, scored = decode_vs_scoring(
            torch, eng.params, cfg, *got, plens, range(g["n"]))
        scoring_launches = dict(fa.launch_counts)
        undo = late_cache_fault(ttr)
        try:
            bad = continuous_generate(eng.params, prompts, lens, None, cfg,
                                      max_new_tokens=g["max_new"], slots=g["slots"], greedy=True)
        finally:
            undo()
        f_mean, f_max, _, _ = decode_vs_scoring(torch, eng.params, cfg, *bad, plens,
                                                range(g["n"]))
        new_tokens = int((got[2].long() - lens).sum())
        settle = capture_vs_settle(torch)
        settle_ok = not settle["errors"] and not settle["thread_alive"]
        serve_ok = (zero_copy and torn_ok and crc_ok and swapped and bitwise and weights_equal
                    and settle_ok
                    and max_d <= DECODE_LOGP_TOL and f_max >= DECODE_FAULT_RATIO * DECODE_LOGP_TOL
                    and all(serve_launches[k] == 0 for k in serve_launches)
                    and all(scoring_launches[k] > 0 for k in ("fa_fwd",)))
        res.update(
            model="gpt2_small", publish_bytes=nbytes, publish_s=publish_s,
            zero_copy=zero_copy, torn_retries=sub.torn_retries, torn_ok=torn_ok,
            crc_retries=sub.crc_retries, crc_record=sub.last_crc_record, crc_ok=crc_ok,
            swap_ms=eng.last_swap_ms, swap_bytes=eng.last_swap_bytes, engine=eng.stats(),
            greedy=dict(prompts=g["n"], prompt_lens=[int(x) for x in plens],
                        max_new_tokens=g["max_new"], slots=g["slots"], new_tokens=new_tokens,
                        batch_s=batch_s, tokens_per_s=new_tokens / batch_s,
                        iterations=st["iterations"], d2h_reads=st["d2h_reads"],
                        iteration_ms_median=float(statistics.median(st["read_ms"])),
                        graphs=st["graphs"], bitwise_vs_direct_restore=bitwise,
                        weights_equal=weights_equal),
            decode_vs_scoring=dict(mean_abs=mean_d, max_abs=max_d, tokens=n_tok, tol=DECODE_LOGP_TOL,
                                   scored_lengths=scored, planted_late_cache_mean=f_mean,
                                   planted_late_cache_max=f_max, ratio_needed=DECODE_FAULT_RATIO),
            decode_launches=serve_launches, scoring_launches=scoring_launches,
            decode_products=ttr.decode_products("cuda"),
            settle_during_capture=dict(settle, ok=settle_ok),
        )
        del eng, model, got, bad
        gc.collect()
        torch.cuda.empty_cache()
        rl = run_rlhf(torch, fa, cfg)
        res["rlhf"] = rl
        ok = serve_ok and rl["ok"]
    finally:
        if sub is not None:
            sub.close()
        if writer is not None:
            writer.close(unlink=True)
        env.close()
    emit("serve", seconds=time.perf_counter() - t0, ok=ok, **res)
    if not ok:
        raise RuntimeError("the serve phase failed its checks")
    return res


def run_rlhf(torch, fa, cfg):
    """A ``RewardModel`` trained ``rm_steps`` steps on seeded preference
    pairs, then ``RLHFEngine`` (``iterations`` of ``make_experience`` and
    ``train``) on the card; every loss and metric finite, the first
    minibatch of each ``train`` at ratio 1 (``approx_kl``, ``clip_frac``
    within ``RLHF_RATIO_TOL``), the launches each path's reckoning; then
    the first update's loss at 2 layers held to the CPU plain path."""
    import copy
    from dataclasses import replace

    from dlrover_tpu_torch.rl import PPOConfig, RLHFEngine, RewardModel
    from dlrover_tpu_torch.rl.ppo import ppo_loss

    r = RLHF_RUN
    V, L = cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(0)
    chosen = rng.integers(1, V, (8, r["rm_len"]))
    rejected = rng.integers(1, V, (8, r["rm_len"]))
    rm = RewardModel(cfg, lr=1e-5, seed=0)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    rm_metrics = [rm.train_on_preferences(chosen, rejected) for _ in range(r["rm_steps"])]
    torch.cuda.synchronize()
    rm_s = time.perf_counter() - t0
    rm_launches = dict(fa.launch_counts)
    per = 2 if cfg.remat else 1
    rm_expect = {"fa_fwd": r["rm_steps"] * 2 * L * per, "fa_bwd_dkdv": r["rm_steps"] * 2 * L,
                 "fa_bwd_dq": r["rm_steps"] * 2 * L}
    ppo = PPOConfig(rollout_batch=r["prompts"], max_new_tokens=r["max_new"],
                    temperature=r["temperature"], top_k=r["top_k"], ppo_epochs=r["ppo_epochs"],
                    minibatch_size=r["minibatch"], learning_rate=1e-5)
    eng = RLHFEngine(cfg, rm.as_reward_fn(), ppo, seed=0)
    prompts = rng.integers(1, V, (r["prompts"], r["prompt_len"]))
    iters = []
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(r["iterations"]):
        te = time.perf_counter()
        exp = eng.make_experience(prompts)
        seen = []
        last = eng.train(r["prompt_len"], on_update=seen.append)
        iters.append(dict(reward_mean=float(exp.rewards[:, -1].mean()),
                          first=seen[0], last=last, updates=len(seen),
                          s=time.perf_counter() - te))
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t0
    ppo_launches = dict(fa.launch_counts)
    n_mb = -(-r["prompts"] // r["minibatch"]) * r["ppo_epochs"]
    # a rollout: the actor's, the ref's and the critic's scoring and the
    # reward model's; an update: the actor's and the critic's forward
    ppo_expect = {"fa_fwd": r["iterations"] * (4 * L + n_mb * 2 * L * per),
                  "fa_bwd_dkdv": r["iterations"] * n_mb * 2 * L,
                  "fa_bwd_dq": r["iterations"] * n_mb * 2 * L}
    finite = all(math.isfinite(v) for m in rm_metrics for v in m.values()) and all(
        math.isfinite(v) for it in iters for m in (it["first"], it["last"]) for v in m.values())
    centered = all(abs(it["first"]["approx_kl"]) <= RLHF_RATIO_TOL
                   and it["first"]["clip_frac"] <= RLHF_RATIO_TOL for it in iters)
    del eng, rm
    gc.collect()
    torch.cuda.empty_cache()

    # the first update's loss at 2 layers: card against the CPU plain path
    cfg2 = replace(cfg, num_layers=2)
    e2 = RLHFEngine(cfg2, lambda t, p: (t[:, p:] % 7 == 0).mean(1).astype(np.float32), ppo,
                    seed=1)
    e2.make_experience(prompts)
    mb = next(e2.buffer.minibatches(r["minibatch"], np.random.default_rng(0)))
    with torch.no_grad():
        card = {"actor": e2.actor_params, "critic": e2.critic_params}
        loss_card, _ = ppo_loss(card, {k: torch.from_numpy(v).cuda() for k, v in mb.items()},
                                r["prompt_len"], cfg=cfg2, ppo=ppo)
        cpu = {k: copy.deepcopy(v).to("cpu") for k, v in card.items()}
        loss_cpu, _ = ppo_loss(cpu, {k: torch.from_numpy(v) for k, v in mb.items()},
                               r["prompt_len"], cfg=cfg2, ppo=ppo)
    loss_card, loss_cpu = float(loss_card), float(loss_cpu)
    del e2, card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    cpu_ok = abs(loss_card - loss_cpu) <= RLHF_CPU_TOL
    ok = (finite and centered and cpu_ok and rm_launches == rm_expect
          and ppo_launches == ppo_expect)
    return dict(
        ok=ok, reward_model=dict(steps=r["rm_steps"], pairs=8, seq=r["rm_len"], metrics=rm_metrics,
                                 s=rm_s, launches=rm_launches, expected_launches=rm_expect),
        ppo=dict(prompts=r["prompts"], prompt_len=r["prompt_len"], max_new_tokens=r["max_new"],
                 temperature=r["temperature"], top_k=r["top_k"], iterations=iters, s=ppo_s,
                 scored_lengths=[r["prompt_len"] + r["max_new"] - 1,
                                 r["prompt_len"] + r["max_new"]],
                 launches=ppo_launches, expected_launches=ppo_expect),
        finite=finite, ratio_centered=centered, ratio_tol=RLHF_RATIO_TOL,
        first_update_loss_2_layers=dict(card=loss_card, cpu_plain=loss_cpu, tol=RLHF_CPU_TOL,
                                        ok=cpu_ok),
    )


def run_serve_phase(torch, fa, qo):
    """``--phase serve``: the ragged attention checks, the full run's
    serving and RLHF paths, co-located serving beside ``ElasticTrainer``,
    the dedicated Llama-2-7B serving and the settle check's planted
    fault."""
    ragged_attention_checks(torch, fa)
    run_serve(torch, fa)
    run_colocated(torch, fa, qo)
    run_serve_7b(torch)
    # the planted fault of the serve line's settle check, last (a failed
    # capture may leave the process's card state behind it): a bare
    # card-wide synchronize while a capture is open; no gate
    emit("capture_vs_bare_sync", **capture_vs_settle(torch, locked=False))


def run_colocated(torch, fa, qo):
    """gpt2_small under ``ElasticTrainer`` as the slice (8 x 1024,
    ``adamw_8bit_flat``, the world-1 strategy) with a Flash Checkpoint
    memory save every ``COLOC_SAVE_EVERY`` steps to a saver of this
    process, ``COLOC_STEPS`` steps alone and again with a
    ``ServingEngine`` thread (``soak="idle_gaps"``) following the
    trainer's commits and serving between steps. Gates: the trainer's
    losses bitwise equal, at least 2 swaps with the weight step going up,
    each batch under one weight step, ``serving_soak`` above 0 in the
    trainer's ledger, tokens served. Printed beside the JAX bench's
    gates, without a gate: step medians, tokens/s, forced batches, swap
    ms, staleness, goodput with and without serving."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.ckpt.shm_handler import ShmSubscriber, shard_shm_name
    from dlrover_tpu_torch.common.multi_process import attach_shared_memory
    from dlrover_tpu_torch.models import gpt2_small
    from dlrover_tpu_torch.models.transformer import Transformer
    from dlrover_tpu_torch.serve import ServingConfig, ServingEngine

    t0 = time.perf_counter()
    cfg = gpt2_small()
    data = RandomTokens(seq=COLOC_SEQ)
    runs = {}
    c = COLOC_SERVING
    toks, plens = prompt_queue(c["n"], c["lens"], cfg.vocab_size, seed=1)
    batches, errors, stats = [], [], {}

    def ledger(trainer):
        rep = trainer._goodput.snapshot()
        return {"goodput_pct": rep.goodput_pct, "serving_soak_s": rep.seconds.get("serving_soak", 0.0),
                "productive_compute_s": rep.seconds.get("productive_compute", 0.0)}

    def one_run(label, serve):
        """One trainer run with a saver of this process, under a job
        and a checkpoint dir of its own (nothing to restore from)."""
        env = _Env(f"coloc{label}")
        ckpt = tempfile.mkdtemp(prefix="coloc_")
        AsyncCheckpointSaver.reset()
        saver = AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=1)
        saver._persisted_step = 10 ** 9  # every save stays in shm: nothing to disk
        # a synchronous memory save: the chunked stage drains a 0.75 GB
        # state at its 5 ms a step over ~10 steps, so at a save every 2
        # steps a commit is followed at once by the next save's open
        # generation, and no frame stays published between steps
        tcfg = dict(ckpt_dir=ckpt, save_memory_interval=COLOC_SAVE_EVERY,
                    save_storage_interval=10 ** 9, chunked_staging=False)
        try:
            # both runs stamp a step when the trainer's stream is done:
            # a device-wide synchronize would book the serving thread's
            # work to the trainer's steps
            if not serve:
                return _trainer_run(torch, fa, qo, cfg, "adamw_8bit_flat", COLOC_STEPS, data,
                                    COLOC_BATCH, strategy=picked_strategy(cfg), tcfg=tcfg,
                                    inspect=ledger, device_sync=False)
            stop = threading.Event()
            sub = ShmSubscriber(0)
            eng = ServingEngine(cfg, sub, Transformer(cfg, device="cuda"),
                                ServingConfig(max_new_tokens=c["max_new"], slots=c["slots"],
                                              soak="idle_gaps"), param_prefix="train/params/")
            prompts, lens = torch.from_numpy(toks).cuda(), torch.from_numpy(plens).cuda()

            def loop():
                # follow the trainer's commits: before each batch try for
                # a newer frame until one lands or COLOC_SWAP_WAIT_S
                # passes (a save opens the next generation ~2 steps after
                # a commit, and a poll can meet it mid-write)
                try:
                    while not stop.is_set():
                        deadline = time.monotonic() + COLOC_SWAP_WAIT_S
                        while (not eng.try_swap() and time.monotonic() < deadline
                               and not stop.is_set()):
                            time.sleep(0.003)
                        if eng.params is None:
                            continue
                        w0, g0 = eng.weight_step, eng.weight_generation
                        stale = eng.staleness_steps()
                        st = {}
                        tb = time.perf_counter()
                        out = eng.serve_batch(prompts, lens, stats=st)
                        batches.append(dict(weight_step=w0, same_weights=eng.weight_step == w0
                                            and eng.weight_generation == g0, staleness=stale,
                                            new_tokens=int((out[2].long() - lens).sum()),
                                            s=time.perf_counter() - tb,
                                            iterations=st["iterations"]))
                except BaseException as e:  # noqa: BLE001 - reported by the phase
                    errors.append(repr(e))

            th = threading.Thread(target=loop, name="serving")

            def finish(trainer):
                stop.set()  # the batch in flight ends and is booked first
                th.join(300)
                return dict(ledger(trainer), thread_alive=th.is_alive())

            try:
                return _trainer_run(torch, fa, qo, cfg, "adamw_8bit_flat", COLOC_STEPS, data,
                                    COLOC_BATCH, strategy=picked_strategy(cfg), tcfg=tcfg,
                                    prepare=lambda trainer: th.start(), inspect=finish,
                                    device_sync=False)
            finally:
                stop.set()
                th.join(300)
                stats.update(eng.stats())
                del eng
                sub.close()
        finally:
            AsyncCheckpointSaver.reset()
            # the saver leaves its segment for a restart to read: this
            # run's job is over
            seg = attach_shared_memory(shard_shm_name(0))
            if seg is not None:
                seg.close()
                seg.unlink()
            env.close()
            shutil.rmtree(ckpt, ignore_errors=True)

    runs["alone"] = one_run("a", False)
    runs["serving"] = one_run("s", True)
    a, s = runs["alone"], runs["serving"]
    steps_seen = [b["weight_step"] for b in batches]
    swaps_up = stats["swaps"] >= 2 and all(x <= y for x, y in zip(steps_seen, steps_seen[1:])) \
        and len(set(steps_seen)) >= 2
    served = sum(b["new_tokens"] for b in batches)
    serve_s = sum(b["s"] for b in batches)
    step_loss = s["median_step_ms"] / a["median_step_ms"] - 1
    goodput_drop = a["goodput_pct"] - s["goodput_pct"]
    ok = (not errors and not s["thread_alive"] and a["losses"] == s["losses"] and swaps_up
          and all(b["same_weights"] for b in batches) and s["serving_soak_s"] > 0 and served > 0)
    emit("serve_colocated", seconds=time.perf_counter() - t0, model="gpt2_small", batch=COLOC_BATCH,
         seq=COLOC_SEQ,
         steps=COLOC_STEPS, save_memory_every=COLOC_SAVE_EVERY, losses_bitwise=a["losses"] == s["losses"],
         median_step_ms={"alone": a["median_step_ms"], "serving": s["median_step_ms"]},
         step_time_lost=step_loss, jax_bench_step_loss_gate=JAX_BENCH_STEP_LOSS,
         goodput_pct={"alone": a["goodput_pct"], "serving": s["goodput_pct"]},
         goodput_points_lost=goodput_drop, jax_bench_goodput_gate_points=JAX_BENCH_GOODPUT_POINTS,
         serving_soak_s=s["serving_soak_s"], batches=len(batches), served_tokens=served,
         tokens_per_s=served / serve_s if serve_s else 0.0,
         tokens_per_s_per_pct_step_lost=(served / serve_s / max(step_loss * 100, 1e-9)
                                         if serve_s else 0.0),
         forced_batches=stats["forced_batches"], swaps=stats["swaps"],
         dropped_swaps=stats["dropped_swaps"], torn_retries=stats["torn_retries"],
         crc_retries=stats["crc_retries"], swap_ms_last=stats["last_swap_ms"],
         swap_bytes=stats["last_swap_bytes"], weight_steps=steps_seen,
         staleness=[b["staleness"] for b in batches], errors=errors,
         launches={"alone": a["launches"], "serving": s["launches"]}, ok=ok)
    if not ok:
        raise RuntimeError("co-located serving failed its checks")


def run_serve_7b(torch):
    """Llama-2-7B at full size (32 x 4096, vocab 32000, f32 params drawn
    on the card from seed 0, bf16 activations) published through a
    ``ShmHandler`` and swapped into a ``ServingEngine``, which serves
    ``soak="always"``: the prompt queue greedy, then sampled. Gates: the
    decode-vs-scoring limit on ``checked`` greedy prompts (B3 at lengths
    up to P + N - 1, no multiple of 64) and the planted late cache on
    them beyond it by ``DECODE_FAULT_RATIO``, every sampled token's
    logprob finite (a token outside the top-k / top-p support reads
    -inf)."""
    from dlrover_tpu_torch.ckpt.shm_handler import ShmHandler, ShmSubscriber
    from dlrover_tpu_torch.models import llama2_7b
    from dlrover_tpu_torch.models import transformer as ttr
    from dlrover_tpu_torch.serve import ServingConfig, ServingEngine

    t0 = time.perf_counter()
    cfg = llama2_7b()
    s7 = SERVE_7B
    env = _Env("serve7b")
    writer = sub = None
    try:
        model = ttr.Transformer(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
        writer = ShmHandler(SERVE_RANK, create=True)
        tp = time.perf_counter()
        nbytes = publish_params(torch, writer, 1, model)
        publish_s = time.perf_counter() - tp
        del model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sub = ShmSubscriber(SERVE_RANK)
        eng = ServingEngine(cfg, sub, ttr.Transformer(cfg, device="cuda"),
                            ServingConfig(max_new_tokens=s7["max_new"], slots=s7["slots"],
                                          soak="always"))
        swapped = eng.try_swap()
        toks, plens = prompt_queue(s7["n"], s7["lens"], cfg.vocab_size, seed=2)
        prompts, lens = torch.from_numpy(toks).cuda(), torch.from_numpy(plens).cuda()
        out = {}
        for mode in ("greedy", "sampled"):
            eng.serving.greedy = mode == "greedy"
            eng.serving.temperature = s7["temperature"]
            eng.serving.top_k = 0 if mode == "greedy" else s7["top_k"]
            eng.serving.top_p = 1.0 if mode == "greedy" else s7["top_p"]
            st, iter_ms = {}, []
            gen = torch.Generator(device="cuda").manual_seed(3)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            res = eng.serve_batch(prompts, lens, gen, stats=st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - tb
            new = int((res[2].long() - lens).sum())
            out[mode] = dict(res=res, stats=dict(
                batch_s=wall, iterations=st["iterations"], d2h_reads=st["d2h_reads"],
                graphs=st["graphs"],
                iteration_ms_median=float(statistics.median(st["read_ms"])),
                iteration_ms_mean=wall / st["iterations"] * 1e3,
                new_tokens=new, prefill_tokens=int(lens.sum()), decode_tokens_per_s=new / wall,
                prefill_tokens_per_s=int(lens.sum()) / wall))
        g, smp = out["greedy"]["res"], out["sampled"]["res"]
        rows = list(range(s7["checked"]))
        mean_d, max_d, n_tok, scored = decode_vs_scoring(torch, eng.params, cfg, *g, plens, rows)
        # the planted late cache on the checked prompts, greedy
        eng.serving.greedy, eng.serving.top_k, eng.serving.top_p = True, 0, 1.0
        n = s7["checked"]
        undo = late_cache_fault(ttr)
        try:
            bad = eng.serve_batch(prompts[:n], lens[:n])
        finally:
            undo()
        f_mean, f_max, _, _ = decode_vs_scoring(torch, eng.params, cfg, *bad, plens, rows)
        del bad
        emitted = [smp[1][i, :int(smp[2][i] - lens[i])] for i in range(s7["n"])]
        sampled_finite = all(bool(torch.isfinite(x).all()) for x in emitted)
        ragged = [t for t in scored if t % 64]
        peak = torch.cuda.max_memory_allocated()
        stats = eng.stats()
        ok = (swapped and max_d <= DECODE_LOGP_TOL and sampled_finite and len(ragged) > 0
              and f_max >= DECODE_FAULT_RATIO * DECODE_LOGP_TOL)
        emit("serve_7b", seconds=time.perf_counter() - t0, model="llama2_7b",
             publish_bytes=nbytes, publish_s=publish_s, swap_ms=stats["last_swap_ms"],
             swap_bytes=stats["last_swap_bytes"], prompts=s7["n"],
             prompt_lens=[int(x) for x in plens], max_new_tokens=s7["max_new"], slots=s7["slots"],
             kv_cache_bytes=2 * cfg.num_layers * s7["slots"] * (s7["lens"][1] + s7["max_new"])
             * cfg.kv_heads * cfg.head_dim * 2,
             greedy=out["greedy"]["stats"], sampled=out["sampled"]["stats"],
             sampling=dict(temperature=s7["temperature"], top_k=s7["top_k"], top_p=s7["top_p"]),
             decode_vs_scoring=dict(mean_abs=mean_d, max_abs=max_d, tokens=n_tok,
                                    tol=DECODE_LOGP_TOL, scored_lengths=scored,
                                    planted_late_cache_mean=f_mean, planted_late_cache_max=f_max,
                                    ratio_needed=DECODE_FAULT_RATIO),
             decode_products=ttr.decode_products("cuda"),
             sampled_logprobs_finite=sampled_finite, peak_bytes=peak, ok=ok)
        del eng, g, smp, out
    finally:
        if sub is not None:
            sub.close()
        if writer is not None:
            writer.close(unlink=True)
        env.close()
        gc.collect()
        torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError("the 7 B serving run failed its checks")


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
    if not os.environ.get("DLROVER_TPU_TOPOLOGY_CACHE"):
        # the link-model and drift caches of every process this run
        # starts, under the run's temp dir
        import tempfile

        os.environ["DLROVER_TPU_TOPOLOGY_CACHE"] = tempfile.mkdtemp(prefix="dlr_topology_")
    if "--dp-worker" in sys.argv:  # one rank of the dp phase
        i = sys.argv.index("--dp-worker")
        dp_worker(sys.argv[i + 1], int(sys.argv[i + 2]))
        return 0
    if "--llama-worker" in sys.argv:  # the llama phase's full model
        llama_worker(sys.argv[sys.argv.index("--llama-worker") + 1], "--profile" in sys.argv,
                     "--search-only" in sys.argv, persist="--ckpt7b-persist" in sys.argv,
                     search="--no-search" not in sys.argv)
        return 0
    if "--accel-worker" in sys.argv:  # the accel phase's link model and offload
        accel_worker(sys.argv[sys.argv.index("--accel-worker") + 1])
        return 0
    if "--peak-worker" in sys.argv:  # one case of the peak_memory phase
        i = sys.argv.index("--peak-worker")
        peak_worker(sys.argv[i + 2], sys.argv[i + 1])
        return 0
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
        if phase not in ("flash_ckpt", "evict", "dp", "llama", "accel", "peak_memory", "resize",
                         "c3", "sp", "tp", "ep", "pp", "ckpt7b", "sparse_tiers", "serve"):
            raise SystemExit(f"unknown phase {phase!r}")
        if phase == "sparse_tiers":  # the sparse slice beside it, for its step and ids/s
            run_sparse_full(torch, er)
            check_embedding_rows(torch, er, cap=256 << 10,
                                 label="B8/B9 emb rows, the 256 MiB tier's table")
            run_sparse_tiers(torch, er)  # the full run's small size too
            run_sparse_tiers(torch, er, full=True)
        elif phase == "ckpt7b":
            link_calibration(torch)
            run_ckpt7b(torch)
        elif phase == "serve":
            run_serve_phase(torch, fa, qo)
        elif phase == "dp":
            run_dp(torch)
        elif phase == "sp":
            run_sp(torch, fa)
        elif phase == "tp":
            run_tp(torch, qo)
        elif phase == "ep":
            run_ep(torch, fa, qo)
        elif phase == "pp":
            run_pp(torch, fa, qo)
        elif phase == "resize":
            run_resize(torch)
        elif phase == "c3":  # C3 alone, with the allocator's history at each peak
            run_c3(torch, trace=True)
        elif phase == "accel":
            run_accel(torch)
        elif phase == "peak_memory":
            run_peak_memory(torch)
        elif phase == "llama":
            run_llama(torch, fa, qo, profile="--profile" in sys.argv)
        else:
            link_arbiter_line(flash=run_flash_ckpt(torch, phase)["arbiter"])
        emit("timing", total_s=time.perf_counter() - T0)
        return 0

    llama = run_llama(torch, fa, qo, profile="--profile" in sys.argv)
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
    ragged = ragged_attention_checks(torch, fa)
    adam_res, adam_abs = check_adam8(torch, qo, gpt2_small())
    leaf_res, leaf_abs = check_adam8_leaf(torch, qo, gpt2_small())
    emb_t = check_embedding_rows(torch, er)
    torch.cuda.empty_cache()

    small_model_agrees(torch)
    counts, flat_losses, audit = run_slice(torch, fa, qo, profile="--profile" in sys.argv)
    link_calibration(torch)
    leaf_counts, leaf_losses, _ = run_slice(torch, fa, qo, opt="adamw_8bit")
    rel = [abs(a - b) / abs(b) for a, b in zip(leaf_losses, flat_losses)]
    ok = len(rel) == len(flat_losses) and max(rel) <= LOSS_MATCH_RTOL
    emit("adamw_8bit_vs_flat", max_rel_diff=max(rel), tol=LOSS_MATCH_RTOL,
         bitwise=leaf_losses == flat_losses, ok=ok)
    if not ok:
        raise RuntimeError("adamw_8bit's losses leave adamw_8bit_flat's")
    serve = run_serve(torch, fa)
    emb_counts = run_sparse_full(torch, er, profile="--profile" in sys.argv)
    spill_link = run_sparse_spill(torch)
    tiers_counts = run_sparse_tiers(torch, er)
    # the accel worker (the link model, gpt2_xl's offload: no timing gate)
    # runs beside the dp phase (gpt2_small ranks: 43 + 3 x 7.8 GB at
    # their peaks)
    accel_wait = _worker_start(torch, "--accel-worker", "accel")
    try:
        dp_accel = run_dp(torch)
    except BaseException:
        accel_wait(abort=True)
        raise
    run_accel(torch, llama["full"]["search"], dp_accel, audit, worker=accel_wait)
    link_arbiter_line(flash=run_flash_ckpt(torch)["arbiter"], spill=spill_link)
    side = run_resize(torch, side=start_tp_ep(torch, fa, qo))
    tp, ep, pp = side["tp"], side["ep"], side["pp"]
    sp = run_sp(torch, fa, full=True)

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
            llama2_7b_launches_per_step=llama["full"]["launches_per_step"][name],
            # per declared mask family and shape: ms, tile error, bound and
            # the launches of one differentiable call under it
            masked={fam: {shape: d[name] for shape, d in by.items()}
                    for fam, by in sp["masks"].items()},
            sp_ring_launches_per_step=sp["runs"]["ring"][0]["launches_per_step"][name],
            tp2_launches_per_step=tp["runs"]["tp2"][0]["launches_per_step"][name],
            ep2_launches_per_step=ep["runs"]["ep2"][0]["launches_per_step"][name],
            pp2_launches_per_step=_pp_launches(pp, name),
            pp_microbatch={k: pp["kernels"][k][name] for k in ("ms", "plain_ms", "bound")},
            pp3d_launches_per_step=_pp_launches(pp["pp3d"], name),
            pp_tp_microbatch={k: pp["pp3d"]["kernels"][k][name]
                              for k in ("ms", "plain_ms", "bound")},
            pp_fsdp_microbatch={k: pp["pp3d"]["kernels"]["fsdp"][k][name]
                                for k in ("ms", "plain_ms", "bound")},
            ep_tp_heads={k: ep["kernels3d"]["tp_heads"][k][name]
                         for k in ("ms", "plain_ms", "bound", "library_ms")},
            # lengths no multiple of a tile (RAGGED_T): ms, bound, plain,
            # library and error per case
            ragged={case: d[name] for case, d in ragged.items()},
            serve_scoring_launches=serve["scoring_launches"][name],
            rlhf_reward_model_launches=serve["rlhf"]["reward_model"]["launches"][name],
            rlhf_ppo_launches=serve["rlhf"]["ppo"]["launches"][name],
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
            llama2_7b_launches_per_step=llama["full"]["launches_per_step"][name],
            tp2_launches_per_step=tp["runs"]["tp2"][0]["launches_per_step"].get(name, 0),
            ep2_launches_per_step=ep["runs"]["ep2"][0]["launches_per_step"].get(name, 0),
            pp2_launches_per_step=_pp_launches(pp, name),
            pp3d_launches_per_step=_pp_launches(pp["pp3d"], name),
            **({"tp_local_w_gate": {k: tp["adam"][k] for k in ("ms", "plain_ms", "bound_ms")},
                "ep_expert_box_w_up": {k: ep["adam"][k] for k in ("ms", "plain_ms", "bound_ms")},
                "pp_stage_row_w_up": {k: pp["adam"][k] for k in ("ms", "plain_ms", "bound_ms")},
                "pp_tp_stage_box_w_up": {k: pp["pp3d"]["adam"][k]
                                         for k in ("ms", "plain_ms", "bound_ms")},
                "ep_tp_expert_box_w_up": ep["kernels3d"]["adam8_ep_tp_box"]}
               if name == "adam8_leaf" else {}),
        ))
    emb_tpu = "dlrover_tpu/ops/embedding/device_tier.py"
    for name, line in (("emb_gather", 139), ("emb_scatter", 162)):
        kernels.append(dict(
            name=name, route="cuda", source="dlrover_tpu_torch/ops/csrc/embedding_rows.cu",
            replaces=f"{emb_tpu}:{line}", also_replaces=[], launches=emb_counts[name],
            sparse_tiers_launches=tiers_counts[name], max_abs_err=0.0, **emb_t[name],
        ))
    emit("timing", total_s=time.perf_counter() - T0, lines=EMITTED)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
