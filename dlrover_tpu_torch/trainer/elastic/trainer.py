"""ElasticTrainer on PyTorch: the user-facing training loop (counterpart
of ``dlrover_tpu/trainer/elastic/trainer.py``).

The same entry a user calls on the JAX package::

    ElasticTrainer(model_cfg=gpt2_small(), tx=build_optimizer(...),
                   dataset=..., trainer_cfg=TrainerConfig(...)).train(n)

runs here with one process for each device (the card unless
``devices="cpu"``). ``strategy`` lays the processes of the default
process group out as a mesh (``accel/strategy.Strategy``). Without one
the trainer searches, as the JAX trainer does: ``auto_accelerate``
(``accel/accelerate.py``) times the candidates of the world size (a warm-up
and 3 steps each of a state of its own) and the ranks adopt rank 0's
winner; ``self.accel`` holds the result and its dry-run reports. With
``Strategy(offload_opt=True)`` the optimizer state lives in pinned host
memory between steps (``ops/host_offload.py``). Every rank reads the
same global batch from the elastic sampler and trains on its own rows of it
(``parallel/mesh.batch_sharding``), and the gradients are synced over
the data axes: the explicit bucketed sync of ``parallel/grad_sync.py``
when ``comm_overlap`` or ``grad_compress`` asks for it and the mesh
qualifies (dp, or dp x fsdp ZeRO with the optimizer on each rank's
shards), else one all-reduce of the whole gradient tree per microbatch.
The rest: the elastic sampler and data loader (master-retuned batch
size and LR scale), the device prefetcher (``prefetch`` batches ahead,
``data/prefetch.py``), the step of ``models/train.py``, the LR schedule
and retune scale of
``build_optimizer``, metrics at log cadence, the eval loop, and Flash
Checkpoint (``ckpt_dir``): a shm save every ``save_memory_interval``
steps whose copies run beside the next step (``chunked_staging``; the
host side, crc32 over the bytes in shm in ``stage_chunk_mb`` chunks,
runs on host threads of its own and takes at most ``stage_budget_ms``
of the loop a step), a persisted save every ``save_storage_interval``
steps (a stage still open at such a step yields to it), the
best eval's checkpoint under ``ckpt_dir/best`` (``save_best``), and a
restore from shm or storage at construction.

The strategy's ``remat`` (or its ``remat`` opt) is stamped on the
model's config, as the JAX accel pins it (without a strategy the
config's own ``remat`` stands), and its ``batch_pad`` appends that
many zero rows to every global batch before the rank split, which the
step weighs 0 in the loss (the eval batch is trimmed instead, to the
rows the data ranks divide, as in the JAX trainer).

A pp strategy (``Strategy(mesh=MeshConfig(pp=, dp=, fsdp=, tp=),
num_microbatches=, pp_schedule=)``) runs the pipeline step of
``parallel/pipeline.py``: each rank holds its stage (under tp its tp
boxes, under fsdp its ZeRO shards of them), every stage and tp rank of
a data coordinate reads that coordinate's rows of each microbatch
(``pipeline.pipeline_rows``), the eval loss runs through the stages,
and a checkpoint records each stage's rows of the JAX stage-stacked
leaves (the shared leaves from stage 0 alone, a tp-whole leaf from tp
coordinate 0).
``adamw_8bit_flat``, ``grad_accum`` (the microbatches are the
accumulation) and the micro-batch rebalance are refused on it, and a
resize keeps pp.

``donation_aware``: the JAX trainer stops donating state buffers while
a save reads them. Here the optimizer updates the state in place, so
the step's stream waits for the save's device copies before the
optimizer runs (forward and backward run beside them); with it off the
loop waits for those copies at the save itself.

The worker's side of the control loop, as in the JAX package:

- telemetry: the ``step`` span with its ``data_wait`` / ``compute`` /
  ``host_sync`` / ``report`` / ``eval`` / ``ckpt_save`` children, the
  metrics registry, a goodput ledger over the spans and a flight
  recorder (a bundle on a crash, a hang, an eviction or a master's
  request). On the card ``compute`` is closed on a CUDA event recorded
  after the optimizer and read once the card has passed it (no
  per-step host sync): the span holds the step's time on the device's
  clock, placed on the host's clock at the later of its dispatch and
  the previous step's end;
- ``report_metrics``: at log cadence the runtime-metrics file carries
  the step, the scalars and every registry scalar (goodput included)
  to the agent, and a heartbeat thread keeps its ``open_span`` fresh
  for the master's hang attribution;
- master commands relayed through the worker-commands file: ``evict``,
  ``flight_dump`` and ``profile`` (a K-step ``torch.profiler``
  capture), each run once;
- the eviction drain: a notice (SIGTERM once
  ``DLROVER_TPU_EVICTION_DEADLINE_S`` is set, ``request_eviction``, or
  the ``evict`` command) ends the loop at the next step boundary, makes
  an emergency shm save of the current step, waits for its disk persist
  while more than ``eviction_persist_floor_s`` of the grace window
  remain, reports the drain and dumps a flight bundle;
- early stopping after ``early_stopping_patience`` evals without a
  better eval loss.

Flash Checkpoint at world size N: a replicated leaf is staged once per
replica set, by the replica set's first rank, and a ZeRO shard by its
owner with its index in the whole leaf; host values (steps, counts,
the sampler) by every rank. A restore reads each rank's own records and
hands the replicated tensors to the rest of the replica set from its
first rank. The error-feedback residual is never staged.

Elastic resize, through the restart path. One process drives one card
and a torch process group cannot lose or gain a rank in place, so a
resize is a restart: the agent relaunches the workers into the new world
(``agent/training_agent.py``), and the constructor lands there, as the
JAX ``resize`` does for a multi-process job:

- every save carries the strategy that staged it (``step_meta`` of the
  checkpoint engine: the shm extras and the done files, never a leaf of
  the train tree); the constructor reads it back (``_peek_staged``: each
  rank's shm and the storage tracker, the newest over the ranks);
- the strategy: the caller's pinned one, else the staged one, each as it
  is when its mesh has the world's ranks, else carried to them by the
  JAX package's ``_strategy_for`` (exact fit, else the largest mesh with
  the surplus ranks idle against the micro-batch rebalance, priced by
  ``price_rebalance_options`` and calibrated by the measured step time:
  this incarnation's, else the previous one's from the runtime-metrics
  file); with neither,
  a search. Derived strategies come from the job-stable strategy cache
  (``accel/compile_cache.py``) when an earlier incarnation, or the
  speculative derivation of the master's predicted worlds
  (``update_scale_candidates``; ``speculative_compile``,
  ``spec_compile_budget_s``), derived them; rank 0's is broadcast;
- the restore takes the JAX engine's rule (shm where this rank's segment
  holds exactly its new records and every rank agrees, else the agreed
  storage step), the replica sets hand the replicated tensors on
  whatever world staged them, and the error-feedback residual starts
  fresh;
- landing at a world or mesh other than the staging one is booked as the
  JAX resize books it (spans ``resize_build`` and ``resize_reshard``,
  the ``dlrover_resize_idle_ranks`` / ``dlrover_resize_mb_pad`` gauges,
  ``PipelineStats``' resize counters) and reported in ``last_resize``,
  the JAX ``resize``'s dict; ``resize(n)`` at another world raises
  ``NotImplementedError`` naming the restart path.

Idle ranks. When the derivation degrades (e.g. world 3 at batch 8 with
``mb_rebalance=False``: dp=2), the mesh covers the first ranks and the
rest are idle (``self.idle``). An idle rank builds no step and holds no
state or shard; it still makes every collective of the default group
the mesh's ranks make: the staged-strategy gather and the strategy
broadcast, the mesh's ``new_group`` calls, the link model's broadcasts,
and the restore's agreements (its shm proposal counts for none). The
checkpoint has the mesh's ranks as its shards. Its ``train()`` returns
when the mesh's ranks finish theirs: every rank meets at one barrier of
the default group at the end of each ``train`` call while idle ranks
exist. A later restart (a membership change) re-derives the world.

MoE models (``num_experts``) train on every strategy the step runs them
on (any mix of dp, fsdp, ep, sp and tp; ep x fsdp on ZeRO's shards of
the ep boxes; ``adamw_8bit_flat`` is refused on a model-sharded mesh,
so the per-leaf ``adamw_8bit`` updates each rank's expert boxes). The
eval routes the whole eval batch on every rank (its capacity from the
whole batch), so its loss does not depend on the mesh. With
``moe_rebalance_interval`` > 0 the measured per-expert load
(``moe_expert_load``) feeds a ``CapacityRebalancer`` every that many
steps; a changed re-split sets ``capacity_splits`` and rebuilds the step
(the state stays), counted in ``PipelineStats.moe_capacity_resplits``
and the ``dlrover_moe_capacity_resplits`` gauge. ep keeps its size
across a resize, as tp and sp do.

``TrainerConfig`` keeps every field and default of the JAX package.
Knobs whose machinery is not ported yet raise ``NotImplementedError``
when set away from their default (``_UNPORTED``, with the ROADMAP item
that ports them).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, fields, replace as dc_replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.accel.accelerate import AccelerateResult, auto_accelerate
from dlrover_tpu_torch.accel.compile_cache import CompileCache, CompileTask, SpeculativeCompiler
from dlrover_tpu_torch.accel.profiler import PipelineStats
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.agent.monitor import (
    last_command_id,
    read_runtime_metrics,
    read_worker_commands,
    report_runtime_metrics,
)
from dlrover_tpu_torch.ckpt.checkpointer import FlashCheckpointer, StorageType
from dlrover_tpu_torch.common import cuda_sync, faults, storage
from dlrover_tpu_torch.common.constants import NodeEnv, TrainerEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.prefetch import DevicePrefetcher
from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.convert import load_train_state_tree, train_state_tree
from dlrover_tpu_torch.models.transformer import forward, token_nll, vocab_split
from dlrover_tpu_torch.obs.audit import (
    StepAuditor,
    StepBudget,
    install_default_auditor,
    load_audit_calibration,
)
from dlrover_tpu_torch.obs.flight_recorder import (
    ProfilerCapture,
    default_recorder,
)
from dlrover_tpu_torch.obs.goodput import GoodputLedger, install_default_ledger
from dlrover_tpu_torch.obs.metrics import default_registry, fold_pipeline_stats
from dlrover_tpu_torch.obs.trace import SpanHeartbeat, get_tracer, span
from dlrover_tpu_torch.parallel import grad_sync, transfer_sched
from dlrover_tpu_torch.parallel.mesh import batch_sharding
from dlrover_tpu_torch.trainer.elastic.dataloader import ElasticDataLoader
from dlrover_tpu_torch.trainer.elastic.sampler import (
    ElasticDistributedSampler,
)
from dlrover_tpu_torch.utils.device import resolve_device


@dataclass
class TrainerConfig:
    batch_size: int = 8
    seq_len: int = 128
    ckpt_dir: str = ""
    save_memory_interval: int = 50
    save_storage_interval: int = 500
    report_metrics: bool = True
    log_interval: int = 10
    eval_interval: int = 0
    eval_steps: int = 50
    grad_accum: int = 1
    save_best: bool = False
    save_best_min_interval_s: float = 60.0
    early_stopping_patience: int = 0
    prefetch: int = 2
    chunked_staging: bool = True
    stage_chunk_mb: int = 64
    stage_budget_ms: float = 5.0
    donation_aware: bool = True
    speculative_compile: bool = True
    spec_compile_budget_s: float = 120.0
    comm_overlap: bool = False
    grad_compress: str = "none"
    grad_topk_density: float = 0.25
    grad_bucket_mb: int = 4
    mb_rebalance: bool = True
    moe_rebalance_interval: int = 0
    eviction_grace_s: float = 30.0
    eviction_persist_floor_s: float = 5.0
    sdc_detect: bool = False
    sdc_window: int = 32
    sdc_min_history: int = 8
    sdc_spike_sigma: float = 6.0
    sdc_suspect_sigma: float = 6.0
    sdc_audit_steps: int = 0


# the longest a disk save waits for the saver to finish persisting an
# older step (the engine's own wait for the disk commit)
STORAGE_SAVE_WAIT_S = 600.0

# knob -> the ROADMAP item that ports its machinery. sdc_detect: the
# JAX trainer escalates a suspect lane to the paired audit probe, and
# half of that defense is worse than none
_UNPORTED = {
    "sdc_detect": "A15 (SDC audit probe)",
}


def _check_unported(tcfg: TrainerConfig) -> None:
    defaults = {f.name: f.default for f in fields(TrainerConfig)}
    for name, item in _UNPORTED.items():
        if getattr(tcfg, name) != defaults[name]:
            raise NotImplementedError(
                f"TrainerConfig.{name}={getattr(tcfg, name)!r} is not "
                f"ported yet (ROADMAP {item})"
            )


# ---------------------------------------------------------------------------
# optimizers + LR schedules (the optax schedules, in plain Python)
# ---------------------------------------------------------------------------
def _linear_schedule(init, end, steps):
    if steps <= 0:
        return lambda count: init

    def f(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return f


def _cosine_decay_schedule(init, decay_steps, alpha=0.0):
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def f(count):
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return f


def _join_schedules(schedules, boundaries):
    def f(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out

    return f


def lr_schedule(lr, schedule, warmup_steps, total_steps) -> Callable[[int], float]:
    if schedule == "constant":
        return (
            _linear_schedule(0.0, lr, warmup_steps)
            if warmup_steps
            else (lambda count: lr)
        )
    if schedule == "cosine":
        if not warmup_steps:
            return _cosine_decay_schedule(lr, total_steps)
        return _join_schedules(
            [
                _linear_schedule(0.0, lr, warmup_steps),
                _cosine_decay_schedule(lr, total_steps - warmup_steps),
            ],
            [warmup_steps],
        )
    if schedule == "linear":
        decay = _linear_schedule(lr, 0.0, max(total_steps - warmup_steps, 1))
        if not warmup_steps:
            return decay
        return _join_schedules(
            [_linear_schedule(0.0, lr, warmup_steps), decay], [warmup_steps]
        )
    raise ValueError(f"unknown lr schedule {schedule!r}")


class ScheduledOptimizer:
    """An optimizer driven by an LR schedule and a retune scale (the
    port of ``optax.inject_hyperparams``): before update ``count`` the
    learning rate is ``lr_fn(count)``; ``retune_scale`` multiplies the
    whole update."""

    def __init__(self, opt: torch.optim.Optimizer, lr_fn: Callable[[int], float]):
        self.opt = opt
        self.lr_fn = lr_fn
        self.count = 0
        self.retune_scale = 1.0
        self.learning_rate = float(lr_fn(0))

    def step(self):
        self.learning_rate = float(self.lr_fn(self.count))
        for g in self.opt.param_groups:
            if "retune_scale" in g:  # the optimizer scales its update
                g["lr"] = self.learning_rate
                g["retune_scale"] = self.retune_scale
            else:  # torch's built-ins: the update is linear in lr
                g["lr"] = self.learning_rate * self.retune_scale
        self.opt.step()
        self.count += 1


_ADAM_KW = {"b1", "b2", "eps"}
_SGD_KW = {"momentum", "nesterov"}
_AGD_KW = {"b1", "b2", "delta", "amsgrad", "clip"}


def build_optimizer(
    name: str = "adamw",
    lr: float = 3e-4,
    schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: int = 10_000,
    weight_decay: float = 0.0,
    **kwargs,
) -> Callable:
    """Optimizer factory + LR schedule, retune-compatible. Returns a
    callable ``params -> ScheduledOptimizer``. Weight decay is decoupled
    for the adaptive optimizers and L2-into-update for sgd, as in the
    JAX package; ``retune_scale`` multiplies the update. The names are
    the JAX package's (``agd`` is ``ops/optimizers.agd``; the 8-bit
    forms take ``bits=4``), plus ``adamw_4bit``, the port's name for
    ``adamw_8bit`` with ``bits=4`` (the JAX ``adamw_4bit`` transform)."""
    lr_fn = lr_schedule(lr, schedule, warmup_steps, total_steps)
    if name not in (
        "adamw", "adam", "sgd", "agd", "adamw_8bit", "adamw_8bit_flat", "adamw_4bit"
    ):
        raise ValueError(f"unknown optimizer {name!r}")
    allowed = {"adamw": _ADAM_KW, "adam": _ADAM_KW, "sgd": _SGD_KW, "agd": _AGD_KW}.get(name)
    if allowed is not None and set(kwargs) - allowed:
        raise TypeError(f"{name}: unsupported arguments {sorted(set(kwargs) - allowed)}")
    lr0 = float(lr_fn(0))

    def make(params):
        if name in ("adamw_8bit", "adamw_8bit_flat", "adamw_4bit"):
            from dlrover_tpu_torch.ops import quantized_optim

            cls = getattr(quantized_optim, name)
            opt = cls(params, lr=lr0, weight_decay=weight_decay, **kwargs)
        elif name == "agd":
            from dlrover_tpu_torch.ops.optimizers import agd

            opt = agd(params, lr0, weight_decay=weight_decay, **kwargs)
        elif name in ("adamw", "adam"):
            # the JAX "adam" chains add_decayed_weights after the Adam
            # direction: decoupled decay, i.e. AdamW
            opt = torch.optim.AdamW(
                params, lr=lr0,
                betas=(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
                eps=kwargs.get("eps", 1e-8), weight_decay=weight_decay,
            )
        else:
            opt = torch.optim.SGD(
                params, lr=lr0, weight_decay=weight_decay,
                momentum=kwargs.get("momentum") or 0.0,
                nesterov=bool(kwargs.get("nesterov", False)),
            )
        return ScheduledOptimizer(opt, lr_fn)

    # what the dry runner's static memory estimate reads
    # (accel/dry_runner._opt_state_bytes)
    make.opt_name = name
    make.opt_kwargs = dict(kwargs)
    return make


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
class ElasticTrainer:
    def __init__(
        self,
        model_cfg: TransformerConfig,
        tx,
        dataset,
        trainer_cfg: Optional[TrainerConfig] = None,
        strategy: Optional[Strategy] = None,
        devices=None,
        collate_fn: Optional[Callable] = None,
        metrics_hook: Optional[Callable[[int, Dict], None]] = None,
        eval_dataset=None,
    ):
        t_start = time.perf_counter()
        self.tcfg = trainer_cfg or TrainerConfig()
        _check_unported(self.tcfg)
        self.device = resolve_device(devices)
        self.cfg = self._model_cfg = model_cfg
        self._tx = tx
        self._metrics_hook = metrics_hook
        self.pipeline_stats = PipelineStats()
        self._setup_telemetry(model_cfg)
        # the strategy cache (accel/compile_cache.py) and its speculative
        # filler for the master's predicted worlds
        self._compile_cache = CompileCache(stats=self.pipeline_stats)
        self._spec_compiler = None
        self._last_candidates: Optional[List[int]] = None
        self._ckptr: Optional[FlashCheckpointer] = None
        if self.tcfg.ckpt_dir:
            self._ckptr = FlashCheckpointer(self.tcfg.ckpt_dir)
        # the JAX resize's report, set when this incarnation landed at a
        # world other than the one that staged its checkpoint
        self.last_resize: Optional[Dict] = None
        # the strategy (derived, searched or pinned) and the winner's
        # step; the strategy's remat reaches the model, as the JAX accel
        # pins it. A rank outside the mesh builds no step
        self.accel: AccelerateResult = self._accelerate(model_cfg, tx, strategy)
        self.strategy = self.accel.strategy
        model_cfg = self.cfg = self.accel.cfg
        self.mesh = self.accel.mesh
        self.idle = self.mesh.idle
        self._grad_sync_plan = self.accel.plan
        t_init = time.perf_counter()
        self.state = None if self.idle else self.accel.init_fn(0)
        self._init_ms = (time.perf_counter() - t_init) * 1e3
        from dlrover_tpu_torch.ops.quantized_optim import adamw_8bit_flat

        m = self.strategy.mesh
        if not self.idle and max(m.fsdp, m.tp, m.ep, m.sp, m.pp) > 1 and isinstance(
            getattr(self.state.opt_state, "opt", None), adamw_8bit_flat
        ):
            # the flat optimizer concatenates every big leaf per step:
            # on a model-sharded mesh that defeats the sharding
            raise ValueError(
                "adamw_8bit_flat is for replicated/dp-only states; use "
                "adamw_8bit (per-leaf) with fsdp/tp/ep/sp/pp sharding"
            )
        self._step_fn = self.accel.step_fn
        # the MoE capacity rebalancer: folds the measured per-expert
        # routing load into a periodic capacity re-split
        # (cfg.capacity_splits), each applied one a step rebuild
        self._moe_rebalancer = None
        if self._model_cfg.num_experts and self.tcfg.moe_rebalance_interval > 0:
            from dlrover_tpu_torch.parallel.moe import CapacityRebalancer

            self._moe_rebalancer = CapacityRebalancer(
                self._model_cfg.num_experts,
                capacity_factor=self._model_cfg.capacity_factor,
                top_k=self._model_cfg.moe_top_k,
            )
        self._rows: Dict[int, torch.Tensor] = {}
        # measured link-cost model (parallel/topology.py): probed once
        # per device fingerprint (warm restarts hit the JSON cache)
        self._link_fp: Optional[str] = None
        t_setup = time.perf_counter()
        self._setup_link_model()
        self._audit_cal_loaded = False
        if not self.idle:
            self._setup_grad_sync()
            self._setup_audit_budget()
        self._setup_ms = (time.perf_counter() - t_setup) * 1e3
        self.sampler = ElasticDistributedSampler(len(dataset), shuffle=True)
        self.dataloader = ElasticDataLoader(
            dataset,
            batch_size=self.tcfg.batch_size,
            sampler=self.sampler,
            collate_fn=collate_fn,
        )
        self._eval_dataset = eval_dataset
        self._collate_fn = collate_fn
        self._applied_lr_scale = 1.0
        self._last_eval: Dict[str, float] = {}
        self._prefetcher: Optional[DevicePrefetcher] = None
        self._stager = None
        # one record per save: step, kind, the loop thread's blocking ms,
        # the stager's own times and, for a staged save, the step at which
        # it committed or was aborted (``end_step``)
        self.save_log: List[Dict] = []
        # where the constructor resumed from: step, "memory" or "storage",
        # and the seconds the restore took (-1 / None when it did not)
        self.restored_step = -1
        self.restore_source: Optional[str] = None
        self.restore_s: Optional[float] = None
        self._best_ckptr: Optional[FlashCheckpointer] = None
        # the best PERSISTED eval loss survives restarts via a sidecar
        self._best_eval_loss = float("inf")
        self._last_best_save = 0.0
        if self._ckptr is not None:
            engine = self._ckptr.engine
            # the mesh's ranks are the checkpoint's shards (an idle rank
            # stages nothing), and every save carries what staged it
            engine.global_shard_num = int(self.mesh.layout.size)
            engine.step_meta = {
                "strategy": self.strategy.to_json(), "world": self._process_world,
            }
            with span("resize_reshard") if self._resizing else contextlib.nullcontext():
                self._maybe_restore()
            if self.tcfg.save_best and not self.idle:
                self._best_dir = os.path.join(self.tcfg.ckpt_dir, "best")
                self._best_ckptr = FlashCheckpointer(self._best_dir)
                self._best_eval_loss = self._load_best_sidecar()
        if self._resizing:
            self._land_resize(t_start)

    def _setup_telemetry(self, model_cfg):
        """The registry and step-time histogram, the span heartbeat, the
        goodput ledger, the flight recorder with its identity and hang
        watchdog, the profiler capture, the command watermark and the
        eviction state (the JAX trainer's construction, in its order)."""
        self._registry = default_registry()
        self._step_time_hist = self._registry.histogram(
            "dlrover_step_time_seconds", "optimizer-step wall time"
        )
        self._step_time_sum = 0.0
        self._step_time_n = 0
        self._train_tid: Optional[int] = None
        # hang attribution: a background heartbeat publishes the train
        # thread's current open span into the runtime-metrics file even
        # while the loop is wedged inside one
        self._span_heartbeat = (
            SpanHeartbeat(tid_fn=lambda: self._train_tid)
            if self.tcfg.report_metrics
            else None
        )
        if self._span_heartbeat is not None:
            self._span_heartbeat.start()
        # the process-wide ledger outlives this trainer: it must not keep
        # the trainer, and its state on the card, alive after close()
        me = weakref.ref(self)
        self._goodput = install_default_ledger(
            GoodputLedger(tid_fn=lambda: getattr(me(), "_train_tid", None))
        )
        # step-budget auditor (obs/audit.py): reconciles the priced
        # per-component StepBudget against the span stream each step —
        # drift reprices, sustained regressions alarm with the component
        # named and a flight bundle captured
        self._auditor = install_default_auditor(
            StepAuditor(
                tid_fn=lambda: getattr(me(), "_train_tid", None),
                on_alarm=lambda c, r, d: me() is not None and me()._on_audit_alarm(c, r, d),
            )
        )
        # spans of an earlier trainer of this process are not this one's
        self._auditor.skip_to_now()
        self._replay_until_step: Optional[int] = None
        # steps dispatched to the card whose compute span is not booked
        # yet: (begin event, end event, host ns at dispatch, span depth)
        self._pending_compute: deque = deque()
        self._device_free_ns = 0  # end of the last booked compute span
        self._flight = default_recorder()
        self._flight.set_identity(
            node_id=int(os.getenv(NodeEnv.NODE_ID, "0") or 0),
            job_name=os.getenv(NodeEnv.JOB_NAME, ""),
            device=str(self.device),
            model=type(model_cfg).__name__,
        )
        if self.tcfg.report_metrics:
            self._flight.start_watchdog(
                hang_dump_after_s=float(
                    os.getenv(TrainerEnv.HANG_DUMP_AFTER_S, "120")
                ),
                tid_fn=lambda: self._train_tid,
            )
        self._profiler_capture = ProfilerCapture()
        # the command file outlives a worker restart, but its commands
        # target the PREVIOUS incarnation: start past them
        self._last_command_id = last_command_id()
        # -- eviction grace-window drain -------------------------------
        env_grace = os.getenv(TrainerEnv.EVICTION_DEADLINE_S, "")
        if env_grace:
            try:
                self.tcfg.eviction_grace_s = float(env_grace)
            except ValueError:
                logger.warning(
                    f"bad {TrainerEnv.EVICTION_DEADLINE_S}={env_grace!r};"
                    f" keeping {self.tcfg.eviction_grace_s}s"
                )
        self._evict_event = threading.Event()
        self._evict_deadline: Optional[float] = None  # monotonic
        self._evict_grace_s = 0.0
        self._evict_reason = ""
        self.evicted = False
        self.eviction_drain_ms = 0.0
        # what the drain did, for the caller: step, grace, drain and
        # emergency-stage ms, committed, persisted (persist_s when it was)
        self.eviction_report: Dict = {}
        self._event_reporter: Optional[Callable[[str, str], None]] = None
        if env_grace:
            # a platform that exports the deadline expects SIGTERM to
            # mean "drain now"
            self.install_eviction_handler()

    @property
    def global_step(self) -> int:
        # an idle rank has no state: the step it restored agreement on
        return self.state.step if self.state is not None else self.restored_step

    # -- data parallelism ------------------------------------------------
    @property
    def _process_world(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1

    def _accelerate(self, model_cfg, tx, strategy: Optional[Strategy]) -> AccelerateResult:
        """``auto_accelerate`` as the JAX trainer calls it, on a strategy
        chosen in this order: the caller's pinned one, else the one that
        staged the checkpoint about to be restored (``step_meta``), each
        as it is when its mesh has this process group's ranks, else
        carried to them by ``_strategy_for`` (the JAX resize's
        derivation, through the strategy cache); else a search over the
        process group's ranks. The trainer's grad-sync
        knobs are named optimizations and, when they are set, their
        bucket size (the knobs then own the sync config). The port also
        stamps the knobs' fields (``_grad_sync_fields``: ``int8_topk``
        and its density, which the names alone do not carry), and a
        search keeps the config's own remat (as a ``remat``
        optimization). A derivation that degrades to fewer ranks than
        the world leaves the last ranks idle: they make the mesh's
        groups with the rest (``new_group`` is collective) and build no
        step."""
        import torch.distributed as dist

        from dlrover_tpu_torch.accel.accelerate import _rank0_choice
        from dlrover_tpu_torch.accel.dry_runner import _apply_strategy, _mesh_for

        world = self._process_world
        self._staged = self._peek_staged()
        base = strategy
        if base is None and self._staged.get("strategy"):
            base = Strategy.from_json(self._staged["strategy"])
        self._resizing = bool(self._staged.get("strategy")) and (
            self._staged.get("world") != world
            or base.mesh != Strategy.from_json(self._staged["strategy"]).mesh
        )
        self._cache_hit: Optional[bool] = None
        self._build_ms = 0.0
        t0 = time.perf_counter()
        with span("resize_build") if self._resizing else contextlib.nullcontext():
            if base is not None and base.mesh.num_devices == world:
                strategy = base  # it fits this world as it is
            elif base is not None:
                strategy, self._cache_hit = self._derive_strategy(base, world)
                strategy = _rank0_choice(strategy)
                self._note_resize_gauges(strategy, world)
            names = self._grad_sync_opt_names()
            rank = dist.get_rank() if dist.is_initialized() else 0
            if strategy is not None and rank >= strategy.mesh.num_devices:
                # an idle rank: the mesh's groups, nothing more
                cfg, applied = _apply_strategy(strategy, model_cfg)
                result = AccelerateResult(
                    strategy=strategy, cfg=cfg, mesh=_mesh_for(applied.mesh, self.device.type),
                    step_fn=None, init_fn=None, reports=[],
                )
            else:
                opts = names + (("remat",) if strategy is None and model_cfg.remat else ())
                result = auto_accelerate(
                    model_cfg, tx, strategy=strategy, optimizations=opts,
                    batch=self.tcfg.batch_size, seq=self.tcfg.seq_len, device=self.device,
                    donate=False, grad_accum=self.tcfg.grad_accum,
                    grad_bucket_mb=self.tcfg.grad_bucket_mb if names else None,
                    stamp=self._grad_sync_fields(), before_update=self._fence_staging,
                )
        self._build_ms = (time.perf_counter() - t0) * 1e3
        return result

    def _peek_staged(self) -> Dict:
        """What staged the newest checkpoint any rank can see
        (``step_meta`` with its ``step``; ``{}`` without one): each rank
        peeks its own shm segment and the storage tracker, and every
        rank takes the newest (one all-gather over the default group)."""
        if self._ckptr is None:
            return {}
        import torch.distributed as dist

        mine = self._ckptr.engine.peek_step_meta(self._ckptr.checkpoint_dir)
        if dist.is_initialized() and dist.get_world_size() > 1:
            seen: List = [None] * dist.get_world_size()
            dist.all_gather_object(seen, mine)
            mine = max(seen, key=lambda x: x[0])
        step, meta = mine
        return dict(meta, step=step) if step >= 0 and meta else {}

    def _strategy_key(self, base: Strategy, n: int) -> str:
        """The strategy cache's key of ``base`` carried to ``n`` ranks:
        everything ``_strategy_for`` reads."""
        from dlrover_tpu_torch.accel.compile_cache import fingerprint

        t = self.tcfg
        return fingerprint(
            "strategy", base.to_json(), int(n), repr(self._model_cfg),
            t.batch_size, t.seq_len, t.grad_accum, t.mb_rebalance,
        )

    def _derive_strategy(self, base: Strategy, n: int):
        """``(strategy, cache hit)``: ``base`` carried to ``n`` ranks by
        ``_strategy_for``, from the strategy cache when an earlier
        incarnation (or the speculative filler) derived it."""
        from types import SimpleNamespace

        # the derivation reads the live strategy, as the JAX resize does
        self.accel = SimpleNamespace(strategy=base)
        self._prev_step_s = self._previous_step_s()
        js, hit = self._compile_cache.get_or_compile(
            self._strategy_key(base, n), lambda: self._strategy_for(n).to_json()
        )
        return Strategy.from_json(js), hit

    def _previous_step_s(self) -> Optional[float]:
        """The previous incarnation's mean step time (its runtime-metrics
        file), which calibrates the rebalance's pricing."""
        if not self.tcfg.report_metrics:
            return None
        ms = read_runtime_metrics().get("step_time_ms")
        try:
            return float(ms) / 1e3 if ms else None
        except (TypeError, ValueError):
            return None

    def _note_resize_gauges(self, strategy: Strategy, world: int) -> None:
        """The JAX resize's idle-rank and pad gauges and logs."""
        idle_ranks = world - strategy.mesh.num_devices
        if idle_ranks:
            logger.warning(
                f"resize: degrading to {strategy.mesh.num_devices} of {world} "
                f"devices ({strategy.mesh.axis_sizes()}), leaving {idle_ranks} "
                f"rank(s) idle"
            )
        if strategy.batch_pad:
            logger.info(
                f"resize: micro-batch rebalance active — batch padded by "
                f"{strategy.batch_pad} zero-weight rows so "
                f"{strategy.mesh.axis_sizes()} uses every rank (resize_idle_ranks=0)"
            )
        self.pipeline_stats.resize_idle_ranks = idle_ranks
        self.pipeline_stats.resize_mb_pad = strategy.batch_pad
        self._registry.gauge(
            "dlrover_resize_idle_ranks", "devices left idle by resize degradation"
        ).set(float(idle_ranks))
        self._registry.gauge(
            "dlrover_resize_mb_pad", "zero-weight pad rows/step of the micro-batch rebalance"
        ).set(float(strategy.batch_pad))

    # -- elastic resize, through the restart path ------------------------
    def _strategy_for_exact(self, n_devices: int) -> Optional[Strategy]:
        """Strategy using EXACTLY ``n_devices``, or None (the JAX
        package's, on ``self.accel.strategy``): the model-parallel axes
        keep their sizes and the data axes (dp, fsdp) absorb the delta;
        when the current shape cannot scale, full candidate
        enumeration."""
        s = self.accel.strategy
        m = s.mesh
        fixed = m.tp * m.sp * m.ep * m.pp
        if n_devices <= 0:
            return None
        if n_devices % fixed == 0:
            rem = n_devices // fixed
            if m.fsdp == 1:
                dp, fsdp = rem, 1
            elif m.dp == 1:
                dp, fsdp = 1, rem
            else:
                # mixed split: keep as much fsdp (the memory win) as
                # divides the remainder
                fsdp = min(m.fsdp, rem)
                while rem % fsdp:
                    fsdp -= 1
                dp = rem // fsdp
            unit = self.tcfg.batch_size // max(self.tcfg.grad_accum, 1)
            if unit % (dp * fsdp) == 0:
                return dc_replace(s, mesh=dc_replace(m, dp=dp, fsdp=fsdp))
        from dlrover_tpu_torch.accel.candidates import candidate_strategies

        cands = [
            c
            for c in candidate_strategies(
                self._model_cfg, n_devices, self.tcfg.batch_size, self.tcfg.seq_len,
                grad_accum=self.tcfg.grad_accum,
            )
            if c.mesh.pp == 1
        ]
        if not cands:
            return None
        return dc_replace(
            cands[0], dtype=s.dtype, remat=s.remat, opts=s.opts, offload_opt=s.offload_opt,
            # field-carried grad-sync knobs survive the fallback too
            comm_overlap=s.comm_overlap, grad_compress=s.grad_compress,
            grad_bucket_mb=s.grad_bucket_mb, grad_topk_density=s.grad_topk_density,
        )

    def _rebalanced_strategy_for(self, n_devices: int) -> Optional[Strategy]:
        """Micro-batch-rebalanced strategy using ALL ``n_devices`` on an
        indivisible count (the JAX package's): the data axes absorb the
        delta and ``batch_pad`` zero-weight rows make the batch divide.
        None when the count divides (the exact path owns it), the model
        axes don't divide ``n_devices``, ``mb_rebalance`` is off, or the
        trainer runs grad_accum (pads would multiply across
        microbatches)."""
        if not self.tcfg.mb_rebalance or self.tcfg.grad_accum > 1:
            return None
        if self._model_cfg.num_experts:
            return None
        s = self.accel.strategy
        m = s.mesh
        fixed = m.tp * m.sp * m.ep * m.pp
        if n_devices <= 0 or n_devices % fixed or m.pp > 1:
            return None
        rem = n_devices // fixed
        if m.fsdp == 1:
            dp, fsdp = rem, 1
        elif m.dp == 1:
            dp, fsdp = 1, rem
        else:
            fsdp = min(m.fsdp, rem)
            while rem % fsdp:
                fsdp -= 1
            dp = rem // fsdp
        shards = dp * fsdp
        pad = (-self.tcfg.batch_size) % shards
        if pad == 0:
            return None
        return dc_replace(s, mesh=dc_replace(m, dp=dp, fsdp=fsdp), batch_pad=pad)

    def _strategy_for(self, n_devices: int) -> Strategy:
        """Strategy for a resized world, degrading gracefully (the JAX
        package's): on a count the batch does not divide, the dry
        runner prices (a) the largest valid mesh <= ``n_devices`` with
        the surplus ranks idle against (b) the micro-batch rebalance
        over every rank, and the cheaper wins; its row term is
        calibrated by the measured step (this incarnation's, else the
        previous one's from the runtime-metrics file,
        ``_prev_step_s``). Raises ValueError when no count down to 1
        admits a mesh."""
        for n in range(n_devices, 0, -1):
            s = self._strategy_for_exact(n)
            if s is None:
                continue
            if s.batch_pad:
                s = dc_replace(s, batch_pad=0)
            if n < n_devices:
                reb = self._rebalanced_strategy_for(n_devices)
                if reb is not None:
                    from dlrover_tpu_torch.accel import dry_runner

                    # this incarnation's measured step, else the last one's
                    n_steps = getattr(self, "_step_time_n", 0)
                    measured = (
                        self._step_time_sum / n_steps if n_steps
                        else getattr(self, "_prev_step_s", None)
                    )
                    idle_s, reb_s = dry_runner.price_rebalance_options(
                        self._model_cfg, self.tcfg.batch_size, self.tcfg.seq_len, s, reb,
                        measured_step_s=measured, current_strategy=self.accel.strategy,
                    )
                    if reb_s < idle_s:
                        logger.info(
                            f"micro-batch rebalance: padding the batch by "
                            f"{reb.batch_pad} rows to use all {n_devices} devices "
                            f"({reb.mesh.axis_sizes()}, est {reb_s * 1e3:.2f} "
                            f"ms/step) instead of idling {n_devices - n} rank(s) "
                            f"(est {idle_s * 1e3:.2f} ms/step)"
                        )
                        return reb
                    logger.info(
                        f"micro-batch rebalance priced out (pad {reb.batch_pad} "
                        f"rows, est {reb_s * 1e3:.2f} ms/step vs idle "
                        f"{idle_s * 1e3:.2f}); degrading instead"
                    )
                logger.info(
                    f"no valid mesh factorization uses all {n_devices} devices "
                    f"at batch={self.tcfg.batch_size}; degrading to "
                    f"{s.mesh.axis_sizes()} on {n} devices"
                )
            return s
        raise ValueError(
            f"no valid mesh factorization for any count <= {n_devices} "
            f"devices at batch={self.tcfg.batch_size}, "
            f"seq={self.tcfg.seq_len}: the resize target must let "
            f"dp*fsdp divide the batch or satisfy the model's "
            f"axis-divisibility rules"
        )

    def _land_resize(self, t_start: float) -> None:
        """The restart's landing in a changed world, booked as the JAX
        resize books it: ``resize_build`` (the strategy and
        ``auto_accelerate``) and ``resize_reshard`` (the restore) were
        spans; here the counters and ``last_resize``, the JAX resize's
        return dict. Every leaf came from the host restore (shm or
        storage): ``fallback_paths`` lists them all, and
        ``reshard_bytes_device`` is 0."""
        from dlrover_tpu_torch.ckpt.sharding import BlockLeaf, flatten_state

        downtime_ms = (time.perf_counter() - t_start) * 1e3
        engine = self._ckptr.engine
        paths = [] if self.idle else [
            p for p, t in flatten_state(self._ckpt_state())
            if isinstance(t, (torch.Tensor, BlockLeaf))
        ]
        self.pipeline_stats.resize_count += 1
        self.pipeline_stats.resize_downtime_ms = downtime_ms
        self.pipeline_stats.reshard_bytes_host = engine.last_load_bytes
        staged = Strategy.from_json(self._staged["strategy"])
        self.last_resize = {
            "downtime_ms": downtime_ms,
            "compile_cache_hit": self._cache_hit,
            "reshard_bytes_device": 0,
            "reshard_bytes_host": engine.last_load_bytes,
            "fallback_paths": paths,
            "mesh": self.strategy.mesh.axis_sizes(),
            # the port's own keys: where it came from and how
            "from_world": self._staged.get("world"),
            "from_mesh": staged.mesh.axis_sizes(),
            "world": self._process_world,
            "idle": self.idle,
            "idle_ranks": self.pipeline_stats.resize_idle_ranks,
            "mb_pad": self.strategy.batch_pad,
            "restored_step": self.restored_step,
            "source": self.restore_source,
            # the landing's parts: the strategy and auto_accelerate, the
            # state's init, the link model and sync probe, the restore
            "build_ms": self._build_ms,
            "state_init_ms": self._init_ms,
            "setup_ms": self._setup_ms,
            "restore_ms": None if self.restore_s is None else self.restore_s * 1e3,
        }
        logger.info(
            f"resized from {self._staged.get('world')} to {self._process_world} "
            f"ranks as {self.strategy.describe()} in {downtime_ms:.0f} ms "
            f"(strategy cache {'hit' if self._cache_hit else 'miss'}, step "
            f"{self.restored_step} from {self.restore_source}"
            f"{', idle' if self.idle else ''})"
        )

    def resize(self, n_devices: Optional[int] = None, devices=None,
               strategy: Optional[Strategy] = None) -> Dict:
        """The JAX resize's entry. The port runs one card a process, and
        a torch process group cannot lose or gain a rank in place: a
        resize is a restart. The agent relaunches the workers into the
        new world, and each one's constructor lands there (derives the
        strategy, restores the staged step, ``last_resize``). So this
        returns that landing's report for the current world, and raises
        ``NotImplementedError`` for any other."""
        if devices is not None or strategy is not None or (
            n_devices is not None and n_devices != self._process_world
        ):
            raise NotImplementedError(
                f"resize to {n_devices if n_devices is not None else devices} "
                f"in place: a torch process group cannot change size in place, "
                f"so the port resizes through the restart path (the agent "
                f"relaunches the workers into the new world and the trainer "
                f"restores the staged step there; ElasticTrainer.last_resize)"
            )
        return dict(self.last_resize or {})

    # -- speculative derivation of the predicted worlds ------------------
    def _staging_active(self) -> bool:
        return self._stager is not None or any(
            c is not None and c.staging_in_flight() for c in (self._ckptr, self._best_ckptr)
        )

    def update_scale_candidates(self, device_counts) -> int:
        """Derive and cache, on a background thread, the strategy of each
        likely next world (the JAX package's speculative pre-lower), so
        that a relaunch into it is a strategy-cache hit; on the card the
        kernel libraries are loaded into the job-stable build directory
        too. Worlds that cannot form a mesh are skipped with a log.
        Returns the number of candidates submitted."""
        if not self.tcfg.speculative_compile or self.idle:
            return 0
        world = self._process_world
        tasks, seen = [], set()
        for n in device_counts:
            n = int(n)
            if n <= 0 or n in seen or n == world:
                continue
            seen.add(n)
            try:
                self._strategy_for(n)
            except ValueError as e:
                logger.info(f"speculative compile: skipping {n}-device candidate ({e})")
                continue
            tasks.append(CompileTask(
                label=f"world{n}", key=self._strategy_key(self.strategy, n),
                build=lambda n=n: self._speculative_build(n),
            ))
        if not tasks:
            return 0
        if self._spec_compiler is None:
            self._spec_compiler = SpeculativeCompiler(
                self._compile_cache, pause_fn=self._staging_active,
                budget_s=self.tcfg.spec_compile_budget_s,
            )
        self._spec_compiler.submit(tasks)
        logger.info(f"speculative compile: {len(tasks)} candidate worlds queued ({sorted(seen)})")
        return len(tasks)

    def _speculative_build(self, n: int) -> str:
        """One predicted world: its strategy (JSON, the cached artifact)
        and, on the card, the kernel libraries in the build directory."""
        js = self._strategy_for(n).to_json()
        if self.device.type == "cuda":
            from dlrover_tpu_torch.ops import _build

            _build.load_library("flash_attention")
        return js

    def _poll_scale_candidates(self):
        """The master's predicted next worker counts, from the
        paral-config file (the agent mirrors the master's
        ``candidate_worker_counts`` there), queued for speculative
        derivation at this node's processes per worker."""
        if not self.tcfg.speculative_compile or self.idle:
            return
        from dlrover_tpu_torch.trainer.elastic.dataloader import read_paral_config

        counts = read_paral_config().get("candidate_worker_counts") or []
        counts = [int(c) for c in counts if isinstance(c, (int, float)) and c > 0]
        if not counts or counts == self._last_candidates:
            return
        self._last_candidates = counts
        per_worker = max(1, int(os.getenv("DLROVER_TPU_LOCAL_WORLD_SIZE", "1") or 1))
        self.update_scale_candidates([c * per_worker for c in counts])

    def _grad_sync_fields(self) -> dict:
        """The grad-sync knobs' Strategy fields when the knobs are set."""
        if not self._grad_sync_opt_names():
            return {}
        out = dict(comm_overlap=True, grad_topk_density=self.tcfg.grad_topk_density)
        if self.tcfg.grad_compress != "none":
            out["grad_compress"] = self.tcfg.grad_compress
        return out

    def _grad_sync_opt_names(self) -> tuple:
        """Named optimizations the trainer's grad-sync knobs translate
        to (the JAX package's ``accel/opt_lib.py`` names), stamped onto
        the strategy."""
        names = ()
        if self.tcfg.comm_overlap:
            names += ("comm_overlap",)
        if self.tcfg.grad_compress == "auto":
            names += ("grad_compress_auto",)
        elif self.tcfg.grad_compress != "none":
            names += ("grad_compress",)
        return names

    def _setup_grad_sync(self):
        """Plan visibility: the error-feedback residual when the plan
        compresses, the plan's wire accounting through PipelineStats,
        and the timing probe (every rank together; CUDA events on the
        card)."""
        plan = self._grad_sync_plan
        stats = self.pipeline_stats
        stats.grad_sync_path = "explicit" if plan is not None else "gspmd"
        grad_sync.export_compress_metrics(plan, self._registry)
        if plan is None:
            return
        grad_sync.ensure_residual(self.state, plan, self.device)
        stats.grad_bytes_raw = plan.raw_bytes
        stats.grad_bytes_wire = plan.wire_bytes
        # the explicit path starts the sync once the backward has made
        # every local grad and waits for it before the update: nothing
        # of it is hidden behind compute (the JAX package's analytic
        # ``estimate_overlap_pct`` describes a bucketed overlap that
        # this path does not have)
        stats.comm_overlap_pct = 0.0
        if plan.two_level:
            stats.grad_sync_ici_ms, stats.grad_sync_dcn_ms = grad_sync.measure_sync_legs_ms(
                plan, self.mesh, iters=3, device=self.device
            )
            stats.grad_sync_ms = stats.grad_sync_ici_ms + stats.grad_sync_dcn_ms
        else:
            stats.grad_sync_ms = stats.grad_sync_ici_ms = grad_sync.measure_sync_ms(
                plan, self.mesh, iters=3, device=self.device
            )
        logger.info(f"grad sync: {plan.describe()}")

    # -- measured link-cost model (parallel/topology.py) ----------------
    def _setup_link_model(self):
        """Probe (or reuse) the per-link bandwidth model for the current
        world (every rank together: the probe's all-reduces run on the
        mesh's groups). The probe runs only when the device fingerprint
        changed; a warm restart reuses the persisted cache without
        touching the card. The arbiter's hidden fraction is calibrated
        (or reused from its cache) under the same discipline; a failure
        of either never kills training."""
        from dlrover_tpu_torch.parallel import topology

        try:
            fp = topology.device_fingerprint(self.device)
            if fp == self._link_fp:
                logger.info(
                    f"link model: device fingerprint unchanged ({fp}),"
                    f" keeping the current probe"
                )
                return
            model = topology.probe_link_model(devices=self.device, mesh=self.mesh)
            self._link_fp = fp
            topology.export_link_metrics(model, self._registry)
            # the dry runner and the auditor price host traffic from the
            # measured per-rail hidden fraction, not the constant
            transfer_sched.ensure_calibrated()
        except Exception as e:  # the probe must never kill training
            logger.warning(f"link-model probe failed: {e!r}")

    # -- step-budget audit (obs/audit.py) -------------------------------
    def _setup_audit_budget(self):
        """Assemble the per-component :class:`StepBudget` for the
        current world and hand it to the auditor: the sync legs priced
        from the link model (``comm_time_legs_s``), the host term from
        the arbiter's registered demand (``aggregate_host_exposed_s``).
        Components the
        trainer cannot price cheaply (compute, data_wait) stay 0.0 — the
        auditor adopts their warmup-mean observation as the budget."""
        from dlrover_tpu_torch.parallel.grad_sync import (
            OVERLAP_HIDDEN_FRACTION,
            comm_time_legs_s,
        )

        try:
            if not self._audit_cal_loaded and self._link_fp:
                # warm restart on the same hardware: start from the
                # persisted per-component drift instead of re-learning
                cal = load_audit_calibration(self._link_fp)
                if cal is not None:
                    self._auditor.apply_calibration(cal)
                self._audit_cal_loaded = True
            budget = StepBudget()
            param_bytes = 0
            itemsize = 4
            for p in self.state.params.jax_ordered_parameters():
                param_bytes += p.numel() * p.element_size()
                itemsize = p.element_size()
            ici_s, dcn_s = comm_time_legs_s(
                param_bytes, self.strategy, grad_itemsize=itemsize
            )
            # the JAX package bills the explicit path's exposed share;
            # its analytic hidden fraction is the pricing side's figure
            exposed = (
                1.0 - OVERLAP_HIDDEN_FRACTION
                if self._grad_sync_plan is not None
                else 1.0
            )
            budget.set_component("ici_sync", ici_s * exposed, "priced")
            budget.set_component("dcn_sync", dcn_s * exposed, "priced")
            budget.set_component(
                "host_xfer", transfer_sched.aggregate_host_exposed_s(), "priced"
            )
            self._auditor.set_budget(budget)
            # the sync legs run inside the step (no per-step spans):
            # the probe-measured times are the standing observation
            stats = self.pipeline_stats
            if stats.grad_sync_ici_ms:
                self._auditor.set_measured(
                    "ici_sync", stats.grad_sync_ici_ms / 1e3 * exposed
                )
            if stats.grad_sync_dcn_ms:
                self._auditor.set_measured(
                    "dcn_sync", stats.grad_sync_dcn_ms / 1e3 * exposed
                )
        except Exception as e:
            logger.warning(f"audit budget assembly failed: {e!r}")

    def _on_audit_alarm(self, component: str, ratio: float, detail: str):
        """Sustained regression: capture forensics at the moment the
        detector fires, and leave a breadcrumb in the recorder's event
        log so later dumps carry the attribution too."""
        self._flight.note_event("audit_regression", detail)
        self._flight.dump(
            "audit_regression",
            extra={
                "component": component,
                "ratio": round(ratio, 3),
                "detail": detail,
            },
        )

    def _local_rows(self, n: int) -> Optional[torch.Tensor]:
        """This rank's rows of a global batch of ``n`` (None: all): of
        each accumulation microbatch, or on a pp mesh of each of the
        pipeline's microbatches (every stage of a data coordinate the
        same rows)."""
        if self.mesh.config.dp * self.mesh.config.fsdp == 1:
            return None
        if n not in self._rows:
            if self.strategy.mesh.pp > 1:
                # the JAX rule: a microbatch splits over the data axes
                # that divide it
                from dlrover_tpu_torch.parallel.pipeline import pipeline_rows

                rows = pipeline_rows(self.mesh, n, self.strategy.num_microbatches)
            else:
                rows = batch_sharding(self.mesh, n, self.tcfg.grad_accum)
            self._rows[n] = torch.from_numpy(rows)
        return self._rows[n]

    def _to_device(self, x, local: bool = True) -> torch.Tensor:
        """A batch array on the device: this rank's rows of it, or all of
        it (``local=False``, the eval loop's)."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        t = t.long()
        rows = self._local_rows(t.shape[0]) if local else None
        if rows is not None:
            t = t.index_select(0, rows)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _device_batch(self, batch, local: bool = True):
        if isinstance(batch, dict):
            bx, by = batch["x"], batch["y"]
        else:  # tuple/list samples from the default collate
            bx, by = batch[0], batch[1]
        pad = self.strategy.batch_pad
        if pad and not local:
            # the eval loss takes no row weights: trim to the largest
            # row count the data ranks divide, as the JAX trainer does
            m = self.strategy.mesh
            n = (int(np.asarray(bx).shape[0]) // max(m.dp * m.fsdp, 1)) * max(m.dp * m.fsdp, 1)
            if n > 0:
                bx, by = np.asarray(bx)[:n], np.asarray(by)[:n]
        elif pad:
            # micro-batch rebalance: zero rows appended to the global
            # batch before the rank split; the step's row weights take
            # them out of the loss
            from dlrover_tpu_torch.models.train import pad_batch_rows

            n = int(np.asarray(bx).shape[0]) + pad
            bx, by = pad_batch_rows(bx, n), pad_batch_rows(by, n)
        return self._to_device(bx, local), self._to_device(by, local)

    # -- eval ----------------------------------------------------------
    def _eval_batches(self, max_batches: int):
        """Sequential fixed-size batches over the eval set."""
        from dlrover_tpu_torch.trainer.elastic.dataloader import _default_collate

        collate = self._collate_fn or _default_collate
        bs = self.tcfg.batch_size
        n = len(self._eval_dataset)
        for start in range(0, min(max_batches * bs, n - bs + 1), bs):
            yield collate([self._eval_dataset[i] for i in range(start, start + bs)])

    @torch.no_grad()
    def evaluate(self, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean NLL over the eval set: {"eval_loss", "eval_ppl"}."""
        if self._eval_dataset is None:
            raise ValueError("ElasticTrainer built without eval_dataset")
        max_batches = max_batches or self.tcfg.eval_steps
        losses = []
        mesh = None
        if self.strategy.mesh.tp > 1 or self.strategy.mesh.ep > 1:
            # every rank runs the whole rows: tp's collectives (ep's
            # exchanges), no sp cut
            mesh = dc_replace(self.mesh, config=dc_replace(self.mesh.config, sp=1))
        for batch in self._eval_batches(max_batches):
            x, y = self._device_batch(batch, local=False)
            if self.strategy.mesh.pp > 1:
                # through the stages: every rank of a data coordinate runs
                # the whole eval batch
                from dlrover_tpu_torch.parallel.pipeline import pipeline_eval_loss

                losses.append(pipeline_eval_loss(self.state.params, self.mesh, x, y,
                                                 self.strategy.num_microbatches,
                                                 units=self.state.units))
                continue
            # a ZeRO rank gathers a unit at a time from its shards
            logits, _ = forward(self.state.params, x, self.cfg, mesh, gather=self.state.units)
            losses.append(float(token_nll(logits, y, split=vocab_split(self.cfg, mesh))))
        if not losses:
            raise ValueError(
                f"eval dataset ({len(self._eval_dataset)} rows) yields "
                f"zero batches of size {self.tcfg.batch_size}"
            )
        mean = float(np.mean(losses))
        return {"eval_loss": mean, "eval_ppl": float(np.exp(min(mean, 20.0)))}

    def current_lr(self) -> Optional[float]:
        """The live effective learning rate (schedule x retune scale)."""
        opt = self.state.opt_state
        lr = getattr(opt, "learning_rate", None)
        if lr is None:
            return None
        return lr * getattr(opt, "retune_scale", 1.0)

    def _apply_lr_scale(self, scale: float):
        """Linear-scaling rule: the master's batch-size factor composes
        with the schedule through the optimizer's retune scale."""
        if scale == self._applied_lr_scale:
            return
        opt = self.state.opt_state
        if not hasattr(opt, "retune_scale"):
            if not getattr(self, "_warned_lr_scale", False):
                logger.warning(
                    f"master suggests lr scale {scale} but the optimizer "
                    "has no retune scale; build tx with build_optimizer"
                )
                self._warned_lr_scale = True
            return
        opt.retune_scale *= scale / self._applied_lr_scale
        self._applied_lr_scale = scale
        logger.info(f"learning rate rescaled x{scale} (linear scaling)")

    # -- checkpoint ----------------------------------------------------
    def _rewound_sampler_state(self, samp: Dict, buffered: int) -> Dict:
        """Sampler state rewound by ``buffered`` prefetched batches: the
        prefetcher's source cursor ran ahead of what actually trained,
        so a restore must replay those batches instead of skipping
        them."""
        samp = dict(samp)
        completed = self.sampler.rewound_completed(
            samp["completed_num"], buffered * self.dataloader.batch_size
        )
        if completed < 0 and samp["epoch"] > 0:
            # the sampler already rolled over but the buffered epoch tail
            # has not trained: rewind ACROSS the rollover
            samp["epoch"] -= 1
            completed += self.sampler._epoch_total()
        # a short final batch makes the rewind an over-estimate; clamping
        # repeats a few samples, the safe direction (never skip)
        samp["completed_num"] = max(0, completed)
        return samp

    def _ckpt_state(self):
        """The train state as the JAX package's tree (its tensors live)
        and the sampler snapshot, rewound by the prefetcher's lookahead
        (read with no pull in flight, so the rewind is exact)."""
        if self._prefetcher is not None:
            samp, buffered = self._prefetcher.snapshot(self.sampler.state_dict)
        else:
            samp, buffered = self.sampler.state_dict(), 0
        if buffered:
            samp = self._rewound_sampler_state(samp, buffered)
        mesh = self.mesh if self._world > 1 else None
        return {"train": train_state_tree(self.state, mesh), "sampler": samp}

    def _maybe_restore(self):
        t0 = time.perf_counter()
        if self.idle:
            # no state: only the agreements the mesh's ranks make
            self._ckptr.engine.load({}, self._ckptr.checkpoint_dir, idle=True)
            return
        step, restored = self._ckptr.load_checkpoint(self._ckpt_state())
        if restored is not None and step >= 0:
            load_train_state_tree(self.state, restored["train"])
            self._share_restored_state()
            self.sampler.load_state_dict(
                {k: int(v) for k, v in restored["sampler"].items()}
            )
            self.restored_step = step
            self.restore_source = self._ckptr.engine.last_load_source
            self.restore_s = time.perf_counter() - t0
            logger.info(
                f"resumed from flash checkpoint step {step} "
                f"({self.restore_source}, {self.restore_s:.3f}s)"
            )
            # restart-replay accounting: the runtime-metrics file
            # outlives the previous incarnation, so the step it had
            # already published says how much progress this restore
            # lost; steps up to it are booked as restart_replay
            if self.tcfg.report_metrics:
                prev_step = int(
                    read_runtime_metrics().get("global_step", -1) or -1
                )
                if prev_step > step:
                    self._replay_until_step = prev_step
                    self._goodput.replay_begin()
                    logger.info(
                        f"replaying lost progress: steps {step}.."
                        f"{prev_step} count as restart_replay"
                    )

    @property
    def _world(self) -> int:
        return int(self.mesh.layout.size)

    def _maybe_rebalance_experts(self, load) -> bool:
        """Fold one measured per-expert routing-load vector into the
        ``CapacityRebalancer``; when the re-split changed, rebuild the
        step with the new ``cfg.capacity_splits`` (the JAX trainer's
        recompile; here only the step's static capacities change, the
        state stays). Returns True when a re-split was applied."""
        from dataclasses import replace as dc_replace

        reb = self._moe_rebalancer
        if reb is None:
            return False
        if isinstance(load, torch.Tensor):
            load = load.detach().float().cpu().numpy()
        reb.observe(np.asarray(load))
        m = self.strategy.mesh
        shards = max(m.dp * m.fsdp * m.sp, 1)
        tokens = max(1, self.tcfg.batch_size * self.tcfg.seq_len // shards)
        splits = reb.splits(tokens)
        if tuple(splits) == tuple(self._model_cfg.capacity_splits):
            return False
        self._model_cfg = dc_replace(self._model_cfg, capacity_splits=splits)
        logger.info(
            f"moe capacity re-split #{self.pipeline_stats.moe_capacity_resplits + 1}: "
            f"{splits} (load EMA {np.round(reb.load, 3).tolist()}); rebuilding the step"
        )
        self.accel = auto_accelerate(
            self._model_cfg, self._tx, strategy=self.strategy,
            batch=self.tcfg.batch_size, seq=self.tcfg.seq_len, device=self.device,
            donate=False, grad_accum=self.tcfg.grad_accum, before_update=self._fence_staging,
        )
        self.cfg = self.accel.cfg
        self._step_fn = self.accel.step_fn
        self.pipeline_stats.moe_capacity_resplits += 1
        self._registry.gauge(
            "dlrover_moe_capacity_resplits", "applied MoE capacity re-splits",
        ).set(float(self.pipeline_stats.moe_capacity_resplits))
        return True

    def _share_restored_state(self):
        """After a restore at world size N: each replica set's first rank
        read the replicated tensors (its target holds them, whatever
        world staged them: the records carry global indices), so it
        hands them to the rest of the set, which need not have existed
        when the state was staged (under ZeRO the step gathers the
        params from the restored shards). Under tp (ep, pp), coordinate
        0 of the axis alone staged the tensors every rank of it holds
        whole: each tp (ep) group first hands those on from it, then each
        pp group (the shared leaves, from stage 0, per tp coordinate)."""
        if self._world == 1:
            return
        from dlrover_tpu_torch.ckpt.sharding import flatten_state
        from dlrover_tpu_torch.models.convert import axis_whole_tensors, replica_group
        from dlrover_tpu_torch.parallel.sharding_rules import splits_of

        for axis, _, _, group in sorted(splits_of(self.mesh), key=lambda s: s[0] == "pp"):
            if group is None:
                continue
            src = self.mesh.ranks[axis][0]
            with torch.no_grad():
                handles = [grad_sync.broadcast(t, src, group)
                           for t in axis_whole_tensors(self.state, self.mesh, axis)]
                for h in handles:
                    h.wait()
        zero = self.state.shards is not None
        name = replica_group(self.mesh, zero)
        group = self.mesh.groups[name]
        if group is not None:
            src = self.mesh.ranks[name][0]
            with torch.no_grad():
                handles = [
                    grad_sync.broadcast(t, src, group)
                    for _, t in flatten_state(train_state_tree(self.state))
                    if isinstance(t, torch.Tensor)
                ]
                for h in handles:
                    h.wait()

    def _note_save(self, step, kind, t0=None, stager=None, ok=True):
        rec = {"step": step, "kind": kind, "ok": bool(ok)}
        if t0 is not None:
            rec["block_ms"] = (time.perf_counter() - t0) * 1e3
        if stager is not None:
            if "block_ms" not in rec:
                rec["block_ms"] = stager.block_s * 1e3
            rec.update(bytes=stager.total_bytes, **stager.timings)
            if hasattr(stager, "priority"):  # the host link's record
                rec.update(
                    priority=int(stager.priority),
                    grant_wait_ms=stager.grant_wait_s * 1e3,
                    stripes=stager.stripes,
                )
        self.save_log.append(rec)

    def save(self, storage_type: StorageType = StorageType.MEMORY) -> bool:
        if self._ckptr is None:
            return False
        t0 = time.perf_counter()
        engine = self._ckptr.engine
        engine.last_stager = None
        ok = self._ckptr.save_checkpoint(
            self.global_step, self._ckpt_state(), storage_type
        )
        kind = "storage" if storage_type == StorageType.DISK else "memory"
        self._note_save(self.global_step, kind, t0, engine.last_stager, ok)
        return ok

    def _fence_staging(self):
        """Before the optimizer writes the state: the step's stream waits
        for the device copies of any save still reading it."""
        for ckptr in (self._ckptr, self._best_ckptr):
            ev = ckptr.engine.copy_fence() if ckptr is not None else None
            if ev is not None:
                torch.cuda.current_stream(self.device).wait_event(ev)
                self.pipeline_stats.fenced_steps += 1

    def _advance_stager(self):
        """Give the save in flight one budget's worth of the loop's time;
        commit (metadata publish + saver notify) once its host side is
        done."""
        if self._stager is None:
            return
        if self.global_step % self.tcfg.save_storage_interval == 0:
            # this step's disk save supersedes the stage and aborts it; a
            # commit now would leave the shard lock with the saver just
            # as the disk save asks for it, and that save would be skipped
            return
        self._stager.advance(
            budget_s=self.tcfg.stage_budget_ms / 1e3,
            stats=self.pipeline_stats,
        )
        if self._stager.done:
            self._finish_stager()

    def _finish_stager(self):
        """The commit barrier: wait for what is left and publish."""
        if self._stager is not None:
            st, self._stager = self._stager, None
            ok = st.commit(stats=self.pipeline_stats)
            self._note_save(st.step, "memory", stager=st, ok=ok)
            self.save_log[-1]["end_step"] = self.global_step

    def wait_for_checkpoint(self):
        """Commit the memory save in flight, if any (the barrier the
        loop otherwise reaches within a few steps)."""
        self._finish_stager()

    def _abort_stager(self):
        if self._stager is not None:
            st, self._stager = self._stager, None
            st.abort()
            self._note_save(st.step, "memory", stager=st, ok=False)
            self.save_log[-1]["end_step"] = self.global_step

    def _maybe_save(self, step: int):
        if self._ckptr is None:
            return
        if step % self.tcfg.save_storage_interval == 0:
            # the persisted save supersedes a half-staged older step:
            # abort it (nobody saw it — metadata is still invalid) so
            # the shard lock is free for this one
            self._abort_stager()
            # a saver still persisting an older step (the port's saver
            # persists every staged step) is waited for: a disk save
            # skipped on one rank leaves the others waiting for its
            # commit
            self._ckptr.engine.wait_saver_idle(STORAGE_SAVE_WAIT_S)
            self.save(StorageType.DISK)
        elif step % self.tcfg.save_memory_interval == 0:
            if not self.tcfg.chunked_staging:
                self.save(StorageType.MEMORY)
            elif self._stager is None:
                # a previous stage still draining keeps draining — skip
                # this interval rather than stall on a forced commit
                self._stager = self._ckptr.begin_chunked_save(
                    step,
                    self._ckpt_state(),
                    chunk_bytes=self.tcfg.stage_chunk_mb << 20,
                )
                if self._stager is None:
                    self._note_save(step, "memory", ok=False)
                elif not self.tcfg.donation_aware:
                    # no overlap asked for: the loop waits for the copies
                    t0 = time.perf_counter()
                    self._stager.wait_copied()
                    self._stager.block_s += time.perf_counter() - t0

    # -- eviction grace-window drain -----------------------------------
    def set_event_reporter(self, reporter: Callable[[str, str], None]):
        """``reporter(event, detail)`` mirrors trainer incidents (the
        ``eviction`` node event) to the master, e.g.
        ``MasterClient.report_eviction_notice``; under the agent the
        metrics file carries the notice instead."""
        self._event_reporter = reporter

    def install_eviction_handler(self, grace_s: Optional[float] = None):
        """Register a SIGTERM handler that enters the drain state
        machine (it only sets flags; the work happens at the next step
        boundary on the train thread). Chains to any previous handler.
        Off the main thread it installs nothing: ``signal.signal`` works
        only there, and the ``evict`` command still drains."""
        import signal

        grace = (
            float(grace_s)
            if grace_s is not None
            else self.tcfg.eviction_grace_s
        )
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _handler(signum, frame):
                self.request_eviction(grace, reason="sigterm")
                if callable(prev) and prev not in (
                    signal.SIG_IGN, signal.SIG_DFL
                ):
                    prev(signum, frame)

            signal.signal(signal.SIGTERM, _handler)
            logger.info(
                f"eviction SIGTERM handler installed (grace {grace}s)"
            )
        except ValueError:
            logger.warning(
                "not on the main thread: SIGTERM eviction handler not "
                "installed (the `evict` worker command still works)"
            )

    def request_eviction(
        self, grace_s: Optional[float] = None, reason: str = "notice"
    ):
        """Enter the drain at the next step boundary. Idempotent: the
        first notice's deadline stands, a tighter one may shorten it,
        none extends it; safe from signal handlers and other threads."""
        grace = (
            float(grace_s)
            if grace_s is not None and grace_s > 0
            else self.tcfg.eviction_grace_s
        )
        deadline = time.monotonic() + grace
        if self._evict_deadline is None or deadline < self._evict_deadline:
            self._evict_deadline = deadline
            self._evict_grace_s = grace
        if not self._evict_event.is_set():
            self._evict_reason = reason
            self._evict_event.set()
            logger.warning(
                f"eviction notice ({reason}): draining within "
                f"{grace:.1f}s"
            )

    @property
    def eviction_pending(self) -> bool:
        return self._evict_event.is_set() and not self.evicted

    def _report_event(self, detail: str):
        if self._event_reporter is not None:
            try:
                self._event_reporter("eviction", detail)
            except Exception as e:
                logger.warning(f"eviction event report failed: {e!r}")

    def _emergency_save(self, step: int, deadline: float) -> bool:
        """Stage the current step into shm and commit it, within the
        grace window less a commit-sized margin; a stage still
        incomplete then is aborted, not committed (an unbounded commit
        would race the platform's kill), and the previous committed
        step stands. A saver still persisting an older step is waited
        for first, within the window (the port's saver persists every
        staged step, so it is busy more often than the JAX package's).
        The stage asks the host link for EMERGENCY: it preempts a
        background holder at its next chunk boundary."""
        # a half-staged OLDER step holds the shard lock; nobody saw it
        self._abort_stager()
        t0 = time.perf_counter()
        self._ckptr.engine.wait_saver_idle(max(deadline - 1.0 - time.monotonic(), 0.0))
        stager = self._ckptr.begin_chunked_save(
            step,
            self._ckpt_state(),
            chunk_bytes=self.tcfg.stage_chunk_mb << 20,
            priority=transfer_sched.Priority.EMERGENCY,
        )
        committed = False
        if hasattr(stager, "priority"):
            self.eviction_report["priority"] = stager.priority.name
            self.eviction_report["grant_wait_ms"] = stager.grant_wait_s * 1e3
        if stager is None:
            # the saver still holds the lock: the plain memory save
            # skips, never blocks, too
            committed = self.save(StorageType.MEMORY)
        else:
            while not stager.done and time.monotonic() < deadline - 0.5:
                stager.advance(budget_s=0.05, stats=self.pipeline_stats)
            if stager.done:
                committed = stager.commit(stats=self.pipeline_stats)
            else:
                stager.abort()
                logger.warning(
                    "eviction: emergency stage incomplete at the "
                    "deadline; aborted, the previous committed step "
                    "stands"
                )
            self._note_save(step, "eviction", stager=stager, ok=committed)
        self.eviction_report["stage_ms"] = (time.perf_counter() - t0) * 1e3
        return committed

    def _wait_persisted(self, step: int, deadline: float) -> bool:
        """The emergency step's disk persist under the agent: its saver
        persists every committed stage by itself, so this waits until
        the commit tracker names ``step``, at most until the deadline's
        margin (the JAX trainer asks for a second, synchronous save
        instead)."""
        while time.monotonic() < deadline - 0.5:
            if self._ckptr.engine.latest_step(self._ckptr.checkpoint_dir) >= step:
                return True
            time.sleep(0.02)
        return False

    def _drain_for_eviction(self):
        """The drain, on the train thread once the in-flight step
        finished: suppress the hang watchdog (the stall ahead is
        deliberate); announce the notice (metrics file + event seam) so
        the master can act while we drain; an emergency shm save of the
        CURRENT step; its disk persist only while more than
        ``eviction_persist_floor_s`` of the window remain (shm covers
        the tight case); book the window to the ``eviction`` goodput
        category; flush the runtime metrics and a flight bundle."""
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        deadline = self._evict_deadline or (
            time.monotonic() + self.tcfg.eviction_grace_s
        )
        grace = self._evict_grace_s or self.tcfg.eviction_grace_s
        step = self.global_step
        committed = persisted = False
        self._goodput.eviction_begin()
        # the drain runs no train compute: the arbiter's window closes
        transfer_sched.note_compute(False)
        try:
            with span("eviction_drain", step=step):
                self._flight.suppress_watchdog(grace + 60.0)
                self._flight.note_event(
                    "eviction",
                    f"{self._evict_reason}: grace={grace:.1f}s step={step}",
                )
                # announce FIRST: the master's resize runs while we drain
                if self.tcfg.report_metrics:
                    report_runtime_metrics(
                        step, eviction_pending=1.0,
                        eviction_grace_s=float(grace),
                    )
                self._report_event(
                    f"grace={grace:.1f}s step={step} "
                    f"reason={self._evict_reason}"
                )
                if self._ckptr is not None:
                    try:
                        committed = self._emergency_save(step, deadline)
                    except Exception as e:
                        logger.error(f"eviction emergency save failed: {e!r}")
                    remaining = deadline - time.monotonic()
                    if committed and not self._ckptr.engine._agent_mode:
                        # without a saver the commit wrote storage
                        persisted = True
                    elif committed and remaining > self.tcfg.eviction_persist_floor_s:
                        t1 = time.perf_counter()
                        persisted = self._wait_persisted(step, deadline)
                        if persisted:
                            self.eviction_report["persist_s"] = time.perf_counter() - t1
                    elif committed:
                        logger.info(
                            f"eviction: {remaining:.1f}s left of the grace "
                            f"window; skipping the disk persist (the shm "
                            f"handoff covers it)"
                        )
                self._close_prefetcher()
        finally:
            # the episode closes on every path, or the ledger books
            # every later second to `eviction`
            drain_ms = (time.perf_counter() - t0) * 1e3
            self.eviction_drain_ms = drain_ms
            self._goodput.eviction_end()
            self.evicted = True
        self.eviction_report.update(
            step=step, grace_s=grace, drain_ms=drain_ms,
            committed=committed, persisted=persisted,
        )
        # flush: goodput + registry + the final runtime-metrics write
        # (with the measured drain latency)
        self._report_metrics(
            step,
            {
                "eviction_pending": 1.0,
                "eviction_grace_s": float(grace),
                "eviction_drain_ms": round(drain_ms, 1),
            },
        )
        self._report_event(
            f"grace={grace:.1f}s step={step} drain_ms={drain_ms:.0f} "
            f"committed={int(committed)} persisted={int(persisted)}"
        )
        self._flight.note_event(
            "eviction_drained",
            f"step={step} drain_ms={drain_ms:.0f} "
            f"committed={int(committed)} persisted={int(persisted)}",
        )
        self._flight.dump(
            "eviction",
            extra={
                "step": step, "grace_s": grace, "drain_ms": drain_ms,
                "committed": committed, "persisted": persisted,
                "eviction_interval": [t0_ns, time.monotonic_ns()],
            },
            force=True,
        )
        logger.warning(
            f"eviction drain complete at step {step}: "
            f"{drain_ms:.0f} ms of a {grace:.1f}s window "
            f"(shm commit={'ok' if committed else 'FAILED'}, "
            f"persist={'ok' if persisted else 'skipped'})"
        )

    # -- save best -----------------------------------------------------
    def _best_sidecar_path(self) -> str:
        return os.path.join(self._best_dir, "best_eval.json")

    def _load_best_sidecar(self) -> float:
        try:
            with open(self._best_sidecar_path()) as f:
                return float(json.load(f)["eval_loss"])
        except (OSError, ValueError, KeyError):
            return float("inf")

    def _after_eval(self, step: int) -> bool:
        """save-best / early-stopping bookkeeping; True = stop now.

        Two distinct "best" trackers on purpose:

        - ``_run_best_eval_loss`` (reset every train() call) drives the
          patience counter: a restarted run that is still improving
          run-locally must not be stopped because it has not yet beaten
          the historical best it restarted below;
        - ``_best_eval_loss`` is the best PERSISTED loss (sidecar) and
          only advances when a checkpoint commits: a save skipped by
          the rate limit stays beatable.
        """
        loss = self._last_eval.get("eval_loss", float("inf"))
        if loss < self._run_best_eval_loss:
            self._run_best_eval_loss = loss
            self._evals_since_best = 0
        else:
            self._evals_since_best += 1
        if (
            self._best_ckptr is not None
            and loss < self._best_eval_loss
            and time.time() - self._last_best_save
            >= self.tcfg.save_best_min_interval_s
        ):
            logger.info(
                f"step {step}: new best eval_loss={loss:.4f}; "
                f"persisting to {self._best_dir}"
            )
            t0 = time.perf_counter()
            ok = self._best_ckptr.save_checkpoint(
                step, self._ckpt_state(), StorageType.DISK
            )
            self._note_save(step, "best", t0, self._best_ckptr.engine.last_stager, ok)
            if ok:
                # the sidecar records the PERSISTED best, written after
                # the commit and durable (fsync before rename)
                storage.durable_replace(
                    self._best_sidecar_path(),
                    lambda f: json.dump({"eval_loss": loss, "step": step}, f),
                )
                self._best_eval_loss = loss
                self._last_best_save = time.time()
        return (
            self.tcfg.early_stopping_patience > 0
            and self._evals_since_best >= self.tcfg.early_stopping_patience
        )

    # -- input ---------------------------------------------------------
    def _epoch_batches(self, num_steps: int):
        """One epoch's (x, y) device batches, prefetched when enabled.
        The prefetcher's source is capped at the steps remaining, so its
        lookahead never pulls samples past the run's end; what it does
        buffer is rewound in ``_ckpt_state``."""
        src = iter(self.dataloader)
        if self.tcfg.prefetch <= 0:
            self._prefetcher = None
            return (self._device_batch(b) for b in src)
        self._prefetcher = DevicePrefetcher(
            itertools.islice(src, max(num_steps - self.global_step, 0)),
            placement=self._device_batch,
            depth=self.tcfg.prefetch,
            stats=self.pipeline_stats,
            device=self.device,
        )
        return self._prefetcher

    def _close_prefetcher(self):
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    # -- compute spans -------------------------------------------------
    def _run_step(self, x, y, depth: int):
        """One optimizer step. On the CPU the ``compute`` span is the
        call itself (the work is done when it returns). On the card the
        call only enqueues, so the span is booked later from two CUDA
        events around the step, once the card has passed the second:
        no host sync is added to the loop.

        The host-link arbiter's compute window follows the same clock:
        on the CPU it spans the call; on the card it opens at dispatch
        and closes when ``_book_compute`` finds no step pending, so
        background transfers are granted while the card computes, not
        while the host merely enqueues."""
        if self.device.type != "cuda":
            with span("compute"):
                transfer_sched.note_compute(True)
                try:
                    return self._step_fn(self.state, x, y)
                finally:
                    transfer_sched.note_compute(False)
        stream = torch.cuda.current_stream(self.device)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host_ns = time.monotonic_ns()
        transfer_sched.note_compute(True)
        begin.record(stream)
        out = self._step_fn(self.state, x, y)
        end.record(stream)
        self._pending_compute.append((begin, end, host_ns, depth))
        self._book_compute()
        return out

    def _book_compute(self, wait: bool = False):
        """Book the ``compute`` span of every step the card has finished
        (with ``wait``, of every step dispatched, waiting for the card):
        its length is the device time between the step's two events, its
        start the later of the step's dispatch and the previous span's
        end (the card runs one step after another), so each span starts
        no earlier, and ends no earlier, than the step did on the card.
        When no step is left pending the arbiter's compute window
        closes."""
        tracer = get_tracer()
        if not self._pending_compute:
            return
        while self._pending_compute:
            begin, end, host_ns, depth = self._pending_compute[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending_compute.popleft()
            dur_ns = int(begin.elapsed_time(end) * 1e6)
            start_ns = max(host_ns, self._device_free_ns)
            self._device_free_ns = start_ns + dur_ns
            tracer.record("compute", start_ns, dur_ns, depth=depth)
        transfer_sched.note_compute(False)

    # -- metrics and master commands -------------------------------------
    def _observe_step_time(self, dt_s: float):
        self._step_time_hist.observe(dt_s)
        self._step_time_sum += dt_s
        self._step_time_n += 1

    def _report_metrics(self, step: int, scalars: Dict[str, float]):
        """Publish at log cadence: the training scalars and the whole
        registry through ONE file (the agent forwards every float in it
        to the master's collector). PipelineStats, the goodput ledger
        and the step auditor's ``dlrover_audit_*`` series fold into the
        registry here, and the master's commands are polled."""
        if self._step_time_n:
            scalars["step_time_ms"] = round(
                1e3 * self._step_time_sum / self._step_time_n, 3
            )
            self._step_time_sum = 0.0
            self._step_time_n = 0
        for k, v in scalars.items():
            self._registry.gauge(
                f"dlrover_train_{k}", "training scalar"
            ).set(v)
        fold_pipeline_stats(self.pipeline_stats, self._registry)
        # every dispatched step's compute span is booked before the
        # ledger closes the window at "now"
        self._book_compute(wait=True)
        self._goodput.export(self._registry)
        # budget reconciliation rides the same cadence: audit every step
        # completed since the last report, publish the dlrover_audit_*
        # series and rate-limited-persist the drift snapshot beside the
        # link-model cache so a warm restart starts repriced
        self._auditor.export(self._registry)
        if self._link_fp:
            self._auditor.persist(fingerprint=self._link_fp)
        self._poll_worker_commands()
        if self.tcfg.report_metrics:
            report_runtime_metrics(
                step, **{**scalars, **self._registry.scalars()}
            )
        return scalars

    def _poll_worker_commands(self):
        """Execute master->worker commands relayed by the agent (the
        eviction notice, flight dumps, profiler captures). Ids are
        master-monotonic, so a command runs exactly once per process."""
        try:
            cmds = read_worker_commands()
        except Exception:
            return
        for c in cmds:
            try:
                cid = int(c.get("id", 0))
            except (TypeError, ValueError):
                continue
            if cid <= self._last_command_id:
                continue
            self._last_command_id = cid
            kind = c.get("kind", "")
            reason = str(c.get("reason", "") or "master_request")
            if kind == "evict":
                # arg carries the grace window, 0 = the trainer's default
                self.request_eviction(
                    float(c.get("arg", 0) or 0) or None,
                    reason=f"master_{reason}",
                )
            elif kind == "flight_dump":
                logger.info(
                    f"master requested flight dump (#{cid}, {reason})"
                )
                self._flight.dump(f"request_{reason}")
            elif kind == "profile":
                steps = int(c.get("arg", 0) or 3)
                if self._profiler_capture.request(steps, reason=reason):
                    logger.info(
                        f"master requested profiler capture (#{cid}, "
                        f"{steps} steps, {reason})"
                    )
                else:
                    # refusal bounds the artifact volume, but it must be
                    # visible: the master believes evidence is coming
                    logger.warning(
                        f"profiler capture request #{cid} ({reason}) "
                        f"refused: capture active or cooling down"
                    )
            else:
                logger.warning(
                    f"unknown worker command kind {kind!r} (#{cid})"
                )

    # -- loop ----------------------------------------------------------
    def train(self, num_steps: int):
        """Run up to ``num_steps`` optimizer steps (across epochs); stops
        early on an eviction notice (after its drain) or on early
        stopping."""
        if self.idle:
            # a rank the resize left idle: back when the mesh's ranks
            # finish (their closing barrier)
            logger.info("idle rank: waiting for the mesh's ranks to finish")
            self._mesh_ranks_done()
            return None
        t0 = time.time()
        start_step = self.global_step
        # hang attribution and the ledger read THIS thread's spans (the
        # prefetch producer parks in a read by design)
        self._train_tid = threading.get_ident()
        self._last_eval = {}
        # run-local best for the patience counter; the PERSISTED best
        # (sidecar-loaded) deliberately survives
        self._run_best_eval_loss = float("inf")
        self._evals_since_best = 0
        try:
            out = self._train_loop(num_steps, t0, start_step)
            self._mesh_ranks_done()
            return out
        except BaseException as e:
            # the black box dumps BEFORE the exception unwinds past the
            # trainer, forced past the rate limit: this is the evidence
            if not isinstance(e, (KeyboardInterrupt, SystemExit)):
                self._flight.dump("crash", exc=e, force=True)
            raise
        finally:
            self._close_prefetcher()
            try:
                # a half-staged checkpoint must not die with the loop:
                # the barrier drains and publishes it
                self._finish_stager()
            except Exception as e:
                # never mask the loop's own exception with a commit
                # failure; the stage is already aborted (lock released)
                logger.error(f"final stage commit failed: {e!r}")

    def _mesh_ranks_done(self):
        """With idle ranks in the process group, every rank meets at one
        barrier of the default group when a ``train`` call ends: the
        idle ranks return from theirs then."""
        import torch.distributed as dist

        if dist.is_initialized() and int(self.mesh.layout.size) < dist.get_world_size():
            dist.barrier()

    def _train_loop(self, num_steps: int, t0: float, start_step: int):
        while self.global_step < num_steps and not self.eviction_pending:
            self.dataloader.load_config()  # master-retuned batch size
            self._apply_lr_scale(self.dataloader.lr_scale)
            # master-predicted next worlds: their strategies derived and
            # cached in the background
            self._poll_scale_candidates()
            batches = iter(self._epoch_batches(num_steps))
            while True:
                # the step boundary is the preemption arrival point:
                # node.preempt `kill` is the scripted hard death; a
                # pending notice enters the graceful drain instead
                faults.fire("node.preempt")
                if self.eviction_pending:
                    break
                self._profiler_capture.on_step_begin()
                step_sp = span("step")
                step_t0 = time.perf_counter()
                try:
                    try:
                        with span("data_wait"):
                            x, y = next(batches)
                    except StopIteration:
                        step_sp.cancel()
                        break
                    self.state, metrics = self._run_step(
                        x, y, getattr(step_sp, "depth", 0) + 1
                    )
                    step = self.global_step
                    # the save in flight gets its budget while the next
                    # step's kernels are queued
                    self._advance_stager()
                    if self._metrics_hook is not None:
                        self._metrics_hook(step, metrics)
                    if (
                        self._moe_rebalancer is not None
                        and step % self.tcfg.moe_rebalance_interval == 0
                        and "moe_expert_load" in metrics
                    ):
                        self._maybe_rebalance_experts(metrics["moe_expert_load"])
                    if step % self.tcfg.log_interval == 0:
                        # the loop's only host sync, at log cadence
                        with span("host_sync"):
                            loss = float(metrics["loss"])
                        with span("report"):
                            scalars = {"loss": loss}
                            lr = self.current_lr()
                            if lr is not None:
                                scalars["lr"] = lr
                            if self._last_eval:
                                scalars.update(self._last_eval)
                            self._report_metrics(step, scalars)
                            rate = (step - start_step) / max(time.time() - t0, 1e-9)
                            lr_s = f" lr={lr:.2e}" if lr is not None else ""
                            logger.info(f"step {step}: loss={loss:.4f}{lr_s} ({rate:.2f} it/s)")
                    if (
                        self._eval_dataset is not None
                        and self.tcfg.eval_interval
                        and step % self.tcfg.eval_interval == 0
                    ):
                        with span("eval"):
                            self._last_eval = self.evaluate()
                        logger.info(
                            f"step {step}: eval_loss={self._last_eval['eval_loss']:.4f} "
                            f"ppl={self._last_eval['eval_ppl']:.2f}"
                        )
                        if self._metrics_hook is not None:
                            self._metrics_hook(step, dict(self._last_eval))
                        if self._after_eval(step):
                            logger.info(
                                f"early stopping at step {step}: no eval "
                                f"improvement in "
                                f"{self.tcfg.early_stopping_patience} evals "
                                f"(best {self._run_best_eval_loss:.4f})"
                            )
                            step_sp.end()
                            return self._settle()
                    # the card may have finished the step meanwhile (an
                    # event query, no sync): the window closes if so
                    self._book_compute()
                    with span("ckpt_save"):
                        self._maybe_save(step)
                    step_sp.end()
                    self._profiler_capture.on_step_end()
                    self._observe_step_time(time.perf_counter() - step_t0)
                    if (
                        self._replay_until_step is not None
                        and step >= self._replay_until_step
                    ):
                        # caught back up to the pre-restart frontier
                        self._goodput.replay_end()
                        self._replay_until_step = None
                except BaseException:
                    step_sp.cancel()
                    raise
                if step >= num_steps:
                    break
            if self.eviction_pending:
                # the prefetcher stays up: the emergency checkpoint's
                # sampler snapshot rewinds its lookahead; the drain
                # closes it afterwards
                break
            self._close_prefetcher()  # a fresh buffer per epoch
        if self.eviction_pending:
            if self.device.type == "cuda":
                cuda_sync.synchronize(self.device)
            self._drain_for_eviction()
        return self._settle()

    def _settle(self):
        """Wait for the card and book the last steps' compute spans."""
        if self.device.type == "cuda":
            cuda_sync.synchronize(self.device)
        self._book_compute(wait=True)
        return self.state

    def forensics(self) -> Dict:
        """What the telemetry holds now: the goodput report, whether the
        trainer was evicted and the drain's record, the profiler
        captures and the flight bundles written."""
        return dict(
            goodput=self._goodput.snapshot().as_dict(),
            evicted=self.evicted,
            eviction=dict(self.eviction_report),
            profiles=list(self._profiler_capture.artifacts),
            flight_dumps=self._flight.dumps,
        )

    def close(self):
        """Stop the heartbeat, the hang watchdog, a live profiler
        capture and the prefetcher, abort an uncommitted save, and close
        the checkpoint engines."""
        if self._span_heartbeat is not None:
            self._span_heartbeat.stop()
            self._span_heartbeat = None
        # final drift snapshot, bypassing the rate limit — short jobs
        # still leave a calibration for the next run on this hardware
        if self._link_fp:
            self._auditor.persist(fingerprint=self._link_fp, force=True)
        self._flight.stop_watchdog()
        self._profiler_capture.abort()
        self._close_prefetcher()
        self._abort_stager()
        transfer_sched.note_compute(False)
        if self._spec_compiler is not None:
            self._spec_compiler.close()
            self._spec_compiler = None
        for ckptr in (self._ckptr, self._best_ckptr):
            if ckptr is not None:
                ckptr.engine.close()
