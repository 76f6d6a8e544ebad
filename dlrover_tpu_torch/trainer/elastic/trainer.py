"""ElasticTrainer on PyTorch: the user-facing training loop (counterpart
of ``dlrover_tpu/trainer/elastic/trainer.py``).

The same entry a user calls on the JAX package::

    ElasticTrainer(model_cfg=gpt2_small(), tx=build_optimizer(...),
                   dataset=..., trainer_cfg=TrainerConfig(...)).train(n)

runs here on one device (the card unless ``devices="cpu"``): the elastic
sampler and data loader (master-retuned batch size and LR scale), the
device prefetcher (``prefetch`` batches ahead, ``data/prefetch.py``),
the step of ``models/train.py``, the LR schedule and retune scale of
``build_optimizer``, metrics at log cadence, the eval loop, and Flash
Checkpoint (``ckpt_dir``): a shm save every ``save_memory_interval``
steps whose copies run beside the next step (``chunked_staging``; the
host side, crc32 over the bytes in shm in ``stage_chunk_mb`` chunks,
runs on host threads of its own and takes at most ``stage_budget_ms``
of the loop a step), a persisted save every ``save_storage_interval``
steps (a stage still open at such a step yields to it), the
best eval's checkpoint under ``ckpt_dir/best`` (``save_best``), and a
restore from shm or storage at construction.

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

``TrainerConfig`` keeps every field and default of the JAX package.
Knobs whose machinery is not ported yet raise ``NotImplementedError``
when set away from their default (``_UNPORTED``, with the ROADMAP item
that ports them). ``speculative_compile`` and ``spec_compile_budget_s``
are accepted and not honored: they belong to the compile cache
(ROADMAP A8). The gradient-sync sizes are accepted and not honored
either (ROADMAP A7).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.agent.monitor import (
    last_command_id,
    read_runtime_metrics,
    read_worker_commands,
    report_runtime_metrics,
)
from dlrover_tpu_torch.ckpt.checkpointer import FlashCheckpointer, StorageType
from dlrover_tpu_torch.common import faults, storage
from dlrover_tpu_torch.common.constants import NodeEnv, TrainerEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.prefetch import DevicePrefetcher, PipelineStats
from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.convert import load_train_state_tree, train_state_tree
from dlrover_tpu_torch.models.train import build_train_step, init_state
from dlrover_tpu_torch.models.transformer import forward, token_nll
from dlrover_tpu_torch.obs.flight_recorder import (
    ProfilerCapture,
    default_recorder,
)
from dlrover_tpu_torch.obs.goodput import GoodputLedger, install_default_ledger
from dlrover_tpu_torch.obs.metrics import default_registry, fold_pipeline_stats
from dlrover_tpu_torch.obs.trace import SpanHeartbeat, get_tracer, span
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


# knob -> the ROADMAP item that ports its machinery
_UNPORTED = {
    "comm_overlap": "A7 (gradient sync)",
    "grad_compress": "A7 (gradient sync)",
    "sdc_detect": "A7 (gradient sync) / A15 (SDC audit)",
    "moe_rebalance_interval": "A11 (MoE)",
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
    JAX package; ``retune_scale`` multiplies the update."""
    lr_fn = lr_schedule(lr, schedule, warmup_steps, total_steps)
    if name == "agd":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A4)"
        )
    if name not in ("adamw", "adam", "sgd", "adamw_8bit", "adamw_8bit_flat"):
        raise ValueError(f"unknown optimizer {name!r}")
    allowed = {"adamw": _ADAM_KW, "adam": _ADAM_KW, "sgd": _SGD_KW}.get(name)
    if allowed is not None and set(kwargs) - allowed:
        raise TypeError(f"{name}: unsupported arguments {sorted(set(kwargs) - allowed)}")
    lr0 = float(lr_fn(0))

    def make(params):
        if name in ("adamw_8bit", "adamw_8bit_flat"):
            from dlrover_tpu_torch.ops import quantized_optim

            cls = getattr(quantized_optim, name)
            opt = cls(params, lr0, weight_decay=weight_decay, **kwargs)
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
        devices=None,
        collate_fn: Optional[Callable] = None,
        metrics_hook: Optional[Callable[[int, Dict], None]] = None,
        eval_dataset=None,
    ):
        self.tcfg = trainer_cfg or TrainerConfig()
        _check_unported(self.tcfg)
        self.device = resolve_device(devices)
        self.cfg = model_cfg
        self._metrics_hook = metrics_hook
        self._setup_telemetry(model_cfg)
        self.state = init_state(model_cfg, tx, seed=0, devices=self.device)
        self._step_fn = build_train_step(
            model_cfg, tx, grad_accum=self.tcfg.grad_accum,
            before_update=self._fence_staging,
        )
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
        self.pipeline_stats = PipelineStats()
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
        self._ckptr: Optional[FlashCheckpointer] = None
        self._best_ckptr: Optional[FlashCheckpointer] = None
        # the best PERSISTED eval loss survives restarts via a sidecar
        self._best_eval_loss = float("inf")
        self._last_best_save = 0.0
        if self.tcfg.ckpt_dir:
            self._ckptr = FlashCheckpointer(self.tcfg.ckpt_dir)
            self._maybe_restore()
            if self.tcfg.save_best:
                self._best_dir = os.path.join(self.tcfg.ckpt_dir, "best")
                self._best_ckptr = FlashCheckpointer(self._best_dir)
                self._best_eval_loss = self._load_best_sidecar()

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
        self._goodput = install_default_ledger(
            GoodputLedger(tid_fn=lambda: self._train_tid)
        )
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
        return self.state.step

    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        t = t.long()
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _device_batch(self, batch):
        if isinstance(batch, dict):
            bx, by = batch["x"], batch["y"]
        else:  # tuple/list samples from the default collate
            bx, by = batch[0], batch[1]
        return self._to_device(bx), self._to_device(by)

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
        for batch in self._eval_batches(max_batches):
            x, y = self._device_batch(batch)
            logits, _ = forward(self.state.params, x, self.cfg)
            losses.append(float(token_nll(logits, y)))
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
        return {"train": train_state_tree(self.state), "sampler": samp}

    def _maybe_restore(self):
        t0 = time.perf_counter()
        step, restored = self._ckptr.load_checkpoint(self._ckpt_state())
        if restored is not None and step >= 0:
            load_train_state_tree(self.state, restored["train"])
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

    def _note_save(self, step, kind, t0=None, stager=None, ok=True):
        rec = {"step": step, "kind": kind, "ok": bool(ok)}
        if t0 is not None:
            rec["block_ms"] = (time.perf_counter() - t0) * 1e3
        if stager is not None:
            if "block_ms" not in rec:
                rec["block_ms"] = stager.block_s * 1e3
            rec.update(bytes=stager.total_bytes, **stager.timings)
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
        The engine takes no link ``priority``: the transfer scheduler is
        ROADMAP A9."""
        # a half-staged OLDER step holds the shard lock; nobody saw it
        self._abort_stager()
        t0 = time.perf_counter()
        self._ckptr.engine.wait_saver_idle(max(deadline - 1.0 - time.monotonic(), 0.0))
        stager = self._ckptr.begin_chunked_save(
            step,
            self._ckpt_state(),
            chunk_bytes=self.tcfg.stage_chunk_mb << 20,
        )
        committed = False
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
        no host sync is added to the loop."""
        if self.device.type != "cuda":
            with span("compute"):
                return self._step_fn(self.state, x, y)
        stream = torch.cuda.current_stream(self.device)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host_ns = time.monotonic_ns()
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
        no earlier, and ends no earlier, than the step did on the card."""
        tracer = get_tracer()
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

    # -- metrics and master commands -------------------------------------
    def _observe_step_time(self, dt_s: float):
        self._step_time_hist.observe(dt_s)
        self._step_time_sum += dt_s
        self._step_time_n += 1

    def _report_metrics(self, step: int, scalars: Dict[str, float]):
        """Publish at log cadence: the training scalars and the whole
        registry through ONE file (the agent forwards every float in it
        to the master's collector). PipelineStats and the goodput ledger
        fold into the registry here, and the master's commands are
        polled. (The JAX package's ``dlrover_audit_*`` leg waits for its
        step auditor's link model, ROADMAP A9.)"""
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
            return self._train_loop(num_steps, t0, start_step)
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

    def _train_loop(self, num_steps: int, t0: float, start_step: int):
        while self.global_step < num_steps and not self.eviction_pending:
            self.dataloader.load_config()  # master-retuned batch size
            self._apply_lr_scale(self.dataloader.lr_scale)
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
                torch.cuda.synchronize(self.device)
            self._drain_for_eviction()
        return self._settle()

    def _settle(self):
        """Wait for the card and book the last steps' compute spans."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
        self._flight.stop_watchdog()
        self._profiler_capture.abort()
        self._close_prefetcher()
        self._abort_stager()
        for ckptr in (self._ckptr, self._best_ckptr):
            if ckptr is not None:
                ckptr.engine.close()
