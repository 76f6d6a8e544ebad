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

``TrainerConfig`` keeps every field and default of the JAX package.
Knobs whose machinery is not ported yet raise ``NotImplementedError``
when set away from their default (``_UNPORTED``, with the ROADMAP item
that ports them). ``speculative_compile``, ``report_metrics`` and the
gradient-sync sizes are accepted and not yet honored (ROADMAP A6/A7).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import time
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.ckpt.checkpointer import FlashCheckpointer, StorageType
from dlrover_tpu_torch.common import storage
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.prefetch import DevicePrefetcher, PipelineStats
from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.convert import load_train_state_tree, train_state_tree
from dlrover_tpu_torch.models.train import build_train_step, init_state
from dlrover_tpu_torch.models.transformer import forward, token_nll
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
    "early_stopping_patience": "A6 (trainer loop)",
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

    # -- save best -----------------------------------------------------
    def _best_sidecar_path(self) -> str:
        return os.path.join(self._best_dir, "best_eval.json")

    def _load_best_sidecar(self) -> float:
        try:
            with open(self._best_sidecar_path()) as f:
                return float(json.load(f)["eval_loss"])
        except (OSError, ValueError, KeyError):
            return float("inf")

    def _after_eval(self, step: int):
        """save_best: a new best eval loss persists a checkpoint under
        ``ckpt_dir/best`` (at most once per ``save_best_min_interval_s``)
        and then the sidecar that names it; a save skipped by the rate
        limit stays beatable."""
        loss = self._last_eval.get("eval_loss", float("inf"))
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

    # -- loop ----------------------------------------------------------
    def train(self, num_steps: int):
        """Run up to ``num_steps`` optimizer steps (across epochs)."""
        t0 = time.time()
        start_step = self.global_step
        try:
            while self.global_step < num_steps:
                self.dataloader.load_config()  # master-retuned batch size
                self._apply_lr_scale(self.dataloader.lr_scale)
                batches = self._epoch_batches(num_steps)
                for x, y in batches:
                    self.state, metrics = self._step_fn(self.state, x, y)
                    step = self.global_step
                    # the save in flight gets its budget while the next
                    # step's kernels are queued
                    self._advance_stager()
                    if self._metrics_hook is not None:
                        self._metrics_hook(step, metrics)
                    if step % self.tcfg.log_interval == 0:
                        # the loop's only host sync at log cadence
                        loss = float(metrics["loss"])
                        lr = self.current_lr()
                        rate = (step - start_step) / max(time.time() - t0, 1e-9)
                        lr_s = f" lr={lr:.2e}" if lr is not None else ""
                        logger.info(f"step {step}: loss={loss:.4f}{lr_s} ({rate:.2f} it/s)")
                    if (
                        self._eval_dataset is not None
                        and self.tcfg.eval_interval
                        and step % self.tcfg.eval_interval == 0
                    ):
                        self._last_eval = self.evaluate()
                        logger.info(
                            f"step {step}: eval_loss={self._last_eval['eval_loss']:.4f} "
                            f"ppl={self._last_eval['eval_ppl']:.2f}"
                        )
                        if self._metrics_hook is not None:
                            self._metrics_hook(step, dict(self._last_eval))
                        self._after_eval(step)
                    self._maybe_save(step)
                    if step >= num_steps:
                        break
                self._close_prefetcher()  # a fresh buffer per epoch
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.state

    def close(self):
        """Stop the prefetcher, abort an uncommitted save, and close the
        checkpoint engines."""
        self._close_prefetcher()
        self._abort_stager()
        for ckptr in (self._ckptr, self._best_ckptr):
            if ckptr is not None:
                ckptr.engine.close()
