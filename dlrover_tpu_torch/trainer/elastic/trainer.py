"""ElasticTrainer on PyTorch: the user-facing training loop (counterpart
of ``dlrover_tpu/trainer/elastic/trainer.py``), lean first slice.

The same entry a user calls on the JAX package::

    ElasticTrainer(model_cfg=gpt2_small(), tx=build_optimizer(...),
                   dataset=..., trainer_cfg=TrainerConfig(...)).train(n)

runs here on one device (the card unless ``devices="cpu"``): the elastic
sampler and data loader (master-retuned batch size and LR scale), the
step of ``models/train.py``, the LR schedule and retune scale of
``build_optimizer``, metrics at log cadence and the eval loop.

``TrainerConfig`` keeps every field and default of the JAX package.
Knobs whose machinery is not ported yet raise ``NotImplementedError``
when set away from their default (``_UNPORTED``, with the ROADMAP item
that ports them). Knobs that only affect speed (``prefetch``,
``chunked_staging``, ``donation_aware``, ``speculative_compile``,
``report_metrics`` and the staging/sync sizes) are accepted and not yet
honored (ROADMAP A6).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, fields
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.config import TransformerConfig
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
    "ckpt_dir": "A5 (flash checkpoint)",
    "save_best": "A5 (flash checkpoint)",
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
            model_cfg, tx, grad_accum=self.tcfg.grad_accum
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

    # -- loop ----------------------------------------------------------
    def train(self, num_steps: int):
        """Run up to ``num_steps`` optimizer steps (across epochs)."""
        t0 = time.time()
        start_step = self.global_step
        while self.global_step < num_steps:
            self.dataloader.load_config()  # master-retuned batch size
            self._apply_lr_scale(self.dataloader.lr_scale)
            for batch in self.dataloader:
                x, y = self._device_batch(batch)
                self.state, metrics = self._step_fn(self.state, x, y)
                step = self.global_step
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
                if step >= num_steps:
                    break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.state

    def close(self):
        """Nothing to release yet: the port's trainer starts no thread
        and opens no file (flash checkpoint and prefetch are ROADMAP
        A5/A6)."""
