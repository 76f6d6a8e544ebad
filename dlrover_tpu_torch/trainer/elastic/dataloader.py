"""Elastic data loader: batch size retunable at runtime via the
master-driven paral-config file (counterpart of
``dlrover_tpu/trainer/elastic/dataloader.py``).

Batches come out as int64 CPU tensors; the trainer moves them to its
device (pinned memory, ``non_blocking``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.trainer.elastic.sampler import (
    ElasticDistributedSampler,
)


def read_paral_config(path: str = "") -> dict:
    path = path or os.getenv(
        ConfigPath.ENV_PARAL_CONFIG, ConfigPath.PARAL_CONFIG
    )
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


class ElasticDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        sampler: Optional[ElasticDistributedSampler] = None,
        collate_fn: Optional[Callable] = None,
        config_file: str = "",
    ):
        self.dataset = dataset
        self._batch_size = batch_size
        self.sampler = sampler or ElasticDistributedSampler(
            len(dataset), shuffle=False
        )
        self._collate_fn = collate_fn or _default_collate
        self._config_file = config_file
        # linear-scaling LR multiplier the master retunes alongside the
        # batch size (optimizer.batch_size_factor); ElasticTrainer
        # applies it as the optimizer's retune scale
        self.lr_scale = 1.0
        self.load_config()

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def set_batch_size(self, batch_size: int):
        if batch_size > 0 and batch_size != self._batch_size:
            logger.info(
                f"dataloader batch size {self._batch_size} -> {batch_size}"
            )
            self._batch_size = batch_size

    def load_config(self):
        """Pick up a master-tuned batch size / LR scale if present."""
        config = read_paral_config(self._config_file)
        dl = config.get("dataloader", {})
        if dl.get("batch_size"):
            self.set_batch_size(int(dl["batch_size"]))
        factor = config.get("optimizer", {}).get("batch_size_factor")
        if factor and factor > 0:
            self.lr_scale = float(factor)

    def __iter__(self) -> Iterator:
        batch = []
        for idx in self.sampler:
            batch.append(self.dataset[idx])
            if len(batch) >= self._batch_size:
                yield self._collate_fn(batch)
                batch = []
        if batch:
            yield self._collate_fn(batch)

    def __len__(self) -> int:
        return -(-len(self.sampler) // self._batch_size)

    # -- checkpoint ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"sampler": self.sampler.state_dict()}

    def load_state_dict(self, state: dict):
        self.sampler.load_state_dict(state.get("sampler", {}))


def _stack(rows) -> torch.Tensor:
    """numpy rows -> one int64 CPU tensor (token ids index embeddings,
    which take int64)."""
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def _default_collate(batch):
    first = batch[0]
    if isinstance(first, tuple):
        return tuple(
            _stack([b[i] for b in batch]) for i in range(len(first))
        )
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batch]) for k in first}
    return _stack(batch)
