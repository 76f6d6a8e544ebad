"""Dataset splitters: carve a dataset into shards for dynamic dispatch.

Parity: dlrover/python/master/shard/dataset_splitter.py:90,144,257 —
``TableDatasetSplitter`` (offset ranges) and ``TextDatasetSplitter``
(offset ranges + shuffled record indices). A shard is the unit of dynamic
work assignment; workers pull shards from the master so a dead worker's
shards get re-dispatched (mid-epoch elasticity).
"""

from __future__ import annotations

import random
from abc import ABC, abstractmethod
from typing import List, Optional

from dlrover_tpu_torch.common.comm import Shard
from dlrover_tpu_torch.common.log import default_logger as logger


class DatasetSplitter(ABC):
    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
    ):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(1, shard_size)
        self._num_epochs = max(1, num_epochs)
        self.epoch = 0

    @abstractmethod
    def create_shards(self) -> List[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self._num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous [start, end) ranges (parity: dataset_splitter.py:144)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        max_shard_count: int = 50000,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._max_shard_count = max_shard_count

    def create_shards(self) -> List[Shard]:
        logger.info(
            f"create shards for {self.dataset_name}: size={self.dataset_size} "
            f"shard_size={self.shard_size} epoch={self.epoch}"
        )
        if self.dataset_size // self.shard_size > self._max_shard_count:
            self.shard_size = self.dataset_size // self._max_shard_count
        shards = [
            Shard(
                name=self.dataset_name,
                start=start,
                end=min(start + self.shard_size, self.dataset_size),
            )
            for start in range(0, self.dataset_size, self.shard_size)
        ]
        if self._shuffle:
            random.shuffle(shards)
        self.epoch += 1
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Ranges plus per-shard (optionally shuffled) record indices
    (parity: dataset_splitter.py:257)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle

    def create_shards(self) -> List[Shard]:
        indices = list(range(self.dataset_size))
        if self._shuffle:
            random.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=start,
                    end=end,
                    record_indices=indices[start:end],
                )
            )
        self.epoch += 1
        return shards


class StreamingDatasetSplitter(DatasetSplitter):
    """Unbounded dataset: shards are carved up to a watermark that grows
    as the producer reports new records (parity:
    dataset_splitter.py:359 StreamingDatasetSplitter, whose partition
    offsets come from a message queue; here the producer reports counts
    over the same RPC the rest of the shard machinery uses).

    A partial tail shard is only emitted after ``end_stream()`` — until
    then it may still fill up.
    """

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        dataset_size: int = -1,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, 1)
        self._watermark = max(0, dataset_size)
        self._next = 0
        self._ended = False

    def add_records(self, count: int):
        if count > 0:
            self._watermark += count

    def end_stream(self):
        self._ended = True

    def create_shards(self) -> List[Shard]:
        shards = []
        while self._next + self.shard_size <= self._watermark:
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=self._next,
                    end=self._next + self.shard_size,
                )
            )
            self._next += self.shard_size
        if self._ended and self._next < self._watermark:
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=self._next,
                    end=self._watermark,
                )
            )
            self._next = self._watermark
        return shards

    def epoch_finished(self) -> bool:
        return self._ended and self._next >= self._watermark


def new_dataset_splitter(
    shuffle: bool,
    shard_size: int,
    dataset_size: int,
    num_epochs: int,
    dataset_name: str,
    storage_type: Optional[str] = None,
) -> DatasetSplitter:
    storage_type = storage_type or "text"
    if storage_type == "table":
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "stream":
        return StreamingDatasetSplitter(
            dataset_name, shard_size, dataset_size
        )
    return TextDatasetSplitter(
        dataset_name, dataset_size, shard_size, num_epochs, shuffle
    )
