"""Checkpointable data sampler that survives world-size changes (a copy
of ``dlrover_tpu/trainer/elastic/sampler.py``, numpy only).

The sampler records global progress (``completed_num``) so training
resumes mid-epoch after a restart even when the number of
data-parallel replicas changed. The copy deals the same indices in the
same order as the JAX package's for the same seed, so a run of either
package consumes the data identically.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas:
            raise ValueError(
                f"rank {rank} >= num_replicas {num_replicas}"
            )
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # samples (global, across all replicas) consumed in this epoch
        self.completed_num = 0
        # heterogeneous throughput weights (parallel/topology.slice_
        # throughput_weights): None = equal round-robin shards (the
        # historical path, byte-identical); else one positive weight
        # per replica and samples are dealt proportionally
        self._weights: Optional[np.ndarray] = None
        self._deal: Optional[np.ndarray] = None  # memoized pattern

    def _epoch_total(self) -> int:
        """Samples per epoch after drop/pad, without materializing indices."""
        if self.drop_last:
            return (
                self.dataset_size // self.num_replicas
            ) * self.num_replicas
        return -(-self.dataset_size // self.num_replicas) * self.num_replicas

    def _epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        total = self._epoch_total()
        if total <= len(indices):
            indices = indices[:total]
        else:
            # wrap as many times as needed (num_replicas can exceed the
            # dataset size); a short epoch would give replicas different
            # step counts and hang the next collective
            reps = -(-total // len(indices))
            indices = np.tile(indices, reps)[:total]
        return indices

    # -- heterogeneous throughput weighting ----------------------------
    def set_throughput_weights(self, weights) -> None:
        """Unequal data shards for unequal replicas (arXiv 2602.18007
        via ``topology.slice_throughput_weights``): ``weights`` is one
        positive share per replica (normalized here) and samples are
        dealt proportionally by a deterministic smooth weighted
        round-robin — every replica computes the identical deal
        pattern from the same weights, so no coordination is needed.
        ``None`` restores equal round-robin dealing."""
        if weights is None:
            self._weights = self._deal = None
            return
        w = np.asarray(list(weights), dtype=np.float64)
        if len(w) != self.num_replicas or (w <= 0).any():
            raise ValueError(
                f"need {self.num_replicas} positive weights, got "
                f"{list(weights)!r}"
            )
        self._weights = w / w.sum()
        self._deal = None

    def _deal_pattern(self) -> np.ndarray:
        """Replica id per global sample position over one window of
        ``16 * num_replicas`` positions (smooth weighted round-robin:
        each position goes to the replica with the largest accumulated
        deficit, so shares interleave instead of clumping). Purely a
        function of the weights — identical on every replica."""
        if self._deal is not None:
            return self._deal
        W = 16 * self.num_replicas
        credit = np.zeros(self.num_replicas)
        out = np.empty(W, dtype=np.int64)
        for p in range(W):
            credit += self._weights
            r = int(np.argmax(credit))
            out[p] = r
            credit[r] -= 1.0
        self._deal = out
        return out

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()
        if self._weights is None:
            # skip what the job already consumed (any previous world
            # size): completed_num is global, so the remaining samples
            # are simply re-dealt round-robin to the current replicas
            remaining = indices[self.completed_num:]
            for i, idx in enumerate(remaining):
                if i % self.num_replicas == self.rank:
                    self.completed_num += self.num_replicas
                    yield int(idx)
        else:
            # weighted dealing walks GLOBAL positions one at a time
            # (completed_num stays the global cursor, so checkpoints
            # and world-size changes keep their exactly-once story)
            pattern = self._deal_pattern()
            W = len(pattern)
            total = len(indices)
            while self.completed_num < total:
                p = self.completed_num
                self.completed_num += 1
                if pattern[p % W] == self.rank:
                    yield int(indices[p])
        # epoch exhausted: roll over so a plain
        # ``for epoch in range(n): for batch in loader`` loop works even
        # without an explicit set_epoch (which still overrides shuffling)
        self.epoch += 1
        self.completed_num = 0

    def rewound_completed(self, completed: int, owned: int) -> int:
        """Global cursor after rewinding ``owned`` of THIS rank's
        samples from ``completed`` — the prefetch-rewind arithmetic
        (trainer ``_rewound_sampler_state``) must match the dealing
        mode. Equal dealing: every owned sample spans ``num_replicas``
        global positions. Weighted dealing: walk the deal pattern
        backwards, releasing a unit of ``owned`` per owned position.
        May return a NEGATIVE value: that many global positions borrow
        from the previous epoch (the caller rolls the epoch back); for
        the weighted walk the remainder past position 0 is converted
        at the equal-dealing rate — exact for ``num_replicas == 1``
        and an approximation that errs on the replay-not-skip side
        only across an epoch rollover."""
        if self._weights is None:
            return completed - owned * self.num_replicas
        pattern = self._deal_pattern()
        W = len(pattern)
        c = completed
        while owned > 0 and c > 0:
            c -= 1
            if pattern[c % W] == self.rank:
                owned -= 1
        return c - owned * self.num_replicas

    def __len__(self) -> int:
        indices_left = max(0, self._epoch_total() - self.completed_num)
        if self._weights is not None:
            # owned positions among the remaining global ones
            pattern = self._deal_pattern()
            W = len(pattern)
            start = self.completed_num
            pos = (np.arange(indices_left) + start) % W
            return int((pattern[pos] == self.rank).sum())
        return indices_left // self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_num = 0

    # -- checkpoint ----------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "completed_num": self.completed_num,
        }

    def load_state_dict(self, state: Dict):
        self.epoch = state.get("epoch", 0)
        self.completed_num = state.get("completed_num", 0)
        # clamp: a smaller dataset or changed padding must not overflow
        total = self._epoch_total()
        if self.completed_num >= total:
            self.completed_num = 0
            self.epoch += 1
