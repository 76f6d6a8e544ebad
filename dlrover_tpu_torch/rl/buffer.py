"""Experience replay buffer for PPO (a copy of
``dlrover_tpu/rl/buffer.py``).

Parity: atorch/rl/replay_buffer (host-side batch store between rollout
and train phases). Numpy-backed: rollouts land as host arrays, and each
minibatch moves to the trainer's device per optimizer step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


@dataclass
class Experience:
    tokens: np.ndarray  # [B, P+N]
    logprobs: np.ndarray  # [B, N] actor logprobs at rollout time
    ref_logprobs: np.ndarray  # [B, N]
    values: np.ndarray  # [B, N] critic values at rollout time
    rewards: np.ndarray  # [B, N] per-token (KL-shaped) rewards
    advantages: np.ndarray  # [B, N]
    returns: np.ndarray  # [B, N]


class ReplayBuffer:
    def __init__(self, capacity: int = 0):
        self._items: List[Experience] = []
        self._capacity = capacity

    def add(self, exp: Experience):
        self._items.append(exp)
        if self._capacity and len(self._items) > self._capacity:
            self._items.pop(0)

    def __len__(self) -> int:
        return sum(len(e.tokens) for e in self._items)

    def clear(self):
        self._items.clear()

    def _stacked(self) -> Dict[str, np.ndarray]:
        fields = (
            "tokens", "logprobs", "ref_logprobs", "values", "rewards",
            "advantages", "returns",
        )
        return {
            f: np.concatenate([getattr(e, f) for e in self._items])
            for f in fields
        }

    def minibatches(
        self, batch_size: int, rng: np.random.Generator
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled minibatches over everything stored (one PPO epoch).
        The final partial batch is yielded too — silently dropping it
        would make train() a no-op whenever n < batch_size."""
        data = self._stacked()
        n = len(data["tokens"])
        order = rng.permutation(n)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            yield {k: v[idx] for k, v in data.items()}
