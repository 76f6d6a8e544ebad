"""Runtime parallel-config service: master-tuned dataloader/optimizer and
mesh knobs delivered to agents.

Parity: the ParallelConfig plumbing in dlrover/python/master/servicer.py +
hyperparams/simple_strategy_generator.py:179 — the master suggests initial
dataloader/optimizer configs from runtime stats and can retune them; the
agent's ParalConfigTuner polls and writes them to a JSON file the
ElasticDataLoader re-reads.
"""

from __future__ import annotations

import threading
from typing import Dict

from dlrover_tpu_torch.common import comm


class ParalConfigService:
    def __init__(self):
        self._lock = threading.Lock()
        self._global_config = comm.ParallelConfig()
        self._node_configs: Dict[int, comm.ParallelConfig] = {}

    def get_config(self, node_id: int) -> comm.ParallelConfig:
        with self._lock:
            return self._node_configs.get(node_id, self._global_config)

    def set_global_config(self, config: comm.ParallelConfig):
        with self._lock:
            config.dataloader.version = (
                self._global_config.dataloader.version + 1
            )
            # the scale prediction rides every config: a retune must not
            # wipe the standing candidates (they come from the scaler's
            # own channel, set_candidate_worker_counts)
            if not config.candidate_worker_counts:
                config.candidate_worker_counts = list(
                    self._global_config.candidate_worker_counts
                )
            self._global_config = config

    def set_candidate_worker_counts(self, counts) -> bool:
        """Publish the auto-scaler's top-k predicted next worker counts
        (most likely first). Bumps the config version only on change so
        the agents' ParalConfigTuner rewrites its file exactly when the
        prediction moves. Returns True when the prediction changed."""
        counts = [int(c) for c in counts if c > 0]
        with self._lock:
            if counts == self._global_config.candidate_worker_counts:
                return False
            self._global_config.candidate_worker_counts = counts
            self._global_config.dataloader.version += 1
        return True

    def suggest_initial_config(
        self,
        batch_size: int,
        num_workers: int = 0,
        node_cpu: float = 0.0,
        node_memory_mb: int = 0,
        used_memory_mb: int = 0,
    ) -> comm.ParallelConfig:
        """Initial dataloader/optimizer suggestion from node resources
        (parity: SimpleStrategyGenerator simple_strategy_generator.py:179
        — dataloader workers from CPU, batch size bounded by memory
        headroom, LR scaled with the global batch).

        With no resource information the caller's values pass through.
        """
        config = comm.ParallelConfig()
        if num_workers <= 0 and node_cpu > 0:
            # the reference reserves ~half the cores for the training
            # proc; IO workers get the rest, at least 2
            num_workers = max(2, int(node_cpu // 2))
        requested = batch_size
        if node_memory_mb and used_memory_mb:
            # batch scales with free memory headroom, capped at 4x the
            # requested batch (runaway suggestions churn the dataloader)
            headroom = max(
                1.0, (node_memory_mb - used_memory_mb) / max(used_memory_mb, 1)
            )
            batch_size = min(int(batch_size * headroom), batch_size * 4)
        config.dataloader.batch_size = batch_size
        config.dataloader.num_workers = num_workers
        # linear-scaling rule: LR multiplier tracking the batch growth
        config.optimizer.batch_size_factor = batch_size / max(requested, 1)
        self.set_global_config(config)
        return config
