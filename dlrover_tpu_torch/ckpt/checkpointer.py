"""User-facing Flash Checkpoint API (counterpart of
``dlrover_tpu/ckpt/checkpointer.py``).

Usage::

    ckptr = FlashCheckpointer("/ckpt/run1")
    ckptr.save_checkpoint(step, state)                    # shm, ms
    ckptr.save_checkpoint(step, state, StorageType.DISK)  # ensure persisted
    step, state = ckptr.load_checkpoint(target=state)

``state`` is a dict (nested or flat) of tensors and host values; a load
fills ``target``'s tensors in place.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Optional, Tuple

from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
from dlrover_tpu_torch.common.storage import CheckpointStorage


class StorageType(Enum):
    MEMORY = 0
    DISK = 1


class FlashCheckpointer:
    def __init__(
        self,
        checkpoint_dir: str,
        storage: Optional[CheckpointStorage] = None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.engine = CheckpointEngine(storage=storage)

    def save_checkpoint(
        self,
        step: int,
        state: Any,
        storage_type: StorageType = StorageType.MEMORY,
        timeout: float = 600.0,
    ) -> bool:
        """``timeout`` bounds how long a DISK save waits for the global
        commit (all nodes' shards); returns False on expiry."""
        if storage_type == StorageType.DISK:
            return self.engine.save_to_storage(
                step, state, self.checkpoint_dir, timeout=timeout
            )
        return self.engine.save_to_memory(step, state, self.checkpoint_dir)

    def begin_chunked_save(
        self, step: int, state: Any, chunk_bytes: int = 64 << 20,
        priority=None,
    ):
        """Start a save that runs beside the next steps: the returned
        stager's ``advance(budget_s)`` runs between train steps and
        ``commit()`` is the barrier. None = skipped (saver busy). See
        ``CheckpointEngine.begin_chunked_save`` (``priority`` = the
        host-link arbitration class)."""
        return self.engine.begin_chunked_save(
            step, state, self.checkpoint_dir, chunk_bytes=chunk_bytes,
            priority=priority,
        )

    def staging_in_flight(self) -> bool:
        """True while any staging is uncommitted."""
        return self.engine.staging_in_flight()

    def latest_verified_step(self) -> int:
        """Newest committed step whose shards pass integrity
        verification (crc32 + completeness); -1 when none does. A
        corrupt newest step is quarantined and the tracker rolled back
        (only on global shard 0)."""
        return self.engine.latest_verified_step(self.checkpoint_dir)

    def load_checkpoint(self, target: Any) -> Tuple[int, Optional[Any]]:
        """Returns ``(step, state)``; ``(-1, None)`` when no checkpoint
        exists yet. The restored step is the newest *verified* one."""
        return self.engine.load(target, self.checkpoint_dir)
