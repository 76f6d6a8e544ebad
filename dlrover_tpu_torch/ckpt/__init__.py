"""Flash Checkpoint for the port (counterpart of ``dlrover_tpu/ckpt``):
state staged into shared memory beside the train step, persisted by the
saver off the critical path, restored from shm or storage.

- ``engine.py``: the training process's side (stager, save, load);
- ``saver.py``: the saver (the agent's side) and the on-disk format;
- ``shm_handler.py``: the shm segment and its metadata;
- ``sharding.py``: torch state <-> shard records;
- ``checkpointer.py``: the user facade.
"""

from dlrover_tpu_torch.ckpt.checkpointer import (  # noqa: F401
    FlashCheckpointer,
    StorageType,
)
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine  # noqa: F401
from dlrover_tpu_torch.ckpt.saver import (  # noqa: F401
    AsyncCheckpointSaver,
    gc_checkpoints,
    quarantine_step_dir,
    resolve_verified_step,
    verify_step_dir,
)
from dlrover_tpu_torch.ckpt.shm_handler import ShmCrcError  # noqa: F401
