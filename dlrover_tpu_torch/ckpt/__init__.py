"""Flash Checkpoint for the port (counterpart of ``dlrover_tpu/ckpt``):
state staged into shared memory beside the train step, persisted by the
saver off the critical path, restored from shm or storage.

- ``engine.py``: the training process's side (stager, save, load);
- ``saver.py``: the saver (the agent's side) and the on-disk format;
- ``shm_handler.py``: the shm segment and its metadata;
- ``sharding.py``: torch state <-> shard records;
- ``checkpointer.py``: the user facade.

The names below load on first use: the agent imports the saver alone,
and the saver's side imports no torch.
"""

import importlib

_EXPORTS = {
    "FlashCheckpointer": "checkpointer",
    "StorageType": "checkpointer",
    "CheckpointEngine": "engine",
    "AsyncCheckpointSaver": "saver",
    "gc_checkpoints": "saver",
    "quarantine_step_dir": "saver",
    "resolve_verified_step": "saver",
    "verify_step_dir": "saver",
    "ShmCrcError": "shm_handler",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
