"""Storage helpers for the port (own copy of what it needs of
``dlrover_tpu/common/storage.py``: ``fsync_dir``)."""

from __future__ import annotations

import os

from dlrover_tpu_torch.common.log import default_logger as logger

_FSYNC_DIR_WARNED: set = set()


def fsync_dir(dirname: str) -> None:
    """fsync a directory, making the renames/creates inside it durable
    — a renamed file whose directory entry is still only in the page
    cache when the host dies rolls back to the previous generation.

    Best-effort: some filesystems reject directory fsync (EINVAL/
    ENOTSUP on 9p, vboxsf, object-store FUSE mounts). By the time this
    runs the rename has already committed, so failing the save here
    would turn a durability *upgrade* into a crash on mounts where the
    plain rename used to work — warn once per directory instead (the
    file's own fsync already happened, so real I/O errors surfaced
    there)."""
    dirname = dirname or "."
    try:
        dfd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError as e:
        if dirname not in _FSYNC_DIR_WARNED:
            _FSYNC_DIR_WARNED.add(dirname)
            logger.warning(
                f"directory fsync unsupported on {dirname!r} ({e!r}): "
                "renames there are atomic but their durability rides "
                "on the filesystem's own metadata ordering"
            )
