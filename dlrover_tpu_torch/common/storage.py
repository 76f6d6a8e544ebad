"""Checkpoint storage abstraction + POSIX impl + deletion strategies (a
copy of ``dlrover_tpu/common/storage.py``: the on-disk format and the
atomic, durable write protocol are the JAX package's, so either
package reads the other's checkpoints).

Parity: dlrover/python/common/storage.py:23,127,202. The writer side stays
byte-oriented (the flash-ckpt saver hands us raw shm slices), so the same
interface backs POSIX disk, and later GCS via a fuse mount.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import zlib
from abc import ABC, abstractmethod
from typing import Any, Callable, List, Optional, Tuple

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


def durable_replace(path: str, write_fn: Callable, mode: str = "w") -> str:
    """Atomic AND durable publish: ``write_fn(f)`` writes the payload to
    a pid+thread-unique tmp file, which is flushed, fsynced, and
    ``os.replace``d onto ``path``. The rename being the commit point
    only helps if the bytes reached the platter first — use this for
    anything a reader treats as committed state."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # the file's bytes being durable means nothing if the rename's
        # directory entry isn't
        fsync_dir(os.path.dirname(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


class CheckpointDeletionStrategy(ABC):
    @abstractmethod
    def clean_up(self, step: int, delete_func):
        """Given a newly-committed step, remove stale checkpoint dirs."""


class KeepLatestStepStrategy(CheckpointDeletionStrategy):
    """Keep only the newest ``max_to_keep`` step dirs.

    Parity: storage.py KeepLatestStepStrategy.
    """

    def __init__(self, max_to_keep: int = 1, checkpoint_dir: str = ""):
        self._max_to_keep = max(1, max_to_keep)
        self._checkpoint_dir = checkpoint_dir
        self._steps: List[int] = []

    def clean_up(self, step: int, delete_func):
        if step in self._steps:
            return
        self._steps.append(step)
        self._steps.sort()
        while len(self._steps) > self._max_to_keep:
            stale = self._steps.pop(0)
            path = os.path.join(self._checkpoint_dir, str(stale))
            try:
                delete_func(path)
            except Exception as e:
                logger.warning(f"fail to clean ckpt {path}: {e!r}")


class KeepStepIntervalStrategy(CheckpointDeletionStrategy):
    """Keep steps that are multiples of ``keep_interval``; drop the rest.

    Parity: storage.py:202 KeepStepIntervalStrategy.
    """

    def __init__(self, keep_interval: int, checkpoint_dir: str = ""):
        self._keep_interval = max(1, keep_interval)
        self._checkpoint_dir = checkpoint_dir

    def clean_up(self, step: int, delete_func):
        if step % self._keep_interval == 0:
            return
        path = os.path.join(self._checkpoint_dir, str(step))
        try:
            delete_func(path)
        except Exception as e:
            logger.warning(f"fail to clean ckpt {path}: {e!r}")


class CheckpointStorage(ABC):
    """Byte/object storage seam used by the flash-checkpoint saver."""

    @abstractmethod
    def write(self, content: bytes | str, path: str):
        """Write ``content`` to ``path`` **atomically**: readers must never
        observe a partial file (the commit protocol publishes tracker files
        through this)."""
        ...

    @abstractmethod
    def write_state_dict(self, state_dict: Any, path: str):
        ...

    @abstractmethod
    def read(self, path: str) -> Optional[bytes]:
        ...

    @abstractmethod
    def read_state_dict(self, path: str) -> Any:
        ...

    @abstractmethod
    def safe_rmtree(self, dir_path: str):
        ...

    @abstractmethod
    def safe_remove(self, path: str):
        ...

    @abstractmethod
    def safe_makedirs(self, dir_path: str):
        ...

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str) -> List[str]:
        ...

    def rename(self, src: str, dst: str):
        """Atomic move within the store (quarantining corrupt step dirs).
        Backends without rename semantics may leave this unimplemented —
        callers fall back to deletion."""
        raise NotImplementedError

    def size(self, path: str) -> Optional[int]:
        """Byte length of ``path``; None when absent. Default reads the
        object — backends with cheap metadata should override (shallow
        checkpoint verification leans on this to avoid full reads)."""
        data = self.read(path)
        return None if data is None else len(data)

    def write_pickle(self, obj: Any, path: str) -> Tuple[int, int]:
        """``obj`` pickled into ``path`` (atomically, as ``write``);
        returns the bytes' crc32 and length. Default pickles in memory —
        a backend that can stream should override (a 7 B shard is ~41
        GB)."""
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self.write(blob, path)
        return zlib.crc32(blob), len(blob)

    def file_crc32(self, path: str) -> Optional[Tuple[int, int]]:
        """crc32 and length of ``path``; None when absent. Default reads
        the object whole — a backend that can read in chunks should
        override."""
        data = self.read(path)
        return None if data is None else (zlib.crc32(data), len(data))

    def commit(self, step: int, success: bool):
        """Hook run after a step is fully persisted."""


class _CrcWriter:
    """A file's ``write`` that folds the crc32 and length of what
    passes."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, data) -> int:
        m = memoryview(data)
        self.crc = zlib.crc32(m, self.crc)
        self.nbytes += m.nbytes
        return self._f.write(m)


class PosixDiskStorage(CheckpointStorage):
    """Local/NFS/FUSE-mounted filesystem storage (parity: storage.py:127).

    Writes are atomic: tmp file in the target dir + ``os.replace``.
    """

    def __init__(self, deletion_strategy: Optional[CheckpointDeletionStrategy] = None):
        self._deletion_strategy = deletion_strategy

    def write(self, content: bytes | str, path: str):
        mode = "wb" if isinstance(content, bytes) else "w"
        self.safe_makedirs(os.path.dirname(path))
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        try:
            with os.fdopen(fd, mode) as f:
                f.write(content)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(os.path.dirname(path))
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def write_state_dict(self, state_dict: Any, path: str):
        self.write(pickle.dumps(state_dict, protocol=pickle.HIGHEST_PROTOCOL), path)

    def write_pickle(self, obj: Any, path: str) -> Tuple[int, int]:
        """``obj`` pickled straight into ``path`` (atomically, as
        ``write``), never whole in memory: the pickler hands an array's
        buffer to the file as it is, so a shard of views into shm is
        written with no host copy. The bytes are ``pickle.dumps``'s.
        Returns their crc32 and length."""
        self.safe_makedirs(os.path.dirname(path))
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                out = _CrcWriter(f)
                pickle.dump(obj, out, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(os.path.dirname(path))
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return out.crc, out.nbytes

    def file_crc32(self, path: str, chunk_bytes: int = 64 << 20) -> Optional[Tuple[int, int]]:
        """crc32 and length of ``path`` read in chunks (None when it is
        absent): a shard is verified without holding it in memory."""
        try:
            f = open(path, "rb", buffering=0)
        except OSError:
            return None
        crc, n = 0, 0
        buf = bytearray(chunk_bytes)
        view = memoryview(buf)
        with f:
            while True:
                got = f.readinto(view)
                if not got:
                    break
                crc = zlib.crc32(view[:got], crc)
                n += got
        return crc, n

    def read(self, path: str) -> Optional[bytes]:
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def read_state_dict(self, path: str) -> Any:
        data = self.read(path)
        return pickle.loads(data) if data is not None else None

    def safe_rmtree(self, dir_path: str):
        shutil.rmtree(dir_path, ignore_errors=True)

    def safe_remove(self, path: str):
        try:
            os.remove(path)
        except OSError:
            pass

    def safe_makedirs(self, dir_path: str):
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(path))
        except OSError:
            return []

    def rename(self, src: str, dst: str):
        os.rename(src, dst)

    def size(self, path: str) -> Optional[int]:
        try:
            return os.path.getsize(path)
        except OSError:
            return None

    def commit(self, step: int, success: bool):
        if success and self._deletion_strategy is not None:
            self._deletion_strategy.clean_up(step, self.safe_rmtree)
