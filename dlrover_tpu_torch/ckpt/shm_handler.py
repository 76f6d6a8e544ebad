"""Shared-memory staging area for one checkpoint shard (a copy of
``dlrover_tpu/ckpt/shm_handler.py``; names, metadata and layout are the
JAX package's).

Added for the card: ``host_tensor`` maps the segment as a uint8 CPU
tensor, ``register_for_device`` pins it with ``cudaHostRegister`` so a
device-to-host copy lands straight in it (and raises if the pin fails:
a copy into pageable memory would block), ``fault_chunk`` passes bytes
already in the segment through the ``ckpt.shm_stage`` fault point, and
``begin_save`` checks the free bytes of ``/dev/shm`` first (writing past
a full tmpfs kills the process with SIGBUS, not an exception).

Parity: ``SharedMemoryHandler`` ckpt_saver.py:208-339 — a tracker-free POSIX
shm segment holds the raw tensor bytes; a ``SharedDict`` (unix-socket served
by the agent) holds the metadata describing what is in the segment. The
writer protocol is crash-safe: metadata is invalidated before the bytes are
touched and re-published (with the new step) only after every buffer landed,
so a reader can never see step-N metadata over step-M bytes. (The JAX
package's seqlock generation and its serving subscriber wait for the
serving port, ROADMAP A14.)
"""

from __future__ import annotations

import os
import zlib
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedMemory,
    attach_shared_memory,
    create_shared_memory,
)
from dlrover_tpu_torch.ckpt.sharding import Index, ShardRecord

_META_DICT_PREFIX = "ckpt_meta"
_SHM_PREFIX = "dlrover_tpu_ckpt"
SHM_ROOT = "/dev/shm"  # where Linux keeps POSIX shared memory


def shm_free_bytes() -> int:
    """Free bytes of the tmpfs behind POSIX shared memory (-1 when the
    host has no ``/dev/shm`` to ask)."""
    try:
        st = os.statvfs(SHM_ROOT)
    except OSError:
        return -1
    return st.f_bavail * st.f_frsize


class ShmCrcError(ValueError):
    """A record's recomputed crc32 disagreed with the writer's checksum.

    Carries the offending record so a caller can act on the identity
    instead of parsing the message: ``record`` is the pytree path, ``index`` its
    position in the published record list, ``want``/``got`` the two
    checksums."""

    def __init__(self, record: str, index: int, want: int, got: int):
        super().__init__(
            f"shm record {record!r} (record {index}) checksum mismatch "
            f"(want {want}, got {got}): shared-memory checkpoint is "
            f"corrupt"
        )
        self.record = record
        self.index = index
        self.want = want
        self.got = got


def data_crc32(data) -> int:
    """crc32 of an array's raw bytes (any dtype/shape; one pass)."""
    arr = np.ascontiguousarray(data)
    return zlib.crc32(arr.reshape(-1).view(np.uint8))


def shard_meta_name(local_rank: int) -> str:
    return f"{_META_DICT_PREFIX}_{local_rank}"


def shard_shm_name(local_rank: int) -> str:
    job = os.getenv("DLROVER_TPU_JOB_NAME", "job")
    node = os.getenv("DLROVER_TPU_NODE_RANK", "0")
    return f"{_SHM_PREFIX}_{job}_{node}_{local_rank}"


@dataclass
class RecordMeta:
    path: str
    global_shape: Tuple[int, ...]
    dtype: str
    index: Index
    offset: int
    nbytes: int
    # crc32 of the record's bytes, computed by the WRITER before the
    # bytes enter shm: a reader (the persisting saver, or a restore's
    # shm proposal) can detect corruption that happened in flight or
    # at rest in the segment. None on writers predating checksums.
    crc32: Optional[int] = None


class ShmHandler:
    """One shm segment + one meta dict, shared by one (engine, saver) pair.

    The side that owns the unix-socket servers (the agent) passes
    ``create=True``; training processes attach as clients.
    """

    def __init__(self, local_rank: int, create: bool = False):
        self.local_rank = local_rank
        self._meta = SharedDict(shard_meta_name(local_rank), create=create)
        self._shm: Optional[SharedMemory] = None
        self._host: Optional[torch.Tensor] = None  # uint8 view of the segment
        self._registered = False

    # -- writer (training process) -------------------------------------
    def begin_save(self, nbytes: int) -> None:
        """Open an incremental write: invalidate the published metadata
        (crash-safe ordering — a reader can never see new-step metadata
        over partially written bytes) and (re)size the segment. Bytes
        then land via ``write_chunk``; ``commit_save`` publishes."""
        total = max(int(nbytes), 1)
        if self._shm is None or self._shm.size < total:
            self._drop_mapping()
            name = shard_shm_name(self.local_rank)
            old = attach_shared_memory(name)
            have = 0 if old is None else old.size
            if old is not None:
                old.close()
            free = shm_free_bytes()
            if free >= 0 and total - have > free:
                raise RuntimeError(
                    f"checkpoint shm {name!r} needs {total} bytes and "
                    f"{SHM_ROOT} has {free} free (the segment holds "
                    f"{have}): enlarge {SHM_ROOT} or checkpoint less state"
                )
            self._shm = create_shared_memory(name, total)
            if self._shm is None:
                raise RuntimeError(f"cannot allocate checkpoint shm {name!r}")
        self._meta.update({"valid": False})

    def host_tensor(self) -> torch.Tensor:
        """The open segment as a uint8 CPU tensor sharing its memory (the
        writer's side: the saver reads through numpy and never imports
        torch)."""
        import torch

        if self._host is None:
            self._host = torch.frombuffer(self._shm.buf, dtype=torch.uint8)
        return self._host

    def register_for_device(self) -> None:
        """Pin the segment for the card (``cudaHostRegister``), once per
        mapping, so copies from the device land in it without a staging
        copy. Raises if CUDA refuses: a non-blocking copy into
        memory that is not pinned would quietly block instead."""
        if self._registered:
            return
        import torch

        host = self.host_tensor()
        err = torch.cuda.cudart().cudaHostRegister(host.data_ptr(), host.numel(), 0)
        if int(err) != 0 or not host.is_pinned():
            raise RuntimeError(
                f"cudaHostRegister of the {host.numel()}-byte checkpoint shm "
                f"failed ({err}); the device-to-host copy needs pinned memory"
            )
        self._registered = True

    def _drop_mapping(self) -> None:
        """Unpin and unmap the segment (every tensor view dropped first:
        a live export keeps the mapping from closing)."""
        if self._registered:
            import torch

            torch.cuda.cudart().cudaHostUnregister(self._host.data_ptr())
            self._registered = False
        self._host = None
        if self._shm is not None:
            self._shm.close()

    def fault_chunk(self, offset: int, nbytes: int) -> None:
        """Fault point ``ckpt.shm_stage`` for bytes that reached the
        segment by another road than ``write_chunk`` (a device copy):
        applied after the writer took their checksum, as there."""
        view = np.ndarray((nbytes,), dtype=np.uint8, buffer=self._shm.buf, offset=offset)
        bad = faults.corrupt_array("ckpt.shm_stage", view)
        if bad is not view:
            view[:] = bad.view(np.uint8).reshape(-1)

    def write_chunk(self, offset: int, data: np.ndarray) -> None:
        """Copy one chunk of raw bytes into the open segment. ``data``
        is any array; its buffer lands byte-for-byte at ``offset``.

        A chunk past
        the segment end is rejected before any byte moves, so a stale
        layout can never silently scribble a neighbor's mapping.

        Fault point ``ckpt.shm_stage``: corruption is applied AFTER the
        writer computed its record checksum, so an armed bit-flip is
        detectable downstream — exactly like real in-flight rot."""
        src = np.ascontiguousarray(data)
        if offset < 0 or offset + src.nbytes > self._shm.buf.nbytes:
            raise ValueError(
                f"write_chunk out of bounds: [{offset}, "
                f"{offset + src.nbytes}) in a "
                f"{self._shm.buf.nbytes}-byte segment"
            )
        src = faults.corrupt_array("ckpt.shm_stage", src)
        view = np.ndarray(
            (src.nbytes,),
            dtype=np.uint8,
            buffer=self._shm.buf,
            offset=offset,
        )
        view[:] = src.view(np.uint8).reshape(-1)

    def commit_save(
        self, step: int, metas: List[RecordMeta], extra: Dict
    ) -> None:
        """Publish the metadata for bytes already written — the moment
        the checkpoint becomes visible to readers."""
        self._meta.update(
            {
                "step": step,
                "records": [asdict(m) for m in metas],
                "extra": extra,
                "shm_name": shard_shm_name(self.local_rank),
                "valid": True,
            }
        )

    @staticmethod
    def layout_records(records: List[ShardRecord]) -> List[RecordMeta]:
        """Assign contiguous offsets to ``records`` (data may be None —
        only dtype/index sizes are read, so a chunked writer can lay
        out the segment before any device→host copy happens)."""
        metas: List[RecordMeta] = []
        offset = 0
        for r in records:
            metas.append(
                RecordMeta(
                    path=r.path,
                    global_shape=tuple(r.global_shape),
                    dtype=r.dtype,
                    index=r.index,
                    offset=offset,
                    nbytes=r.nbytes,
                )
            )
            offset += r.nbytes
        return metas

    def save_records(
        self, step: int, records: List[ShardRecord], extra: Dict
    ) -> None:
        """One-shot write: layout + begin + every chunk + commit (the
        synchronous-drain path; the chunked stager in ckpt/engine.py
        interleaves the same primitives between train steps)."""
        metas = self.layout_records(records)
        total = metas[-1].offset + metas[-1].nbytes if metas else 1
        self.begin_save(total)
        for r, m in zip(records, metas):
            # checksum BEFORE the bytes enter shm (write_chunk is where
            # the ckpt.shm_stage fault corrupts): end-to-end integrity
            m.crc32 = data_crc32(r.data)
            self.write_chunk(m.offset, r.data)
        self.commit_save(step, metas, extra)

    # -- reader (agent saver, or engine on restore) --------------------
    def metadata(self) -> Dict:
        return self._meta.as_dict()

    def load_records(
        self, copy: bool = True, verify: bool = False
    ) -> Tuple[int, List[ShardRecord], Dict]:
        """Read back (step, records, extra); records hold *copies* of the
        bytes so the segment can be overwritten immediately after.

        ``copy=False`` returns zero-copy views into the segment — the
        caller must hold the shard lock until it has consumed them and
        must drop every record before the handler closes (a live view
        pins the mapping). The restore path uses this: its packed
        transfer makes exactly one host copy, shm → flat buffer.

        ``verify=True`` recomputes each record's crc32 against the
        writer's published checksum and raises ``ShmCrcError`` (a
        ``ValueError``) naming the offending record on the first
        mismatch — the saver uses it before persisting (corrupt shm
        must not poison storage), the restore's shm proposal uses it
        to downgrade to the storage fallback."""
        meta = self.metadata()
        if not meta.get("valid"):
            raise LookupError("no valid checkpoint in shared memory")
        needed = max(
            (m["offset"] + m["nbytes"] for m in meta["records"]), default=1
        )
        shm = self._shm
        if shm is not None and shm.size < needed:
            # the writer outgrew and recreated the segment; our cached
            # mapping points at the old unlinked one — reattach
            self._drop_mapping()
            shm = self._shm = None
        if shm is None:
            shm = attach_shared_memory(meta["shm_name"])
            if shm is None or shm.size < needed:
                raise LookupError("checkpoint shm segment missing")
            self._shm = shm
        records = []
        for i, m in enumerate(meta["records"]):
            raw = np.ndarray(
                (m["nbytes"],),
                dtype=np.uint8,
                buffer=shm.buf,
                offset=m["offset"],
            )
            if verify and m.get("crc32") is not None:
                got = zlib.crc32(raw)
                if got != m["crc32"]:
                    raise ShmCrcError(m["path"], i, m["crc32"], got)
            shape = tuple(hi - lo for lo, hi in m["index"])
            data = (raw.copy() if copy else raw).view(
                np.dtype(m["dtype"])
            ).reshape(shape)
            records.append(
                ShardRecord(
                    path=m["path"],
                    global_shape=tuple(m["global_shape"]),
                    dtype=m["dtype"],
                    index=tuple(tuple(i) for i in m["index"]),
                    data=data,
                )
            )
        return int(meta["step"]), records, meta.get("extra", {})

    def no_checkpoint(self) -> bool:
        try:
            return not self.metadata().get("valid")
        except Exception:
            return True

    def close(self, unlink: bool = False):
        if self._shm is not None:
            self._drop_mapping()
            if unlink:
                self._shm.unlink()
            self._shm = None
        self._meta.close()
        if unlink:
            logger.info(
                f"checkpoint shm shard {self.local_rank} unlinked"
            )
