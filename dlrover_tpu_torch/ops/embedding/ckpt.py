"""Incremental embedding checkpoints: full snapshots + version deltas,
crc-verified with rollback, and a chunked budgeted stager (counterpart
of ``dlrover_tpu/ops/embedding/ckpt.py``; the same files and manifest,
so a chain written by either package restores in the other).

Parity: TFPlus's incremental checkpoint manager
(tfplus/kv_variable/python/training/checkpoint_manager.py:333) built on
KvVariable FullOrDeltaExport — recommender embedding tables are huge but
churn slowly, so persisting only rows touched since the last save cuts
checkpoint cost by orders of magnitude. Here the native store's
per-row mutation versions drive it: a full snapshot every
``full_every`` saves, deltas (rows with version > last saved version,
per shard) in between; restore = latest full + deltas in order (delta
rows carry full values+slots, so import order is the only invariant).

Integrity (the dense checkpoint's shard rules applied to embeddings):

- every file's whole-blob crc32 + nbytes land in the manifest, computed
  by the WRITER before the bytes can be corrupted in flight (the
  ``embedding.export`` fault site corrupts after);
- ``restore`` verifies each chain file (``embedding.import`` fault
  site on the read leg); a corrupt file is quarantined to
  ``*.corrupt`` and the restore rolls back — a bad delta truncates the
  chain at the last good prefix (an earlier consistent state), a bad
  full falls back to the previous full chain. A torn export can no
  longer restore silently;
- ``begin_chunked_save`` returns an :class:`EmbeddingDeltaStager`
  mirroring the dense ``ChunkedStager`` surface: the delta export is
  snapshotted up front, then ``advance(budget_s)`` writes fixed-size
  chunks between train steps (bounded critical-path cost, incremental
  crc folded chunk-by-chunk so the published crc equals the whole-blob
  crc), and ``commit()`` is the only barrier — it publishes the
  manifest entry, so a crash mid-drain leaves the previous chain
  intact and restorable.

Over a tiered store the delta's cold rows follow the same rule as the
version cursor: the tier's cold cursor moves only when the delta that
carried its rows is published (``publish_delta_export``), so an aborted
stager leaves both where they were. (The reference's tiers move theirs
at the export.)
"""

from __future__ import annotations

import io
import json
import os
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.storage import durable_replace, fsync_dir
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ops.embedding.store import ShardedKvEmbedding
from dlrover_tpu_torch.parallel import wire_format as wire_fmt

_DEF_CHUNK_BYTES = 4 << 20

# npz key prefixes carrying the int8 wire's sidecar data: per-chunk
# scales and the original dtype of each quantized array
_WIRE_SCALES = "__wire_scales__"
_WIRE_DTYPE = "__wire_dtype__"


def _serialize_state(step: int, state: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, step=np.int64(step), **state)
    return buf.getvalue()


def _encode_wire(state: Dict[str, np.ndarray], wire: str):
    """Apply the opt-in wire format to an export. Returns
    ``(wire_state, decoded_crc32)`` — the crc is the digest of what a
    reader will hold AFTER decoding (``wire_format.decoded_crc32``), so
    restore gates bitwise on the decoded payload even though the int8
    wire itself is lossy. ``("none")`` passes through with no crc (the
    whole-blob crc already covers a bitwise file)."""
    if wire != "int8":
        return state, None
    out: Dict[str, np.ndarray] = {}
    decoded: Dict[str, np.ndarray] = {}
    for k, v in state.items():
        arr = np.asarray(v)
        if wire_fmt.quantizable(arr):
            q, scales = wire_fmt.encode_int8(arr)
            out[k] = q
            out[_WIRE_SCALES + k] = scales
            out[_WIRE_DTYPE + k] = np.array(arr.dtype.str)
            decoded[k] = wire_fmt.decode_int8(q, scales, arr.dtype)
        else:
            # ints/bools (keys, versions) stay bitwise on the wire
            out[k] = arr
            decoded[k] = arr
    return out, wire_fmt.decoded_crc32(decoded)


def _decode_wire(data: Dict[str, np.ndarray]):
    """Inverse of :func:`_encode_wire` on a loaded npz dict. Returns
    ``(state, decoded_crc32)``; the crc is None when the file carries
    no wire sidecar keys (a bitwise checkpoint). ``step`` is excluded
    from the digest — the writer computed it over the export alone."""
    if not any(k.startswith(_WIRE_SCALES) for k in data):
        return data, None
    out: Dict[str, np.ndarray] = {}
    for k, v in data.items():
        if k.startswith(_WIRE_SCALES) or k.startswith(_WIRE_DTYPE):
            continue
        if _WIRE_SCALES + k in data:
            out[k] = wire_fmt.decode_int8(
                v,
                data[_WIRE_SCALES + k],
                np.dtype(str(data[_WIRE_DTYPE + k])),
            )
        else:
            out[k] = v
    crc = wire_fmt.decoded_crc32(
        {k: v for k, v in out.items() if k != "step"}
    )
    return out, crc


class EmbeddingDeltaStager:
    """Budgeted chunked writer of one (already exported) checkpoint.

    The export snapshot happens at construction — the delta is a
    consistent point-in-time view however long the drain takes. Until
    ``commit()`` publishes the manifest entry the file is a ``.staging``
    temp invisible to restore (the ChunkedStager crash-safe ordering).
    """

    def __init__(
        self,
        manager: "IncrementalCheckpointManager",
        step: int,
        kind: str,
        name: str,
        blob: bytes,
        chunk_bytes: int = _DEF_CHUNK_BYTES,
    ):
        self._manager = manager
        self.step = step
        self.kind = kind
        self.name = name
        self._blob = blob
        self._chunk_bytes = max(int(chunk_bytes), 1 << 10)
        self.total_bytes = len(blob)
        self._offset = 0
        self._crc = 0
        self.chunks_written = 0
        self._finished = False
        self._failed = False
        self._tmp = os.path.join(
            manager._dir, f"{name}.staging.{os.getpid()}"
        )
        self._f = open(self._tmp, "wb")

    @property
    def backlog_bytes(self) -> int:
        return self.total_bytes - self._offset

    @property
    def done(self) -> bool:
        return self._offset >= self.total_bytes

    @property
    def finished(self) -> bool:
        return self._finished

    def advance(self, budget_s: Optional[float] = None) -> int:
        """Write chunks until ``budget_s`` of wall time is spent (None
        = drain everything). Bounded overshoot: at most one chunk past
        the budget. Returns bytes written by this call."""
        if self._finished:
            return 0
        t0 = time.perf_counter()
        written = 0
        try:
            while not self.done:
                chunk = self._blob[
                    self._offset : self._offset + self._chunk_bytes
                ]
                # fold BEFORE the fault site corrupts: the published
                # crc is the writer's truth, a torn chunk is detected
                self._crc = zlib.crc32(chunk, self._crc)
                self._offset += len(chunk)
                corrupted = faults.corrupt("embedding.export", chunk)
                self._f.write(corrupted)
                written += len(chunk)
                self.chunks_written += 1
                if (
                    budget_s is not None
                    and time.perf_counter() - t0 >= budget_s
                ):
                    break
        except BaseException:
            self.abort()
            raise
        return written

    def commit(self) -> str:
        """Drain the backlog, fsync-rename the file into place, publish
        the manifest entry. Returns the final path."""
        if self._finished:
            return os.path.join(self._manager._dir, self.name)
        try:
            self.advance(budget_s=None)
            self._f.flush()
            os.fsync(self._f.fileno())  # post-commit means DURABLE
            self._f.close()
            path = os.path.join(self._manager._dir, self.name)
            os.replace(self._tmp, path)
            # post-commit means DURABLE for the rename too: the dir
            # entry must survive the crash, not just the bytes
            fsync_dir(self._manager._dir)
        except BaseException:
            self.abort()
            raise
        self._finished = True
        self._manager._publish(
            self.step, self.kind, self.name, self._crc,
            self.total_bytes, getattr(self, "rows", None),
            wire=getattr(self, "wire", "none"),
            decoded_crc32=getattr(self, "decoded_crc32", None),
        )
        self._blob = b""
        return path

    def abort(self):
        if self._finished:
            return
        self._finished = True
        self._failed = True
        self._blob = b""
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.remove(self._tmp)
        except OSError:
            pass
        self._manager._staging_aborted(self)


class IncrementalCheckpointManager:
    def __init__(
        self,
        store: ShardedKvEmbedding,
        directory: str,
        full_every: int = 10,
        keep_history: int = 2,
        wire_format: str = "none",
    ):
        if wire_format not in wire_fmt.WIRE_FORMATS:
            raise ValueError(
                f"unknown wire_format {wire_format!r}; "
                f"one of {wire_fmt.WIRE_FORMATS}"
            )
        self._store = store
        self._dir = directory
        # opt-in int8 wire for the slow-rail bulk leg: float arrays are
        # quantized per chunk in the npz; the manifest then carries the
        # decoded-payload crc32 and restore gates on it (the whole-blob
        # crc keeps covering the wire bytes themselves)
        self._wire_format = wire_format
        self._full_every = max(1, full_every)
        self._keep_history = max(1, keep_history)
        # per-shard version at the last save; len mismatch (resharded
        # store) forces the next save to be full
        self._last_versions: List[int] = []
        # version snapshot taken when a chunked save exported (becomes
        # _last_versions only at publish — an aborted stager must not
        # swallow its rows from the next delta)
        self._pending_versions: Optional[List[int]] = None
        # deltas written since this manager's last full (None = none yet)
        self._saves_since_full: Optional[int] = None
        # at most ONE stager in flight: a second would reuse the same
        # file index (it only advances at publish) and clobber the
        # pending version cursor
        self._active_stager: Optional[EmbeddingDeltaStager] = None
        os.makedirs(directory, exist_ok=True)
        # file indices must be unique against whatever already lives in
        # the directory (restore trims the manifest; len(entries) would
        # collide with surviving higher-numbered files and a later GC
        # would delete a live checkpoint)
        self._save_count = self._next_index()

    def _next_index(self) -> int:
        indices = [
            int(e["file"].rsplit("_", 1)[1].split(".")[0])
            for e in self._read_manifest()
        ]
        return max(indices) + 1 if indices else 0

    # -- manifest -------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self._dir, "manifest.json")

    def _read_manifest(self) -> List[dict]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return []

    def _write_manifest(self, entries: List[dict]):
        durable_replace(
            self._manifest_path(), lambda f: json.dump(entries, f)
        )

    # -- save -----------------------------------------------------------
    def _next_save_kind(self) -> str:
        shards = self._store.shards
        force_full = (
            self._saves_since_full is None
            or self._saves_since_full >= self._full_every
            or len(self._last_versions) != len(shards)
        )
        return "full" if force_full else "delta"

    def _export(self, kind: str) -> Dict[str, np.ndarray]:
        return self._store.export_state(
            since_versions=None
            if kind == "full"
            else self._last_versions
        )

    def save(self, step: int = 0) -> str:
        """Write one checkpoint synchronously; returns the file path.
        Full when due (cadence, first save, or the store was
        resharded), else delta."""
        stager = self.begin_chunked_save(step)
        return stager.commit()

    def begin_chunked_save(
        self, step: int = 0, chunk_bytes: int = _DEF_CHUNK_BYTES
    ) -> EmbeddingDeltaStager:
        """Snapshot the export now, drain it in budgeted chunks later:
        the trainer calls ``advance(budget_s)`` once per step and
        ``commit()`` at checkpoint cadence. Dirty-row deltas ride the
        same versions machinery as :meth:`save`."""
        if (
            self._active_stager is not None
            and not self._active_stager.finished
        ):
            raise RuntimeError(
                "a chunked embedding save is already in flight — "
                "commit() or abort() it before beginning another "
                "(both would target the same file index)"
            )
        kind = self._next_save_kind()
        state = self._export(kind)
        rows = len(state["keys"])
        name = f"{kind}_{self._save_count:06d}.npz"
        wire_state, decoded_crc = _encode_wire(
            state, self._wire_format
        )
        blob = _serialize_state(step, wire_state)
        self._pending_versions = self._store.shard_versions()
        stager = EmbeddingDeltaStager(
            self, step, kind, name, blob, chunk_bytes=chunk_bytes
        )
        stager.rows = rows
        stager.wire = self._wire_format
        stager.decoded_crc32 = decoded_crc
        self._active_stager = stager
        return stager

    def _publish(
        self,
        step: int,
        kind: str,
        name: str,
        crc: int,
        nbytes: int,
        rows: Optional[int] = None,
        wire: str = "none",
        decoded_crc32: Optional[int] = None,
    ):
        entries = self._read_manifest()
        entry = {
            "file": name,
            "kind": kind,
            "step": step,
            "rows": rows,
            "crc32": crc,
            "nbytes": nbytes,
        }
        if wire != "none":
            entry["wire"] = wire
            entry["decoded_crc32"] = decoded_crc32
        entries.append(entry)
        self._write_manifest(entries)
        self._last_versions = (
            self._pending_versions
            if self._pending_versions is not None
            else self._store.shard_versions()
        )
        self._pending_versions = None
        if kind == "delta":
            # a tiered store's cold rows of this delta are now on disk
            publish = getattr(self._store, "publish_delta_export", None)
            if publish is not None:
                publish()
        self._active_stager = None
        self._save_count += 1
        self._saves_since_full = (
            0
            if kind == "full"
            else (self._saves_since_full or 0) + 1
        )
        logger.info(
            f"embedding ckpt {name}: {nbytes} bytes ({kind}, "
            f"crc {crc:08x})"
        )
        self._gc(entries)

    def _staging_aborted(self, stager: EmbeddingDeltaStager):
        # the exported rows were NOT published: the next delta must
        # still carry them, so the version cursor does not advance.
        # Guarded on identity so a stale stager's late abort cannot
        # clobber a newer save's pending cursor
        if self._active_stager is stager:
            self._pending_versions = None
            self._active_stager = None

    def _gc(self, entries: List[dict]):
        """Keep the last ``keep_history`` full chains; drop older files."""
        full_idx = [
            i for i, e in enumerate(entries) if e["kind"] == "full"
        ]
        if len(full_idx) <= self._keep_history:
            return
        cut = full_idx[-self._keep_history]
        dead, live = entries[:cut], entries[cut:]
        for e in dead:
            try:
                os.remove(os.path.join(self._dir, e["file"]))
            except OSError:
                pass
        self._write_manifest(live)

    # -- restore --------------------------------------------------------
    def _load_entry(self, e: dict) -> Dict[str, np.ndarray]:
        """Read + verify one chain file; raises ValueError on any
        corruption (length, crc, unreadable zip)."""
        path = os.path.join(self._dir, e["file"])
        faults.fire("embedding.import")
        with open(path, "rb") as f:
            blob = f.read()
        if "crc32" in e:
            if len(blob) != e.get("nbytes", len(blob)) or (
                zlib.crc32(blob) != e["crc32"]
            ):
                raise ValueError(
                    f"embedding ckpt {e['file']} fails crc/length "
                    f"verification"
                )
        try:
            data = dict(np.load(io.BytesIO(blob)))
        except Exception as err:
            raise ValueError(
                f"embedding ckpt {e['file']} unreadable: {err!r}"
            )
        state, dec_crc = _decode_wire(data)
        if e.get("wire") == "int8":
            # the decoded payload is what the store will import: gate
            # on ITS digest, not just the wire bytes'
            if dec_crc is None or dec_crc != e.get("decoded_crc32"):
                raise ValueError(
                    f"embedding ckpt {e['file']} fails decoded-payload "
                    f"crc verification"
                )
        return state

    def _quarantine(self, e: dict):
        path = os.path.join(self._dir, e["file"])
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        logger.error(
            f"embedding ckpt {e['file']} quarantined (corrupt)"
        )

    def restore(self) -> Optional[int]:
        """Latest VERIFIED full + subsequent verified deltas, in order.

        Corruption rolls back instead of restoring silently: a corrupt
        delta truncates the chain at the last good prefix (an earlier
        consistent state); a corrupt full drops the whole chain and the
        previous full chain is tried. Quarantined files are renamed
        ``*.corrupt`` and trimmed from the manifest. Returns the last
        restored training step, or None when nothing verifiable
        remains."""
        entries = self._read_manifest()
        while True:
            full_idx = [
                i for i, e in enumerate(entries) if e["kind"] == "full"
            ]
            if not full_idx:
                return None
            chain = entries[full_idx[-1] :]
            loaded = []
            bad_at: Optional[int] = None
            for j, e in enumerate(chain):
                try:
                    loaded.append((e, self._load_entry(e)))
                except ValueError as err:
                    logger.error(str(err))
                    self._quarantine(e)
                    bad_at = j
                    break
            if bad_at == 0:
                # the full itself is bad: drop this chain entirely and
                # fall back to the previous full chain
                entries = entries[: full_idx[-1]]
                self._write_manifest(entries)
                continue
            if bad_at is not None:
                # truncate at the last good prefix; later files (even
                # if healthy) can't apply over the missing delta
                entries = entries[: full_idx[-1] + bad_at]
                self._write_manifest(entries)
                chain = chain[:bad_at]
            step = 0
            for e, data in loaded:
                step = int(data.pop("step", 0))
                self._store.import_state(data)
            logger.info(
                f"restored embedding from {len(loaded)} files "
                f"(1 full + {len(loaded) - 1} deltas), step {step}"
                + (" [rolled back past corruption]" if bad_at else "")
            )
            # future deltas must be relative to what is now in the
            # store; the restored chain counts as a fresh full for
            # cadence purposes
            self._last_versions = self._store.shard_versions()
            self._save_count = self._next_index()
            self._saves_since_full = len(loaded) - 1
            return step
