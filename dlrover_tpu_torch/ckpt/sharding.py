"""Torch state <-> host-memory shard records (counterpart of
``dlrover_tpu/ckpt/sharding.py``).

A state is a dict, nested or flat, whose leaves are tensors (on one
device), runs of a bigger leaf (``BlockLeaf``: a ZeRO shard, recorded
as blocks of the leaf's own shape) or host values (Python numbers,
numpy arrays). Its record paths
are the ``/``-joined key paths with keys sorted, as JAX flattens a dict
pytree, so a checkpoint reads the same way in both packages. On one
device every leaf is one record with its full index
``((0, d0), (0, d1), ...)``; the index and ``assemble_leaf`` keep the
JAX package's format, in which a leaf may also arrive as several
blocks from a sharded writer.

``restore_state`` copies into the target's existing tensors (a
non-blocking ``copy_`` from pinned memory for CUDA tensors), so an
optimizer bound to the parameters and its moment buffers stays bound.

torch is imported inside the functions that take tensors: the saver,
on the agent's side, needs only ``ShardRecord`` and ``Index``, and the
agent's process imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# index of a shard in the global array: ((start, stop) per dim); () = scalar
Index = Tuple[Tuple[int, int], ...]

_NP_NAMES = (
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint8", "bool",
)
# restore stages CUDA targets through pinned bins of at most this size
_PIN_BIN_BYTES = 256 << 20


@dataclass
class ShardRecord:
    """One contiguous block of one leaf, owned by this host."""

    path: str  # "/"-joined key path
    global_shape: Tuple[int, ...]
    dtype: str
    index: Index
    data: Optional[np.ndarray] = None  # None once serialized to shm

    @property
    def nbytes(self) -> int:
        n = np.dtype(self.dtype).itemsize
        for lo, hi in self.index:
            n *= hi - lo
        return n

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.index)


@dataclass
class BlockLeaf:
    """A tensor that holds a run of a bigger leaf's row-major flatten (a
    ZeRO shard): the leaf's global shape and the run ``[lo, hi)``, whose
    elements are the tensor's first ``hi - lo`` (any rest is padding and
    is never recorded). As a state leaf it is recorded, and restored, as
    the blocks of the leaf's own shape that tile the run
    (``flat_boxes``), so a reader of either package assembles the leaf
    from the records of all its owners.

    ``place``: the leaf is itself one box of the checkpoint's leaf (a
    tensor-parallel rank's box of a split leaf, whole or ZeRO-sharded):
    ``(record shape, box)``, the box's index in the record leaf, with
    one more leading dim than ``global_shape`` when the record stacks
    the tp ranks' leaves. Every block is recorded at its place there."""

    tensor: Any
    global_shape: Tuple[int, ...]
    lo: int
    hi: int
    place: Optional[Tuple[Tuple[int, ...], Index]] = None

    @property
    def record_shape(self) -> Tuple[int, ...]:
        return tuple(self.place[0]) if self.place is not None else tuple(self.global_shape)

    def _placed(self, box: Index) -> Index:
        if self.place is None:
            return box
        where = self.place[1]
        lead = len(where) - len(box)
        return tuple(where[:lead]) + tuple(
            (lo + w[0], hi + w[0]) for (lo, hi), w in zip(box, where[lead:])
        )

    def blocks(self) -> List[Tuple[Index, Any]]:
        """``(index, view)`` of each block of the run, in order: ``view``
        is the block's part of the tensor, in the block's shape, and the
        index its place in the record leaf."""
        flat = self.tensor.detach().reshape(-1)
        out, off = [], 0
        for box in flat_boxes(self.global_shape, self.lo, self.hi):
            shape = tuple(hi - lo for lo, hi in box)
            n = int(np.prod(shape, dtype=np.int64))
            out.append((self._placed(box), flat[off:off + n].view(shape)))
            off += n
        return out


def flat_boxes(shape: Tuple[int, ...], lo: int, hi: int) -> List[Index]:
    """The blocks (indexes in ``shape``) that tile elements ``[lo, hi)``
    of its row-major flatten, in flatten order: at most two partial rows
    of each dim around whole rows."""
    if lo >= hi:
        return []
    if not shape:
        return [()]
    inner = int(np.prod(shape[1:], dtype=np.int64))
    rest = full_index(shape[1:])
    out: List[Index] = []
    r = lo // inner
    if lo % inner:  # a partial first row
        stop = min(hi, (r + 1) * inner)
        out += [((r, r + 1),) + b for b in flat_boxes(shape[1:], lo - r * inner, stop - r * inner)]
        r += 1
        if stop == hi:
            return out
    if hi // inner > r:  # whole rows
        out.append(((r, hi // inner),) + rest)
        r = hi // inner
    if hi % inner:  # a partial last row
        out += [((r, r + 1),) + b for b in flat_boxes(shape[1:], 0, hi - r * inner)]
    return out


def dtype_name(path: str, dtype: torch.dtype) -> str:
    """The numpy name of a tensor dtype. A dtype numpy cannot name
    without ``ml_dtypes`` (bfloat16, the float8s) raises, naming the
    record: it is never cast quietly."""
    name = str(dtype).removeprefix("torch.")
    if name not in _NP_NAMES:
        raise ValueError(
            f"checkpoint record {path!r}: dtype {dtype} has no numpy name "
            f"(the record format stores numpy dtypes); keep this leaf in "
            f"a dtype numpy names, e.g. float32"
        )
    return name


def full_index(shape) -> Index:
    return tuple((0, int(d)) for d in shape)


def flatten_state(state: Dict) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's dict flatten order (keys sorted,
    nested dicts joined with ``/``)."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        else:
            out.append((prefix or ".", node))

    walk("", state)
    return out


def _unflatten_like(state: Dict, values: Dict[str, Any]) -> Dict:
    def walk(prefix, node):
        if isinstance(node, dict):
            return {
                k: walk(f"{prefix}/{k}" if prefix else str(k), v)
                for k, v in node.items()
            }
        return values[prefix or "."]

    return walk("", state)


def _records_for(path: str, leaf) -> List[Tuple[ShardRecord, Any]]:
    """[(record without data, source)]: the live tensor (a block's view
    of it), or a host copy."""
    import torch

    if isinstance(leaf, BlockLeaf):
        dt = dtype_name(path, leaf.tensor.dtype)
        shape = leaf.record_shape
        return [(ShardRecord(path, shape, dt, box), view) for box, view in leaf.blocks()]
    if isinstance(leaf, torch.Tensor):
        shape = tuple(leaf.shape)
        rec = ShardRecord(path, shape, dtype_name(path, leaf.dtype), full_index(shape))
        return [(rec, leaf.detach())]
    arr = np.array(leaf)  # eager copy: host leaves are small and mutable
    rec = ShardRecord(path, tuple(arr.shape), str(arr.dtype), full_index(arr.shape))
    return [(rec, arr)]


def host_shard_plan(state: Dict) -> List[Tuple[ShardRecord, Any]]:
    """Each leaf's records (``data`` None) and their sources: the live
    tensor, still on its device, or a host copy of a host leaf taken now
    (the sampler state moves on; the snapshot must be of save time). The
    chunked stager (``ckpt/engine.py``) copies the tensors itself."""
    return [item for path, leaf in flatten_state(state) for item in _records_for(path, leaf)]


def host_shard_records(state: Dict) -> List[ShardRecord]:
    """Every leaf as a record holding a host copy of its bytes (a
    device tensor is copied to the host and waited for)."""
    import torch

    from dlrover_tpu_torch.ops.host_offload import settle_host_sources

    plan = host_shard_plan(state)
    settle_host_sources(src for _, src in plan)  # offloaded state's copies home
    records = []
    for rec, src in plan:
        if isinstance(src, torch.Tensor):
            src = src.to("cpu", copy=True).contiguous().numpy()
        rec.data = src
        records.append(rec)
    return records


def host_shard_index_set(state: Dict) -> set:
    """The ``(path, index)`` pairs ``host_shard_records`` would give."""
    import torch

    out = set()
    for path, leaf in flatten_state(state):
        if isinstance(leaf, BlockLeaf):
            out.update((path, box) for box, _ in leaf.blocks())
            continue
        shape = leaf.shape if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        out.add((path, full_index(shape)))
    return out


def assemble_leaf(
    global_shape: Tuple[int, ...],
    dtype: str,
    want: Index,
    records: List[ShardRecord],
) -> np.ndarray:
    """Build the ``want`` slice of a leaf from overlapping shard records."""
    shape = tuple(hi - lo for lo, hi in want)
    # fast path: a single record covers the request exactly
    for r in records:
        if r.index == want and r.data is not None:
            return r.data
    out = np.empty(shape, dtype=np.dtype(dtype))
    # coverage mask, not a count: overlapping records (e.g. files from two
    # world layouts in one step dir) must not mask a real hole — a hole
    # would silently return np.empty garbage as weights
    covered = np.zeros(shape, dtype=bool) if shape else np.zeros((), bool)
    for r in records:
        if r.data is None:
            continue
        # overlap of r.index with want, in both coordinate systems
        src_sel, dst_sel, ok = [], [], True
        for (wlo, whi), (rlo, rhi) in zip(want, r.index):
            lo, hi = max(wlo, rlo), min(whi, rhi)
            if lo >= hi:
                ok = False
                break
            src_sel.append(slice(lo - rlo, hi - rlo))
            dst_sel.append(slice(lo - wlo, hi - wlo))
        if not ok:
            continue
        block = r.data[tuple(src_sel)] if src_sel else r.data
        if dst_sel:
            out[tuple(dst_sel)] = block
            covered[tuple(dst_sel)] = True
        else:
            out[...] = block
            covered[...] = True
    if not covered.all():
        raise ValueError(
            f"checkpoint shards do not cover requested index {want} of "
            f"shape {global_shape}"
        )
    return out


def _check_records(path, shape, dtype, recs):
    for r in recs:
        if tuple(r.global_shape) != tuple(shape) or r.dtype != dtype:
            raise ValueError(
                f"checkpoint record {path!r} is {r.dtype}{list(r.global_shape)}, "
                f"the target {dtype}{list(shape)}"
            )


def _copy_into_cuda(items: List[Tuple[torch.Tensor, np.ndarray]]) -> None:
    """Host blocks into CUDA tensors: packed into pinned bins, each bin
    moved by non-blocking copies and waited for before it is reused."""
    import torch

    total = sum(b.nbytes for _, b in items)
    pinned = torch.empty(min(total, _PIN_BIN_BYTES), dtype=torch.uint8, pin_memory=True)
    if not pinned.is_pinned():
        raise RuntimeError("restore could not allocate pinned host memory")
    stream = torch.cuda.current_stream(items[0][0].device)
    pinned_np = pinned.numpy()
    i = 0
    while i < len(items):
        off, batch = 0, []
        while i < len(items) and (not batch or off + items[i][1].nbytes <= pinned.numel()):
            t, block = items[i]
            n = block.nbytes
            if n > pinned.numel():  # one record larger than the bin
                pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
                pinned_np = pinned.numpy()
            pinned_np[off:off + n] = np.ascontiguousarray(block).reshape(-1).view(np.uint8)
            batch.append((t, off, n))
            off += n
            i += 1
        for t, o, n in batch:
            t.view(-1).view(torch.uint8).copy_(pinned[o:o + n], non_blocking=True)
        stream.synchronize()


def restore_state(
    target: Dict,
    read_records: Callable[[str], List[ShardRecord]],
) -> Dict:
    """Fill a state shaped like ``target`` from shard records.

    ``read_records(path)`` returns every available record for a leaf.
    Tensor leaves are filled in place and returned as the same tensors;
    a record whose shape or dtype differs from its tensor raises, naming
    the path. Host leaves come back as numpy values (0-d leaves as numpy
    scalars). Returns a dict with the target's nesting."""
    import torch

    values: Dict[str, Any] = {}
    cuda_items, cpu_items = [], []
    with torch.no_grad():
        for path, leaf in flatten_state(target):
            recs = read_records(path)
            if isinstance(leaf, BlockLeaf):
                t = leaf.tensor
                if not t.is_contiguous():
                    raise ValueError(f"restore target {path!r} is not contiguous")
                dt = dtype_name(path, t.dtype)
                _check_records(path, leaf.record_shape, dt, recs)
                for box, view in leaf.blocks():
                    block = assemble_leaf(leaf.record_shape, dt, box, recs)
                    (cuda_items if t.device.type == "cuda" else cpu_items).append((view, block))
                values[path] = leaf
                continue
            if isinstance(leaf, torch.Tensor):
                if not leaf.is_contiguous():
                    raise ValueError(f"restore target {path!r} is not contiguous")
                shape, dt = tuple(leaf.shape), dtype_name(path, leaf.dtype)
                _check_records(path, shape, dt, recs)
                block = assemble_leaf(shape, dt, full_index(shape), recs)
                (cuda_items if leaf.device.type == "cuda" else cpu_items).append((leaf, block))
                values[path] = leaf
                continue
            np_leaf = np.asarray(leaf)
            block = assemble_leaf(
                tuple(np_leaf.shape), str(np_leaf.dtype), full_index(np_leaf.shape), recs
            )
            # copy: the exact-match fast path returns the record's buffer,
            # which may be a view into shm that must not outlive the lock
            values[path] = block[()] if block.ndim == 0 else np.array(block)
        for t, block in cpu_items:
            t.copy_(torch.from_numpy(np.array(block)).view(t.shape))
        if cuda_items:
            _copy_into_cuda(cuda_items)
    return _unflatten_like(target, values)
