"""Embedding row gather and in-place scatter on Hopper (the kernels
under ``ops/embedding/device_tier.py``'s ``_Kernels``; counterpart of
its Pallas ``_build_gather`` / ``_build_scatter``).

Two hand-written CUDA kernels (``csrc/embedding_rows.cu``):

- ``emb_gather``: ``rows[i] = table[slots[i]]`` into a new ``[n, R]``
  tensor;
- ``emb_scatter``: ``table[slots[i]] = rows[i]`` in place, the
  counterpart of the Pallas call's ``input_output_aliases``: no
  table-sized copy.

Both are memory copies, bound by HBM bandwidth; each warp moves one
row with 16-byte accesses when the row width is a multiple of 4 floats.
Dispatch is by device: a table on the CPU takes the plain versions
(``table[slots]``, ``table.index_copy_``); a CUDA table takes the
kernel or raises. Slots are int32 in ``[0, table rows)``. Padding
entries may name one scratch row many times, with identical values.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# launches per kernel, counted where the wrapper launches it
launch_counts: Dict[str, int] = {"emb_gather": 0, "emb_scatter": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "emb_gather": [_P, _L, _P, _P, _I, _I, _P],
    "emb_scatter": [_P, _L, _P, _P, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lib():
    from dlrover_tpu_torch.ops._build import load_library

    lib = load_library("embedding_rows")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------
def gather_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    return table[slots.long()]


def scatter_plain(table: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return table.index_copy_(0, slots.long(), rows)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(table, slots, rows=None):
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise NotImplementedError(
            f"embedding row kernels take a contiguous 2-D f32 table, got "
            f"{table.dtype} {tuple(table.shape)}"
        )
    if slots.dtype != torch.int32 or slots.dim() != 1 or not slots.is_contiguous():
        raise NotImplementedError(
            f"slots must be a contiguous 1-D int32 tensor, got {slots.dtype} "
            f"{tuple(slots.shape)}"
        )
    if slots.device != table.device or (rows is not None and rows.device != table.device):
        raise ValueError("table, slots and rows must lie on one device")
    if rows is not None and (
        rows.dtype != torch.float32
        or not rows.is_contiguous()
        or tuple(rows.shape) != (slots.numel(), table.shape[1])
    ):
        raise ValueError(
            f"rows must be contiguous f32 [{slots.numel()}, {table.shape[1]}], "
            f"got {rows.dtype} {tuple(rows.shape)}"
        )
    if slots.numel() == 0:
        raise ValueError("empty slot list")


def _launch(name, table, slots, other):
    fn = getattr(_lib(), name)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            table.data_ptr(), table.shape[0], slots.data_ptr(),
            other.data_ptr(), slots.numel(), table.shape[1], stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def emb_gather(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``table[slots]`` as a new ``[n, R]`` tensor: the kernel on CUDA,
    the plain version on the CPU."""
    if table.device.type != "cuda":
        return gather_plain(table, slots)
    _check(table, slots)
    out = torch.empty((slots.numel(), table.shape[1]), dtype=table.dtype, device=table.device)
    _launch("emb_gather", table, slots, out)
    return out


def emb_scatter_(table: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[slots] = rows`` in place; returns ``table``. The kernel on
    CUDA, the plain version on the CPU."""
    if table.device.type != "cuda":
        return scatter_plain(table, slots, rows)
    _check(table, slots, rows)
    _launch("emb_scatter", table, slots, rows)
    return table
