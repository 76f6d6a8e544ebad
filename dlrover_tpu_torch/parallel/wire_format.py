"""Opt-in int8-per-chunk wire format for bulk movers on slow rails (a
copy of ``dlrover_tpu/parallel/wire_format.py``: numpy and zlib only,
the same bytes on the wire, so a file written by either package decodes
in the other).

Its user in the port is the incremental embedding checkpoint
(``ops/embedding/ckpt.py``): float arrays of a full or delta export
are quantized per chunk, and the manifest carries the decoded
payload's crc32.

Contract (the reason this is SAFE to opt into):

- **per-chunk scale**: each ``chunk_bytes`` window of the flattened
  array gets its own ``max|x| / 127`` scale, so one outlier only costs
  its own chunk's resolution;
- **idempotent roundtrip**: ``decode(encode(x))`` is a fixed point —
  encoding the decoded payload reproduces the identical wire bytes
  (the chunk max decodes to exactly ``127 * scale``), so re-staging a
  restored state never drifts further;
- **crc over the DECODED payload**: the sender computes the digest of
  ``decode(encode(x))`` (cheap — it already has the wire form), the
  receiver verifies the digest of what it decoded. A corrupted wire
  chunk fails the check even though the wire is lossy; bitwise restore
  of the decoded payload is gated exactly like the uncompressed path.

``wire_format="none"`` everywhere keeps bitwise-exact byte movement;
``"int8"`` is opt-in per call site.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np

# formats bulk movers accept; validated at the call sites
WIRE_FORMATS = ("none", "int8")

# default quantization window: small enough that one outlier row does
# not flatten a whole table's resolution, big enough that the scale
# array is noise next to the payload (1 float per 256 KiB)
DEFAULT_WIRE_CHUNK_BYTES = 256 << 10

# dtypes the int8 wire may quantize; everything else (ints, bools,
# index arrays) must stay bitwise and is passed through by callers
QUANTIZABLE_DTYPES = (np.float32, np.float64, np.float16)


def quantizable(arr: np.ndarray) -> bool:
    return arr.dtype.type in QUANTIZABLE_DTYPES and arr.size > 0


def encode_int8(
    arr: np.ndarray, chunk_bytes: int = DEFAULT_WIRE_CHUNK_BYTES
) -> Tuple[np.ndarray, np.ndarray]:
    """``(q, scales)``: int8 wire payload (same shape as ``arr``) plus
    one float32 scale per ``chunk_bytes`` window of the flattened
    array. All-zero chunks get scale 1.0 (q stays 0 — exact)."""
    if not quantizable(arr):
        raise TypeError(
            f"int8 wire format needs a float array, got {arr.dtype}"
        )
    flat = np.ascontiguousarray(arr).reshape(-1).astype(np.float32)
    per = max(1, int(chunk_bytes) // arr.dtype.itemsize)
    nchunks = (flat.size + per - 1) // per
    q = np.empty(flat.size, dtype=np.int8)
    scales = np.empty(nchunks, dtype=np.float32)
    for i in range(nchunks):
        seg = flat[i * per:(i + 1) * per]
        m = float(np.max(np.abs(seg)))
        s = m / 127.0 if m > 0.0 else 1.0
        scales[i] = s
        q[i * per:(i + 1) * per] = np.clip(
            np.rint(seg / s), -127, 127
        ).astype(np.int8)
    return q.reshape(arr.shape), scales


def decode_int8(
    q: np.ndarray,
    scales: np.ndarray,
    dtype,
    chunk_bytes: int = DEFAULT_WIRE_CHUNK_BYTES,
) -> np.ndarray:
    """Inverse of :func:`encode_int8` (up to quantization): each chunk
    dequantizes as ``q * scale``, cast back to the original dtype."""
    dtype = np.dtype(dtype)
    flat = np.ascontiguousarray(q).reshape(-1).astype(np.float32)
    per = max(1, int(chunk_bytes) // dtype.itemsize)
    out = np.empty(flat.size, dtype=np.float32)
    for i in range(len(scales)):
        seg = flat[i * per:(i + 1) * per]
        out[i * per:(i + 1) * per] = seg * np.float32(scales[i])
    return out.astype(dtype).reshape(q.shape)


def roundtrip_int8(
    arr: np.ndarray, chunk_bytes: int = DEFAULT_WIRE_CHUNK_BYTES
) -> np.ndarray:
    """What the receiver will hold after an int8 wire hop — the value
    the sender must crc (crc over the decoded payload) and the value a
    bitwise-restore gate compares against."""
    q, scales = encode_int8(arr, chunk_bytes)
    return decode_int8(q, scales, arr.dtype, chunk_bytes)


def decoded_crc32(arrays: Dict[str, np.ndarray]) -> int:
    """Order-independent-of-arrival digest of a decoded payload: key
    names and raw bytes folded in sorted-key order. Senders compute it
    over ``decode(encode(state))``; receivers over what they decoded —
    equal iff the wire delivered every chunk intact."""
    crc = 0
    for k in sorted(arrays):
        crc = zlib.crc32(k.encode("utf-8"), crc)
        a = np.ascontiguousarray(arrays[k])
        crc = zlib.crc32(a.reshape(-1).view(np.uint8), crc)
    return crc & 0xFFFFFFFF
