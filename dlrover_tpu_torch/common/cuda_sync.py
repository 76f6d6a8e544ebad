"""One lock between CUDA graph captures and card-wide synchronizes.

A ``torch.cuda.synchronize()`` (``cudaDeviceSynchronize``) issued while
any thread of the process is capturing a CUDA graph fails, and takes
the capture down with it, whatever the capture's error mode: the
synchronize would have to wait on a stream that is recording, not
running. The serving plane captures its decode graphs in a thread of
its own beside a trainer's (co-located serving), so the two must not
meet. Every capture runs under ``capturing()`` and every card-wide
synchronize of the port goes through ``synchronize()``: one waits for
the other. A stream's own ``synchronize()`` needs neither (a capture
on another stream leaves it alone).
"""

from __future__ import annotations

import contextlib
import threading

# reentrant: a thread that holds it for a capture may synchronize after
# the capture ended without letting go
_LOCK = threading.RLock()


@contextlib.contextmanager
def capturing():
    """Hold the lock for a graph capture (and its warm-up)."""
    with _LOCK:
        yield


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)``, never during a capture."""
    import torch

    with _LOCK:
        torch.cuda.synchronize(device)
