"""The all-to-all that Ulysses (``parallel/ulysses.py``) and the MoE
dispatch and return (``parallel/moe.py``) share.

``all_to_all(x, group, comm)`` sends chunk ``j`` of ``x``'s leading dim
to group rank ``j`` and returns every rank's chunk for this one, in
group rank order. Each caller passes its own counter dict (``"ms"``,
``"calls"``, ``"staged"``), so the sp and ep all-to-alls are reported
apart: ``calls`` counts the collectives, ``ms`` their host time (on the
card the queued kernels are drained before and after each, so the time
is the transfer's), ``staged`` those that moved CUDA tensors over gloo,
which stages them through host memory.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


def new_counter() -> Dict[str, float]:
    return {"ms": 0.0, "calls": 0, "staged": 0}


def reset_counter(comm: Dict[str, float]) -> None:
    comm.update(ms=0.0, calls=0, staged=0)


def all_to_all(x: torch.Tensor, group, comm: Dict[str, float]) -> torch.Tensor:
    """``x`` (contiguous, leading dim the group size) exchanged over
    ``group``: row ``j`` to group rank ``j``, row ``i`` of the result
    from group rank ``i``."""
    import torch.distributed as dist

    out = torch.empty_like(x)
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.current_stream().synchronize()
    t0 = time.perf_counter()
    dist.all_to_all_single(out, x, group=group)
    if cuda:
        torch.cuda.current_stream().synchronize()
        comm["staged"] += int(dist.get_backend(group) == "gloo")
    comm["ms"] += (time.perf_counter() - t0) * 1e3
    comm["calls"] += 1
    return out
