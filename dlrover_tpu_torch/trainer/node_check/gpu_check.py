"""Node health-check workload on the card: a timed bf16 matmul and a timed
all-reduce (the port's counterpart of
``dlrover_tpu/trainer/node_check/tpu_check.py``).

Parity: dlrover/trainer/torch/node_check/nvidia_gpu.py:26 and
utils.py:59-90 — the reference times a bf16 matmul plus rounds of a
16M-element collective over NCCL; slow or failed nodes are bisected by
the master's paired rendezvous. Two failure surfaces:

- **card compute**: chained bf16 matmuls (``torch.matmul``, the plain
  product: the JAX check computes it as a jitted ``jnp`` product, no
  Pallas kernel);
- **the collective path**: chained all-reduces across every process of
  the paired group (NCCL on the card, gloo on the CPU). A group of one
  process (one card) gets a process group of its own, so the
  communicator is still made and timed.

The agent starts this script as the check round's workers
(``agent/node_check_agent.py``); each rank writes its elapsed seconds to
``$DLROVER_TPU_CHECK_RESULT_FILE.<local rank>`` and logs one ``gpu
check:`` JSON line (matmul TFLOP/s, all-reduce ms a round).
``DLROVER_TPU_MOCK_ERR_RANK=<process id>`` makes that rank raise and
``DLROVER_TPU_MOCK_SLOW_RANK`` makes it 2 s slower (utils.py:50).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import TrainerEnv
from dlrover_tpu_torch.common.log import default_logger as logger


def write_result(elapsed: float, path: str = "", **extra):
    path = path or os.getenv(TrainerEnv.CHECK_RESULT_FILE, "")
    if not path:
        return
    local_rank = os.getenv("DLROVER_TPU_LOCAL_RANK", "0")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(f"{path}.{local_rank}", "w") as f:
        json.dump({"elapsed": elapsed, **extra}, f)


def _workload_scale(device: torch.device):
    """(matmul_size, matmul_rounds, collective_elems, collective_rounds).

    On the card the load must *sustain* the tensor cores and the link
    long enough that a degraded card or link separates from healthy
    noise: 8192^2 bf16 matmuls (~1.1 TFLOP each) x 30 chained rounds,
    and 16M f32 elements x 10 chained all-reduces. On the CPU (tests)
    the same shapes would dominate the suite, so they drop to token
    sizes. Env overrides for either case:
    DLROVER_TPU_CHECK_{MM_SIZE,MM_ROUNDS,COLL_ELEMS,COLL_ROUNDS}.
    """
    on_card = device.type == "cuda"
    mm_size = 8192 if on_card else 256
    mm_rounds = 30 if on_card else 3
    elems = (1 << 24) if on_card else (1 << 16)
    coll_rounds = 10 if on_card else 3
    mm_size = int(os.getenv("DLROVER_TPU_CHECK_MM_SIZE", mm_size))
    mm_rounds = int(os.getenv("DLROVER_TPU_CHECK_MM_ROUNDS", mm_rounds))
    elems = int(os.getenv("DLROVER_TPU_CHECK_COLL_ELEMS", elems))
    coll_rounds = int(os.getenv("DLROVER_TPU_CHECK_COLL_ROUNDS", coll_rounds))
    return mm_size, mm_rounds, elems, coll_rounds


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def matmul_rounds(rounds: int, size: int, device: torch.device) -> float:
    """Seconds for ``rounds`` chained bf16 matmuls of ``size``^2."""
    scale = 1.0 / size

    def mm(a):
        # normalized so chained rounds stay ~1.0 (bf16 ones would
        # overflow after a few rounds)
        return torch.matmul(a, a) * scale

    a = torch.ones((size, size), dtype=torch.bfloat16, device=device)
    float(mm(a).sum())  # warm-up outside the timed region
    t0 = time.monotonic()
    for _ in range(rounds):
        a = mm(a)
    # a scalar that depends on the whole chain: the card has finished
    float(a.sum())
    return time.monotonic() - t0


def collective_rounds(rounds: int, elems: int, device: torch.device) -> float:
    """Seconds for ``rounds`` chained all-reduces of ``elems`` f32 over
    the default process group."""
    world = dist.get_world_size()
    x = torch.ones(elems, dtype=torch.float32, device=device)
    dist.all_reduce(x)  # makes the communicator, outside the timed region
    x /= world
    _sync(device)
    t0 = time.monotonic()
    for _ in range(rounds):
        dist.all_reduce(x)
        x /= world
    float(x[0])
    return time.monotonic() - t0


def main() -> int:
    from dlrover_tpu_torch.trainer.elastic.distributed import init_elastic

    ctx = init_elastic()
    device = (
        torch.device("cpu")
        if ctx.device_spec == "cpu"
        else torch.device("cuda", torch.cuda.current_device())
    )
    own_group = not dist.is_initialized()
    if own_group:
        # one process: init_elastic makes no group, but the check still
        # makes and times the communicator of the job's backend
        dist.init_process_group(
            "gloo" if device.type == "cpu" else "nccl",
            init_method=f"tcp://127.0.0.1:{comm.find_free_port()}",
            rank=0,
            world_size=1,
        )
    try:
        mock_err = os.getenv(TrainerEnv.MOCK_ERR_RANK, "")
        if mock_err and int(mock_err) == ctx.process_id:
            raise RuntimeError(f"mock error on rank {ctx.process_id}")
        mm_size, mm_rounds, elems, coll_rounds = _workload_scale(device)
        t_mm = matmul_rounds(mm_rounds, mm_size, device)
        t_coll = collective_rounds(coll_rounds, elems, device)
        t = t_mm + t_coll
        mock_slow = os.getenv(TrainerEnv.MOCK_SLOW_RANK, "")
        if mock_slow and int(mock_slow) == ctx.process_id:
            time.sleep(2.0)
            t += 2.0
        result = dict(
            rank=ctx.process_id,
            device=(
                torch.cuda.get_device_name(device)
                if device.type == "cuda"
                else "cpu"
            ),
            backend=dist.get_backend(),
            world_size=dist.get_world_size(),
            mm_size=mm_size,
            mm_rounds=mm_rounds,
            matmul_s=t_mm,
            matmul_tflops=2 * mm_size**3 * mm_rounds / t_mm / 1e12,
            coll_elems=elems,
            coll_rounds=coll_rounds,
            allreduce_s=t_coll,
            allreduce_ms_per_round=t_coll / coll_rounds * 1e3,
        )
        logger.info(f"gpu check: {json.dumps(result)}")
        write_result(t, **result)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
