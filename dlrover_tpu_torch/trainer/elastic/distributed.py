"""Training-process bootstrap: wire a PyTorch process into the elastic job
(the port of ``dlrover_tpu/trainer/elastic/distributed.py``).

The agent exports ``NodeEnv`` vars computed from the master-assigned comm
world; ``init_elastic()`` consumes them. It makes the local rank's card
the current CUDA device (before anything touches the card), then joins
``torch.distributed`` through the ``tcp://`` rendezvous on the
coordinator address the master assigned, whose store process 0 binds.
The master owns coordinator assignment and restart, which is the
elasticity seam (SURVEY.md §5 "Distributed communication backend").

``DLROVER_TPU_DEVICE_SPEC`` is ``cpu`` (gloo, the tests' backend) or
``cuda`` / empty (NCCL on the card). The JAX package also points JAX's
persistent compilation cache at a job-stable directory here; the port's
counterpart, a cache of compiled steps or CUDA graphs, is ROADMAP A8.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.utils.device import configure_devices


@dataclass
class ElasticContext:
    process_id: int = 0
    num_processes: int = 1
    node_rank: int = 0
    node_num: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    restart_count: int = 0
    rdzv_round: int = 0
    coordinator_addr: str = ""
    master_addr: str = ""
    # "cpu", "cuda" or "" (the card): DLROVER_TPU_DEVICE_SPEC
    device_spec: str = ""

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def in_elastic_job(self) -> bool:
        return bool(self.master_addr)


def elastic_context() -> ElasticContext:
    return ElasticContext(
        process_id=int(os.getenv(NodeEnv.PROCESS_ID, "0")),
        num_processes=int(os.getenv(NodeEnv.NUM_PROCESSES, "1")),
        node_rank=int(os.getenv(NodeEnv.NODE_RANK, "0")),
        node_num=int(os.getenv(NodeEnv.NODE_NUM, "1")),
        local_rank=int(os.getenv("DLROVER_TPU_LOCAL_RANK", "0")),
        local_world_size=int(os.getenv("DLROVER_TPU_LOCAL_WORLD_SIZE", "1")),
        restart_count=int(os.getenv(NodeEnv.RESTART_COUNT, "0")),
        rdzv_round=int(os.getenv("DLROVER_TPU_RDZV_ROUND", "0")),
        coordinator_addr=os.getenv(NodeEnv.COORDINATOR_ADDR, ""),
        master_addr=os.getenv(NodeEnv.MASTER_ADDR, ""),
        device_spec=configure_devices(),
    )


def init_elastic(
    timeout_secs: int = 300, device_spec: str = ""
) -> ElasticContext:
    """Take the local rank's card and join the process group.

    Safe to call for single-process jobs: at world size 1 no process
    group is made, as in the JAX package. Unless the device spec
    (``device_spec``, else ``DLROVER_TPU_DEVICE_SPEC``) names the CPU,
    the local rank's card becomes the current device first, and a host
    without a card raises. A relaunched worker calls this again with the
    world the agent re-assigned.
    """
    ctx = elastic_context()
    if device_spec:
        ctx.device_spec = configure_devices(device_spec)
    spec = ctx.device_spec
    if spec != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; set DLROVER_TPU_DEVICE_SPEC=cpu "
                "(the launcher's --device-spec cpu) to run on the CPU"
            )
        torch.cuda.set_device(ctx.local_rank)
    if ctx.is_distributed and not torch.distributed.is_initialized():
        backend = "gloo" if spec == "cpu" else "nccl"
        logger.info(
            f"init_process_group({backend}, tcp://{ctx.coordinator_addr}, "
            f"rank={ctx.process_id}, world_size={ctx.num_processes})"
        )
        # process 0 binds the coordinator port for the store: a port
        # taken meanwhile raises here, the worker exits non-zero and the
        # agent restarts the round on a fresh port
        torch.distributed.init_process_group(
            backend,
            init_method=f"tcp://{ctx.coordinator_addr}",
            rank=ctx.process_id,
            world_size=ctx.num_processes,
            timeout=datetime.timedelta(seconds=timeout_secs),
        )
    return ctx
