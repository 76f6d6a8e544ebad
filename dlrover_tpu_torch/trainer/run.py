"""The port's elastic launcher (a copy of ``dlrover_tpu/trainer/run.py``).

Parity: dlrover/trainer/torch/elastic_run.py:124-371 — on the first node it
spawns a local job master when none is provided
(``_launch_dlrover_local_master:230``), starts the flash-checkpoint saver,
then runs the per-host elastic agent which rendezvouses through the master
and supervises the training processes; before it relaunches a failed
worker it persists the newest staged step ("save at breakpoint"). Flags
mirror the reference's additions: ``--node-unit``, ``--max-restarts``,
plus ``--device-spec`` (``cpu`` for gloo workers on the CPU, else the
card).

Usage:
    python -m dlrover_tpu_torch.trainer.run --nnodes=1 --nproc-per-node=1 \
        examples/train_gpt2_torch.py [args...]
    python -m dlrover_tpu_torch.trainer.run --nnodes=2:4 train.py  # elastic

``--network-check`` runs the paired node check before training
(``agent/node_check_agent.py``: two rounds of ``trainer/node_check/
gpu_check.py``, a timed bf16 matmul on each card and a timed all-reduce
over the check's process group); a node the master finds faulty (or a
straggler, with ``--exclude-straggler``) leaves with exit code 3 before
any worker starts. The launcher and the agent never create a CUDA
context: ``--auto-config`` counts the cards with ``nvidia-smi -L``, and
the check runs in worker processes. When the agent is done, its report
daemons make one last report, so the master holds the workers' final
step, goodput and any eviction notice.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from typing import Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training_agent import (
    ElasticTrainingAgent,
    WorkerSpec,
    WorkerState,
    die_with_parent_hook,
)
from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.utils.env import child_env
from dlrover_tpu_torch.common.constants import NodeEnv, RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.utils.device import configure_devices


def parse_args(argv=None):
    p = argparse.ArgumentParser("dlrover_tpu_torch.trainer.run")
    p.add_argument(
        "--nnodes",
        type=str,
        default="1",
        help="node count, fixed ('2') or elastic range ('2:4')",
    )
    p.add_argument("--nproc-per-node", type=int, default=1)
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument(
        "--master-addr",
        type=str,
        default="",
        help="existing master host:port; empty => node 0 spawns one",
    )
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--monitor-interval", type=float, default=3.0)
    p.add_argument(
        "--rdzv-waiting-timeout",
        type=float,
        default=5.0,
        help="lastcall seconds to wait for more nodes past min",
    )
    p.add_argument(
        "--node-unit",
        type=int,
        default=1,
        help="hosts per unit that fails and restarts together; worlds "
        "are multiples of this",
    )
    p.add_argument(
        "--network-check",
        action="store_true",
        help="run the paired node health check before training",
    )
    p.add_argument(
        "--exclude-straggler",
        action="store_true",
        help="with --network-check: a straggling node leaves the job "
        "too (default: warn only)",
    )
    p.add_argument(
        "--auto-config",
        action="store_true",
        help="infer nnodes from NODE_NUM and nproc-per-node from the "
        "local card count (parity: dlrover-run --auto-config)",
    )
    p.add_argument(
        "--device-spec",
        type=str,
        default="",
        help="'cpu' for gloo workers on the CPU; default: the card "
        "(NCCL)",
    )
    p.add_argument(
        "--job-name",
        type=str,
        default="",
        help="namespaces IPC sockets/shm so jobs on one host don't collide",
    )
    p.add_argument("--log-dir", type=str, default="")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def parse_nnodes(spec: str) -> Tuple[int, int]:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return int(lo), int(hi)
    n = int(spec)
    return n, n


def launch_local_master(node_num: int) -> Tuple[subprocess.Popen, str]:
    """Parity: _launch_dlrover_local_master elastic_run.py:230."""
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.master.main",
            "--node_num",
            str(node_num),
        ],
        stdout=subprocess.PIPE,
        stderr=None,
        text=True,
        env=child_env(),
        # a SIGKILL'd launcher must not orphan the job master it spawned
        # (see agent/training_agent._die_with_parent)
        preexec_fn=die_with_parent_hook(),
    )
    # Read the address line on a thread so a wedged master (alive but never
    # printing its address) cannot block the launcher past the deadline; the
    # thread keeps draining stdout afterwards so the pipe never fills up.
    box: dict = {}
    got = threading.Event()

    def _reader():
        for line in proc.stdout:
            if not got.is_set() and line.startswith(
                "DLROVER_TPU_MASTER_ADDR="
            ):
                box["addr"] = line.strip().split("=", 1)[1]
                got.set()
        got.set()

    threading.Thread(target=_reader, daemon=True).start()
    got.wait(timeout=30)
    addr = box.get("addr", "")
    if not addr:
        proc.terminate()
        raise RuntimeError("local master failed to start")
    return proc, addr


def _run_network_check(args, client: MasterClient) -> bool:
    """Run the node health check before training (parity:
    NetworkCheckElasticAgent training.py:799 + run_network_check:1014).
    The check rendezvous was already configured via
    RendezvousParamsReport."""
    from dlrover_tpu_torch.agent.node_check_agent import run_network_check

    return run_network_check(
        node_rank=args.node_rank,
        nproc_per_node=args.nproc_per_node,
        client=client,
        device_spec=args.device_spec,
        exclude_straggler=args.exclude_straggler,
    )


def auto_configure(args):
    """--auto-config (parity: elastic_run.py:33-40 + ElasticLaunchConfig
    .auto_configure_params training.py:140): nnodes from the platform's
    NODE_NUM env (the operator sets it on every pod), nproc-per-node
    from the locally visible card count, and network-check on for jobs
    of >= 4 nodes."""
    try:
        node_num = int(os.getenv(NodeEnv.NODE_NUM, "0") or "0")
    except ValueError:
        node_num = 0  # templated-but-unset env: fall back to --nnodes
    if node_num > 0:
        args.nnodes = str(node_num)
    from dlrover_tpu_torch.utils.device import local_device_count

    n = local_device_count(args.device_spec)
    if n > 0:
        args.nproc_per_node = n
    # gate on the RESOLVED min_nodes, not only the env-derived node_num:
    # `--auto-config --nnodes=8` without the platform env must still turn
    # the health check on (parity: training.py:154 gates on min_nodes)
    min_nodes, _ = parse_nnodes(args.nnodes)
    if min_nodes >= 4:
        args.network_check = True
    logger.info(
        f"auto-config: nnodes={args.nnodes} "
        f"nproc_per_node={args.nproc_per_node} "
        f"network_check={args.network_check}"
    )
    return args


def run(args) -> int:
    if args.job_name:
        os.environ[NodeEnv.JOB_NAME] = args.job_name
    if getattr(args, "auto_config", False):
        args = auto_configure(args)
    configure_devices(args.device_spec)  # a bad spec fails before anything starts
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    master_proc: Optional[subprocess.Popen] = None
    master_addr = args.master_addr or os.getenv(NodeEnv.MASTER_ADDR, "")
    if not master_addr:
        if args.node_rank != 0:
            raise SystemExit(
                "--master-addr is required on non-zero node ranks"
            )
        master_proc, master_addr = launch_local_master(max_nodes)
        logger.info(f"spawned local master at {master_addr}")
    os.environ[NodeEnv.MASTER_ADDR] = master_addr

    client = MasterClient(
        master_addr, node_id=args.node_rank, node_type="worker"
    )
    # configure both rendezvous
    for name in (
        RendezvousName.ELASTIC_TRAINING,
        RendezvousName.NETWORK_CHECK,
    ):
        client.report(
            comm.RendezvousParamsReport(
                rdzv_name=name,
                min_nodes=min_nodes,
                max_nodes=max_nodes,
                waiting_timeout=args.rdzv_waiting_timeout,
                node_unit=args.node_unit,
            )
        )

    monitors = []
    try:
        if args.network_check:
            ok = _run_network_check(args, client)
            if not ok:
                logger.error("this node failed the network check")
                return 3

        spec = WorkerSpec(
            entrypoint=args.training_script,
            args=list(args.training_script_args),
            nproc_per_node=args.nproc_per_node,
            max_restarts=args.max_restarts,
            monitor_interval=args.monitor_interval,
            log_dir=args.log_dir,
            device_spec=args.device_spec,
        )
        # Flash-checkpoint saver must own its IPC endpoints before workers
        # spawn (parity: start_async_saving_ckpt ckpt_saver.py:405); it also
        # persists shm before any elastic restart ("save at breakpoint").
        saver = AsyncCheckpointSaver.start_async_saving_ckpt(
            local_shard_num=args.nproc_per_node, node_rank=args.node_rank
        )
        # degraded-checkpoint-mode (and recovery) node events reach the
        # master: a job silently running shm-only would lose everything
        # on the next node death without anyone being told
        saver.set_event_reporter(
            lambda event, msg: client.report_failure(
                f"{event}: {msg}", level="warning"
            )
        )
        # agent-side daemons (parity: launch_agent starts the monitors at
        # training.py:721). Default: the aggregation tier — ONE
        # delta-encoded RPC per tick coalescing telemetry/step/resource
        # and the command + paral-config poll legs (docs/control-plane.md).
        # DLROVER_TPU_AGENT_BATCH=0 falls back to the legacy per-channel
        # daemons (mixed-version fleets against an old master).
        if os.getenv("DLROVER_TPU_AGENT_BATCH", "1").strip().lower() not in (
            "0", "false", "no", "off"
        ):
            from dlrover_tpu_torch.agent.aggregator import (
                AgentReportBatcher,
                host_resource_fn,
            )

            monitors += [
                AgentReportBatcher(
                    client, resource_fn=host_resource_fn(client.node_id)
                ),
            ]
        else:
            from dlrover_tpu_torch.agent.monitor import (
                ParalConfigTuner,
                ResourceMonitor,
                TrainingMonitor,
                WorkerCommandRelay,
            )

            monitors += [
                ResourceMonitor(client),
                TrainingMonitor(client),
                ParalConfigTuner(client),
                # master->worker forensics channel: flight-dump /
                # profile requests land in the command file the
                # trainer polls
                WorkerCommandRelay(client),
            ]
        for m in monitors:
            m.start()
        agent = ElasticTrainingAgent(
            node_rank=args.node_rank, spec=spec, client=client
        )
        # restart-path persist: the agent survives, so the global commit
        # runs on its own thread — a dead peer's missing done files must
        # not stall re-rendezvous (sync commit is for SIGTERM/close only)
        agent.set_checkpoint_hook(
            lambda: saver.save_shm_to_storage(sync_commit=False)
        )
        result = agent.run()
        # one last report now that the workers exited: their final step,
        # goodput and any eviction notice reach the master before it
        # stops (a daemon's next tick may be seconds away)
        for m in monitors:
            m.stop()
            m.tick_once()
        logger.info(
            f"agent finished: {result.state} after "
            f"{result.restarts} restarts"
        )
        return 0 if result.state == WorkerState.SUCCEEDED else 1
    finally:
        for m in monitors:
            m.stop()
        AsyncCheckpointSaver.reset()
        client.close()
        if master_proc is not None:
            master_proc.terminate()
            try:
                master_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                master_proc.kill()


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
