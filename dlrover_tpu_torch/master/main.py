"""Master process entry: ``python -m dlrover_tpu_torch.master.main`` (a
copy of ``dlrover_tpu/master/main.py``; ``--platform k8s`` raises until
ROADMAP A17 ports the k8s master).

Parity: dlrover/python/master/main.py:43-66 — parse args, build the
platform-appropriate master, serve until the job exits.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.local_master import LocalJobMaster


def parse_args(argv=None):
    parser = argparse.ArgumentParser("dlrover-tpu master")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument(
        "--platform", type=str, default="local", choices=["local", "k8s"]
    )
    parser.add_argument("--job_name", type=str, default="dlrover-tpu-job")
    return parser.parse_args(argv)


def run(args) -> int:
    if args.platform == "k8s":
        # the pod scaler and watcher (dlrover_tpu/k8s) are not ported yet
        raise NotImplementedError("ROADMAP A17")
    master = LocalJobMaster(port=args.port, node_num=args.node_num)
    master.prepare()
    # the launcher reads this line to learn the bound port
    print(f"DLROVER_TPU_MASTER_ADDR={master.addr}", flush=True)

    def _term(signum, frame):
        logger.info(f"master got signal {signum}; stopping")
        master.stop()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    reason = master.run()
    # what the master last heard from the workers: the newest global
    # step and the goodput reports, rolled up
    logger.info(
        f"master exiting: {reason}; global step "
        f"{master.speed_monitor.completed_global_step}; goodput "
        f"{json.dumps(master.telemetry.fleet_goodput())}"
    )
    return 0 if reason == "succeeded" else 1


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
