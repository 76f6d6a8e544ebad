"""Agent-side network check: run the paired health-check rendezvous twice,
report timings, learn which hosts are faulty/straggling (a copy of
``dlrover_tpu/agent/node_check_agent.py`` whose rounds run
``trainer/node_check/gpu_check.py``).

Parity: dlrover/python/elastic_agent/torch/training.py:799
(NetworkCheckElasticAgent) + :1014 (run_network_check) — two rounds with
different partners (master pairs them, rdzv_manager.py:353) bisect a bad
host with no healthy-host false positives.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import time
from typing import Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training_agent import ElasticTrainingAgent, WorkerSpec
from dlrover_tpu_torch.common.constants import RendezvousName, TrainerEnv
from dlrover_tpu_torch.common.log import default_logger as logger

CHECK_TIMEOUT_SECS = 300


class _NodeCheckAgent(ElasticTrainingAgent):
    """Reuses the rendezvous + process plumbing to run one check round."""

    def run_round(self, result_file: str) -> Tuple[bool, float]:
        world = self._rendezvous(timeout=CHECK_TIMEOUT_SECS)
        self._spec.env[TrainerEnv.CHECK_RESULT_FILE] = result_file
        self._start_workers(world)
        try:
            deadline = time.time() + CHECK_TIMEOUT_SECS
            while time.time() < deadline:
                state = self._monitor_workers()
                if state.value != "HEALTHY":
                    break
                time.sleep(0.5)
            else:
                return False, CHECK_TIMEOUT_SECS
            success = state.value == "SUCCEEDED"
            elapsed = 0.0
            for path in glob.glob(f"{result_file}.*"):
                try:
                    with open(path) as f:
                        elapsed = max(elapsed, json.load(f)["elapsed"])
                except (OSError, ValueError, KeyError):
                    success = False
            return success, elapsed
        finally:
            # always reap: a peer-failed round leaves survivors blocked in
            # a collective; leaking them would poison the next round (and
            # they hold the card)
            self._stop_workers()


def run_network_check(
    node_rank: int,
    nproc_per_node: int,
    client: MasterClient,
    device_spec: str = "",
    rounds: int = 2,
    exclude_straggler: bool = False,
) -> bool:
    """Returns True if THIS node passes the check.

    ``exclude_straggler``: treat a straggler verdict like a fault (the
    reference's ``--exclude-straggler``, elastic_run.py flag): a slow
    host leaves the job instead of dragging every synchronous collective
    down to its pace. Default keeps stragglers (warn only), as the JAX
    package does."""
    check_script = os.path.join(
        os.path.dirname(__file__), "..", "trainer", "node_check", "gpu_check.py"
    )
    check_script = os.path.abspath(check_script)
    spec = WorkerSpec(
        entrypoint=check_script,
        nproc_per_node=nproc_per_node,
        rdzv_name=RendezvousName.NETWORK_CHECK,
        device_spec=device_spec,
        env={},
    )
    agent = _NodeCheckAgent(node_rank=node_rank, spec=spec, client=client)
    with tempfile.TemporaryDirectory(prefix="dlrover_tpu_check_") as tmpdir:
        for rnd in range(rounds):
            result_file = os.path.join(tmpdir, f"round{rnd}")
            success, elapsed = agent.run_round(result_file)
            logger.info(
                f"node {node_rank} check round {rnd}: "
                f"success={success} elapsed={elapsed:.3f}s"
            )
            client.report_network_check_result(node_rank, success, elapsed)
            # wait until the master has everyone's report for this round
            deadline = time.time() + CHECK_TIMEOUT_SECS
            while time.time() < deadline:
                _, reason = client.check_fault_node()
                if reason != "not_all_reported":
                    break
                time.sleep(0.5)
    faults, _ = client.check_fault_node()
    stragglers, _ = client.check_straggler()
    return check_verdict(node_rank, faults, stragglers, exclude_straggler)


def check_verdict(
    node_rank: int,
    faults,
    stragglers,
    exclude_straggler: bool,
) -> bool:
    """Does THIS node stay in the job after the health check?"""
    if stragglers:
        logger.warning(f"straggler hosts detected: {stragglers}")
    if node_rank in faults:
        logger.error(f"node {node_rank} is faulty (faults={faults})")
        return False
    if exclude_straggler and node_rank in stragglers:
        logger.error(
            f"node {node_rank} is a straggler and --exclude-straggler "
            f"is set; leaving the job"
        )
        return False
    return True
