"""The port stands alone: every module of dlrover_tpu_torch (and the
chip smoke script) imports in a fresh interpreter in which ``jax``,
``jaxlib``, ``dlrover_tpu`` and ``grpc`` cannot be imported (the card's
host has no ``grpc``: the port's control plane speaks plain TCP)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "dlrover_tpu", "grpc")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())

import dlrover_tpu_torch
import dlrover_tpu_torch.ops.embedding.device_tier
import dlrover_tpu_torch.trainer.sparse
names = ["dlrover_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(dlrover_tpu_torch.__path__, "dlrover_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""

# the flash checkpoint slice's modules, which must be among them
CKPT_SLICE = {
    "dlrover_tpu_torch.ckpt",
    "dlrover_tpu_torch.ckpt.checkpointer",
    "dlrover_tpu_torch.ckpt.engine",
    "dlrover_tpu_torch.ckpt.saver",
    "dlrover_tpu_torch.ckpt.sharding",
    "dlrover_tpu_torch.ckpt.shm_handler",
    "dlrover_tpu_torch.common.multi_process",
    "dlrover_tpu_torch.common.faults",
    "dlrover_tpu_torch.common.storage",
    "dlrover_tpu_torch.obs.metrics",
    "dlrover_tpu_torch.obs.trace",
    "dlrover_tpu_torch.data.prefetch",
}

# the worker's side of the control loop: telemetry, the node check
WORKER_LOOP = {
    "dlrover_tpu_torch.agent.node_check_agent",
    "dlrover_tpu_torch.obs.flight_recorder",
    "dlrover_tpu_torch.obs.goodput",
    "dlrover_tpu_torch.obs.metrics",
    "dlrover_tpu_torch.obs.trace",
    "dlrover_tpu_torch.trainer.elastic.trainer",
    "dlrover_tpu_torch.trainer.node_check",
    "dlrover_tpu_torch.trainer.node_check.gpu_check",
    "dlrover_tpu_torch.trainer.sparse",
}

# the launcher, agent, master and distributed init (ROADMAP A6)
CONTROL_PLANE = {
    "dlrover_tpu_torch.agent.aggregator",
    "dlrover_tpu_torch.agent.master_client",
    "dlrover_tpu_torch.agent.monitor",
    "dlrover_tpu_torch.agent.training_agent",
    "dlrover_tpu_torch.common.comm",
    "dlrover_tpu_torch.common.constants",
    "dlrover_tpu_torch.common.daemon",
    "dlrover_tpu_torch.common.global_context",
    "dlrover_tpu_torch.common.node",
    "dlrover_tpu_torch.common.telemetry_delta",
    "dlrover_tpu_torch.master.elastic_ps",
    "dlrover_tpu_torch.master.job_auto_scaler",
    "dlrover_tpu_torch.master.job_manager",
    "dlrover_tpu_torch.master.kv_store",
    "dlrover_tpu_torch.master.local_master",
    "dlrover_tpu_torch.master.main",
    "dlrover_tpu_torch.master.monitor.speed_monitor",
    "dlrover_tpu_torch.master.paral_config",
    "dlrover_tpu_torch.master.rdzv_manager",
    "dlrover_tpu_torch.master.resource.optimizer",
    "dlrover_tpu_torch.master.scaler",
    "dlrover_tpu_torch.master.servicer",
    "dlrover_tpu_torch.master.shard.dataset_splitter",
    "dlrover_tpu_torch.master.shard.task_manager",
    "dlrover_tpu_torch.master.state",
    "dlrover_tpu_torch.master.stats.collector",
    "dlrover_tpu_torch.master.sync_service",
    "dlrover_tpu_torch.obs.aggregate",
    "dlrover_tpu_torch.obs.goodput",
    "dlrover_tpu_torch.trainer.elastic.distributed",
    "dlrover_tpu_torch.trainer.run",
    "dlrover_tpu_torch.utils.env",
}


def test_port_imports_with_jax_and_the_jax_package_blocked():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode == 0, p.stderr[-3000:]
    # every module of the slices: package inits, common, utils, models,
    # ops (attention, optimizer, embedding rows, the store and the device
    # tier), data (the sparse row pipeline, the prefetcher), trainer
    # (elastic and sparse, the node check), ckpt and obs, and the
    # control plane
    names = set(p.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 70
    assert CKPT_SLICE <= names, sorted(CKPT_SLICE - names)
    assert CONTROL_PLANE <= names, sorted(CONTROL_PLANE - names)
    assert WORKER_LOOP <= names, sorted(WORKER_LOOP - names)


def test_probe_really_blocks():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE.replace("import dlrover_tpu_torch\n", "import dlrover_tpu_torch\nimport dlrover_tpu.common.log\n", 1)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode != 0 and "blocked import of dlrover_tpu" in p.stderr
