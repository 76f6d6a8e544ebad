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

# data parallelism: the mesh, the gradient sync, the SDC fence and the
# strategy (ROADMAP A7)
DATA_PARALLEL = {
    "dlrover_tpu_torch.accel",
    "dlrover_tpu_torch.accel.strategy",
    "dlrover_tpu_torch.parallel",
    "dlrover_tpu_torch.parallel.grad_sync",
    "dlrover_tpu_torch.parallel.mesh",
    "dlrover_tpu_torch.parallel.sdc",
}


# the model and optimizer leftovers (ROADMAP A2, A4)
MODEL_LEFTOVERS = {
    "dlrover_tpu_torch.models.mup",
    "dlrover_tpu_torch.models.policy",
    "dlrover_tpu_torch.models.transformer",
    "dlrover_tpu_torch.ops.optimizers",
    "dlrover_tpu_torch.ops.quantized_optim",
}


# the strategy search, the link model, the step auditor and offload
# (ROADMAP A9)
STRATEGY_SEARCH = {
    "dlrover_tpu_torch.accel.accelerate",
    "dlrover_tpu_torch.accel.bayes",
    "dlrover_tpu_torch.accel.candidates",
    "dlrover_tpu_torch.accel.dry_runner",
    "dlrover_tpu_torch.accel.opt_lib",
    "dlrover_tpu_torch.accel.profiler",
    "dlrover_tpu_torch.obs.audit",
    "dlrover_tpu_torch.ops.host_offload",
    "dlrover_tpu_torch.parallel.topology",
}


# elastic resize through the restart path and ZeRO's per-unit gather
# (ROADMAP A8, C3)
RESIZE = {
    "dlrover_tpu_torch.accel.compile_cache",
    "dlrover_tpu_torch.models.train",
    "dlrover_tpu_torch.ops._build",
    "dlrover_tpu_torch.trainer.elastic.distributed",
    "dlrover_tpu_torch.trainer.elastic.trainer",
}


# sequence parallelism: the schemes, the scheme table, the mesh's sp group
SEQUENCE_PARALLEL = {
    "dlrover_tpu_torch.parallel.ring_attention",
    "dlrover_tpu_torch.parallel.ulysses",
    "dlrover_tpu_torch.parallel.sp_select",
    "dlrover_tpu_torch.parallel.mesh",
    "dlrover_tpu_torch.ops.flash_attention",
}


# tensor parallelism: the rule table and the tp layout, the model's tp
# collectives, the converter's boxes
TENSOR_PARALLEL = {
    "dlrover_tpu_torch.parallel.sharding_rules",
    "dlrover_tpu_torch.models.transformer",
    "dlrover_tpu_torch.models.convert",
    "dlrover_tpu_torch.ckpt.sharding",
}


# the host-link arbiter and its users (ROADMAP A9b)
LINK_ARBITER = {
    "dlrover_tpu_torch.parallel.transfer_sched",
    "dlrover_tpu_torch.ckpt.engine",
    "dlrover_tpu_torch.ops.embedding.device_tier",
    "dlrover_tpu_torch.trainer.elastic.trainer",
    "dlrover_tpu_torch.accel.dry_runner",
    "dlrover_tpu_torch.obs.audit",
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
    assert DATA_PARALLEL <= names, sorted(DATA_PARALLEL - names)
    assert MODEL_LEFTOVERS <= names, sorted(MODEL_LEFTOVERS - names)
    assert STRATEGY_SEARCH <= names, sorted(STRATEGY_SEARCH - names)
    assert RESIZE <= names, sorted(RESIZE - names)
    assert SEQUENCE_PARALLEL <= names, sorted(SEQUENCE_PARALLEL - names)
    assert TENSOR_PARALLEL <= names, sorted(TENSOR_PARALLEL - names)
    assert LINK_ARBITER <= names, sorted(LINK_ARBITER - names)


def test_data_parallel_modules_and_the_rank_worker_import_without_jax():
    """The data-parallel, strategy-search, resize, sequence- and
    tensor-parallel modules and the host-link arbiter's by name, and the
    rank processes of the multi-rank tests
    (``tests/torch_dist_worker.py``), with JAX and the JAX package
    blocked."""
    probe = _PROBE.split("import dlrover_tpu_torch\n")[0] + "\n".join(
        f"importlib.import_module({m!r})"
        for m in sorted(DATA_PARALLEL | STRATEGY_SEARCH | RESIZE | SEQUENCE_PARALLEL
                        | TENSOR_PARALLEL | LINK_ARBITER)
    ) + (
        "\nsys.path.insert(0, 'tests')\nimportlib.import_module('torch_dist_worker')"
        "\nleaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)"
        "\nassert not leaked, leaked\n"
    )
    p = subprocess.run(
        [sys.executable, "-c", probe],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode == 0, p.stderr[-3000:]


def test_probe_really_blocks():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE.replace("import dlrover_tpu_torch\n", "import dlrover_tpu_torch\nimport dlrover_tpu.common.log\n", 1)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode != 0 and "blocked import of dlrover_tpu" in p.stderr
