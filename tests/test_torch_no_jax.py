"""The port stands alone: every module of dlrover_tpu_torch (and the
chip smoke script) imports in a fresh interpreter in which ``jax``,
``jaxlib`` and ``dlrover_tpu`` cannot be imported."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "dlrover_tpu")

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
print(len(names))
"""


def test_port_imports_with_jax_and_the_jax_package_blocked():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode == 0, p.stderr[-3000:]
    # every module of both slices: package inits, common, utils, models,
    # ops (attention, optimizer, embedding rows, the store and the device
    # tier), data (the sparse row pipeline), trainer (elastic and sparse)
    assert int(p.stdout.strip().splitlines()[-1]) >= 28


def test_probe_really_blocks():
    p = subprocess.run(
        [sys.executable, "-c", _PROBE.replace("import dlrover_tpu_torch\n", "import dlrover_tpu_torch\nimport dlrover_tpu.common.log\n", 1)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode != 0 and "blocked import of dlrover_tpu" in p.stderr
