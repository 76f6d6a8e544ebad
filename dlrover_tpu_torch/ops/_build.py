"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, bound with ``ctypes``. Nothing
builds at import time: a library builds at first use into the build
directory, named by a hash of its source and flags, so an unchanged
source is never rebuilt there. The directory is
``$DLROVER_TPU_KERNEL_BUILD_DIR`` when set (``enable_compile_cache``
sets it to the job-stable compile cache, so a relaunched or
replacement worker loads what an earlier one built), else ``ops/_build/``
in the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
BUILD_DIR_ENV = "DLROVER_TPU_KERNEL_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report registers, shared memory and spills
)

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's report (registers, spills) of each library built by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cands = []
    if os.getenv("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from source on the machine with the card"
    )


def build_dir_in_use() -> Path:
    """Where the libraries build: ``$DLROVER_TPU_KERNEL_BUILD_DIR``, else
    the checkout's ``ops/_build/``."""
    env = os.getenv(BUILD_DIR_ENV, "")
    return Path(env) if env else BUILD_DIR


def load_library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use.
    Raises with the compiler's output if the build fails."""
    lib = _libs.get(name)
    if lib is None:
        src = SRC_DIR / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        build_dir = build_dir_in_use()
        out = build_dir / f"lib{name}_{h.hexdigest()[:16]}.so"
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            # built under a name of this process's and renamed: workers
            # sharing the directory never load a half-written library
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            build_logs[name] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{build_logs[name]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib
