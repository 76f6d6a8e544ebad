"""Device selection for the port (counterpart of
``dlrover_tpu/utils/device.py``).

The port runs on the card. The CPU is taken only when the caller names
it, as the tests do: a missing card is an error, never a quiet move to
the CPU. Under the launcher each worker trains on the card of its local
rank: ``init_elastic`` makes that card the current one before anything
touches CUDA, and ``resolve_device(None)`` answers the current card.
"""

from __future__ import annotations

import os
import subprocess
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

# torch is imported where a device is resolved: the launcher checks the
# spec and counts cards without importing it
DeviceSpec = Optional[Union[str, "torch.device"]]

DEVICE_SPEC_ENV = "DLROVER_TPU_DEVICE_SPEC"
DEVICE_SPECS = ("cpu", "cuda")


def resolve_device(devices: DeviceSpec = None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` -> the CPU;
    ``"cuda[:N]"`` or a ``torch.device`` as given. Raises when a CUDA
    device is asked for (explicitly or by default) and no card is
    present."""
    import torch

    dev = torch.device("cuda" if devices is None else devices)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass devices='cpu' to run "
                "the port's plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {devices!r}")
    return dev


def configure_devices(spec: str = "") -> str:
    """Check a device spec (``DLROVER_TPU_DEVICE_SPEC`` when ``spec`` is
    empty): ``"cpu"``, ``"cuda"`` or empty (the card). Returns it. The
    JAX package's spec also sizes a virtual CPU mesh (``"cpu:8"``); a
    port worker is one process on one device, so its spec names only
    the device's type."""
    spec = spec or os.getenv(DEVICE_SPEC_ENV, "")
    if spec and spec not in DEVICE_SPECS:
        raise ValueError(
            f"unknown device spec {spec!r}: the port takes "
            f"{' or '.join(DEVICE_SPECS)}"
        )
    return spec


def local_device_count(spec: str = "") -> int:
    """Locally visible card count for ``--auto-config``: the entries of
    ``CUDA_VISIBLE_DEVICES`` when it is set, else the ``GPU`` lines of
    ``nvidia-smi -L``, run in a subprocess so that the launcher never
    initializes CUDA itself. 0 for the CPU spec (``--nproc-per-node``
    then stands) and when probing fails."""
    from dlrover_tpu_torch.common.log import default_logger as logger

    if configure_devices(spec) == "cpu":
        return 0
    visible = os.getenv("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    try:
        p = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60
        )
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"device probe failed: {e!r}")
        return 0
    if p.returncode != 0:
        logger.warning(
            f"device probe failed (rc={p.returncode}): {p.stderr[-500:]}"
        )
        return 0
    return sum(line.startswith("GPU ") for line in p.stdout.splitlines())
