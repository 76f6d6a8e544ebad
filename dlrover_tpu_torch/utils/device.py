"""Device selection for the port (counterpart of
``dlrover_tpu/utils/device.py``).

The port runs on the card. The CPU is taken only when the caller names
it, as the tests do: a missing card is an error, never a quiet move to
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceSpec = Optional[Union[str, torch.device]]


def resolve_device(devices: DeviceSpec = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cpu"`` -> the CPU; ``"cuda[:N]"`` or a
    ``torch.device`` as given. Raises when a CUDA device is asked for
    (explicitly or by default) and no card is present."""
    dev = torch.device("cuda:0" if devices is None else devices)
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
