"""ZeRO's params sharded through the step, on the card. Marked ``cuda``;
on a host without a card every test skips (the per-unit gather's CPU
tests are ``tests/test_torch_zero_units.py``).

Two gloo ranks on the card run ``chip_smoke.py``'s C3 case (Llama-2
width, 4 layers, 1 x 4096 a rank, per-leaf ``adamw_8bit``, ZeRO dp=1 x
fsdp=2, 3 steps): the measured peak (``max_memory_allocated`` over the
steps, the resident state included) is within ``PEAK_CAL_RTOL`` of
``accel/dry_runner.static_peak_bytes``."""

import math

import pytest
import torch

import torch_dist_worker as tdw

pytestmark = pytest.mark.cuda
PEAK_CAL_RTOL = 0.05  # chip_smoke.py's, for any static peak against its measured one


def test_zero_peak_within_the_static_figure(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the peak is the card's allocator's")
    ranks = tdw.run_ranks("zero_peak", 2, {"zero": dict(mesh=dict(fsdp=2))}, str(tmp_path))
    for r in ranks:
        z = r["zero"]
        assert z["zero"] and all(math.isfinite(x) for x in z["losses"])
        assert abs(z["static_bytes"] / z["peak_bytes"] - 1) <= PEAK_CAL_RTOL
