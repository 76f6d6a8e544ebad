"""Data-driven sequence-parallel scheme selection (the port of
``dlrover_tpu/parallel/sp_select.py``): the same rule, the same tie
margin, and a table measured on the port's own card.

``MEASURED_MS`` is each scheme's per-device attention forward ms,
compute only, at sp = 4, H = 16, D = 128, bf16, causal, one row
(``chip_smoke.py --phase sp``, its ``sp_select`` line): one process
runs one device's work of each scheme, the ring's the busiest rank's
(all four hops of the last sequence block, each an ``fa_fwd`` launch at
its offsets, merged in f32), Ulysses' one ``fa_fwd`` over the whole
sequence for 16 / 4 heads; device times from a replayed CUDA graph.
The busiest ring rank attends 1.75x Ulysses' pairs and merges four
partials, so Ulysses wins on compute at both lengths. The communication
that the table cannot time
differs by scheme: the ring's hops overlap the next hop's kernel, and
Ulysses' two all-to-alls do not, so ties break to the ring.
"""

from __future__ import annotations

from typing import Dict

# seq -> scheme -> per-device attention ms; NVIDIA H100 80GB HBM3, power
# limit 700.00 W (nvidia-smi), chip_smoke.py's sp phase
MEASURED_MS: Dict[int, Dict[str, float]] = {
    4096: {"ring": 0.32321, "ulysses": 0.087689},
    8192: {"ring": 0.72366, "ulysses": 0.17799},
}

# ring's comm overlaps compute, ulysses' all-to-alls do not: a scheme
# must beat ring by this margin on compute before the table flips
_TIE_MARGIN = 0.9


def pick_sp_scheme(seq_len: int) -> str:
    """Scheme for a global sequence length, from the measured table (the
    nearest measured seq; measured at sp=4, other degrees reuse the
    nearest row). Returns ``"ring"`` or ``"ulysses"``."""
    if not MEASURED_MS:
        return "ring"
    nearest = min(MEASURED_MS, key=lambda s: abs(s - seq_len))
    row = MEASURED_MS[nearest]
    if row.get("ulysses", 1e9) < row.get("ring", 1e9) * _TIE_MARGIN:
        return "ulysses"
    return "ring"
