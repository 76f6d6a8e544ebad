"""The goodput taxonomy and formula (the part of
``dlrover_tpu/obs/goodput.py`` that the master's telemetry aggregator
reads: ``CATEGORIES`` and ``compute_goodput_pct``).

Every second of job wall time belongs to one category, in priority
order (an instant claimed by a higher row is subtracted from every lower
row); "other" is the remainder and closes the partition. The workers'
ledger, which books the categories from the span stream, is not ported
yet (ROADMAP A6, the rest of the trainer loop): until it is, the
aggregator sees no goodput scalars from the port's workers.
"""

from __future__ import annotations

# the closed taxonomy, in priority order (highest claim first)
CATEGORIES = (
    "eviction",
    "resize_downtime",
    "restart_replay",
    "ckpt_block",
    "data_stall",
    "comm_exposed",
    "productive_compute",
    "degraded",
    "serving_soak",
    "other",
)


def compute_goodput_pct(productive_s: float, wall_s: float) -> float:
    """The one shared goodput formula."""
    if wall_s <= 0:
        return 0.0
    return 100.0 * max(0.0, productive_s) / wall_s
