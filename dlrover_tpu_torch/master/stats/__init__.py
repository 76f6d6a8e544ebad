"""Master-side job statistics (parity: dlrover/python/master/stats/)."""

from dlrover_tpu_torch.master.stats.collector import (  # noqa: F401
    JobMetricCollector,
)
