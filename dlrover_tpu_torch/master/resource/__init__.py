"""Job-level resource optimization (parity: dlrover/python/master/resource/)."""

from dlrover_tpu_torch.master.resource.optimizer import (  # noqa: F401
    JobResourceOptimizer,
    ResourcePlan,
)
