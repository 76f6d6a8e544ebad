"""Parallelism on ``torch.distributed`` (the port of
``dlrover_tpu/parallel``): the named-axis mesh over the ranks
(``mesh.py``), the bucketed gradient sync (``grad_sync.py``), the
measured link-cost model (``topology.py``), the SDC detector's per-lane
fence (``sdc.py``), sequence parallelism (``ring_attention.py``,
``ulysses.py``), the tensor- and expert-parallel layouts
(``sharding_rules.py``), MoE layers over the ep group (``moe.py``, with
the all-to-all it shares with Ulysses, ``collectives.py``), pipeline
parallelism over the pp group (``pipeline.py``), the host-link
arbiter (``transfer_sched.py``) and the int8 wire of the bulk movers
(``wire_format.py``)."""

from dlrover_tpu_torch.parallel.grad_sync import (  # noqa: F401
    BucketPlan,
    plan_buckets,
)
from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    build_mesh,
)
from dlrover_tpu_torch.parallel.topology import (  # noqa: F401
    LinkModel,
    get_link_model,
    probe_link_model,
)
from dlrover_tpu_torch.parallel.transfer_sched import (  # noqa: F401
    Priority,
    StripedTransfer,
    TransferArbiter,
    get_arbiter,
)
