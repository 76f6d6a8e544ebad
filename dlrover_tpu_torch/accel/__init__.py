"""Strategy search: the ``auto_accelerate`` analog (the port of
``dlrover_tpu/accel``).

A strategy is the mesh over the process group's ranks × remat ×
microbatching × the gradient sync's knobs × optimizer-state offload.
``auto_accelerate`` generates the candidates (``candidates.py``), scores
each statically (``dry_runner.compiled_cost``: the analytic cost model,
the sync priced from the measured link model, and a static estimate of
the step's peak memory that allocates nothing), times the finalists on
the card (``dry_runner.timed_run``), and builds the winner's step; the
optimization library (``opt_lib.py``) and the TPE search (``bayes.py``)
are the JAX package's. ``agree_strategy`` publishes rank 0's winner
through the master KV store.
"""

from dlrover_tpu_torch.accel.strategy import Strategy  # noqa: F401
from dlrover_tpu_torch.accel.candidates import candidate_strategies  # noqa: F401
from dlrover_tpu_torch.accel.dry_runner import DryRunReport, dry_run  # noqa: F401
from dlrover_tpu_torch.accel.opt_lib import (  # noqa: F401
    apply_optimizations,
    register_optimization,
    registered_optimizations,
)
from dlrover_tpu_torch.accel.accelerate import (  # noqa: F401
    AccelerateResult,
    agree_strategy,
    auto_accelerate,
)
