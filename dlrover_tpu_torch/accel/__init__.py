"""Strategies (the port of ``dlrover_tpu/accel``): ``Strategy``, the
recipe a trainer builds its mesh and gradient sync from. The search
that picks one (``auto_accelerate``, the dry runner, the optimization
library) is ROADMAP A9."""

from dlrover_tpu_torch.accel.strategy import Strategy  # noqa: F401
