"""Hopper kernels + optimizer math (counterpart of ``dlrover_tpu/ops``):
``flash_attention`` (CUDA C++) and ``quantized_optim`` (Triton).

Kernels build at first use, never at import (``ops/_build.py``). The
submodules are not re-exported here, so ``ops.flash_attention`` names
the module, never the function of the same name."""
