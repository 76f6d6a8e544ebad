"""dlrover-tpu on PyTorch and CUDA: the port of ``dlrover_tpu`` to an
NVIDIA Hopper card.

The package mirrors ``dlrover_tpu``'s module paths, so each module's
counterpart is found by name, and keeps PyTorch idiom inside:

- the model is one ``nn.Module`` whose parameters carry the JAX
  package's leaf names and shapes (``models/transformer.py``), so
  weights convert leaf for leaf (``models/convert.py``);
- every Pallas kernel of the ported path is a kernel written by hand
  for ``sm_90a``: flash attention forward and backward in CUDA C++
  (``ops/csrc/flash_attention.cu``) and the fused 8-bit AdamW update
  in Triton (``ops/quantized_optim.py``). Each has a plain PyTorch
  version beside it, taken only for tensors that lie on the CPU;
- nothing here imports ``jax`` or ``dlrover_tpu``: what the port needs
  of a JAX-free module there is copied, not imported.

Entry points run on the card unless the caller asks for the CPU
(``devices="cpu"``), as the tests do.
"""

__version__ = "0.1.0"
