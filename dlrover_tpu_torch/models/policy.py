"""Mixed-precision policy system (a copy of
``dlrover_tpu/models/policy.py``, on the port's own config).

Parity: atorch's AMP optimization (auto/opt_lib amp_optimization +
amp/amp.py apex/native glue, SURVEY §2.3 "AMP / misc"). The TPU story is
simpler by hardware design — bf16 has fp32's exponent range, so there is
no GradScaler/inf-check machinery to port; a policy is just which dtype
each role uses:

- ``param_dtype``  — master weights (and optimizer state);
- ``compute_dtype`` — matmul/activation dtype (MXU native bf16).

Logits, losses and normalization statistics are ALWAYS fp32 — that is
the model's numerics contract (transformer.py), not a policy knob, so
there is deliberately no "output" role here.

Policies parse from the haiku/jmp-style string form
(``"params=float32,compute=bfloat16"``) or a preset name, and apply
onto a ``TransformerConfig``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

from dlrover_tpu_torch.models.config import TransformerConfig

_ALIASES = {
    "f32": "float32",
    "fp32": "float32",
    "float32": "float32",
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
    "f16": "float16",
    "fp16": "float16",
    "float16": "float16",
}


@dataclass(frozen=True)
class MixedPrecisionPolicy:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @staticmethod
    def parse(spec: str) -> "MixedPrecisionPolicy":
        """``"params=f32,compute=bf16"`` (any subset; jmp conventions)
        or a preset name."""
        if spec in PRESETS:
            return PRESETS[spec]
        kw: Dict[str, str] = {}
        for part in spec.split(","):
            if not part.strip():
                continue
            key, _, value = part.partition("=")
            key = key.strip().rstrip("s")  # "params" → "param"
            value = _ALIASES.get(value.strip())
            if value is None:
                raise ValueError(f"unknown dtype in policy: {part!r}")
            if key == "param":
                kw["param_dtype"] = value
            elif key == "compute":
                kw["compute_dtype"] = value
            else:
                raise ValueError(
                    f"unknown policy role: {part!r} (logits are always "
                    f"fp32; only params/compute are policy knobs)"
                )
        return MixedPrecisionPolicy(**kw)

    def apply(self, cfg: TransformerConfig) -> TransformerConfig:
        """Stamp the policy onto a model config. (The model computes
        norm/softmax statistics in fp32 regardless — that is the
        numerics contract, not a policy knob.)"""
        return replace(
            cfg, dtype=self.compute_dtype, param_dtype=self.param_dtype
        )

    def describe(self) -> str:
        return f"params={self.param_dtype},compute={self.compute_dtype}"


PRESETS = {
    # the TPU default: fp32 master weights, bf16 MXU compute
    "mixed_bf16": MixedPrecisionPolicy(),
    # everything fp32 (debugging / CPU tests)
    "full_fp32": MixedPrecisionPolicy(
        param_dtype="float32", compute_dtype="float32"
    ),
    # memory-lean: bf16 weights too (half the param HBM; fine for
    # inference and for large models whose optimizer keeps fp32 copies)
    "full_bf16": MixedPrecisionPolicy(
        param_dtype="bfloat16", compute_dtype="bfloat16"
    ),
}
