"""Model-family configs (a copy of ``dlrover_tpu/models/config.py``).

One config dataclass switches the architectural differences of GPT-2
and Llama-2 (learned vs rotary positions, LayerNorm vs RMSNorm,
GELU-MLP vs SwiGLU, MHA vs GQA, optional MoE blocks). The fields and
defaults are the JAX package's, so one config drives both packages;
the port's model raises on the switches it does not run yet
(``models/transformer.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    model_dim: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # None => MHA
    mlp_dim: Optional[int] = None  # None => 4*model_dim (gpt) / swiglu dim
    max_seq_len: int = 1024
    # architecture switches
    rope: bool = False  # False => learned positional embeddings
    rope_theta: float = 10000.0
    rmsnorm: bool = False
    swiglu: bool = False
    tie_embeddings: bool = True
    # MoE: every `moe_every`-th block uses an expert FFN
    num_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    capacity_splits: tuple = ()
    moe_top_k: int = 1
    router_z_weight: float = 1e-3
    # sequence-parallel attention scheme when the mesh has sp > 1
    sp_scheme: str = "ring"
    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = False  # checkpoint each block (HBM <-> FLOPs trade)
    scan_layers: bool = False
    # muP forward multipliers (defaults = standard parametrization)
    mup_attn_scale: Optional[float] = None  # None => 1/sqrt(head_dim)
    mup_output_mult: float = 1.0
    int8_mlp: bool = False

    def __post_init__(self):
        if self.scan_layers and self.num_experts:
            raise ValueError(
                "scan_layers needs homogeneous blocks; MoE interleave "
                "(num_experts > 0) makes every moe_every-th block a "
                "different pytree"
            )

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads

    @property
    def ffn_dim(self) -> int:
        if self.mlp_dim:
            return self.mlp_dim
        return 4 * self.model_dim


def gpt2_small() -> TransformerConfig:
    return TransformerConfig()


def gpt2_xl() -> TransformerConfig:
    """GPT-2 xl 1.5B."""
    return TransformerConfig(
        num_layers=48, model_dim=1600, num_heads=25, max_seq_len=1024
    )


def llama2_7b() -> TransformerConfig:
    """Llama-2-7B."""
    return TransformerConfig(
        vocab_size=32000,
        num_layers=32,
        model_dim=4096,
        num_heads=32,
        num_kv_heads=32,
        mlp_dim=11008,
        max_seq_len=4096,
        rope=True,
        rmsnorm=True,
        swiglu=True,
        tie_embeddings=False,
    )


def is_moe_layer(cfg: TransformerConfig, i: int) -> bool:
    """Block ``i`` carries an expert FFN (the JAX package's placement
    rule, kept identical so converted checkpoints line up)."""
    return bool(
        cfg.num_experts and i % cfg.moe_every == cfg.moe_every - 1
    )


def tiny(**overrides) -> TransformerConfig:
    """Test config: small every-feature model."""
    cfg = TransformerConfig(
        vocab_size=256,
        num_layers=2,
        model_dim=32,
        num_heads=4,
        num_kv_heads=2,
        mlp_dim=64,
        max_seq_len=64,
        rope=True,
        rmsnorm=True,
        swiglu=True,
        tie_embeddings=False,
        dtype="float32",
    )
    return replace(cfg, **overrides)
