"""Decoder-only transformer in PyTorch (counterpart of
``dlrover_tpu/models/transformer.py``), dense path.

The parameters are one ``nn.Module`` whose names and shapes are the JAX
package's leaves (``embed.tokens [V,D]``, ``layers.{i}.attn.wq
[D,H,K]``, ``wo [H,K,D]``, ...), so weights convert leaf for leaf
(``models/convert.py``). The forward keeps the JAX functions and their
names: params in ``cfg.param_dtype``, matmuls in ``cfg.dtype``,
normalization and softmax in f32, and attention through the flash
kernels on ``[B,H,T,D]`` straight from the projection einsums.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: MoE layers (A11), sequence parallelism over a mesh (A10),
``remat`` and ``scan_layers`` (A2), ``int8_mlp`` (A12).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.ops.flash_attention import flash_attention


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def check_supported(cfg: TransformerConfig, mesh=None) -> None:
    """Raise for the configuration switches the port does not run yet."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP A11)")
    if mesh is not None:
        raise NotImplementedError(
            "meshes / sequence parallelism are not ported yet (ROADMAP A10)"
        )
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP A2)")
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers is not ported yet (ROADMAP A2)")
    if cfg.int8_mlp:
        raise NotImplementedError("int8_mlp is not ported yet (ROADMAP A12)")


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, make):
        super().__init__()
        d, h, kvh, hd = cfg.model_dim, cfg.num_heads, cfg.kv_heads, cfg.head_dim
        f = cfg.ffn_dim
        self.attn_norm = nn.ParameterDict({"scale": make("ones", (d,))})
        self.mlp_norm = nn.ParameterDict({"scale": make("ones", (d,))})
        if not cfg.rmsnorm:
            self.attn_norm["bias"] = make("zeros", (d,))
            self.mlp_norm["bias"] = make("zeros", (d,))
        self.attn = nn.ParameterDict(
            {
                "wq": make("dense", (d, h, hd), d),
                "wk": make("dense", (d, kvh, hd), d),
                "wv": make("dense", (d, kvh, hd), d),
                "wo": make("dense", (h, hd, d), h * hd),
            }
        )
        if cfg.swiglu:
            self.mlp = nn.ParameterDict(
                {
                    "w_gate": make("dense", (d, f), d),
                    "w_up": make("dense", (d, f), d),
                    "w_down": make("dense", (f, d), f),
                }
            )
        else:
            self.mlp = nn.ParameterDict(
                {
                    "w_up": make("dense", (d, f), d),
                    "b_up": make("zeros", (f,)),
                    "w_down": make("dense", (f, d), f),
                    "b_down": make("zeros", (d,)),
                }
            )


class Transformer(nn.Module):
    """The parameter tree (see the module docstring); the model runs
    through the free function ``forward``."""

    def __init__(
        self,
        cfg: TransformerConfig,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pd = _torch_dtype(cfg.param_dtype)

        def make(kind, shape, fan_in=None):
            # drawn on the CPU from the explicit generator, then moved:
            # the same seed gives the same weights on every device
            if kind == "dense" and generator is not None:
                w = torch.randn(shape, generator=generator) * fan_in**-0.5
            elif kind == "ones":
                w = torch.ones(shape)
            else:
                w = torch.zeros(shape)
            return nn.Parameter(w.to(device=device, dtype=pd))

        d = cfg.model_dim
        self.embed = nn.ParameterDict(
            {"tokens": make("dense", (cfg.vocab_size, d), d)}
        )
        self.final_norm = nn.ParameterDict({"scale": make("ones", (d,))})
        if not cfg.rmsnorm:
            self.final_norm["bias"] = make("zeros", (d,))
        if not cfg.rope:
            self.embed["positions"] = make("dense", (cfg.max_seq_len, d), d)
        if not cfg.tie_embeddings:
            self.lm_head = make("dense", (d, cfg.vocab_size), d)
        self.layers = nn.ModuleList(
            [_Layer(cfg, make) for _ in range(cfg.num_layers)]
        )

    def jax_ordered_parameters(self):
        """Parameters in the JAX package's pytree flatten order (dict
        keys sorted, layers in order) — the leaf order of the flat
        optimizer's layout."""

        def key(item):
            return tuple(
                int(p) if p.isdigit() else p for p in item[0].split(".")
            )

        return [p for _, p in sorted(self.named_parameters(), key=key)]


def init_params(
    generator: torch.Generator, cfg: TransformerConfig, device=None
) -> Transformer:
    """Random weights from an explicit generator (the port of
    ``init_params(key, cfg)``): dense ``N(0, 1/fan_in)``, norm scales 1,
    biases 0."""
    return Transformer(cfg, generator=generator, device=device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _norm(x, p, cfg: TransformerConfig):
    xf = x.float()
    if cfg.rmsnorm:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _rope(x, positions, theta: float, layout: str = "bthd"):
    """Rotate pairs (d, d+D/2). x: [B,T,H,D] or [B,H,T,D] per layout."""
    half = x.shape[-1] // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions[:, :, None].float() * freqs  # [B,T,half]
    if layout == "bhtd":
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    else:
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def _causal_attention(q, k, v, layout: str = "bthd"):
    """Single-device causal attention through the flash kernels."""
    return flash_attention(q, k, v, causal=True, layout=layout)


def _attention_block(x, layer, cfg: TransformerConfig, positions):
    """The ``bhtd`` (no sequence parallelism) branch of the JAX block."""
    h = _norm(x, layer.attn_norm, cfg)
    a = layer.attn
    q = torch.einsum("btd,dhk->bhtk", h, a["wq"].to(h.dtype))
    k = torch.einsum("btd,dhk->bhtk", h, a["wk"].to(h.dtype))
    v = torch.einsum("btd,dhk->bhtk", h, a["wv"].to(h.dtype))
    if cfg.rope:
        q = _rope(q, positions, cfg.rope_theta, "bhtd")
        k = _rope(k, positions, cfg.rope_theta, "bhtd")
    if cfg.mup_attn_scale is not None:
        # muP 1/d attention folded into q: the kernels keep 1/sqrt(d)
        q = q * (cfg.mup_attn_scale * cfg.head_dim**0.5)
    o = _causal_attention(q, k, v, layout="bhtd")
    return x + torch.einsum("bhtk,hkd->btd", o, a["wo"].to(o.dtype))


def _zero_aux(device=None) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"balance": z, "z": z}


def _mlp_block(x, layer, cfg: TransformerConfig):
    h = _norm(x, layer.mlp_norm, cfg)
    mlp = layer.mlp

    def mm(a, w):
        return a @ w.to(a.dtype)

    if cfg.swiglu:
        z = F.silu(mm(h, mlp["w_gate"])) * mm(h, mlp["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        z = F.gelu(mm(h, mlp["w_up"]) + mlp["b_up"].to(h.dtype), approximate="tanh")
    out = mm(z, mlp["w_down"])
    if not cfg.swiglu:
        out = out + mlp["b_down"].to(h.dtype)
    return x + out


def embed_tokens(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B,T] -> residual stream [B,T,D] (token + learned positions)."""
    dt = _torch_dtype(cfg.dtype)
    T = tokens.shape[-1]
    x = F.embedding(tokens, params.embed["tokens"].to(dt))
    if not cfg.rope:
        x = x + params.embed["positions"].to(dt)[:T][None]
    return x


def lm_head(params: Transformer, x: torch.Tensor, cfg: TransformerConfig):
    """final residual [B,T,D] -> logits [B,T,vocab] f32 (incl. final norm)."""
    dt = _torch_dtype(cfg.dtype)
    x = _norm(x, params.final_norm, cfg)
    if cfg.tie_embeddings:
        logits = x @ params.embed["tokens"].to(dt).t()
    else:
        logits = x @ params.lm_head.to(dt)
    logits = logits.float()
    if cfg.mup_output_mult != 1.0:
        logits = logits * cfg.mup_output_mult
    return logits


def token_nll(logits: torch.Tensor, targets: torch.Tensor):
    """Mean next-token negative log-likelihood, as
    ``logsumexp(logits) - logits[target]``."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tgt).mean()


def forward(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B,T] -> (logits [B,T,vocab] f32, aux dict of zeros — the
    dense model has no MoE losses)."""
    check_supported(cfg, mesh)
    B, T = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    for layer in params.layers:
        x = _attention_block(x, layer, cfg, positions)
        x = _mlp_block(x, layer, cfg)
    return lm_head(params, x, cfg), _zero_aux(x.device)


def loss_fn(
    params: Transformer,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    mesh=None,
):
    """Mean NLL (the dense model's MoE aux losses are zero)."""
    logits, _ = forward(params, tokens, cfg, mesh)
    return token_nll(logits, targets)
