"""Decoder-only transformer in PyTorch (counterpart of
``dlrover_tpu/models/transformer.py``), dense path.

The parameters are one ``nn.Module`` whose names and shapes are the JAX
package's leaves (``embed.tokens [V,D]``, ``layers.{i}.attn.wq
[D,H,K]``, ``wo [H,K,D]``, ...), so weights convert leaf for leaf
(``models/convert.py``). The forward keeps the JAX functions and their
names: params in ``cfg.param_dtype``, matmuls in ``cfg.dtype``,
normalization and softmax in f32, and attention through the flash
kernels on ``[B,H,T,D]`` straight from the projection einsums.

``cfg.scan_layers`` keeps the layers stacked, as the JAX package's
``stack_layer_params`` does: one ``[L, ...]`` parameter a layer leaf
(``layers.attn.wq [L,D,H,K]``). The forward unbinds each stacked leaf
into per-layer views once, so the backward stacks the layers' grads
into the stacked parameter's grad in one operation. ``cfg.remat`` runs
each block under ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of ``jax.checkpoint(block)``: the backward recomputes the
block from its input, attention kernels included, on the same inputs.

``forward(..., gather=...)`` runs the model as units (the embedding,
each block, the head; the stacked blocks as one under ``scan_layers``)
so that ZeRO can hold a unit's full params only while it runs
(``models/train.ZeroUnits``, ``unit_parameters``).

Sequence parallelism (a mesh with ``sp > 1``; ``parallel/mesh``): each
rank runs the model on its block of the sequence
(``mesh.sequence_sharding``). Attention takes the ``bthd`` projections
and runs the ring or Ulysses (``cfg.sp_scheme``, with the JAX
``ValueError`` for an unknown one) over the ``sp`` group; RoPE rotates,
and the learned position table is read, at the block's global positions.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: MoE layers (A11), tensor parallelism and fsdp x sp (A10), expert
and pipeline parallelism (A11), ``int8_mlp`` (A12), the KV-cache decode
paths (A14).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.ops.flash_attention import flash_attention


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def check_supported(cfg: TransformerConfig, mesh=None) -> None:
    """Raise for the configuration switches the port does not run yet.
    ``mesh``: a ``parallel/mesh.Mesh`` or its ``MeshConfig``; data axes
    and sp run, a tp, ep or pp axis raises naming its ROADMAP item."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP A11)")
    if mesh is not None:
        m = getattr(mesh, "config", mesh)
        if m.tp > 1:
            raise NotImplementedError(
                "tensor parallelism is not ported yet (ROADMAP A10, its tp half)"
            )
        if m.ep > 1 or m.pp > 1:
            raise NotImplementedError(
                "expert / pipeline parallelism is not ported yet (ROADMAP A11)"
            )
        if m.sp > 1 and m.fsdp > 1:
            raise NotImplementedError(
                "fsdp x sp without tp is not ported yet (ROADMAP A10, its tp half)"
            )
    if cfg.int8_mlp:
        raise NotImplementedError("int8_mlp is not ported yet (ROADMAP A12)")


def _sp(mesh) -> int:
    return getattr(getattr(mesh, "config", mesh), "sp", 1) if mesh is not None else 1


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


_LAYER_PARTS = ("attn_norm", "mlp_norm", "attn", "mlp")


class _StackedLayers(nn.Module):
    """The ``scan_layers`` storage: each layer leaf stacked into one
    ``[L, ...]`` parameter, under the list layout's names without the
    layer index (``attn.wq``)."""

    def __init__(self, layers: List[_Layer]):
        super().__init__()
        for part in _LAYER_PARTS:
            setattr(self, part, nn.ParameterDict({
                k: nn.Parameter(torch.stack([getattr(l, part)[k].detach() for l in layers]))
                for k in getattr(layers[0], part)
            }))


def layer_views(layers) -> list:
    """The blocks' parameters in order: the ``_Layer`` modules of the
    list layout, or per-layer views of the stacked leaves under the
    attributes ``_Layer`` has (one ``unbind`` a leaf, so the backward
    builds each stacked grad in one ``stack``)."""
    if isinstance(layers, nn.ModuleList):
        return list(layers)
    unbound = {
        part: {k: p.unbind(0) for k, p in getattr(layers, part).items()}
        for part in _LAYER_PARTS
    }
    L = len(next(iter(unbound["attn"].values())))
    return [
        SimpleNamespace(**{part: {k: v[i] for k, v in d.items()} for part, d in unbound.items()})
        for i in range(L)
    ]


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
            # drawn from the explicit generator on its own device (the
            # CPU's: the same seed gives the same weights on every
            # device), then moved
            if kind == "dense" and generator is not None:
                w = torch.randn(shape, generator=generator, device=generator.device) * fan_in**-0.5
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
        # drawn layer by layer in both layouts: a stacked model holds the
        # list layout's weights of the same seed
        layers = [_Layer(cfg, make) for _ in range(cfg.num_layers)]
        self.layers = _StackedLayers(layers) if cfg.scan_layers else nn.ModuleList(layers)

    def jax_ordered_parameters(self):
        """Parameters in the JAX package's pytree flatten order (dict
        keys sorted, layers in order; stacked leaves as the stacked
        tree's keys) — the leaf order of the flat optimizer's layout."""

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


def _tree_map(fn, *trees):
    """``fn`` over the leaves of congruent nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(layers: list) -> Dict[str, Any]:
    """[L homogeneous layer dicts] -> one tree of ``[L, ...]`` leaves (the
    ``cfg.scan_layers`` layout); numpy or torch leaves."""

    def stack(*xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)

    return _tree_map(stack, *layers)


def unstack_layer_params(stacked: Dict[str, Any]) -> list:
    """Inverse of ``stack_layer_params``."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_tree_map(lambda x: x[i], stacked) for i in range(leaf.shape[0])]


def logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """A tree congruent with the JAX package's params (and with
    ``convert.params_to_numpy``) holding each leaf's logical axis names,
    as the JAX ``logical_axes`` gives them."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP A11)")
    axes: Dict[str, Any] = {
        "embed": {"tokens": ("vocab", "embed")},
        "final_norm": {"scale": ("norm",)},
    }
    if not cfg.rmsnorm:
        axes["final_norm"]["bias"] = ("norm",)
    if not cfg.rope:
        axes["embed"]["positions"] = (None, "embed")
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    layer = {
        "attn_norm": {"scale": ("norm",)},
        "mlp_norm": {"scale": ("norm",)},
        "attn": {
            "wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
        },
    }
    if not cfg.rmsnorm:
        layer["attn_norm"]["bias"] = ("norm",)
        layer["mlp_norm"]["bias"] = ("norm",)
    if cfg.swiglu:
        layer["mlp"] = {
            "w_gate": ("embed", "mlp"),
            "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed"),
        }
    else:
        layer["mlp"] = {
            "w_up": ("embed", "mlp"),
            "b_up": ("mlp",),
            "w_down": ("mlp", "embed"),
            "b_down": ("norm",),
        }
    if cfg.scan_layers:
        axes["layers"] = _tree_map(lambda t: ("layer_stack",) + t, layer)
    else:
        axes["layers"] = [_tree_map(lambda t: t, layer) for _ in range(cfg.num_layers)]
    return axes


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


def _attention_block(x, layer, cfg: TransformerConfig, positions, mesh=None):
    """The JAX block: without sequence parallelism the kernel-native
    ``bhtd`` projections; under sp (this rank's block of the sequence)
    ``bthd`` and the ring or Ulysses over the mesh's sp group."""
    h = _norm(x, layer.attn_norm, cfg)
    a = layer.attn
    sp = _sp(mesh) > 1
    layout = "bthd" if sp else "bhtd"
    proj = "btd,dhk->bthk" if sp else "btd,dhk->bhtk"
    q = torch.einsum(proj, h, a["wq"].to(h.dtype))
    k = torch.einsum(proj, h, a["wk"].to(h.dtype))
    v = torch.einsum(proj, h, a["wv"].to(h.dtype))
    if cfg.rope:
        q = _rope(q, positions, cfg.rope_theta, layout)
        k = _rope(k, positions, cfg.rope_theta, layout)
    if cfg.mup_attn_scale is not None:
        # muP 1/d attention folded into q: the kernels keep 1/sqrt(d)
        q = q * (cfg.mup_attn_scale * cfg.head_dim**0.5)
    if not sp:
        o = _causal_attention(q, k, v, layout="bhtd")
    elif cfg.sp_scheme == "ulysses":
        from dlrover_tpu_torch.parallel.ulysses import ulysses_self_attention

        o = ulysses_self_attention(q, k, v, mesh, causal=True)
    elif cfg.sp_scheme == "ring":
        from dlrover_tpu_torch.parallel.ring_attention import ring_self_attention

        o = ring_self_attention(q, k, v, mesh, causal=True)
    else:
        # a typo silently running the other scheme would make every
        # comparison between them quietly wrong
        raise ValueError(
            f"unknown sp_scheme {cfg.sp_scheme!r} (expected 'ring' or 'ulysses')"
        )
    out = "bthk,hkd->btd" if sp else "bhtk,hkd->btd"
    return x + torch.einsum(out, o, a["wo"].to(o.dtype))


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


def embed_tokens(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
                 offset: int = 0):
    """tokens [B,T] -> residual stream [B,T,D] (token + learned positions;
    ``offset``: the global position of the block's first token, under
    sequence parallelism)."""
    dt = _torch_dtype(cfg.dtype)
    T = tokens.shape[-1]
    x = F.embedding(tokens, params.embed["tokens"].to(dt))
    if not cfg.rope:
        x = x + params.embed["positions"].to(dt)[offset:offset + T][None]
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


def token_nll(logits: torch.Tensor, targets: torch.Tensor, row_weights=None):
    """Mean next-token negative log-likelihood, as
    ``logsumexp(logits) - logits[target]``. ``row_weights`` ([B]; see
    ``models/train.pad_row_weights``) weighs each row's tokens in the
    mean: padded rows weigh 0."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - tgt
    if row_weights is not None:
        return (row_weights[:, None].to(nll.dtype) * nll).mean()
    return nll.mean()


def _run_unit(key, fn, x, recompute=False):
    """The model's own parameters: run the unit as it is."""
    return fn(x)


def forward(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    mesh=None,
    gather=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B,T] -> (logits [B,T,vocab] f32, aux dict of zeros — the
    dense model has no MoE losses).

    The model runs as units: the embedding (``"embed"``), each block
    (``("layer", i)``; under ``scan_layers`` all of them, ``"layers"``:
    a stacked leaf is one parameter) and the head (``"head"``).
    ``gather(key, fn, x, recompute)`` runs ``fn(x)`` with that unit's
    parameters in place (ZeRO's per-unit gather, ``models/train.
    ZeroUnits``; ``recompute``: the unit is a remat block, rebuilt in
    the backward).

    Under sequence parallelism (``mesh`` with sp > 1) ``tokens`` is this
    rank's block of each row (``mesh.sequence_sharding``), at global
    positions ``sp index x T`` on; the logits are the block's."""
    check_supported(cfg, mesh)
    run = gather or _run_unit
    B, T = tokens.shape
    offset = T * mesh.coords.get("sp", 0) if _sp(mesh) > 1 else 0
    x = run("embed", lambda t: embed_tokens(params, t, cfg, offset), tokens)
    positions = (offset + torch.arange(T, device=tokens.device)).expand(B, T)

    def block(x, layer):
        return _mlp_block(_attention_block(x, layer, cfg, positions, mesh), layer, cfg)

    def blocks(x, layers):
        for layer in layers:
            if cfg.remat:
                x = checkpoint(block, x, layer, use_reentrant=False)
            else:
                x = block(x, layer)
        return x

    if gather is None or cfg.scan_layers:
        x = run("layers", lambda x: blocks(x, layer_views(params.layers)), x)
    else:
        # a remat block is its own recompute: the gather rebuilds it
        for i, layer in enumerate(params.layers):
            x = run(("layer", i), lambda x, layer=layer: block(x, layer), x, cfg.remat)
    return run("head", lambda x: lm_head(params, x, cfg), x), _zero_aux(x.device)


def unit_parameters(params: Transformer) -> Dict[Any, List[torch.nn.Parameter]]:
    """The parameters each unit of ``forward`` reads, by its key (the
    tied head reads the embedding's table)."""
    units: Dict[Any, List[torch.nn.Parameter]] = {"embed": list(params.embed.values())}
    if isinstance(params.layers, nn.ModuleList):
        for i, layer in enumerate(params.layers):
            units[("layer", i)] = list(layer.parameters())
    else:
        units["layers"] = list(params.layers.parameters())
    head = list(params.final_norm.values())
    head.append(params.embed["tokens"] if params.cfg.tie_embeddings else params.lm_head)
    units["head"] = head
    return units


def loss_fn(
    params: Transformer,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    mesh=None,
    row_weights=None,
    gather=None,
):
    """Mean NLL (the dense model's MoE aux losses are zero), weighted by
    row with ``row_weights``; ``gather`` as in ``forward``."""
    logits, _ = forward(params, tokens, cfg, mesh, gather)
    return token_nll(logits, targets, row_weights)
