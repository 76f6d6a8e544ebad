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

Tensor parallelism (a mesh with ``tp > 1``) is the Megatron layout GSPMD
derives from the JAX package's rule table (``parallel/sharding_rules``):
each tp rank holds its box of every leaf the table splits (``wq [D,
H/tp, K]``, ``wk`` / ``wv [D, kvh/tp, K]``, ``wo [H/tp, K, D]``,
``w_gate`` / ``w_up [D, F/tp]``, ``b_up [F/tp]``, ``w_down [F/tp, D]``,
and when tp divides the vocab the embedding's rows and the head's
columns), and the rest whole. A block's normed input enters its local
heads or MLP columns through ``copy_to_tp`` (identity forward, the tp sum
backward), and the partial sum of ``wo`` or ``w_down`` leaves through
``reduce_from_tp`` (the tp sum forward, identity backward) before
``b_down`` and the residual add. A split embedding reads its rows
(zeros for tokens outside them) and sums over tp; a split head makes
the rank's logits ``[B, T, V/tp]`` and the loss is the vocab-parallel
``lse - tgt`` (``token_nll``), the same number on every tp rank. The
attention kernels, the ring and Ulysses run on the rank's local heads.
A replicated leaf's gradient is the same on every tp rank by
construction: every collective of the backward leaves the residual
stream's gradient whole and equal on all of them.

Mixture-of-Experts (``cfg.num_experts``; every ``moe_every``-th block,
``config.is_moe_layer``): the block's MLP is an expert FFN,
``layers.{i}.moe`` with the JAX ``MoEParams`` leaves ``gate [D, E]``,
``w_up [E, D, F]`` and ``w_down [E, F, D]``, run by
``parallel/moe.moe_layer_local`` on the rank's tokens. Each block
returns its routing aux beside the residual stream (a dense block of a
MoE model zeros), ``forward`` sums it over the blocks and ``loss_fn``
adds ``MOE_AUX_WEIGHT x balance + router_z_weight x z`` to the NLL, as
the JAX ``loss_fn`` does. On a mesh with ``ep > 1`` each ep rank holds
its ``E/ep`` experts of every expert leaf (``sharding_rules.splits_of``)
and the layer exchanges its buckets over the ``ep`` group. Under tp the
expert FFN is split as the dense MLP is (each tp rank its ``F/tp``
columns of every local expert, one tp sum of the layer's output); under
sp each rank gates its own block of the sequence. Every mix of dp,
fsdp, ep, sp and tp runs.

Pipeline parallelism (a mesh with ``pp > 1``) runs the blocks of a
stage on each pp rank: ``parallel/pipeline.PipelineStage`` holds them,
drawn by this module's ``leaf_maker`` in the order ``Transformer`` draws
them (under pp x tp each stage row's tp box), and runs them through
``_attention_block`` / ``_mlp_block`` (over the stage's tp group),
``embed_tokens``, ``lm_head`` and ``token_nll``.

Cached decoding (``init_kv_cache``, ``forward_step``,
``forward_step_ragged``; the RLHF rollouts and the serving engine): the
JAX decode's math with the cache written in place. ``decode_weights``
casts every weight to the activation dtype once (a rollout or a weight
swap, not every token: the cast is elementwise, so the bits are the
same); the scores and probabilities keep f32 accumulation, and attend
over the live prefix of the static cache only. A learned position table
read past ``max_seq_len`` raises ``ValueError`` (the JAX decode clamps
the index and decodes with wrong positions).

Not ported yet, and raising ``NotImplementedError`` with its ROADMAP
item: ``int8_mlp`` (A12). pp x sp and pp x ep raise the JAX package's
``ValueError``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.models.config import TransformerConfig, is_moe_layer
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.parallel.sharding_rules import (
    check_tp,
    jax_order,
    list_layout,
    local_shape,
    local_shard,
    splits_of,
    tp_dims,
    tp_of,
)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def check_supported(cfg: TransformerConfig, mesh=None) -> None:
    """Raise for the configuration switches the port does not run yet.
    ``mesh``: a ``parallel/mesh.Mesh`` or its ``MeshConfig``; every mix
    of dp, fsdp, ep, sp and tp runs, MoE on any of them, and pp composes
    with dp, tp and fsdp. pp x ep and pp x sp (the JAX package's
    refusals), a model the pipeline cannot stage
    (``parallel/pipeline._check_pipeline_cfg``), a tp degree that does
    not divide the heads, the kv heads or the MLP width, or an ep degree
    on a dense model or one that does not divide the experts, raise
    ``ValueError``; ``int8_mlp`` raises ``NotImplementedError`` naming
    its ROADMAP item."""
    if mesh is not None:
        m = getattr(mesh, "config", mesh)
        if m.pp > 1:
            if m.ep > 1:
                # the JAX package scopes EP x PP out: MoE blocks and the
                # stage-stacked layout are separate optimizations
                raise ValueError(
                    f"pp={m.pp} x ep={m.ep}: pipeline parallelism with expert "
                    f"parallelism is not supported (use ep without pp)"
                )
            if m.sp > 1:
                raise ValueError("sp (ring attention) inside pp stages not supported")
            from dlrover_tpu_torch.parallel.pipeline import _check_pipeline_cfg

            _check_pipeline_cfg(cfg, m.pp)
        if m.ep > 1:
            if not cfg.num_experts:
                raise ValueError(f"ep={m.ep} needs a MoE config (num_experts > 0)")
            if cfg.num_experts % m.ep:
                raise ValueError(
                    f"ep={m.ep} does not divide num_experts={cfg.num_experts}"
                )
        if m.tp > 1:
            check_tp(cfg, m.tp)
    if cfg.int8_mlp:
        raise NotImplementedError("int8_mlp is not ported yet (ROADMAP A12)")


def _sp(mesh) -> int:
    return getattr(getattr(mesh, "config", mesh), "sp", 1) if mesh is not None else 1


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, make, prefix: str, index: int = 0):
        super().__init__()
        d, h, kvh, hd = cfg.model_dim, cfg.num_heads, cfg.kv_heads, cfg.head_dim
        f = cfg.ffn_dim

        def group(part, specs):
            # each leaf made under its parameter name (``make`` cuts a
            # tp rank's box by it)
            return nn.ParameterDict({k: make(f"{prefix}{part}.{k}", *v) for k, v in specs.items()})

        norm = {"scale": ("ones", (d,))}
        if not cfg.rmsnorm:
            norm["bias"] = ("zeros", (d,))
        self.attn_norm = group("attn_norm", norm)
        self.mlp_norm = group("mlp_norm", norm)
        self.attn = group("attn", {
            "wq": ("dense", (d, h, hd), d),
            "wk": ("dense", (d, kvh, hd), d),
            "wv": ("dense", (d, kvh, hd), d),
            "wo": ("dense", (h, hd, d), h * hd),
        })
        if is_moe_layer(cfg, index):
            E = cfg.num_experts
            # the JAX init_moe_params scales, drawn in MoEParams order
            self.moe = group("moe", {
                "gate": ("dense", (d, E), d),
                "w_up": ("dense", (E, d, f), d),
                "w_down": ("dense", (E, f, d), f),
            })
        elif cfg.swiglu:
            self.mlp = group("mlp", {
                "w_gate": ("dense", (d, f), d),
                "w_up": ("dense", (d, f), d),
                "w_down": ("dense", (f, d), f),
            })
        else:
            self.mlp = group("mlp", {
                "w_up": ("dense", (d, f), d),
                "b_up": ("zeros", (f,)),
                "w_down": ("dense", (f, d), f),
                "b_down": ("zeros", (d,)),
            })


_LAYER_PARTS = ("attn_norm", "mlp_norm", "attn", "mlp")
# The balance loss's weight in ``loss_fn``: the JAX ``loss_fn``'s default,
# the one value every caller uses.
MOE_AUX_WEIGHT = 0.01


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


def leaf_maker(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
               device=None, mesh=None):
    """``make(name, kind, shape, fan_in=None)``: one parameter leaf by its
    list-layout name, ``kind`` "dense" (``N(0, 1/fan_in)`` from
    ``generator``, drawn whole on the generator's own device: the same
    seed gives the same weights on every device), "ones" or "zeros"
    (also "dense" without a generator), cut to this rank's box (along
    tp, then ep: ``sharding_rules.splits_of``) and moved to ``device`` in ``cfg.param_dtype``. The draws advance
    ``generator`` in call order: ``Transformer`` and
    ``parallel/pipeline.PipelineStage`` call it leaf by leaf in one
    order, so both hold the same weights of one seed."""
    pd = _torch_dtype(cfg.param_dtype)
    # each splitting axis (tp, then ep) with each leaf's dim on it, by its
    # list-layout name (the names the leaves are drawn under)
    cuts = [(n, coord, tp_dims(list_layout(cfg), n, axis))
            for axis, n, coord, _ in splits_of(mesh) if axis != "pp"]

    def make(name, kind, shape, fan_in=None):
        box, split = tuple(shape), False
        for n, _, dims in cuts:
            box = local_shape(box, dims.get(name), n)
            split = split or dims.get(name) is not None
        if kind == "dense" and generator is not None:
            w = torch.randn(shape, generator=generator, device=generator.device) * fan_in**-0.5
            if split:
                for n, coord, dims in cuts:
                    w = local_shard(w, dims.get(name), n, coord)
                # a copy of the box alone: the whole leaf is freed
                w = w.clone(memory_format=torch.contiguous_format)
        elif kind == "ones":
            w = torch.ones(box)
        else:
            w = torch.zeros(box)
        p = nn.Parameter(w.to(device=device, dtype=pd))
        if split:
            # the 8-bit AdamW decides quantization on the whole leaf
            p.leaf_numel = int(np.prod(shape))
        return p

    return make


def shared_leaves(cfg: TransformerConfig, make):
    """The leaves outside the blocks, drawn in ``Transformer``'s order:
    ``(embed, final_norm, lm_head or None)``."""
    d = cfg.model_dim
    embed = nn.ParameterDict({"tokens": make("embed.tokens", "dense", (cfg.vocab_size, d), d)})
    final_norm = nn.ParameterDict({"scale": make("final_norm.scale", "ones", (d,))})
    if not cfg.rmsnorm:
        final_norm["bias"] = make("final_norm.bias", "zeros", (d,))
    if not cfg.rope:
        embed["positions"] = make("embed.positions", "dense", (cfg.max_seq_len, d), d)
    head = None if cfg.tie_embeddings else make("lm_head", "dense", (d, cfg.vocab_size), d)
    return embed, final_norm, head


class Transformer(nn.Module):
    """The parameter tree (see the module docstring); the model runs
    through the free function ``forward``. With a ``mesh`` of tp > 1 or
    ep > 1 (a ``parallel/mesh.Mesh``, or a ``MeshConfig`` for coordinate
    0's shapes) each leaf the rules split on those axes is this rank's
    box of it; the generator still draws every whole leaf, so the weights
    are tp = 1's (ep = 1's) of the same seed."""

    def __init__(
        self,
        cfg: TransformerConfig,
        generator: Optional[torch.Generator] = None,
        device=None,
        mesh=None,
    ):
        super().__init__()
        check_supported(cfg, mesh)
        self.cfg = cfg
        make = leaf_maker(cfg, generator, device, mesh)
        self.embed, self.final_norm, head = shared_leaves(cfg, make)
        if head is not None:
            self.lm_head = head
        # drawn layer by layer in both layouts: a stacked model holds the
        # list layout's weights of the same seed
        layers = [_Layer(cfg, make, f"layers.{i}.", i) for i in range(cfg.num_layers)]
        self.layers = _StackedLayers(layers) if cfg.scan_layers else nn.ModuleList(layers)

    def jax_ordered_parameters(self):
        """Parameters in the JAX package's pytree flatten order (dict
        keys sorted, layers in order; stacked leaves as the stacked
        tree's keys) — the leaf order of the flat optimizer's layout."""

        named = dict(self.named_parameters())
        return [named[n] for n in jax_order(named)]


def init_params(
    generator: torch.Generator, cfg: TransformerConfig, device=None, mesh=None
) -> Transformer:
    """Random weights from an explicit generator (the port of
    ``init_params(key, cfg)``): dense ``N(0, 1/fan_in)``, norm scales 1,
    biases 0; under tp this rank's boxes of them."""
    return Transformer(cfg, generator=generator, device=device, mesh=mesh)


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
        mlp = {
            "w_gate": ("embed", "mlp"),
            "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed"),
        }
    else:
        mlp = {
            "w_up": ("embed", "mlp"),
            "b_up": ("mlp",),
            "w_down": ("mlp", "embed"),
            "b_down": ("norm",),
        }
    moe = {
        "gate": (None, None),
        "w_up": ("experts", None, "expert_mlp"),
        "w_down": ("experts", "expert_mlp", None),
    }

    def of(i):
        out = _tree_map(lambda t: t, layer)
        out["moe" if is_moe_layer(cfg, i) else "mlp"] = dict(moe if is_moe_layer(cfg, i) else mlp)
        return out

    if cfg.scan_layers:
        axes["layers"] = _tree_map(lambda t: ("layer_stack",) + t, of(0))
    else:
        axes["layers"] = [of(i) for i in range(cfg.num_layers)]
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


# ---------------------------------------------------------------------------
# tensor parallelism: the collectives over the tp group
# ---------------------------------------------------------------------------
# the tp all-reduces' number and host ms (on the card the queue is
# drained before and after each; read by the tp phase of chip_smoke.py)
tp_comm = {"calls": 0, "ms": 0.0}


def reset_tp_comm() -> None:
    tp_comm.update(calls=0, ms=0.0)


def _tp_sum(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` reduced over the tp group (a sum unless ``op``), as a new
    tensor of ``t``'s dtype. The reduction runs in f32 whatever ``t``'s
    dtype (two bf16 partial sums round once, as one bf16 add rounds).
    Over gloo a CUDA tensor's all-reduce is staged by gloo itself
    through host memory (its CUDA work copies the tensor to a pinned
    host buffer and back): that is the card's tp transport when two
    ranks share one card, the tensors never leave the card otherwise."""
    import time

    import torch.distributed as dist

    buf = t.detach().to(torch.float32, copy=True)
    cuda = buf.device.type == "cuda"
    if cuda:
        torch.cuda.current_stream().synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op, group=group)
    if cuda:
        torch.cuda.current_stream().synchronize()
    tp_comm["ms"] += (time.perf_counter() - t0) * 1e3
    tp_comm["calls"] += 1
    return buf if t.dtype == torch.float32 else buf.to(t.dtype)


class _CopyToTp(torch.autograd.Function):
    """Identity forward, the tp sum backward: the input of the local
    heads or MLP columns, whose gradients are each rank's share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_sum(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    """The tp sum forward, identity backward: a row-parallel matmul's
    partial sums."""

    @staticmethod
    def forward(ctx, x, group):
        return _tp_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTp.apply(x, group)


def _tp_group(mesh):
    """The tp group of a mesh with tp > 1, else None."""
    tp, _, group = tp_of(mesh)
    return group if tp > 1 else None


def vocab_split(cfg: TransformerConfig, mesh) -> Optional[Tuple[int, Any]]:
    """``(first row, tp group)`` of this rank's vocab block when tp > 1
    divides the vocab, else None (the table and the head whole on every
    tp rank)."""
    tp, coord, group = tp_of(mesh)
    if tp == 1 or group is None or cfg.vocab_size % tp:
        return None
    return coord * (cfg.vocab_size // tp), group


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``lse - logits[target]`` over a vocab split on tp:
    ``logits [B,T,V/tp]`` (f32) are this rank's columns ``[lo, lo +
    V/tp)``. The max and the sum of exponentials are reduced over tp and
    the target's logit comes from the one rank that holds it (a sum of
    it and zeros), so the result is the same number on every tp rank.
    The backward is the local ``softmax - onehot``: one ``[B,T,V/tp]``
    f32 tensor, formed in place (the softmax the JAX form's backward
    needs, no second one)."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        import torch.distributed as dist

        V = logits.shape[-1]
        local = targets.long() - lo
        inside = (local >= 0) & (local < V)
        idx = local.clamp(0, V - 1)
        m = _tp_sum(logits.amax(-1), group, dist.ReduceOp.MAX)
        s = torch.exp(logits - m[..., None]).sum(-1)
        tgt = logits.gather(-1, idx[..., None])[..., 0] * inside
        st = _tp_sum(torch.stack([s, tgt]), group)
        lse = m + torch.log(st[0])
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse - st[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], -inside.to(grad.dtype)[..., None])
        grad.mul_(g[..., None])
        return grad, None, None, None


def _attention_block(x, layer, cfg: TransformerConfig, positions, mesh=None):
    """The JAX block: without sequence parallelism the kernel-native
    ``bhtd`` projections; under sp (this rank's block of the sequence)
    ``bthd`` and the ring or Ulysses over the mesh's sp group. Under tp
    the rank's local heads, their ``wo`` partial sums reduced over tp."""
    h = _norm(x, layer.attn_norm, cfg)
    tp_group = _tp_group(mesh)
    h = copy_to_tp(h, tp_group)
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
    return x + reduce_from_tp(torch.einsum(out, o, a["wo"].to(o.dtype)), tp_group)


def _zero_aux(cfg: Optional[TransformerConfig] = None, device=None) -> Dict[str, torch.Tensor]:
    """The aux tree the blocks sum into (the JAX ``_zero_aux``): the
    balance and z losses, and with a MoE config the per-expert load
    vector and the drop rate."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    aux = {"balance": z, "z": z}
    if cfg is not None and cfg.num_experts:
        aux["load"] = torch.zeros((cfg.num_experts,), dtype=torch.float32, device=device)
        aux["drop"] = z
    return aux


# a MoE model's blocks return their aux as one f32 vector beside the
# residual stream: [balance, z, drop, load (E)], which the remat
# checkpoint and ZeRO's unit wrapper carry as a plain tensor output
def _pack_aux(aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([torch.stack([aux["balance"], aux["z"], aux["drop"]]).float(),
                      aux["load"].float()])


def _unpack_aux(v: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"balance": v[0], "z": v[1], "drop": v[2], "load": v[3:]}


def _moe_block(h, moe, cfg: TransformerConfig, mesh=None):
    """The expert FFN on the normed ``h [B, T, D]``: the rank's tokens
    through ``moe_layer_local``, over the mesh's ep group when ep > 1
    and with each tp rank's ``F/tp`` columns of the experts under tp."""
    from dlrover_tpu_torch.parallel.moe import ep_group_of, moe_layer_local

    B, T, d = h.shape
    group, ep = ep_group_of(mesh)
    tp, tp_coord, _ = tp_of(mesh)
    out, aux = moe_layer_local(
        dict(moe), h.reshape(B * T, d), group=group, ep=ep,
        capacity_factor=cfg.capacity_factor, top_k=cfg.moe_top_k,
        expert_caps=tuple(cfg.capacity_splits) or None,
        tp_group=_tp_group(mesh), tp_coord=tp_coord,
    )
    return out.reshape(B, T, d), aux


def _mlp_block(x, layer, cfg: TransformerConfig, mesh=None):
    """The block's MLP half: ``x`` out, or in a MoE model ``(x, packed
    aux)`` (zeros for a dense block)."""
    h = _norm(x, layer.mlp_norm, cfg)
    moe = getattr(layer, "moe", None)
    if moe is not None:
        out, aux = _moe_block(h, moe, cfg, mesh)
        return x + out, _pack_aux(aux)
    tp_group = _tp_group(mesh)
    h = copy_to_tp(h, tp_group)
    mlp = layer.mlp

    def mm(a, w):
        return a @ w.to(a.dtype)

    if cfg.swiglu:
        z = F.silu(mm(h, mlp["w_gate"])) * mm(h, mlp["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        z = F.gelu(mm(h, mlp["w_up"]) + mlp["b_up"].to(h.dtype), approximate="tanh")
    out = reduce_from_tp(mm(z, mlp["w_down"]), tp_group)
    if not cfg.swiglu:
        out = out + mlp["b_down"].to(h.dtype)
    if cfg.num_experts:
        return x + out, _pack_aux(_zero_aux(cfg, x.device))
    return x + out


def embed_tokens(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
                 offset: int = 0, mesh=None):
    """tokens [B,T] -> residual stream [B,T,D] (token + learned positions;
    ``offset``: the global position of the block's first token, under
    sequence parallelism). A vocab split over tp reads this rank's rows
    (zeros for the tokens outside them) and sums over tp."""
    dt = _torch_dtype(cfg.dtype)
    T = tokens.shape[-1]
    table = params.embed["tokens"].to(dt)
    split = vocab_split(cfg, mesh)
    if split is None:
        x = F.embedding(tokens, table)
    else:
        lo, group = split
        local = tokens - lo
        inside = (local >= 0) & (local < table.shape[0])
        x = F.embedding(local.clamp(0, table.shape[0] - 1), table) * inside[..., None].to(dt)
        x = reduce_from_tp(x, group)
    if not cfg.rope:
        x = x + params.embed["positions"].to(dt)[offset:offset + T][None]
    return x


def lm_head(params: Transformer, x: torch.Tensor, cfg: TransformerConfig, mesh=None):
    """final residual [B,T,D] -> logits [B,T,vocab] f32 (incl. final norm);
    under a vocab split over tp this rank's ``[B,T,vocab/tp]``."""
    dt = _torch_dtype(cfg.dtype)
    x = _norm(x, params.final_norm, cfg)
    split = vocab_split(cfg, mesh)
    if split is not None:
        x = copy_to_tp(x, split[1])
    if cfg.tie_embeddings:
        logits = x @ params.embed["tokens"].to(dt).t()
    else:
        logits = x @ params.lm_head.to(dt)
    logits = logits.float()
    if cfg.mup_output_mult != 1.0:
        logits = logits * cfg.mup_output_mult
    return logits


def token_nll(logits: torch.Tensor, targets: torch.Tensor, row_weights=None, split=None):
    """Mean next-token negative log-likelihood, as
    ``logsumexp(logits) - logits[target]``. ``row_weights`` ([B]; see
    ``models/train.pad_row_weights``) weighs each row's tokens in the
    mean: padded rows weigh 0. ``split`` (``vocab_split``): the logits
    are this rank's vocab block, and the loss is the vocab-parallel one
    (``_VocabParallelNLL``)."""
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None].long())[..., 0]
        nll = lse - tgt
    else:
        nll = _VocabParallelNLL.apply(logits, targets, split[0], split[1])
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
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B,T] -> (logits [B,T,vocab] f32, aux): the MoE losses and
    routing stats summed over the blocks (``_zero_aux``: zeros for a
    dense model).

    ``return_hidden=True`` returns the final-norm'd residual stream
    [B,T,D] in place of the logits and skips the vocab projection (the
    trunk of the RLHF critic and reward model, so their math can never
    drift from the LM path).

    The model runs as units: the embedding (``"embed"``), each block
    (``("layer", i)``; under ``scan_layers`` all of them, ``"layers"``:
    a stacked leaf is one parameter) and the head (``"head"``).
    ``gather(key, fn, x, recompute)`` runs ``fn(x)`` with that unit's
    parameters in place (ZeRO's per-unit gather, ``models/train.
    ZeroUnits``; ``recompute``: the unit is a remat block, rebuilt in
    the backward). A MoE model's block units return ``(x, packed aux)``.

    Under sequence parallelism (``mesh`` with sp > 1) ``tokens`` is this
    rank's block of each row (``mesh.sequence_sharding``), at global
    positions ``sp index x T`` on; the logits are the block's. Under a
    vocab split over tp (``vocab_split``) they are this rank's vocab
    block. Under ep every ep rank runs the same tokens."""
    check_supported(cfg, mesh)
    run = gather or _run_unit
    moe = bool(cfg.num_experts)
    B, T = tokens.shape
    offset = T * mesh.coords.get("sp", 0) if _sp(mesh) > 1 else 0
    x = run("embed", lambda t: embed_tokens(params, t, cfg, offset, mesh), tokens)
    positions = (offset + torch.arange(T, device=tokens.device)).expand(B, T)
    aux = _pack_aux(_zero_aux(cfg, x.device)) if moe else None

    def block(x, layer):
        return _mlp_block(_attention_block(x, layer, cfg, positions, mesh), layer, cfg, mesh)

    def blocks(x, layers):
        total = _pack_aux(_zero_aux(cfg, x.device)) if moe else None
        for layer in layers:
            if cfg.remat:
                out = checkpoint(block, x, layer, use_reentrant=False)
            else:
                out = block(x, layer)
            if moe:
                x, a = out
                total = total + a
            else:
                x = out
        return (x, total) if moe else x

    if gather is None or cfg.scan_layers:
        out = run("layers", lambda x: blocks(x, layer_views(params.layers)), x)
        if moe:
            x, aux = out
        else:
            x = out
    else:
        # a remat block is its own recompute: the gather rebuilds it
        for i, layer in enumerate(params.layers):
            out = run(("layer", i), lambda x, layer=layer: block(x, layer), x, cfg.remat)
            if moe:
                x, a = out
                aux = aux + a
            else:
                x = out
    if return_hidden:
        out = run("head", lambda x: _norm(x, params.final_norm, cfg), x)
    else:
        out = run("head", lambda x: lm_head(params, x, cfg, mesh), x)
    return out, (_unpack_aux(aux) if moe else _zero_aux(device=x.device))


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
    return_aux: bool = False,
):
    """Mean NLL, weighted by row with ``row_weights``, plus a MoE model's
    aux losses (the balance loss at ``MOE_AUX_WEIGHT``, the router z-loss
    at ``cfg.router_z_weight``); ``gather`` as in ``forward``.
    ``return_aux``: ``(loss, aux)``. Under tp the same number on every tp
    rank."""
    logits, aux = forward(params, tokens, cfg, mesh, gather)
    loss = token_nll(logits, targets, row_weights, vocab_split(cfg, mesh))
    if cfg.num_experts:
        loss = loss + MOE_AUX_WEIGHT * aux["balance"] + cfg.router_z_weight * aux["z"]
    return (loss, aux) if return_aux else loss


# ---------------------------------------------------------------------------
# cached autoregressive decoding (generation / RLHF rollouts / serving)
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None):
    """Per-layer K/V buffers ``[L, B, kv_heads, S, head_dim]`` in the
    activation dtype: the JAX cache ``[L, B, S, kv_heads, head_dim]``
    with its two middle axes swapped, so that a (batch, kv head)'s keys
    are one ``[S, head_dim]`` block for the decode's batched products.
    Static: the decode writes into it in place."""
    dt = _torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_weights(params: Transformer, cfg: TransformerConfig,
                   own: bool = False) -> SimpleNamespace:
    """Every weight the decode reads, cast to the activation dtype once
    (the JAX decode casts inside the compiled loop, where XLA hoists the
    cast; eager PyTorch would cast every weight at every token). Norm
    parameters stay in their own dtype, as ``_norm`` reads them in f32;
    MoE experts stay as they are (``moe_layer_local`` casts). Per-layer
    entries for both layer layouts (``layer_views``). ``own``: every
    entry a tensor of its own, copied where the cast would hand back the
    parameter itself, so that a later write into ``params`` leaves them
    as they were (the serving engine's swaps)."""
    dt = _torch_dtype(cfg.dtype)

    def cast(t):
        return t.detach().to(dt, copy=own)

    def keep(d):
        return {k: v.detach().clone() for k, v in d.items()} if own else d

    def cast_all(d):
        return {k: cast(v) for k, v in d.items()}

    with torch.no_grad():
        layers = []
        for lv in layer_views(params.layers):
            entry = SimpleNamespace(attn_norm=keep(lv.attn_norm), mlp_norm=keep(lv.mlp_norm),
                                    attn=cast_all(lv.attn))
            if getattr(lv, "moe", None) is not None:
                entry.moe = keep(lv.moe)
            else:
                entry.mlp = cast_all(lv.mlp)
            layers.append(entry)
        table = cast(params.embed["tokens"])
        head = table.t() if cfg.tie_embeddings else cast(params.lm_head)
        pos = None if cfg.rope else cast(params.embed["positions"])
    return SimpleNamespace(layers=layers, embed=table, positions=pos, head=head,
                           final_norm=keep(params.final_norm))


def check_positions(cfg: TransformerConfig, end: int) -> None:
    """Raise ``ValueError`` when a learned position table would be read
    at position ``end - 1`` or later past its ``max_seq_len`` rows (RoPE
    models have no table to run off)."""
    if not cfg.rope and end > cfg.max_seq_len:
        raise ValueError(
            f"positions up to {end - 1} need {end} rows of the learned position "
            f"table, which has max_seq_len={cfg.max_seq_len}"
        )


def decode_products(device) -> str:
    """How the decode's batched products reach f32 on ``device``: on the
    card, each product of bf16 inputs returns its f32 accumulator
    (``bmm``'s ``out_dtype``) and P V splits P in two bf16 parts
    (``"bf16 in, f32 out; P as hi + lo"``); elsewhere the inputs are
    copied to f32 (``"f32 copies"``)."""
    if torch.device(device).type == "cuda":
        return "bf16 in, f32 out; P as hi + lo"
    return "f32 copies"


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, m, k] @ b [N, k, n]`` accumulated and returned in f32, as
    the JAX decode's ``preferred_element_type=f32``: on the card the f32
    output of a product of the inputs' own dtype, elsewhere the product
    of f32 copies (``decode_products``)."""
    if a.dtype != torch.float32 and a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _probs_v_f32(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``probs [N, m, S] (f32) @ v [N, S, hd]`` in f32. On the card
    ``probs`` is split into two parts of ``v``'s dtype (``hi = round(p)``,
    ``lo = round(p - hi)``, p to about 16 bits) and each is one
    f32-output product with ``v`` as it lies in the cache; elsewhere
    ``v`` is copied to f32 (``decode_products``)."""
    if v.dtype != torch.float32 and v.is_cuda:
        hi = probs.to(v.dtype)
        lo = (probs - hi.float()).to(v.dtype)
        return _bmm_f32(hi, v) + _bmm_f32(lo, v)
    return torch.bmm(probs, v.float())


def _cached_decode_layer(x, lw, k_cache, v_cache, *, positions, mask, key_len, cfg, write_kv):
    """One cached transformer block: (x, this layer's cast weights ``lw``
    and K/V buffers ``[B, kvh, S, hd]``) -> x'. The cache is written in
    place (``write_kv``); attention reads its live prefix, keys ``0 ..
    key_len - 1``, under ``mask [B, t, key_len]``. The shared body of
    ``forward_step`` and ``forward_step_ragged``: QKV, rope, the muP
    scale, GQA attention with f32 scores and probabilities (a
    bf16-accumulated decode would drift from the teacher-forced
    re-scoring and bias PPO's ratios), wo and the MLP."""
    B, t = x.shape[0], x.shape[1]
    kvh, hd = cfg.kv_heads, cfg.head_dim
    g = cfg.num_heads // kvh
    h = _norm(x, lw.attn_norm, cfg)
    q = torch.einsum("btd,dhk->bthk", h, lw.attn["wq"])
    k = torch.einsum("btd,dhk->bthk", h, lw.attn["wk"])
    v = torch.einsum("btd,dhk->bthk", h, lw.attn["wv"])
    if cfg.rope:
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    if cfg.mup_attn_scale is not None:
        # the muP 1/d fold of _attention_block: decode scores with the
        # training attention math
        q = q * (cfg.mup_attn_scale * cfg.head_dim**0.5)
    write_kv(k_cache, k)
    write_kv(v_cache, v)
    kk = k_cache[:, :, :key_len].reshape(B * kvh, key_len, hd)
    vv = v_cache[:, :, :key_len].reshape(B * kvh, key_len, hd)
    # GQA: a kv head's query heads fold next to it, rows (head, token)
    qg = q.reshape(B, t, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(B * kvh, g * t, hd)
    scores = _bmm_f32(qg, kk.transpose(1, 2)) * (hd**-0.5)
    scores = scores.view(B, kvh, g, t, key_len)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).view(B * kvh, g * t, key_len)
    o = _probs_v_f32(probs, vv).to(x.dtype)
    o = o.view(B, kvh, g, t, hd).permute(0, 3, 1, 2, 4).reshape(B, t, cfg.num_heads, hd)
    x = x + torch.einsum("bthk,hkd->btd", o, lw.attn["wo"])
    out = _mlp_block(x, lw, cfg, None)
    return out[0] if isinstance(out, tuple) else out


def _run_cached_layers(x, weights, cache, cfg, decode_layer):
    """Drive ``decode_layer`` over every layer's cast weights and its
    slice of the cache (both layer layouts: ``decode_weights`` holds
    per-layer entries either way)."""
    for i, lw in enumerate(weights.layers):
        x = decode_layer(x, lw, cache["k"][i], cache["v"][i])
    return x


def _decode_head(weights, x, cfg: TransformerConfig) -> torch.Tensor:
    """``lm_head`` on the cast weights: final norm, vocab projection,
    logits f32."""
    x = _norm(x, weights.final_norm, cfg)
    logits = (x @ weights.head).float()
    if cfg.mup_output_mult != 1.0:
        logits = logits * cfg.mup_output_mult
    return logits


@torch.no_grad()
def forward_step(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    cache,
    cur_len: int,
    weights: Optional[SimpleNamespace] = None,
) -> torch.Tensor:
    """Cached forward: ``tokens [B, t]`` occupy positions ``cur_len ..
    cur_len + t - 1`` (t > 1: a prefill chunk, t = 1: a decode step).
    Returns logits ``[B, t, vocab]`` f32; the cache is written in place
    (the JAX function returns a new cache). ``weights``: the
    ``decode_weights`` of ``params`` (cast here when not given).
    Positions past the cache or past a learned table raise
    ``ValueError``."""
    B, t = tokens.shape
    end = int(cur_len) + t
    if end > cache["k"].shape[3]:
        raise ValueError(f"positions up to {end - 1} past the cache's {cache['k'].shape[3]}")
    check_positions(cfg, end)
    w = decode_weights(params, cfg) if weights is None else weights
    x = w.embed[tokens]
    positions = (cur_len + torch.arange(t, device=tokens.device)).expand(B, t)
    if w.positions is not None:
        x = x + w.positions[cur_len:end][None]
    # a query at cur_len + i sees keys 0 .. cur_len + i
    mask = torch.arange(end, device=tokens.device)[None, None, :] <= positions[:, :, None]

    def write_kv(c, val):
        c[:, :, cur_len:end] = val.transpose(1, 2).to(c.dtype)

    def decode_layer(x, lw, kc, vc):
        return _cached_decode_layer(x, lw, kc, vc, positions=positions, mask=mask,
                                    key_len=end, cfg=cfg, write_kv=write_kv)

    x = _run_cached_layers(x, w, cache, cfg, decode_layer)
    return _decode_head(w, x, cfg)


@torch.no_grad()
def forward_step_ragged(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    cache,
    cur_lens: torch.Tensor,
    weights: Optional[SimpleNamespace] = None,
    key_len: Optional[int] = None,
) -> torch.Tensor:
    """Per-slot decode step: slot ``s``'s one token (``tokens [S]``)
    occupies position ``cur_lens[s]`` of its sequence, the continuous
    batcher's slots sitting at different depths. Returns logits ``[S,
    vocab]`` f32 and writes the cache in place (a per-slot scatter).
    ``key_len``: a bound on every slot's ``cur_lens + 1`` known to the
    caller (default the cache's length): attention reads that prefix.
    Stale cache entries from a slot's previous occupant need no clearing:
    position ``i`` is rewritten before any later query attends to it. The
    caller keeps ``cur_lens`` inside a learned position table
    (``check_positions``): reading it here would cost a device read."""
    S_slots = tokens.shape[0]
    T = cache["k"].shape[3]
    key_len = T if key_len is None else min(int(key_len), T)
    w = decode_weights(params, cfg) if weights is None else weights
    slot_ix = torch.arange(S_slots, device=tokens.device)
    cur = cur_lens.long()
    x = w.embed[tokens][:, None]
    positions = cur[:, None]
    if w.positions is not None:
        x = x + w.positions[cur][:, None]
    mask = torch.arange(key_len, device=tokens.device)[None, None, :] <= positions[:, :, None]

    def write_kv(c, val):
        # per-slot scatter: cache[s, :, cur[s]] = val[s, 0]
        c[slot_ix, :, cur] = val[:, 0].to(c.dtype)

    def decode_layer(x, lw, kc, vc):
        return _cached_decode_layer(x, lw, kc, vc, positions=positions, mask=mask,
                                    key_len=key_len, cfg=cfg, write_kv=write_kv)

    x = _run_cached_layers(x, w, cache, cfg, decode_layer)
    return _decode_head(w, x, cfg)[:, 0]
