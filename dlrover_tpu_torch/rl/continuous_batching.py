"""Continuous-batching generation engine, the vLLM-backend analog
(counterpart of ``dlrover_tpu/rl/continuous_batching.py``).

vLLM's throughput comes from *continuous batching*: finished sequences
leave the batch immediately and new prompts take their slots, so short
completions never leave the device idle waiting for the batch's longest
sequence. The JAX engine's design is kept, static shapes included:

- ``slots`` fixed sequence slots, each with its own region of the
  preallocated KV cache (``init_kv_cache``), written in place.
- **Unified chunked-prefill/decode step**: every iteration feeds exactly
  one token per slot through ``forward_step_ragged`` (per-slot
  positions). A slot mid-prompt consumes its next PROMPT token; a slot
  past its prompt consumes the token it just sampled.
- **Refill on the device**: a slot finishing (EOS / token budget)
  scatters its completed sequence to the output buffers (idle slots to
  the dump row ``N``) and loads the next queued prompt in the same
  iteration — stale cache needs no clearing because position ``i`` is
  rewritten before anything can attend to it.

The JAX ``lax.while_loop`` becomes a host loop: its ``emitted < N`` test
is one device-to-host read an iteration, which also brings back the
slots' deepest position, so attention reads only the cache's live
prefix. Per-step sampling generators are derived from the
generator's seed and the step (the JAX ``fold_in(key, step)``).

On the card the forward of an iteration is replayed from a CUDA graph
(``_DecodeGraphs``: one a live-prefix length, rounded up to
``GRAPH_BUCKET`` keys, captured at its first use), as XLA runs the JAX
loop's body as one program: eager, the decode is a few hundred small
launches an iteration and the host bounds it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.common import cuda_sync
from dlrover_tpu_torch.models.config import TransformerConfig
from dlrover_tpu_torch.models.transformer import (
    Transformer,
    check_positions,
    decode_weights,
    forward_step_ragged,
    init_kv_cache,
)
from dlrover_tpu_torch.rl.generation import _no_mesh, check_sampling, sample_tokens, step_generator

# the live-prefix lengths a captured decode step covers, rounded up to this
GRAPH_BUCKET = 128
# one warm-up stream a card for every capture: each new stream would get
# (and keep) a cuBLAS workspace of its own
_WARMUP_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


class _DecodeGraphs:
    """``forward_step_ragged`` over one cache as CUDA graphs: the feed
    and the positions are copied into static inputs, and each graph
    attends a live prefix rounded up to ``GRAPH_BUCKET`` keys (the keys
    past a slot's position are masked, so the prefix length changes the
    sums' order only). A graph is captured at its first use, after one
    warm-up call on a side stream (which writes the same K/V the replay
    writes). A capture holds ``cuda_sync.capturing()``: no card-wide
    synchronize of the port meets it."""

    def __init__(self, params, cfg, cache, weights, slots, device):
        self.args = (params, cfg, cache, weights)
        self.T = cache["k"].shape[3]
        self.feed = torch.zeros((slots,), dtype=torch.long, device=device)
        self.cur = torch.zeros((slots,), dtype=torch.long, device=device)
        self.graphs, self.out = {}, {}

    def _run(self, key_len):
        params, cfg, cache, w = self.args
        return forward_step_ragged(params, self.feed, cfg, cache, self.cur, w, key_len=key_len)

    def __call__(self, feed, cur, key_len):
        b = min(self.T, -(-key_len // GRAPH_BUCKET) * GRAPH_BUCKET)
        self.feed.copy_(feed)
        self.cur.copy_(cur)
        if b not in self.graphs:
            dev = self.feed.device
            # a card-wide synchronize in another thread (a trainer's
            # beside the serving one) would fail the capture: it waits
            with cuda_sync.capturing():
                side = _WARMUP_STREAMS.get(dev)
                if side is None:
                    side = _WARMUP_STREAMS[dev] = torch.cuda.Stream(device=dev)
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self._run(b)
                torch.cuda.current_stream().wait_stream(side)
                g = torch.cuda.CUDAGraph()
                # thread-local: that trainer's thread goes on launching
                # and querying its own events while this thread captures
                with torch.cuda.graph(g, capture_error_mode="thread_local"):
                    self.out[b] = self._run(b)
            self.graphs[b] = g
        self.graphs[b].replay()
        return self.out[b]


@torch.no_grad()
def continuous_generate(
    params: Transformer,
    prompts: torch.Tensor,  # [N, P_max], right-padded
    prompt_lens: torch.Tensor,  # [N]
    generator: Optional[torch.Generator],
    cfg: TransformerConfig,
    max_new_tokens: int = 32,
    eos_id: int = -1,  # -1: no EOS — every sequence runs its budget
    slots: int = 8,
    temperature: float = 1.0,
    greedy: bool = False,
    top_k: int = 0,
    top_p: float = 1.0,
    mesh=None,
    weights=None,
    stats: Optional[Dict] = None,
    cuda_graphs: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate completions for ``N`` prompts through ``slots`` device
    slots with continuous refill.

    Returns ``(tokens [N, P_max+max_new] int32, logps [N, max_new] f32,
    out_lens [N] int32)`` on the prompts' device: per prompt, its tokens
    (prompt + completion, zero-padded past ``out_lens``), the behavior
    logprobs of the generated part (zero-padded), and the total sequence
    length. A sequence stops at ``eos_id`` (the EOS token is kept) or
    after ``max_new_tokens``. ``weights``: the params'
    ``decode_weights`` (cast here when not given); ``generator``: its
    seed seeds every step (unused when greedy); ``stats`` (a dict) gets
    the iterations, the device-to-host reads and the host ms between
    consecutive reads (``read_ms``: each read waits for the card).
    ``cuda_graphs`` (default: on CUDA tensors) replays each iteration's
    forward from a captured graph. ``P_max + max_new_tokens`` past a
    learned position table raises ``ValueError``.

    Tail-latency note: once the prompt queue drains, idle slots still
    run full forward passes each iteration until the slowest active
    slot finishes — the price of static shapes; size ``slots`` to the
    live prompt count."""
    check_sampling(top_k, top_p, temperature, greedy)
    _no_mesh(mesh)
    dev = prompts.device
    N, P_max = prompts.shape
    S = min(slots, N)
    T = P_max + max_new_tokens
    check_positions(cfg, T)
    w = decode_weights(params, cfg) if weights is None else weights
    seed = 0 if generator is None else generator.initial_seed()
    cache = init_kv_cache(cfg, S, T, device=dev)
    graphs = None
    if dev.type == "cuda" if cuda_graphs is None else cuda_graphs:
        graphs = _DecodeGraphs(params, cfg, cache, w, S, dev)
    prompts_T = torch.zeros((N, T), dtype=torch.long, device=dev)
    prompts_T[:, :P_max] = prompts.long()
    plens = prompt_lens.to(device=dev, dtype=torch.long)

    # slot state; idle slots carry prompt index N (the dump row)
    slot_ix = torch.arange(S, device=dev)
    tokens = prompts_T[:S].clone()  # [S, T] token buffer per slot
    logps = torch.zeros((S, T), dtype=torch.float32, device=dev)
    cur = torch.zeros((S,), dtype=torch.long, device=dev)  # tokens already in cache
    plen = plens[:S].clone()
    pidx = slot_ix.clone()
    next_p = torch.full((), S, dtype=torch.long, device=dev)
    emitted = torch.zeros((), dtype=torch.long, device=dev)
    # output buffers; row N is the dump row for idle-slot scatters
    out_tokens = torch.zeros((N + 1, T), dtype=torch.long, device=dev)
    out_logps = torch.zeros((N + 1, T), dtype=torch.float32, device=dev)
    out_lens = torch.zeros((N + 1,), dtype=torch.long, device=dev)

    step = 0
    read_ms, last = [], time.perf_counter()
    while True:
        done_n, deepest = torch.stack([emitted, cur.max()]).tolist()
        now = time.perf_counter()
        read_ms.append((now - last) * 1e3)
        last = now
        if done_n >= N:
            break
        active = pidx < N
        # feed one token per slot: the next unprocessed buffer entry
        feed = tokens[slot_ix, cur]
        # attention reads the cache up to the deepest slot's position
        key_len = deepest + 1
        if graphs is not None:
            logits = graphs(feed, cur, key_len)
        else:
            logits = forward_step_ragged(params, feed, cfg, cache, cur, w, key_len=key_len)
        new_cur = cur + active.long()

        # slots whose fed token completed the prompt (or continued the
        # completion) sample their next token from these logits
        in_decode = active & (new_cur >= plen)
        gen = None if greedy else step_generator(seed, step, dev)
        tok, tok_logp = sample_tokens(logits, gen, greedy, temperature, top_k, top_p)
        col = new_cur.clamp_max(T - 1)
        tokens[slot_ix, col] = torch.where(in_decode, tok, tokens[slot_ix, col])
        logps[slot_ix, col] = torch.where(in_decode, tok_logp, 0.0)

        n_new = new_cur + 1 - plen  # completion tokens incl. this one
        hit_eos = in_decode & (tok == eos_id) if eos_id >= 0 else torch.zeros_like(in_decode)
        done = hit_eos | (in_decode & (n_new >= max_new_tokens))

        # emit: the sequence length counts the sampled token
        dump = torch.where(done, pidx, N)
        out_tokens.index_copy_(0, dump, tokens)
        out_logps.index_copy_(0, dump, logps)
        out_lens.index_copy_(0, dump, new_cur + 1)

        # refill: the k-th finishing slot (slot order) takes prompt
        # next_p + k; slots beyond the queue go idle (pidx = N)
        order = torch.cumsum(done.long(), 0) - 1
        new_idx = next_p + order
        refillable = done & (new_idx < N)
        safe_idx = torch.where(refillable, new_idx, 0)
        tokens = torch.where(refillable[:, None], prompts_T[safe_idx], tokens)
        logps = torch.where(refillable[:, None], 0.0, logps)
        cur = torch.where(done, 0, new_cur)
        plen = torch.where(refillable, plens[safe_idx], plen)
        pidx = torch.where(done, torch.where(refillable, new_idx, N), pidx)
        n_done = done.long().sum()
        next_p = next_p + n_done
        emitted = emitted + n_done
        step += 1

    if stats is not None:
        stats.update(iterations=step, d2h_reads=len(read_ms), read_ms=read_ms[1:],
                     graphs=0 if graphs is None else len(graphs.graphs))
    out_tokens, out_lens = out_tokens[:N], out_lens[:N]
    # the logps buffer is indexed by absolute position (a completion
    # starts at its prompt's length); shift rows to start at column 0
    cols = torch.arange(max_new_tokens, device=dev)[None, :]
    gather_ix = (plens[:, None] + cols).clamp(0, T - 1)
    aligned = out_logps[:N].gather(1, gather_ix)
    n_new = out_lens - plens
    aligned = torch.where(cols < n_new[:, None], aligned, 0.0)
    return out_tokens.int(), aligned, out_lens.int()
