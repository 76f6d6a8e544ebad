"""Port parity: the RLHF slice of dlrover_tpu_torch (the KV-cache decode,
generation, continuous batching, the reward model and PPO) against the
JAX package on the same seeded weights and inputs, in f32 on the CPU.

Tolerances: 1e-5 on the cached forwards, their caches, logprobs,
values, rewards, losses, metrics and updated params (f32 sums in a
different order over a few layers); 1e-6 on ``_mask_logits``' values;
tokens and lengths of greedy decodes equal. Sampling draws Gumbel-max
from a ``torch.Generator``, so sampled tokens are held to their
distribution, not to JAX's draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import config as jcfg
from dlrover_tpu.models import transformer as jtr
from dlrover_tpu.rl import continuous_batching as jcb
from dlrover_tpu.rl import generation as jgen
from dlrover_tpu.rl import ppo as jppo
from dlrover_tpu.rl import reward as jrew
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import transformer as ttr
from dlrover_tpu_torch.models.convert import (
    head_model_from_jax,
    head_model_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from dlrover_tpu_torch.rl import PPOConfig, RLHFEngine, RewardModel
from dlrover_tpu_torch.rl import continuous_batching as tcb
from dlrover_tpu_torch.rl import generation as tgen
from dlrover_tpu_torch.rl import ppo as tppo
from dlrover_tpu_torch.rl import reward as trew

TOL = 1e-5
MASK_TOL = 1e-6

# tiny Llama (RoPE, RMSNorm, SwiGLU, GQA 4/2, untied), tiny GPT-2
# (learned positions, LayerNorm, tanh-GELU, MHA, tied) and GPT-2 with
# the muP attention scale
CONFIGS = {
    "llama": dict(vocab_size=48),
    "gpt2": dict(vocab_size=48, rope=False, rmsnorm=False, swiglu=False,
                 tie_embeddings=True, num_kv_heads=None),
    "gpt2_mup": dict(vocab_size=48, rope=False, rmsnorm=False, swiglu=False,
                     tie_embeddings=True, num_kv_heads=None, mup_attn_scale=1 / 8.0,
                     mup_output_mult=0.5),
}
_CACHE = {}


def _model(name, scan=False, seed=0):
    """(JAX cfg, port cfg, JAX params, port model) of one config."""
    key = (name, scan, seed)
    if key not in _CACHE:
        over = dict(CONFIGS[name], scan_layers=scan)
        jc, tc = jcfg.tiny(**over), tcfg.tiny(**over)
        params = jax.device_get(jax.jit(jtr.init_params, static_argnums=1)(
            jax.random.PRNGKey(seed), jc))
        if scan and isinstance(params["layers"], list):
            params = dict(params, layers=jax.device_get(jtr.stack_layer_params(params["layers"])))
        _CACHE[key] = (jc, tc, params, params_from_jax(params, tc))
    return _CACHE[key]


def _jax_cache(cache):
    """The port's cache [L, B, kvh, S, hd] in the JAX layout."""
    return {k: v.permute(0, 1, 3, 2, 4).numpy() for k, v in cache.items()}


def _port_cache(jcache):
    return {k: torch.from_numpy(np.asarray(v)).permute(0, 1, 3, 2, 4).contiguous()
            for k, v in jcache.items()}


_jstep = jax.jit(jtr.forward_step, static_argnums=2)
_jragged = jax.jit(jtr.forward_step_ragged, static_argnums=2)


def _tokens(rng, shape, vocab):
    return rng.integers(1, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the cached forwards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["llama", "gpt2", "gpt2_mup"])
def test_forward_step_and_cache_match_jax(name):
    """A prefill chunk then two decode steps: logits and the cache."""
    jc, tc, params, model = _model(name)
    rng = np.random.default_rng(1)
    toks = _tokens(rng, (2, 9), jc.vocab_size)
    jcache = jtr.init_kv_cache(jc, 2, 12)
    tcache = ttr.init_kv_cache(tc, 2, 12)
    for lo, hi in ((0, 7), (7, 8), (8, 9)):
        lj, jcache = _jstep(params, jnp.asarray(toks[:, lo:hi]), jc, jcache, lo)
        lt = ttr.forward_step(model, torch.from_numpy(toks[:, lo:hi]).long(), tc, tcache, lo)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    for k, v in _jax_cache(tcache).items():
        np.testing.assert_allclose(v, np.asarray(jcache[k]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_forward_step_ragged_matches_jax(name):
    """One token a slot at per-slot depths over a cache holding stale
    entries: logits and the scattered cache."""
    jc, tc, params, model = _model(name)
    rng = np.random.default_rng(2)
    L, S, T = jc.num_layers, 3, 10
    shape = (L, S, T, jc.kv_heads, jc.head_dim)
    jcache = {k: rng.normal(size=shape).astype(np.float32) for k in ("k", "v")}
    tcache = _port_cache(jcache)
    cur = np.array([3, 0, 9], np.int32)
    toks = _tokens(rng, (S,), jc.vocab_size)
    lj, jnew = _jragged(params, jnp.asarray(toks), jc,
                                       {k: jnp.asarray(v) for k, v in jcache.items()},
                                       jnp.asarray(cur))
    lt = ttr.forward_step_ragged(model, torch.from_numpy(toks).long(), tc, tcache,
                                 torch.from_numpy(cur))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    for k, v in _jax_cache(tcache).items():
        np.testing.assert_allclose(v, np.asarray(jnew[k]), atol=TOL, rtol=TOL)
    # a bound on the live prefix reads the same keys
    tcache2 = _port_cache(jcache)
    lt2 = ttr.forward_step_ragged(model, torch.from_numpy(toks).long(), tc, tcache2,
                                  torch.from_numpy(cur), key_len=int(cur.max()) + 1)
    np.testing.assert_allclose(lt2.numpy(), lt.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_scan_layout_decodes_as_the_list_layout(name):
    """The stacked ``scan_layers`` layout (the JAX package's converted
    stacked tree) through both cached forwards: the list layout's
    logits and caches, which the tests above hold to JAX."""
    _, tc, params, model = _model(name)
    jc_s, tc_s, params_s, model_s = _model(name, scan=True)
    assert isinstance(params_s["layers"], dict)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(_tokens(rng, (2, 6), tc.vocab_size)).long()
    caches = [ttr.init_kv_cache(c, 2, 8) for c in (tc, tc_s)]
    outs = [ttr.forward_step(m, toks, c, k, 0) for m, c, k in
            ((model, tc, caches[0]), (model_s, tc_s, caches[1]))]
    assert torch.equal(outs[0], outs[1])
    cur = torch.tensor([6, 2])
    feed = torch.from_numpy(_tokens(rng, (2,), tc.vocab_size)).long()
    outs = [ttr.forward_step_ragged(m, feed, c, k, cur) for m, c, k in
            ((model, tc, caches[0]), (model_s, tc_s, caches[1]))]
    assert torch.equal(outs[0], outs[1])
    for key in ("k", "v"):
        assert torch.equal(caches[0][key], caches[1][key])


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_prefill_and_incremental_decode_match_plain_forward(name):
    """The JAX package's cached-decoding cases on the port alone: one
    prefill equals ``forward``, token-by-token equals one prefill."""
    _, tc, _, model = _model(name)
    toks = torch.from_numpy(_tokens(np.random.default_rng(0), (2, 8), tc.vocab_size)).long()
    with torch.no_grad():
        ref, _ = ttr.forward(model, toks, tc)
    full = ttr.forward_step(model, toks, tc, ttr.init_kv_cache(tc, 2, 8), 0)
    np.testing.assert_allclose(full.numpy(), ref.numpy(), atol=TOL, rtol=TOL)
    cache = ttr.init_kv_cache(tc, 2, 8)
    steps = [ttr.forward_step(model, toks[:, i:i + 1], tc, cache, i)[:, 0] for i in range(8)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=TOL, rtol=TOL)


def test_return_hidden_is_the_normed_trunk():
    jc, tc, params, model = _model("llama")
    toks = _tokens(np.random.default_rng(3), (2, 7), jc.vocab_size)
    hj, _ = jax.jit(jtr.forward, static_argnames=("cfg", "return_hidden"))(
        params, jnp.asarray(toks), cfg=jc, return_hidden=True)
    with torch.no_grad():
        ht, _ = ttr.forward(model, torch.from_numpy(toks).long(), tc, return_hidden=True)
    assert ht.shape == (2, 7, jc.model_dim)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)


def test_decode_weights_are_the_cast_params_for_both_layouts():
    """The hoisted cast: one entry a layer in either layout, the same
    bits as casting at every step."""
    for scan in (False, True):
        _, tc, _, model = _model("llama", scan)
        w = ttr.decode_weights(model, tc)
        assert len(w.layers) == tc.num_layers
        for lw, lv in zip(w.layers, ttr.layer_views(model.layers)):
            assert torch.equal(lw.attn["wq"], lv.attn["wq"].to(lw.attn["wq"].dtype))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_greedy_generate_matches_jax(name):
    jc, tc, params, model = _model(name)
    prompt = _tokens(np.random.default_rng(4), (3, 5), jc.vocab_size)
    tj, lj = jgen.generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0), jc,
                           max_new_tokens=6, greedy=True)
    tt, lt = tgen.generate(model, torch.from_numpy(prompt), None, tc, max_new_tokens=6,
                           greedy=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)


def test_generate_shapes_logprobs_and_rescoring():
    _, tc, _, model = _model("llama")
    prompt = torch.zeros((3, 4), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    tokens, logprobs = tgen.generate(model, prompt, gen, tc, max_new_tokens=6)
    assert tokens.shape == (3, 10) and logprobs.shape == (3, 6)
    assert (logprobs <= 0).all()
    with torch.no_grad():
        rescored = tgen.sequence_logprobs(model, tokens, tc, prompt_len=4)
    np.testing.assert_allclose(logprobs.numpy(), rescored.numpy(), atol=3e-5, rtol=3e-5)
    t1, _ = tgen.generate(model, prompt, torch.Generator().manual_seed(1), tc, 5, greedy=True)
    t2, _ = tgen.generate(model, prompt, torch.Generator().manual_seed(42), tc, 5, greedy=True)
    assert torch.equal(t1, t2)


def test_top_k_one_sampling_is_greedy_with_logprob_zero():
    _, tc, _, model = _model("llama")
    prompt = torch.zeros((4, 4), dtype=torch.int32)
    ta, la = tgen.generate(model, prompt, torch.Generator().manual_seed(0), tc, 6, top_k=1)
    tb, _ = tgen.generate(model, prompt, torch.Generator().manual_seed(123), tc, 6, top_k=1)
    tg, _ = tgen.generate(model, prompt, None, tc, 6, greedy=True)
    assert torch.equal(ta, tb) and torch.equal(ta, tg)
    np.testing.assert_allclose(la.numpy(), 0.0, atol=1e-5)


def test_sampler_draws_the_masked_distribution():
    """Gumbel-max over the restricted support: the empirical frequencies
    of 20000 draws follow softmax of the masked, temperature-scaled
    logits (JAX's ``categorical`` draws the same distribution)."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(1, 12)).astype(np.float32) * 2)
    rows = logits.expand(20000, 12).contiguous()
    gen = torch.Generator().manual_seed(7)
    tok, logp = tgen.sample_tokens(rows, gen, False, 0.8, 5, 0.9)
    masked = tgen._mask_logits(logits / 0.8, 5, 0.9)
    probs = torch.softmax(masked, -1)[0].numpy()
    freq = np.bincount(tok.numpy(), minlength=12) / 20000
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(probs))
    np.testing.assert_allclose(freq, probs, atol=0.015)
    np.testing.assert_allclose(logp.numpy(), np.log(probs[tok.numpy()]), atol=1e-5)


MASK_CASES = [(0, 1.0), (3, 1.0), (99, 1.0), (0, 0.6), (0, 1e-6), (4, 0.7), (2, 0.5),
              (60, 0.95)]


@pytest.mark.parametrize("top_k,top_p", MASK_CASES)
def test_mask_logits_matches_jax(top_k, top_p):
    x = np.random.default_rng(6).normal(size=(5, 48)).astype(np.float32) * 3
    j = np.asarray(jgen._mask_logits(jnp.asarray(x), top_k, top_p))
    t = tgen._mask_logits(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    np.testing.assert_allclose(t[np.isfinite(t)], j[np.isfinite(j)], atol=MASK_TOL, rtol=0)


@pytest.mark.parametrize(
    "probs,top_k,top_p,keep",
    [
        ([0.5, 0.3, 0.15, 0.05], 0, 0.6, [1, 1, 0, 0]),  # the boundary token stays
        ([0.2, 0.5, 0.3], 0, 1e-6, [0, 1, 0]),  # a tiny p keeps the argmax
        ([0.4, 0.3, 0.2, 0.1], 2, 0.5, [1, 0, 0, 0]),  # the nucleus of the renormalized top-k
        ([0.4, 0.3, 0.2, 0.1], 0, 0.5, [1, 1, 0, 0]),
        ([0.5, 0.3, 0.15, 0.05], 2, 0.7, [1, 1, 0, 0]),
        ([0.5, 0.3, 0.15, 0.05], 100, 1.0, [1, 1, 1, 1]),  # top_k past the vocab keeps all
    ],
)
def test_mask_logits_edge_cases(probs, top_k, top_p, keep):
    out = tgen._mask_logits(torch.log(torch.tensor([probs])), top_k, top_p)
    np.testing.assert_array_equal(torch.isfinite(out[0]).numpy(), np.array(keep, bool))


def test_sampling_knobs_are_checked():
    _, tc, _, model = _model("llama")
    p = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="top_p"):
        tgen.generate(model, p, None, tc, top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        tcb.continuous_generate(model, p, torch.tensor([3, 3]), None, tc, top_k=-1)
    with pytest.raises(ValueError, match="temperature"):
        tcb.continuous_generate(model, p, torch.tensor([3, 3]), None, tc, temperature=0.0)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
def _queue(n, p_max, vocab, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, p_max + 1, size=n).astype(np.int32)
    toks = np.zeros((n, p_max), np.int32)
    for i, ln in enumerate(lens):
        toks[i, :ln] = rng.integers(1, vocab, size=ln)
    return toks, lens


@pytest.mark.parametrize(
    "name,N,slots,eos_step",
    [
        ("llama", 5, 2, None),  # refill waves through both slots, one slot idle at the end
        ("gpt2", 3, 3, 2),  # EOS on prompt 0's third token; learned positions
    ],
)
def test_greedy_continuous_generate_matches_jax(name, N, slots, eos_step):
    jc, tc, params, model = _model(name)
    new = 5
    toks, lens = _queue(N, 7, jc.vocab_size, seed=1)
    eos = -1
    if eos_step is not None:
        ref, _ = tgen.generate(model, torch.from_numpy(toks[:1, :lens[0]]), None, tc,
                               max_new_tokens=new, greedy=True)
        eos = int(ref[0, lens[0] + eos_step])
    got = tcb.continuous_generate(model, torch.from_numpy(toks), torch.from_numpy(lens), None,
                                  tc, max_new_tokens=new, slots=slots, greedy=True, eos_id=eos)
    want = jcb.continuous_generate(params, jnp.asarray(toks), jnp.asarray(lens),
                                   jax.random.PRNGKey(0), jc, max_new_tokens=new, slots=slots,
                                   greedy=True, eos_id=eos)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if eos_step is not None:  # prompt 0 stops at the first EOS it emits, and keeps it
        first = ref[0, lens[0]:].tolist().index(eos)
        assert int(got[2][0]) == lens[0] + first + 1
        assert int(got[0][0, lens[0] + first]) == eos
        assert not got[1][0, first + 1:].any()


def test_continuous_generate_matches_single_prompt_generate():
    """The slot machinery is invisible: each prompt's greedy decode is
    ``generate`` on that prompt alone; one device read an iteration."""
    _, tc, _, model = _model("llama")
    N, new = 6, 4
    toks, lens = _queue(N, 6, tc.vocab_size, seed=7)
    st = {}
    out = tcb.continuous_generate(model, torch.from_numpy(toks), torch.from_numpy(lens), None,
                                  tc, max_new_tokens=new, slots=2, greedy=True, stats=st)
    assert st["d2h_reads"] == st["iterations"] + 1 and st["graphs"] == 0
    for i in range(N):
        ln = int(lens[i])
        ref, ref_lp = tgen.generate(model, torch.from_numpy(toks[i:i + 1, :ln]), None, tc,
                                    max_new_tokens=new, greedy=True)
        assert torch.equal(out[0][i, :ln + new].long(), ref[0].long())
        np.testing.assert_allclose(out[1][i].numpy(), ref_lp[0].numpy(), atol=TOL, rtol=TOL)
        assert int(out[2][i]) == ln + new


def test_sampled_continuous_generate_is_seeded_and_restricted():
    _, tc, _, model = _model("llama")
    toks, lens = _queue(4, 6, tc.vocab_size, seed=9)
    args = (model, torch.from_numpy(toks), torch.from_numpy(lens))
    kw = dict(max_new_tokens=4, slots=2, temperature=0.8, top_k=5, top_p=0.9)
    a = tcb.continuous_generate(*args, torch.Generator().manual_seed(42), tc, **kw)
    b = tcb.continuous_generate(*args, torch.Generator().manual_seed(42), tc, **kw)
    c = tcb.continuous_generate(*args, torch.Generator().manual_seed(43), tc, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert (a[1] <= 0).all()
    g = tcb.continuous_generate(*args, None, tc, max_new_tokens=4, slots=2, greedy=True)
    k1 = tcb.continuous_generate(*args, torch.Generator().manual_seed(0), tc, max_new_tokens=4,
                                 slots=2, temperature=0.7, top_k=1)
    assert torch.equal(g[0], k1[0])


# ---------------------------------------------------------------------------
# reference fault 1: learned positions past max_seq_len
# ---------------------------------------------------------------------------
def test_positions_past_a_learned_table_raise_where_jax_clamps():
    """The JAX decode reads the position table with clamping indices, so
    a GPT-2 asked for more than ``max_seq_len`` positions decodes with
    wrong positions and no error; the port raises up front."""
    jc, tc, params, model = _model("gpt2")
    # the clamping itself: an index past the end reads the last row
    assert int(jnp.arange(5)[7]) == 4
    assert np.asarray(jax.lax.dynamic_slice_in_dim(jnp.arange(5), 4, 2)).tolist() == [3, 4]
    P, N = jc.max_seq_len - 2, 6  # positions up to max_seq_len + 3
    prompt = _tokens(np.random.default_rng(12), (1, P), jc.vocab_size)
    toks, lps = jgen.generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0), jc,
                              max_new_tokens=N, greedy=True)
    assert toks.shape == (1, P + N) and np.isfinite(np.asarray(lps)).all()  # no error
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.generate(model, torch.from_numpy(prompt), None, tc, max_new_tokens=N, greedy=True)
    with pytest.raises(ValueError, match="max_seq_len"):
        tcb.continuous_generate(model, torch.from_numpy(prompt), torch.tensor([P]), None, tc,
                                max_new_tokens=N, greedy=True)
    with pytest.raises(ValueError, match="max_seq_len"):
        ttr.forward_step(model, torch.ones((1, 3), dtype=torch.long), tc,
                         ttr.init_kv_cache(tc, 1, P + N), P)
    # RoPE has no table to run off: the port decodes past max_seq_len as
    # the JAX package does
    jc, tc, params, model = _model("llama")
    tj, _ = jgen.generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0), jc,
                          max_new_tokens=N, greedy=True)
    tt, _ = tgen.generate(model, torch.from_numpy(prompt), None, tc, max_new_tokens=N,
                          greedy=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_meshes_raise_a14b():
    _, tc, _, model = _model("llama")
    p = torch.zeros((1, 3), dtype=torch.int32)
    for call in (lambda: tgen.generate(model, p, None, tc, mesh=object()),
                 lambda: tcb.continuous_generate(model, p, torch.tensor([3]), None, tc,
                                                 mesh=object()),
                 lambda: RLHFEngine(tc, None, train_mesh=object(), rollout_mesh=object(),
                                    device="cpu")):
        with pytest.raises(NotImplementedError, match="A14b"):
            call()


# ---------------------------------------------------------------------------
# scoring: sequence logprobs, the critic, the reward model, GAE
# ---------------------------------------------------------------------------
def _heads(name, head_name, seed=3):
    jc, tc, params, _ = _model(name)
    rng = np.random.default_rng(seed)
    tree = {"trunk": params,
            head_name: (rng.normal(size=jc.model_dim) * jc.model_dim**-0.5).astype(np.float32)}
    return jc, tc, tree, head_model_from_jax(tree, tc, head_name)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_sequence_logprobs_and_critic_values_match_jax(name):
    jc, tc, params, model = _model(name)
    toks = _tokens(np.random.default_rng(8), (3, 11), jc.vocab_size)
    lj = jax.jit(jgen.sequence_logprobs, static_argnums=(2, 3))(params, jnp.asarray(toks), jc, 4)
    with torch.no_grad():
        lt = tgen.sequence_logprobs(model, torch.from_numpy(toks), tc, 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    _, _, tree, critic = _heads(name, "value_head")
    vj = jax.jit(jppo.critic_values, static_argnums=(2, 3))(tree, jnp.asarray(toks), jc, 4)
    with torch.no_grad():
        vt = tppo.critic_values(critic, torch.from_numpy(toks), tc, 4)
    assert vt.shape == (3, 7)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pad", [None, 0])
def test_reward_scores_and_preference_loss_match_jax(pad):
    jc, tc, tree, rm = _heads("llama", "reward_head")
    rng = np.random.default_rng(9)
    chosen, rejected = _tokens(rng, (4, 9), jc.vocab_size), _tokens(rng, (4, 9), jc.vocab_size)
    if pad is not None:  # right-padded rows of different lengths
        for row, n in zip(chosen, (9, 6, 3, 1)):
            row[n:] = pad
    sj = jax.jit(jrew.reward_scores, static_argnums=(2, 3))(tree, jnp.asarray(chosen), jc, pad)
    with torch.no_grad():
        st = trew.reward_scores(rm, torch.from_numpy(chosen), tc, pad)
        loss_t, acc_t = trew.preference_loss(rm, torch.from_numpy(chosen),
                                             torch.from_numpy(rejected), tc, pad)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL, rtol=TOL)
    loss_j, acc_j = jax.jit(jrew.preference_loss, static_argnums=(3, 4))(
        tree, jnp.asarray(chosen), jnp.asarray(rejected), jc, pad)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=TOL, rtol=TOL)
    assert float(acc_t) == float(acc_j)


def test_pad_aware_scoring_reads_the_last_real_token():
    _, tc, _, rm = _heads("llama", "reward_head")
    body = np.array([[5, 7, 3, 9, 4, 6]], np.int32)
    with torch.no_grad():
        s8 = trew.reward_scores(rm, torch.from_numpy(np.pad(body, ((0, 0), (0, 2)))), tc, 0)
        s12 = trew.reward_scores(rm, torch.from_numpy(np.pad(body, ((0, 0), (0, 6)))), tc, 0)
        naive = trew.reward_scores(rm, torch.from_numpy(np.pad(body, ((0, 0), (0, 6)))), tc)
    np.testing.assert_allclose(s8.numpy(), s12.numpy(), rtol=1e-5)
    assert abs(float(naive[0]) - float(s12[0])) > 1e-6


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    r, v = (rng.normal(size=(2, 5)).astype(np.float32) for _ in range(2))
    aj, rj = jppo.gae_advantages(jnp.asarray(r), jnp.asarray(v), 0.9, 0.8)
    at, rt = tppo.gae_advantages(torch.from_numpy(r), torch.from_numpy(v), 0.9, 0.8)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=TOL, rtol=TOL)


def test_head_trees_round_trip():
    _, _, tree, critic = _heads("gpt2", "value_head")
    back = head_model_to_numpy(critic)
    np.testing.assert_array_equal(back["value_head"], tree["value_head"])
    for a, b in zip(jax.tree.leaves(back["trunk"]), jax.tree.leaves(tree["trunk"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the updates against optax
# ---------------------------------------------------------------------------
def _assert_tree_close(port_tree, jax_tree):
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["llama"])
def test_ppo_update_matches_optax(name):
    """One ``_ppo_update`` from the same weights and minibatch: loss,
    metrics, the gradients (optax's first moment over ``1 - b1``) and
    the actor's and critic's updated params. Adam's first step moves a
    parameter by ``lr g / (|g| + eps)``: where ``|g|`` is near eps (1e-8)
    the f32 rounding of ``g`` is a difference of order ``lr`` in that
    step, so those parameters are held to Adam's step bound ``2 lr``
    and every other one to 1e-5."""
    jc, tc, params, _ = _model(name)
    _, _, ctree, _ = _heads(name, "value_head")
    ppo = PPOConfig(learning_rate=1e-3)
    rng = np.random.default_rng(10)
    B, P, N = 4, 3, 5
    toks = _tokens(rng, (B, P + N), jc.vocab_size)
    mb = {"tokens": toks}
    for k in ("logprobs", "values", "advantages", "returns"):
        mb[k] = rng.normal(size=(B, N)).astype(np.float32)
    with torch.no_grad():
        lp = tgen.sequence_logprobs(params_from_jax(params, tc), torch.from_numpy(toks), tc, P)
    mb["logprobs"] = lp.numpy() + rng.normal(size=(B, N)).astype(np.float32) * 0.3  # some clip
    tx = optax.adamw(ppo.learning_rate)
    jp = {"actor": params, "critic": ctree}
    step = jax.jit(functools.partial(jppo._ppo_update, cfg=jc, ppo=ppo, tx=tx),
                   static_argnums=(3,))
    jp2, state, mj = step(jp, tx.init(jp), {k: jnp.asarray(v) for k, v in mb.items()}, P)
    actor = params_from_jax(params, tc)
    critic = head_model_from_jax(ctree, tc, "value_head")
    opt = trew.optax_adamw(list(actor.parameters()) + list(critic.parameters()),
                           ppo.learning_rate)
    mt = tppo._ppo_update({"actor": actor, "critic": critic}, opt,
                          {k: torch.from_numpy(v) for k, v in mb.items()}, P, cfg=tc, ppo=ppo)
    assert 0.0 < float(mt["clip_frac"]) < 1.0
    for k, v in mj.items():
        np.testing.assert_allclose(float(mt[k]), float(v), atol=TOL, rtol=TOL, err_msg=k)
    mu = state[0].mu
    grads = {"actor": params_to_numpy(_grads_of(actor)),
             "critic": head_model_to_numpy(_grads_of(critic))}
    new = {"actor": params_to_numpy(actor), "critic": head_model_to_numpy(critic)}
    for g, m, p, q in zip(jax.tree.leaves(grads), jax.tree.leaves(mu), jax.tree.leaves(new),
                          jax.tree.leaves(jp2)):
        np.testing.assert_allclose(g, np.asarray(m) / 0.1, atol=TOL, rtol=1e-4)
        sound = np.abs(g) > 1e-6
        np.testing.assert_allclose(p[sound], np.asarray(q)[sound], atol=TOL, rtol=TOL)
        assert np.abs(p - np.asarray(q)).max() <= 2 * ppo.learning_rate
    moved = max(np.abs(a - np.asarray(b)).max() for a, b in
                zip(jax.tree.leaves(new["actor"]), jax.tree.leaves(params)))
    assert moved > 0.5 * ppo.learning_rate


def _grads_of(model):
    """A copy of ``model`` holding its parameters' gradients as values."""
    import copy

    out = copy.deepcopy(model)
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(), out.named_parameters()):
            q.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    return out


def test_reward_model_step_matches_optax():
    jc, tc, tree, _ = _heads("llama", "reward_head")
    rng = np.random.default_rng(11)
    c, r = _tokens(rng, (6, 8), jc.vocab_size), _tokens(rng, (6, 8), jc.vocab_size)
    tx = optax.adamw(1e-2)
    step = jax.jit(functools.partial(jrew._reward_update, cfg=jc, tx=tx))
    jp2, _, mj = step(tree, tx.init(tree), jnp.asarray(c), jnp.asarray(r))
    rm = RewardModel(tc, lr=1e-2, device="cpu")
    rm.set_params(head_model_from_jax(tree, tc, "reward_head"))
    mt = rm.train_on_preferences(c, r)
    np.testing.assert_allclose(mt["loss"], float(mj["loss"]), atol=TOL, rtol=TOL)
    assert mt["accuracy"] == float(mj["accuracy"])
    _assert_tree_close(head_model_to_numpy(rm.params), jp2)


def test_reward_model_learns_preferences():
    _, tc, _, _ = _model("llama")
    rng = np.random.default_rng(0)

    def pairs(n):
        chosen = rng.choice([3, 4], size=(n, 12), p=[0.9, 0.1])
        rejected = rng.choice([11, 4], size=(n, 12), p=[0.9, 0.1])
        return chosen.astype(np.int32), rejected.astype(np.int32)

    rm = RewardModel(tc, lr=1e-3, seed=0, device="cpu")
    c, r = pairs(64)
    for _ in range(30):
        m = rm.train_on_preferences(c, r)
    assert m["accuracy"] == 1.0, m
    c, r = pairs(32)
    assert (rm.score(c) > rm.score(r)).mean() > 0.9


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _engine(tc, **ppo):
    return RLHFEngine(tc, lambda tokens, p: (tokens[:, p:] == 7).mean(1).astype(np.float32),
                      ppo=PPOConfig(**ppo), seed=0, device="cpu")


def test_ppo_config_forwards_sampling_knobs():
    _, tc, _, _ = _model("llama")
    eng = _engine(tc, rollout_batch=4, max_new_tokens=6, minibatch_size=4, ppo_epochs=1,
                  top_k=1)
    exp = eng.make_experience(np.tile(np.array([[2, 9, 4, 1]], np.int32), (4, 1)))
    assert (exp.tokens == exp.tokens[0]).all()


def test_restricted_sampling_keeps_the_ratio_centered_and_trains():
    """The recorded old logprobs are the update's own scoring (not the
    sampler's), so the first minibatch's ratio is 1: approx_kl and
    clip_frac 0; every metric finite."""
    _, tc, _, _ = _model("llama")
    eng = _engine(tc, rollout_batch=4, max_new_tokens=6, minibatch_size=4, ppo_epochs=2,
                  top_k=2, temperature=0.7, learning_rate=1e-3)
    prompts = np.tile(np.array([[2, 9, 4, 1]], np.int32), (4, 1))
    exp = eng.make_experience(prompts)
    with torch.no_grad():
        rescored = tgen.sequence_logprobs(eng.actor_params, torch.from_numpy(exp.tokens), tc, 4)
    np.testing.assert_allclose(exp.logprobs, rescored.numpy(), rtol=1e-5, atol=1e-6)
    seen = []
    last = eng.train(prompt_len=4, on_update=seen.append)
    assert len(seen) == 2 and abs(seen[0]["approx_kl"]) < 1e-6 and seen[0]["clip_frac"] == 0.0
    assert all(np.isfinite(v) for m in seen for v in m.values())
    assert last == seen[-1] and len(eng.buffer) == 0


def test_the_example_runs_on_the_cpu():
    """``examples/rlhf_ppo_torch.py --cpu``: the reward model, then PPO,
    every metric finite."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "rlhf_ppo_torch.py")
    spec = importlib.util.spec_from_file_location("rlhf_ppo_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    metrics = mod.main(["--cpu", "--iters", "1", "--rm-steps", "2"])
    assert all(np.isfinite(v) for v in metrics.values())
