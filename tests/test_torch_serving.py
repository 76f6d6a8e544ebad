"""Port parity: the serving slice of dlrover_tpu_torch (the shm
publication's seqlock generation, the zero-copy subscriber and its crc
gate, ``ServingEngine`` and the goodput ledger's ``serving_soak`` row),
case by case after the JAX package's ``tests/test_serving.py``, plus
both directions across the packages: a frame one package publishes polls
in the other's subscriber.

The torn-frame cases are driven by the ``serve.stale_read`` delay (or a
commit made inside the engine's copy), never by a race left to chance;
every thread is joined with a time limit. The file's shm ranks and job
name are its own.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ckpt.sharding import host_shard_records
from dlrover_tpu_torch.ckpt.shm_handler import (
    ShmCrcError,
    ShmHandler,
    ShmSubscriber,
    data_crc32,
)
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.models import transformer as ttr
from dlrover_tpu_torch.models.convert import param_state
from dlrover_tpu_torch.obs import goodput as obs_goodput
from dlrover_tpu_torch.obs.goodput import GoodputLedger
from dlrover_tpu_torch.obs.trace import SpanTracer
from dlrover_tpu_torch.parallel import transfer_sched
from dlrover_tpu_torch.rl.continuous_batching import continuous_generate
from dlrover_tpu_torch.serve import METRIC_PREFIX, ServingConfig, ServingEngine
from dlrover_tpu_torch.obs.metrics import MetricsRegistry

MS = 1_000_000  # ns
JOIN_S = 10.0
_RANKS = itertools.count(260)


@pytest.fixture(autouse=True)
def _own_job_and_clean_faults(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", "torch_serving")
    faults.reset()
    yield
    faults.reset()


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "b": rng.normal(size=(4,)).astype(np.float32),
        "w": rng.normal(size=(8, 4)).astype(np.float32),
    }


@pytest.fixture
def chan():
    """One publication channel: a port writer plus a port subscriber
    factory."""
    rank = next(_RANKS)
    writer = ShmHandler(rank, create=True)
    subs = []

    def subscribe(**kw):
        s = ShmSubscriber(rank, **kw)
        subs.append(s)
        return s

    yield writer, subscribe
    for s in subs:
        s.close()
    writer.close(unlink=True)


def _join(t):
    t.join(JOIN_S)
    assert not t.is_alive(), "thread did not finish in time"


class TestSeqlockPublication:
    def test_generation_parity_and_monotonicity(self, chan):
        writer, _ = chan
        recs = host_shard_records(_state())
        writer.save_records(1, recs, {})
        meta = writer.metadata()
        assert meta["valid"] and meta["gen"] % 2 == 0
        g0 = meta["gen"]
        writer.begin_save(sum(r.data.nbytes for r in recs))
        mid = writer.metadata()
        assert not mid["valid"] and mid["gen"] % 2 == 1 and mid["gen"] > g0
        metas = writer.layout_records(recs)
        for r, m in zip(recs, metas):
            m.crc32 = data_crc32(r.data)
            writer.write_chunk(m.offset, r.data)
        writer.commit_save(2, metas, {})
        done = writer.metadata()
        assert done["valid"] and done["gen"] % 2 == 0 and done["gen"] > mid["gen"]

    def test_subscriber_maps_zero_copy(self, chan):
        writer, subscribe = chan
        state = _state()
        writer.save_records(5, host_shard_records(state), {})
        sub = subscribe()
        frame = sub.poll()
        assert frame is not None and frame.step == 5
        seg = np.frombuffer(sub.handler._shm.buf, dtype=np.uint8)
        for r in frame.records:
            assert np.shares_memory(r.data, seg)
        np.testing.assert_array_equal(frame.by_path()["w"].data, state["w"])
        del frame, seg

    def test_no_new_commit_returns_none(self, chan):
        writer, subscribe = chan
        writer.save_records(1, host_shard_records(_state()), {})
        sub = subscribe()
        assert sub.poll() is not None
        assert sub.poll() is None
        writer.save_records(2, host_shard_records(_state(1)), {})
        frame = sub.poll()
        assert frame is not None and frame.step == 2
        del frame

    def test_mid_write_frame_invisible(self, chan):
        writer, subscribe = chan
        recs = host_shard_records(_state())
        writer.save_records(1, recs, {})
        sub = subscribe()
        assert sub.poll() is not None
        writer.begin_save(sum(r.data.nbytes for r in recs))
        assert sub.poll() is None
        assert sub.torn_retries == 0

    def test_torn_frame_caught_by_generation_recheck(self, chan):
        """A commit inside the ``serve.stale_read`` delay: the frame is
        dropped (``torn_retries``), the next poll adopts the commit."""
        writer, subscribe = chan
        writer.save_records(1, host_shard_records(_state()), {})
        sub = subscribe()
        assert sub.poll() is not None
        writer.save_records(2, host_shard_records(_state(2)), {})
        faults.configure("serve.stale_read:delay:1.0")
        mapped = threading.Event()
        real_load = sub.handler.load_records

        def load_then_signal(*a, **kw):
            out = real_load(*a, **kw)
            mapped.set()  # the views exist: the delay starts now
            return out

        sub.handler.load_records = load_then_signal

        def racing_commit():
            assert mapped.wait(JOIN_S)
            writer.save_records(3, host_shard_records(_state(3)), {})

        t = threading.Thread(target=racing_commit)
        t.start()
        frame = sub.poll()
        _join(t)
        assert frame is None and sub.torn_retries == 1
        faults.reset()
        frame = sub.poll()
        assert frame is not None and frame.step == 3
        del frame

    def test_restarted_writer_continues_generation(self, chan):
        writer, subscribe = chan
        writer.save_records(1, host_shard_records(_state()), {})
        g0 = writer.metadata()["gen"]
        sub = subscribe()
        assert sub.poll() is not None
        writer2 = ShmHandler(writer.local_rank, create=False)
        try:
            writer2.save_records(2, host_shard_records(_state(1)), {})
            assert writer2.metadata()["gen"] > g0
            frame = sub.poll()
            assert frame is not None and frame.step == 2
            del frame
        finally:
            writer2.close()


class TestCrcGate:
    def _publish_rotten(self, writer, state, step, seed=7):
        faults.configure(f"ckpt.shm_stage:bit_flip:@1:{seed}")
        try:
            writer.save_records(step, host_shard_records(state), {})
        finally:
            faults.reset()

    def test_typed_error_names_the_record(self, chan):
        writer, _ = chan
        self._publish_rotten(writer, _state(), 1)
        with pytest.raises(ShmCrcError) as ei:
            writer.load_records(verify=True)
        err = ei.value
        assert err.record == "b" and err.index == 0 and err.want != err.got
        assert "checksum mismatch" in str(err) and isinstance(err, ValueError)

    def test_subscriber_skips_rotten_generation(self, chan):
        writer, subscribe = chan
        writer.save_records(1, host_shard_records(_state()), {})
        sub = subscribe()
        f1 = sub.poll()
        assert f1 is not None and f1.step == 1
        del f1
        self._publish_rotten(writer, _state(2), 2)
        assert sub.poll() is None and sub.crc_retries == 1 and sub.last_crc_record == "b"
        assert sub.poll() is None and sub.crc_retries == 1
        writer.save_records(3, host_shard_records(_state(3)), {})
        f3 = sub.poll()
        assert f3 is not None and f3.step == 3
        del f3

    def test_a_tear_the_crc_sees_counts_as_torn_not_rot(self, chan, monkeypatch):
        """The writer's next save begins while the subscriber reads: the
        torn bytes fail their crc, but the generation moved on, so it is
        a tear (``torn_retries``), not rot; the JAX subscriber books the
        same read as a crc failure."""
        from dlrover_tpu.ckpt.sharding import host_shard_records as jax_records
        from dlrover_tpu.ckpt.shm_handler import ShmHandler as JaxHandler
        from dlrover_tpu.ckpt.shm_handler import ShmSubscriber as JaxSubscriber
        import dlrover_tpu.ckpt.shm_handler as jax_shm
        import dlrover_tpu_torch.ckpt.shm_handler as port_shm

        def tear_under_the_read(writer, sub, module, monkeypatch):
            """The next save begins, and its first bytes land, as the
            subscriber's first crc starts."""
            import zlib

            torn = []

            def crc32(data, value=0):
                if not torn:
                    torn.append(1)
                    writer.begin_save(144)  # the frame's own size: the same segment
                    writer.write_chunk(0, np.full(64, 255, np.uint8))
                return zlib.crc32(data, value)

            monkeypatch.setattr(module, "zlib", type("Z", (), {"crc32": staticmethod(crc32)}))
            try:
                return sub.poll()
            finally:
                monkeypatch.setattr(module, "zlib", zlib)

        writer, subscribe = chan
        writer.save_records(1, host_shard_records(_state()), {})
        sub = subscribe()
        assert tear_under_the_read(writer, sub, port_shm, monkeypatch) is None
        assert (sub.torn_retries, sub.crc_retries) == (1, 0)
        writer.save_records(2, host_shard_records(_state(2)), {})
        frame = sub.poll()
        assert frame is not None and frame.step == 2
        del frame

        rank = next(_RANKS)
        jw = JaxHandler(rank, create=True)
        js = JaxSubscriber(rank)
        try:
            jw.save_records(1, jax_records(_state()), {})
            assert tear_under_the_read(jw, js, jax_shm, monkeypatch) is None
            assert (js.torn_retries, js.crc_retries) == (0, 1)
        finally:
            js.close()
            jw.close(unlink=True)

    def test_a_recreated_segment_is_mapped_again(self, chan):
        """A writer that grew its segment made a new one under the same
        name. A frame that still fits the old mapping is read from the
        new segment: the JAX handler keeps reading its stale mapping
        (every crc fails), the port's maps the new one."""
        from dlrover_tpu.ckpt.sharding import host_shard_records as jax_records
        from dlrover_tpu.ckpt.shm_handler import ShmHandler as JaxHandler
        from dlrover_tpu.ckpt.shm_handler import ShmSubscriber as JaxSubscriber

        writer, subscribe = chan
        sub = subscribe()
        rank = next(_RANKS)
        jw = JaxHandler(rank, create=True)
        js = JaxSubscriber(rank)
        try:
            for w, s, recs in ((writer, sub, host_shard_records), (jw, js, jax_records)):
                w.save_records(1, recs(_state()), {})
                assert s.poll() is not None
                w.begin_save(1 << 16)  # grows: a new segment
                w.write_chunk(0, np.zeros(16, np.uint8))
                metas = w.layout_records(recs(_state(2)))
                for r, m in zip(recs(_state(2)), metas):
                    m.crc32 = data_crc32(r.data)
                    w.write_chunk(m.offset, r.data)
                w.commit_save(2, metas, {})
            frame = sub.poll()
            assert frame is not None and frame.step == 2 and sub.crc_retries == 0
            np.testing.assert_array_equal(frame.by_path()["w"].data, _state(2)["w"])
            del frame
            assert js.poll() is None and js.crc_retries == 1
        finally:
            js.close()
            jw.close(unlink=True)

    def test_subscribe_fault_site_raises_through(self, chan):
        writer, subscribe = chan
        writer.save_records(1, host_shard_records(_state()), {})
        sub = subscribe()
        faults.configure("serve.subscribe:io_error:@1")
        with pytest.raises(OSError):
            sub.poll()
        faults.reset()
        frame = sub.poll()
        assert frame is not None and frame.step == 1
        del frame

    def test_wait_for_commit_times_out_and_delivers(self, chan):
        writer, subscribe = chan
        sub = subscribe()
        assert sub.wait_for_commit(timeout=0.05, interval=0.01) is None
        writer.save_records(4, host_shard_records(_state()), {})
        frame = sub.wait_for_commit(timeout=2.0, interval=0.01)
        assert frame is not None and frame.step == 4
        del frame


class TestAcrossPackages:
    """The meta dict's fields are the JAX package's: each package's
    subscriber polls the other's publication, generations included."""

    def test_jax_published_frame_polls_in_the_port(self):
        from dlrover_tpu.ckpt.sharding import host_shard_records as jax_records
        from dlrover_tpu.ckpt.shm_handler import ShmHandler as JaxHandler

        rank = next(_RANKS)
        writer = JaxHandler(rank, create=True)
        sub = ShmSubscriber(rank)
        try:
            writer.save_records(7, jax_records(_state(4)), {"k": 1})
            frame = sub.poll()
            assert frame is not None and frame.step == 7 and frame.extra == {"k": 1}
            assert frame.generation == writer.metadata()["gen"] and frame.generation % 2 == 0
            np.testing.assert_array_equal(frame.by_path()["w"].data, _state(4)["w"])
            assert sub.frame_is_current(frame)
            writer.begin_save(1 << 10)
            assert not sub.frame_is_current(frame)
            del frame
        finally:
            sub.close()
            writer.close(unlink=True)

    def test_port_published_frame_polls_in_jax(self):
        from dlrover_tpu.ckpt.shm_handler import ShmSubscriber as JaxSubscriber

        rank = next(_RANKS)
        writer = ShmHandler(rank, create=True)
        sub = JaxSubscriber(rank)
        try:
            writer.save_records(8, host_shard_records(_state(5)), {})
            frame = sub.poll()
            assert frame is not None and frame.step == 8
            np.testing.assert_array_equal(frame.by_path()["b"].data, _state(5)["b"])
            writer.save_records(9, host_shard_records(_state(6)), {})
            frame = sub.poll()
            assert frame is not None and frame.step == 9 and sub.frames == 2
            del frame
        finally:
            sub.close()
            writer.close(unlink=True)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
_CFG = tcfg.tiny(vocab_size=31, num_layers=1, max_seq_len=32)


def _params(seed):
    return ttr.init_params(torch.Generator().manual_seed(seed), _CFG)


def _prompts(n=3, p_max=6, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, p_max + 1, size=n).astype(np.int32)
    toks = np.zeros((n, p_max), np.int32)
    for i, ln in enumerate(lens):
        toks[i, :ln] = rng.integers(1, _CFG.vocab_size, size=ln)
    return torch.from_numpy(toks), torch.from_numpy(lens)


def _publish(writer, step, model):
    writer.save_records(step, host_shard_records(param_state(model)), {})


def _decode_direct(params, prompts, lens, scfg):
    return continuous_generate(params, prompts, lens, None, _CFG,
                               max_new_tokens=scfg.max_new_tokens, eos_id=scfg.eos_id,
                               slots=scfg.slots, greedy=True)


def _engine(chan, soak="always", **kw):
    _, subscribe = chan
    scfg = ServingConfig(max_new_tokens=4, slots=2, soak=soak, **kw)
    template = ttr.Transformer(_CFG)  # zeros: filled by the first swap
    return ServingEngine(_CFG, subscribe(), template, scfg, registry=MetricsRegistry()), scfg


class TestServingEngine:
    def test_swap_and_bitwise_decode(self, chan):
        """Serving equals decoding under the same weights restored
        directly from a copy of the frame (``load_records(copy=True)``)."""
        writer, _ = chan
        p0 = _params(3)
        eng, scfg = _engine(chan)
        with pytest.raises(RuntimeError):
            eng.serve_batch(*_prompts())
        _publish(writer, 10, p0)
        assert eng.try_swap() and eng.weight_step == 10 and eng.swaps == 1
        prompts, lens = _prompts()
        got = eng.serve_batch(prompts, lens)
        from dlrover_tpu_torch.ckpt.sharding import restore_state

        _, recs, _ = writer.load_records(copy=True)
        direct = ttr.Transformer(_CFG)
        by = {r.path: [r] for r in recs}
        restore_state(param_state(direct), lambda p: by.get(p, []))
        want = _decode_direct(direct, prompts, lens, scfg)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        stats = eng.stats()
        assert stats["swaps"] == 1 and stats["staleness_steps"] == 0
        assert eng._m_tokens.value == int((got[2] - lens).sum())
        assert eng._m_tokens.name == METRIC_PREFIX + "tokens_total"

    def test_swap_only_between_batches_tracks_staleness(self, chan):
        writer, _ = chan
        p0, p1 = _params(3), _params(4)
        eng, scfg = _engine(chan)
        _publish(writer, 10, p0)
        assert eng.try_swap()
        _publish(writer, 12, p1)
        assert eng.staleness_steps() == 2
        prompts, lens = _prompts(seed=1)
        assert torch.equal(eng.serve_batch(prompts, lens)[0],
                           _decode_direct(p0, prompts, lens, scfg)[0])
        assert eng.try_swap() and eng.weight_step == 12 and eng.staleness_steps() == 0
        assert torch.equal(eng.serve_batch(prompts, lens)[0],
                           _decode_direct(p1, prompts, lens, scfg)[0])
        # every swap fills the one template; the decode reads a cast of
        # its own, never the template's tensors
        _publish(writer, 14, p0)
        assert eng.try_swap() and eng.params is eng.params_template
        held = {p.data_ptr() for p in eng.params_template.parameters()}
        w = eng._weights
        cast = [t for lw in w.layers for d in (lw.attn_norm, lw.mlp_norm, lw.attn, lw.mlp)
                for t in d.values()] + [w.embed, w.head, *w.final_norm.values()]
        assert not any(t.data_ptr() in held for t in cast)
        assert torch.equal(eng.serve_batch(prompts, lens)[0],
                           _decode_direct(p0, prompts, lens, scfg)[0])

    def test_swap_fault_keeps_previous_weights(self, chan):
        writer, _ = chan
        p0, p1 = _params(3), _params(4)
        eng, _ = _engine(chan)
        _publish(writer, 10, p0)
        assert eng.try_swap()
        _publish(writer, 11, p1)
        faults.configure("serve.swap:io_error:@1")
        assert not eng.try_swap() and eng.weight_step == 10
        faults.reset()
        _publish(writer, 13, p1)
        assert eng.try_swap() and eng.weight_step == 13

    def test_commit_during_the_copy_drops_the_torn_params(self, chan, monkeypatch):
        """A commit that lands while the swap copies off the views: the
        generation re-check drops the copy, the engine serves the weights
        it held, and the next poll adopts the racing commit."""
        import dlrover_tpu_torch.serve.engine as eng_mod

        writer, _ = chan
        p0, p1, p2 = _params(3), _params(4), _params(5)
        eng, scfg = _engine(chan)
        _publish(writer, 10, p0)
        assert eng.try_swap()
        _publish(writer, 11, p1)
        real = eng_mod.restore_state

        def restore_then_commit(state, read):
            out = real(state, read)
            _publish(writer, 12, p2)  # lands before the re-check
            return out

        monkeypatch.setattr(eng_mod, "restore_state", restore_then_commit)
        assert not eng.try_swap()
        assert eng.dropped_swaps == 1 and eng.weight_step == 10
        assert eng.weights_dirty and eng.stats()["weights_dirty"]
        prompts, lens = _prompts(seed=2)
        assert torch.equal(eng.serve_batch(prompts, lens)[0],
                           _decode_direct(p0, prompts, lens, scfg)[0])
        monkeypatch.setattr(eng_mod, "restore_state", real)
        assert eng.try_swap() and eng.weight_step == 12 and not eng.weights_dirty
        assert torch.equal(eng.serve_batch(prompts, lens)[0],
                           _decode_direct(p2, prompts, lens, scfg)[0])

    def test_idle_gap_gate(self, chan):
        eng, _ = _engine(chan, soak="idle_gaps", gap_wait_timeout_s=0.05,
                         gap_poll_interval_s=0.005)
        try:
            transfer_sched.note_compute(True)
            assert transfer_sched.get_arbiter().in_compute_window()
            assert not eng._wait_for_gap()
            transfer_sched.note_compute(False)
            assert not transfer_sched.get_arbiter().in_compute_window()
            assert eng._wait_for_gap()
        finally:
            transfer_sched.note_compute(False)

    def test_embedding_probe_is_read_only(self, chan):
        eng, _ = _engine(chan)
        calls = []

        class Table:
            def gather(self, ids, insert_missing=True):
                calls.append(insert_missing)
                return np.zeros((len(ids), 4), np.float32)

        rows = eng.embedding_probe(Table(), np.array([3, 5, 9]))
        assert rows.shape == (3, 4) and calls == [False]
        assert eng._m_probe_rows.value == 3

    def test_mesh_raises_a14b(self, chan):
        _, subscribe = chan
        with pytest.raises(NotImplementedError, match="A14b"):
            ServingEngine(_CFG, subscribe(), ttr.Transformer(_CFG), mesh=object())


def test_swap_is_priced_at_the_records_it_reads_where_jax_prices_the_frame():
    """Reference fault 2: a trainer that publishes its whole train state
    ships the optimizer's moments too. The JAX engine asks the arbiter
    for the whole frame's bytes; the port asks for the params' bytes,
    the ones it copies."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.ckpt.sharding import host_shard_records as jax_records
    from dlrover_tpu.ckpt.shm_handler import ShmHandler as JaxHandler
    from dlrover_tpu.ckpt.shm_handler import ShmSubscriber as JaxSubscriber
    from dlrover_tpu.serve import ServingConfig as JaxConfig
    from dlrover_tpu.serve import ServingEngine as JaxEngine
    from dlrover_tpu_torch.models.convert import params_to_numpy

    model = _params(3)
    params = params_to_numpy(model)
    moments = jax.tree.map(np.zeros_like, params)
    state = {"params": params, "opt_state": {"mu": moments, "nu": moments},
             "step": np.asarray(5, np.int32)}
    param_bytes = sum(a.nbytes for a in jax.tree.leaves(params))
    frame_bytes = sum(np.asarray(a).nbytes for a in jax.tree.leaves(state))
    rank = next(_RANKS)
    writer = JaxHandler(rank, create=True)
    subs = [JaxSubscriber(rank), ShmSubscriber(rank)]
    try:
        writer.save_records(5, jax_records(state), {})
        asked = {}

        def recorder(name, stream):
            real = stream.transfer

            def transfer(nbytes, *a, **kw):
                asked[name] = nbytes
                return real(nbytes, *a, **kw)

            return transfer

        jeng = JaxEngine(None, subs[0], jax.tree.map(jnp.zeros_like, params),
                         JaxConfig(soak="always"), param_prefix="params/")
        jeng._stream.transfer = recorder("jax", jeng._stream)
        teng = ServingEngine(_CFG, subs[1], ttr.Transformer(_CFG), ServingConfig(soak="always"),
                             param_prefix="params/", registry=MetricsRegistry())
        teng._stream.transfer = recorder("port", teng._stream)
        assert jeng.try_swap() and teng.try_swap()
        assert asked["jax"] == frame_bytes and frame_bytes > 2.9 * param_bytes
        assert asked["port"] == param_bytes == teng.stats()["last_swap_bytes"]
        for a, b in zip(jax.tree.leaves(params_to_numpy(teng.params)), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        del jeng
    finally:
        for s in subs:
            s.close()
        writer.close(unlink=True)


# ---------------------------------------------------------------------------
# the goodput row
# ---------------------------------------------------------------------------
class TestServingGoodput:
    def _ledger(self):
        tr = SpanTracer(enabled=True)
        led = GoodputLedger(tracer=tr, tid_fn=lambda: 1)
        led._t0_ns -= 1_000 * MS
        led._last_ns -= 1_000 * MS
        return tr, led, led._last_ns

    @staticmethod
    def _put(tracer, name, start_ns, dur_ns, tid=1, depth=0):
        tracer._buf.append((name, tid, start_ns, dur_ns, depth, None, next(tracer._seq)))
        tracer._appended += 1

    def test_serving_soak_claims_only_idle_time(self):
        tr, led, t0 = self._ledger()
        self._put(tr, "compute", t0, 100 * MS)
        led.mark_interval("serving_soak", t0 + 60 * MS, t0 + 180 * MS)
        rep = led.snapshot(now_ns=t0 + 200 * MS)
        assert rep.seconds["productive_compute"] == pytest.approx(0.100)
        assert rep.seconds["serving_soak"] == pytest.approx(0.080)
        assert rep.goodput_pct == pytest.approx(50.0)
        assert rep.closure_error_pct == pytest.approx(0.0, abs=1e-6)

    def test_serving_episode_channel(self):
        _, led, _ = self._ledger()
        led.serving_begin()
        time.sleep(0.03)
        led.serving_end()
        rep = led.snapshot()
        assert rep.seconds["serving_soak"] >= 0.025
        assert rep.closure_error_pct == pytest.approx(0.0, abs=1e-6)

    def test_note_serving_seam(self, monkeypatch):
        _, led, _ = self._ledger()
        monkeypatch.setattr(obs_goodput, "_default", None)
        obs_goodput.note_serving(True)  # no ledger: must not raise
        obs_goodput.install_default_ledger(led)
        obs_goodput.note_serving(True)
        time.sleep(0.02)
        obs_goodput.note_serving(False)
        assert led.snapshot().seconds["serving_soak"] >= 0.015
        monkeypatch.setattr(obs_goodput, "_default", None)

    def test_a_served_batch_is_booked_to_serving_soak(self, chan, monkeypatch):
        writer, _ = chan
        _, led, _ = self._ledger()
        monkeypatch.setattr(obs_goodput, "_default", led)
        eng, _ = _engine(chan)
        _publish(writer, 1, _params(3))
        assert eng.try_swap()
        eng.serve_batch(*_prompts())
        assert led.snapshot().seconds["serving_soak"] > 0
        monkeypatch.setattr(obs_goodput, "_default", None)


class TestCaptureAgainstDeviceSync:
    """A card-wide synchronize and a CUDA graph capture in another thread
    never overlap (``cuda_sync``): the trainer's ``_settle`` and the
    decode's capture take one lock. Here ``torch.cuda.synchronize`` is a
    recorder, so the order shows without a card."""

    def _hold(self, opened, release):
        from dlrover_tpu_torch.common import cuda_sync

        with cuda_sync.capturing():
            opened.set()
            release.wait(JOIN_S)

    def test_settle_waits_for_an_open_capture(self, monkeypatch):
        from types import SimpleNamespace

        from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

        events = []
        monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: events.append("sync"))
        opened, release = threading.Event(), threading.Event()
        th = threading.Thread(target=self._hold, args=(opened, release))
        th.start()
        assert opened.wait(JOIN_S)
        stub = SimpleNamespace(device=torch.device("cuda"), state="state",
                               _book_compute=lambda wait: events.append("book"))
        settler = threading.Thread(target=ElasticTrainer._settle, args=(stub,))
        settler.start()
        time.sleep(0.1)
        assert events == []  # still waiting for the capture
        events.append("capture ended")
        release.set()
        th.join(JOIN_S)
        settler.join(JOIN_S)
        assert not th.is_alive() and not settler.is_alive()
        assert events == ["capture ended", "sync", "book"]

    def test_the_decode_capture_holds_the_lock(self, monkeypatch):
        """``_DecodeGraphs`` captures under ``cuda_sync.capturing()``."""
        import contextlib

        from dlrover_tpu_torch.common import cuda_sync
        from dlrover_tpu_torch.rl import continuous_batching as cb

        held = []

        class Graph:
            def replay(self):
                pass

        class Stream:
            def wait_stream(self, other):
                pass

        monkeypatch.setattr(cb, "_WARMUP_STREAMS", {torch.device("cpu"): Stream()})
        monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)

        @contextlib.contextmanager
        def graph(g, capture_error_mode=None):
            held.append(cuda_sync._LOCK._is_owned())
            yield

        monkeypatch.setattr(torch.cuda, "graph", graph)
        model = ttr.Transformer(_CFG)
        cache = ttr.init_kv_cache(_CFG, 2, 8)
        w = ttr.decode_weights(model, _CFG)
        graphs = cb._DecodeGraphs(model, _CFG, cache, w, 2, torch.device("cpu"))
        out = graphs(torch.tensor([1, 2]), torch.tensor([0, 0]), 1)
        assert held == [True] and out.shape[0] == 2
        assert not cuda_sync._LOCK._is_owned()
