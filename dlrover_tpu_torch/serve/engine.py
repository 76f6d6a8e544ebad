"""Continuous-batching serving engine over subscriber-mapped weights
(counterpart of ``dlrover_tpu/serve/engine.py``).

Co-location contract (what keeps training whole while serving earns
tokens):

- **Weights**: adopted only from seqlock-validated, crc-verified
  ``PublishedFrame``s; a swap happens strictly BETWEEN batches — a
  sequence is always decoded end-to-end under one weight step. The
  frame's records fill the template, a port ``Transformer`` on the
  card; the decode reads only the cast of the served step
  (``decode_weights(own=True)``: tensors of its own), which a swap
  replaces once its copy is whole. After the host→device copy the
  frame's generation is re-checked: a commit that landed mid-copy tears
  the views, so the template is left dirty (``weights_dirty``) and the
  engine keeps serving the previous step's cast, which the copy never
  touched.
- **Transfers**: every swap's host→device bytes ride a
  ``Priority.BACKGROUND`` arbiter stream (``serve_h2d``), priced at the
  bytes of the records the swap reads: a trainer that publishes its
  whole train state also ships the optimizer's moments, which the swap
  never copies (the JAX engine prices the whole frame).
- **Sparse state**: serving-side embedding lookups go through the
  read-only probe (``gather(insert_missing=False)``), so serving
  traffic can neither admit rows to the trainer's hot tier nor perturb
  its LRU recency / pin state.
- **Scheduling**: with ``soak="idle_gaps"`` a batch starts only while
  the arbiter's compute-window marks read idle (between steps, resize
  drains, or no trainer at all); batch wall time is booked to the
  goodput ledger's ``serving_soak`` row, which ranks below every
  training category — serving can only claim seconds training left
  unclaimed.

Each swap casts the weights to the activation dtype once
(``decode_weights``); every batch decodes from that cast. The card
holds the template and one cast (Llama-2-7B: 26.95 GB f32 and 13.5 GB
bf16); the previous cast is let go before the next is made. Everything
observable exports as ``dlrover_serving_*`` metrics.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ckpt.sharding import ShardRecord, flatten_state, restore_state
from dlrover_tpu_torch.ckpt.shm_handler import PublishedFrame, ShmSubscriber
from dlrover_tpu_torch.models.convert import param_state
from dlrover_tpu_torch.models.transformer import Transformer, decode_weights
from dlrover_tpu_torch.obs import goodput
from dlrover_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from dlrover_tpu_torch.parallel import transfer_sched

METRIC_PREFIX = "dlrover_serving_"


@dataclass
class ServingConfig:
    """Knobs of the co-located serving plane."""

    max_new_tokens: int = 16
    slots: int = 4
    eos_id: int = -1
    temperature: float = 1.0
    greedy: bool = True
    top_k: int = 0
    top_p: float = 1.0
    # "idle_gaps": start a batch only while the trainer's arbiter
    # marks read idle (preferential soak); "always": serve whenever
    # asked (dedicated serving process, or tests)
    soak: str = "idle_gaps"
    # idle-gap gate: poll cadence and how long to wait for a gap
    # before serving anyway (a soak that can starve forever is an
    # outage, not a policy; forced batches are counted)
    gap_poll_interval_s: float = 0.002
    gap_wait_timeout_s: float = 2.0


class ServingEngine:
    """Decode continuous batches over the newest subscribed weights.

    ``params_template`` is a port ``Transformer`` of the published
    model's config, dtypes and device: every swap fills it in place
    (``restore_state`` over its parameters' JAX-named paths,
    ``convert.param_state``), and ``params`` is it once a swap landed;
    it holds the served step's weights unless ``weights_dirty`` (a swap
    torn after its copy began). ``param_prefix`` maps its paths onto the
    published record paths (a trainer that publishes its whole train
    state prefixes its params subtree, ``"train/params/"`` for the port's
    ``ElasticTrainer``; publishing bare params needs none).
    """

    def __init__(
        self,
        cfg,
        subscriber: ShmSubscriber,
        params_template: Transformer,
        serving: Optional[ServingConfig] = None,
        param_prefix: str = "",
        mesh=None,
        registry: Optional[MetricsRegistry] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "serving under a mesh (tp-sharded weights) is not ported yet (ROADMAP A14b)"
            )
        self.cfg = cfg
        self.subscriber = subscriber
        self.serving = serving or ServingConfig()
        self.params_template = params_template
        self.param_prefix = param_prefix
        self.registry = registry or default_registry()
        self.params: Optional[Transformer] = None
        self._weights = None  # decode_weights(own=True) of the served step
        self.weights_dirty = False  # the template holds a torn or failed copy
        self.weight_step: int = -1
        self.weight_generation: int = -1
        self.last_swap_ms: float = 0.0
        self.last_swap_bytes: int = 0
        self.swaps = 0
        self.dropped_swaps = 0  # commit landed mid-copy; params dropped
        self.forced_batches = 0  # served without an idle gap (timeout)
        self._exported_crc = 0
        self._exported_torn = 0
        self._stream = transfer_sched.get_arbiter().register(
            "serve_h2d",
            priority=transfer_sched.Priority.BACKGROUND,
            direction="h2d",
        )
        r = self.registry
        self._m_tokens = r.counter(
            METRIC_PREFIX + "tokens_total",
            "completion tokens served by the co-located plane",
        )
        self._m_batches = r.counter(
            METRIC_PREFIX + "batches_total",
            "continuous batches decoded by the co-located plane",
        )
        self._m_tokens_per_s = r.gauge(
            METRIC_PREFIX + "tokens_per_s",
            "serving throughput over the last batch",
        )
        self._m_staleness = r.gauge(
            METRIC_PREFIX + "weight_staleness_steps",
            "steps the serving weights lag the newest shm commit",
        )
        self._m_swap_ms = r.gauge(
            METRIC_PREFIX + "swap_latency_ms",
            "host→device latency of the last adopted weight swap",
        )
        self._m_swaps = r.counter(
            METRIC_PREFIX + "swaps_total",
            "weight frames adopted by the serving engine",
        )
        self._m_crc = r.counter(
            METRIC_PREFIX + "crc_retries_total",
            "subscribed frames skipped on crc mismatch",
        )
        self._m_torn = r.counter(
            METRIC_PREFIX + "torn_retries_total",
            "subscribed frames dropped by the seqlock re-check",
        )
        self._m_forced = r.counter(
            METRIC_PREFIX + "forced_batches_total",
            "batches served without finding an idle gap (gate timeout)",
        )
        self._m_probe_rows = r.counter(
            METRIC_PREFIX + "embedding_probe_rows_total",
            "rows served via the read-only embedding probe",
        )

    # -- weight swaps ---------------------------------------------------
    def try_swap(self) -> bool:
        """Adopt the newest committed frame, if any. Called between
        batches only — never while a sequence is mid-decode.

        Fault point ``serve.swap``: an armed io_error makes this swap
        attempt fail closed (the engine keeps serving the weights it
        already holds; the next commit retries)."""
        frame = self.subscriber.poll()
        self._fold_subscriber_counters()
        if frame is None:
            return False
        try:
            faults.fire("serve.swap")
            params = self._adopt(frame)
        except Exception as e:
            logger.warning(
                f"serving: swap to step {frame.step} failed ({e}); "
                f"keeping step {self.weight_step}"
            )
            return False
        if params is None:
            self.dropped_swaps += 1
            self._m_torn.inc()
            return False
        # the previous cast goes before the next is made (one on the card)
        self._weights = None
        self._weights = decode_weights(params, self.cfg, own=True)
        self.params = params
        self.weights_dirty = False
        self.weight_step = frame.step
        self.weight_generation = frame.generation
        self.swaps += 1
        self._m_swaps.inc()
        self._m_swap_ms.set(self.last_swap_ms)
        return True

    def _adopt(self, frame: PublishedFrame) -> Optional[Transformer]:
        """Host→device copy of a frame into the template, priced
        BACKGROUND at the bytes it reads, generation re-checked after the
        bytes left the views. The template is dirty from the copy's start
        until a whole copy is adopted."""
        by_path: Dict[str, List[ShardRecord]] = {}
        for r in frame.records:
            by_path.setdefault(r.path, []).append(r)
        prefix = self.param_prefix

        def read_records(path: str) -> List[ShardRecord]:
            return by_path.get(prefix + path, by_path.get(path, []))

        target = self.params_template
        state = param_state(target)
        # the price is what the restore reads: the template's records
        # only (a whole train state's optimizer moments stay in shm)
        nbytes = sum(r.nbytes for path, _ in flatten_state(state) for r in read_records(path))
        self.last_swap_bytes = nbytes
        self.weights_dirty = True
        t0 = time.perf_counter()
        # ignore_window: the swap runs in exactly the inter-step gaps
        # the window gate reserves, and it must finish before the views
        # rot — it still queues BACKGROUND behind every training
        # transfer contending for the rail
        with self._stream.transfer(max(nbytes, 1), ignore_window=True):
            if not self._copy_from_pinned_segment(state, read_records):
                restore_state(state, read_records)
            if any(p.is_cuda for p in target.parameters()):
                # this thread's copies; not the whole device, which a
                # trainer beside it is using (and a device-wide
                # synchronize fails while any thread captures a graph)
                torch.cuda.current_stream().synchronize()
        self.last_swap_ms = (time.perf_counter() - t0) * 1e3
        # the views fed the restore's host packing; a commit during that
        # window may have torn them — the seqlock re-check decides
        if not self.subscriber.frame_is_current(frame):
            logger.warning(
                f"serving: commit raced the swap copy of step "
                f"{frame.step}; dropping the torn params"
            )
            return None
        return target

    def _copy_from_pinned_segment(self, state, read_records) -> bool:
        """Card targets each filled by one record that is its whole leaf:
        the subscriber's mapping is pinned for the card once
        (``register_for_device``) and each leaf is one non-blocking copy
        straight out of the segment (``restore_state`` would stage the
        bytes through a pinned bin first: at ~3 GB/s a frame of a
        trainer saving every few steps is overwritten before it lands).
        Returns False, copying nothing, when a leaf is on the CPU or
        comes in several records."""
        from dlrover_tpu_torch.ckpt.sharding import dtype_name, full_index

        moves = []
        for path, t in flatten_state(state):
            recs = read_records(path)
            if not (isinstance(t, torch.Tensor) and t.is_cuda and len(recs) == 1):
                return False
            r = recs[0]
            if (r.index != full_index(t.shape) or r.dtype != dtype_name(path, t.dtype)
                    or tuple(r.global_shape) != tuple(t.shape)):
                return False
            moves.append((t, r.data))
        self.subscriber.handler.register_for_device()
        with torch.no_grad():
            for t, data in moves:
                src = torch.from_numpy(data.reshape(-1).view(np.uint8))
                t.view(-1).view(torch.uint8).copy_(src, non_blocking=True)
        return True

    def _fold_subscriber_counters(self) -> None:
        """Fold the subscriber's retry counts into the counters by
        delta, so repeated polls never double-count."""
        sub = self.subscriber
        if sub.crc_retries > self._exported_crc:
            self._m_crc.inc(sub.crc_retries - self._exported_crc)
            self._exported_crc = sub.crc_retries
        if sub.torn_retries > self._exported_torn:
            self._m_torn.inc(sub.torn_retries - self._exported_torn)
            self._exported_torn = sub.torn_retries

    def staleness_steps(self) -> int:
        """How many steps the serving weights lag the newest commit."""
        try:
            meta = self.subscriber.handler.metadata()
        except Exception:
            return 0
        if not meta.get("valid") or self.weight_step < 0:
            return 0
        return max(0, int(meta.get("step", 0)) - self.weight_step)

    # -- decoding -------------------------------------------------------
    def _wait_for_gap(self) -> bool:
        """Block until the trainer is between compute spans (or the
        wait times out). Returns True when a genuine gap was found."""
        if self.serving.soak != "idle_gaps":
            return True
        arb = transfer_sched.get_arbiter()
        deadline = time.monotonic() + self.serving.gap_wait_timeout_s
        while arb.in_compute_window():
            if time.monotonic() >= deadline:
                return False
            time.sleep(self.serving.gap_poll_interval_s)
        return True

    def serve_batch(self, prompts, prompt_lens, generator=None, stats=None):
        """Decode one continuous batch under the current weights.

        Returns ``(tokens, logps, out_lens)`` exactly as
        ``continuous_generate`` does (``prompts`` / ``prompt_lens``
        tensors or arrays, moved to the weights' device). Weight identity
        is frozen for the whole call — swaps happen only via
        ``try_swap`` between batches."""
        from dlrover_tpu_torch.rl.continuous_batching import continuous_generate

        if self._weights is None:
            raise RuntimeError(
                "serving engine holds no weights yet — call try_swap() "
                "after the first commit"
            )
        s = self.serving
        dev = next(self.params.parameters()).device
        prompts = torch.as_tensor(np.asarray(prompts) if not torch.is_tensor(prompts)
                                  else prompts).to(dev)
        prompt_lens = torch.as_tensor(np.asarray(prompt_lens) if not torch.is_tensor(prompt_lens)
                                      else prompt_lens).to(dev)
        if not self._wait_for_gap():
            self.forced_batches += 1
            self._m_forced.inc()
        self._m_staleness.set(float(self.staleness_steps()))
        t0 = time.perf_counter()
        goodput.note_serving(True)
        try:
            tokens, logps, out_lens = continuous_generate(
                self.params, prompts, prompt_lens, generator, self.cfg,
                max_new_tokens=s.max_new_tokens, eos_id=s.eos_id, slots=s.slots,
                temperature=s.temperature, greedy=s.greedy, top_k=s.top_k,
                top_p=s.top_p, weights=self._weights, stats=stats,
            )
            new_tokens = int((out_lens.long() - prompt_lens.long()).clamp_min(0).sum())
        finally:
            goodput.note_serving(False)
        dt = time.perf_counter() - t0
        self._m_tokens.inc(new_tokens)
        self._m_batches.inc()
        if dt > 0:
            self._m_tokens_per_s.set(new_tokens / dt)
        return tokens, logps, out_lens

    # -- sparse features ------------------------------------------------
    def embedding_probe(self, table, ids):
        """Serving-side sparse gather: the read-only probe. Never
        admits rows to the trainer's hot tier, never touches recency or
        pins — serving traffic cannot evict what training needs."""
        rows = table.gather(ids, insert_missing=False)
        self._m_probe_rows.inc(int(ids.numel() if torch.is_tensor(ids) else np.asarray(ids).size))
        return rows

    def stats(self) -> Dict[str, Any]:
        """Engine-side counters."""
        return {
            "weight_step": self.weight_step,
            "swaps": self.swaps,
            "dropped_swaps": self.dropped_swaps,
            "forced_batches": self.forced_batches,
            "last_swap_ms": round(self.last_swap_ms, 3),
            "last_swap_bytes": self.last_swap_bytes,
            "weights_dirty": self.weights_dirty,
            "crc_retries": self.subscriber.crc_retries,
            "torn_retries": self.subscriber.torn_retries,
            "staleness_steps": self.staleness_steps(),
        }
