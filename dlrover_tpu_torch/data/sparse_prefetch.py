"""Overlapped sparse-row pipeline: fault-in for step N+1 rides the host
link while step N computes (counterpart of
``dlrover_tpu/data/sparse_prefetch.py``).

This is the ``DevicePrefetcher`` shape applied to embedding rows
instead of batches: the producer thread pulls ``(ids, batch)`` N+1 from
the source iterator, dedups the ids and calls
``DeviceSparseEmbedding.prepare`` — the host-tier gather of missing
rows (the slow leg: C++ hash probes, possibly a disk fault-in, then the
H2D dispatch) — concurrently with the train thread's compute of step N.
By the time the consumer asks for step N+1, every unique id is already
device-resident and the step's gather is a pure device kernel
(``emb_gather``).

The other half of the overlap is the scatter-back: LRU spills leave the
device as async D2H handoffs to ``DeviceSparseEmbedding``'s drain
thread, so neither direction of the host link ever sits on the step's
critical path.

Error/exhaustion semantics match ``DevicePrefetcher``: every prepared
step before a failure is delivered first, then the original exception
re-raises from ``__next__``; ``close()`` is idempotent and never blocks
on a wedged source.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger

# buffer entry kinds: ("step", ids, batch, prep) | ("err", exc) | ("end",)


class SparseRowPipeline:
    """Wrap an ``(ids, batch)`` iterator with a depth-``depth`` buffer
    of prepared steps (unique ids deduped and device-resident).

    ``depth=2`` is classic double buffering: one step computing, one
    being faulted in.
    """

    def __init__(
        self,
        source: Iterator[Tuple[np.ndarray, Any]],
        embedding,
        depth: int = 2,
    ):
        self._src = iter(source)
        self._emb = embedding
        self._depth = max(1, int(depth))
        self._cond = threading.Condition()
        self._buf: deque = deque()
        self._closed = False
        self.prepared_steps = 0
        self.prepare_wait_s = 0.0  # consumer stalls on an unready prep
        self.prepare_waits = 0
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="sparse-row-prefetch"
        )
        self._thread.start()

    # -- producer ------------------------------------------------------
    def _produce(self):
        while True:
            with self._cond:
                while not self._closed and len(self._buf) >= self._depth:
                    self._cond.wait()
                if self._closed:
                    return
            try:
                ids, batch = next(self._src)
            except StopIteration:
                entry = ("end",)
            except BaseException as e:  # noqa: BLE001 — must propagate
                entry = ("err", e)
            else:
                try:
                    # the overlap: host gather + H2D for step N+1 runs
                    # here while the consumer computes step N (the C++
                    # gather and numpy legs release the GIL)
                    with torch.profiler.record_function("emb_fault_in"):
                        prep = self._emb.prepare(ids)
                    entry = ("step", ids, batch, prep)
                except BaseException as e:  # noqa: BLE001
                    entry = ("err", e)
            with self._cond:
                if self._closed:
                    # close() raced this prepare: the consumer will
                    # never see it, so its pins go back here
                    if entry[0] == "step":
                        self._release(entry[3])
                    return
                self._buf.append(entry)
                self.prepared_steps += entry[0] == "step"
                self._cond.notify_all()
                if entry[0] in ("end", "err"):
                    return

    # -- consumer ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            waited = None
            if not self._buf:
                t0 = time.perf_counter()
                while not self._buf:
                    if self._closed:
                        raise RuntimeError(
                            "SparseRowPipeline is closed"
                        )
                    self._cond.wait()
                waited = time.perf_counter() - t0
            head = self._buf[0]
            if head[0] == "end":
                raise StopIteration
            if head[0] == "err":
                # terminal: the same error on every retry
                raise head[1]
            if waited is not None:
                self.prepare_wait_s += waited
                self.prepare_waits += 1
            self._buf.popleft()
            self._cond.notify_all()
            return head[1], head[2], head[3]

    def buffered_steps(self) -> int:
        with self._cond:
            return sum(1 for e in self._buf if e[0] == "step")

    def _release(self, prep):
        try:
            self._emb.release(prep)
        except Exception:  # teardown must not raise past close()
            pass

    def close(self):
        """Stop the producer and drop the buffer — RELEASING the pins
        of every undelivered prepared step (a consumer that breaks out
        of the loop early, or an exception mid-step, must not leave
        un-evictable ghost-pinned slots behind). Safe to call twice; a
        producer wedged in a blocking source read is a daemon thread
        and cannot stall the caller's teardown."""
        with self._cond:
            self._closed = True
            dropped = [e for e in self._buf if e[0] == "step"]
            self._buf.clear()
            self._cond.notify_all()
        for entry in dropped:
            self._release(entry[3])
        self._thread.join(timeout=1.0)
        if self.prepare_waits:
            logger.info(
                f"sparse pipeline: {self.prepare_waits} consumer "
                f"stalls, {self.prepare_wait_s * 1e3:.1f} ms total "
                f"(raise depth or the HBM budget if this is hot)"
            )
