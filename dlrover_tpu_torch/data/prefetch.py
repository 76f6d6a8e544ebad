"""Device prefetcher: overlap the input's host work and its copy to the
card with compute (counterpart of ``dlrover_tpu/data/prefetch.py``).

A producer thread pulls batch N+1 from the source iterator and places
it (the caller's ``placement``, e.g. pinned memory and a non-blocking
copy) on a side CUDA stream, recording an event, while batch N
computes. The consumer's stream waits for that event and the batch's
tensors are marked used on it (``record_stream``), so the allocator
never hands their memory out while the step still reads it. On the CPU
there is no stream: placement runs on the producer thread as it is.

As in the JAX package: exhaustion and producer exceptions reach the
consumer in order, after every batch pulled before them;
``buffered_batches`` says how far the source ran ahead of what trained
(a checkpoint rewinds its sampler snapshot by it); ``reprime`` re-places
the buffered host batches. ``snapshot`` (added here) reads the source's
state and that count together, with no pull in flight, so the rewind is
exact: a resumed run must see the very batches the uninterrupted run
saw.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs.trace import span

# buffer entry kinds: ("batch", host, device, event) | ("perr", host, exc)
# (placement failed; host kept so reprime can retry) | ("err", exc)
# (source raised) | ("end",)


@dataclass
class PipelineStats:
    """Counters of the overlapped host-device pipeline (what the port
    uses of the JAX package's ``accel.profiler.PipelineStats``): the
    prefetcher's hits and waits and the checkpoint stager's work."""

    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetch_reprimes: int = 0
    prefetch_wait_s: float = 0.0  # time the consumer blocked on misses
    stage_chunks: int = 0
    stage_bytes: int = 0
    stage_backlog_bytes: int = 0  # bytes still to stage (last observed)
    stage_block_s: float = 0.0  # loop-thread seconds in advance()
    stage_commits: int = 0
    fenced_steps: int = 0  # optimizer steps that waited for a staging copy

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class DevicePrefetcher:
    """Wrap any batch iterator with a depth-``depth`` buffer of placed
    batches. ``device`` is where ``placement`` puts them: a CUDA device
    gets the side stream and the events; None or the CPU runs placement
    as it is."""

    def __init__(
        self,
        source: Iterator[Any],
        placement: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
        stats: Optional[PipelineStats] = None,
        device=None,
    ):
        self._src = iter(source)
        self._place = placement or (lambda batch: batch)
        self._depth = max(1, int(depth))
        self.stats = stats if stats is not None else PipelineStats()
        self._device = torch.device(device) if device is not None else None
        self._stream = (
            torch.cuda.Stream(device=self._device)
            if self._device is not None and self._device.type == "cuda"
            else None
        )
        self._cond = threading.Condition()
        self._buf: deque = deque()
        self._gen = 0  # bumped by reprime; in-flight placements re-check
        self._closed = False
        # True while the producer is between taking a slot and filing
        # the batch: the source cursor may have moved for a batch not
        # yet in the buffer
        self._pulling = False
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="device-prefetch"
        )
        self._thread.start()

    # -- producer ------------------------------------------------------
    def _entry(self, host: Any, place: Callable[[Any], Any]):
        try:
            with span("h2d"):
                if self._stream is None:
                    return ("batch", host, place(host), None)
                with torch.cuda.stream(self._stream):
                    dev = place(host)
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                return ("batch", host, dev, ready)
        except Exception as e:  # placement failure: host batch survives
            return ("perr", host, e)

    def _produce(self):
        while True:
            with self._cond:
                while not self._closed and len(self._buf) >= self._depth:
                    self._cond.wait()
                if self._closed:
                    return
                gen, place = self._gen, self._place
                self._pulling = True
            # the slow legs (source pull + placement) run OUTSIDE the
            # lock so the consumer never blocks on them
            try:
                with span("prefetch_pull"):
                    # fault point prefetch.pull: an injected OSError rides
                    # the normal producer-error path
                    faults.fire("prefetch.pull")
                    host = next(self._src)
            except StopIteration:
                entry = ("end",)
            except BaseException as e:  # noqa: BLE001 — must propagate
                entry = ("err", e)
            else:
                entry = self._entry(host, place)
            with self._cond:
                self._pulling = False
                if entry[0] in ("batch", "perr") and self._gen != gen:
                    # a reprime raced this placement: place again
                    entry = self._entry(entry[1], self._place)
                self._buf.append(entry)
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
                        raise RuntimeError("DevicePrefetcher is closed")
                    self._cond.wait()
                waited = time.perf_counter() - t0
            head = self._buf[0]
            kind = head[0]
            if kind == "batch":
                if waited is None:
                    self.stats.prefetch_hits += 1
                else:
                    self.stats.prefetch_misses += 1
                    self.stats.prefetch_wait_s += waited
            if kind == "end":
                raise StopIteration  # the sentinel stays: next() raises again
            if kind == "err":
                raise head[1]  # terminal: the same error on every retry
            if kind == "perr":
                raise head[2]  # retryable through reprime()
            self._buf.popleft()
            self._cond.notify_all()  # wake the producer to top up
        batch, ready = head[2], head[3]
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in _tensors(batch):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        return batch

    def buffered_batches(self) -> int:
        """Batches pulled from the source but not yet consumed. A pull in
        flight counts as one: the source may have advanced for it
        already."""
        with self._cond:
            return self._buffered()

    def _buffered(self) -> int:
        return (1 if self._pulling else 0) + sum(
            1 for e in self._buf if e[0] in ("batch", "perr")
        )

    def snapshot(self, read_source_state: Callable[[], Any]) -> Tuple[Any, int]:
        """``(read_source_state(), buffered)`` taken together while no
        pull is in flight (waiting out at most the one in flight), so the
        source state is exactly ``buffered`` batches ahead of what the
        consumer has taken."""
        with self._cond:
            while self._pulling:
                self._cond.wait()
            return read_source_state(), self._buffered()

    # -- elasticity ----------------------------------------------------
    def reprime(self, placement: Optional[Callable[[Any], Any]] = None) -> int:
        """Drop every buffered device copy and place the kept host
        batches again under ``placement`` (or the existing one), in
        order. Returns the number of batches re-placed."""
        with self._cond:
            if placement is not None:
                self._place = placement
            self._gen += 1
            place = self._place
            n = 0
            rebuilt: deque = deque()
            for entry in self._buf:
                if entry[0] in ("batch", "perr"):
                    rebuilt.append(self._entry(entry[1], place))
                    n += 1
                else:
                    rebuilt.append(entry)
            self._buf = rebuilt
            self.stats.prefetch_reprimes += 1
            self._cond.notify_all()
        if n:
            logger.info(f"prefetcher reprimed: {n} buffered batches re-placed")
        return n

    def close(self):
        """Stop the producer and drop the buffer. Safe to call twice.
        The producer is a daemon thread, so a source blocked in a read
        cannot wedge interpreter exit."""
        with self._cond:
            self._closed = True
            self._buf.clear()
            self._cond.notify_all()
        self._thread.join(timeout=1.0)
