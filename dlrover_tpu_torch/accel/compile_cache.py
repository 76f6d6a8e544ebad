"""The compile cache of an elastic resize, and its speculative filler
(the port of ``dlrover_tpu/accel/compile_cache.py``).

The JAX package caches AOT-compiled train steps so that a resize into a
world seen before skips XLA's compile. The port compiles no step: a
worker relaunched into a world builds three things before its first
step, and each has a job-stable home here:

- the nvcc libraries of ``ops/csrc`` (``ops/_build.py``) and Triton's
  kernel cache: ``enable_compile_cache`` (``trainer/elastic/
  distributed.py``) points both at the directory that
  ``DLROVER_TPU_COMPILE_CACHE`` names, so a relaunched or replacement
  worker loads what an earlier incarnation built;
- the world's strategy (``ElasticTrainer._strategy_for``, or the
  search): a ``CompileCache`` entry, kept in memory and, when it is a
  string (``Strategy.to_json``), on disk under
  ``DLROVER_TPU_STRATEGY_CACHE`` (which ``enable_compile_cache`` sets),
  so a worker relaunched into a
  world that was derived before, by an earlier incarnation or by the
  ``SpeculativeCompiler`` for a predicted world, is a
  ``compile_cache_hit``.

``CompileCache`` is the JAX package's two-tier LRU with its counters;
``get_or_build`` is the memory-only memo, ``get_or_compile`` consults
the disk layer. ``SpeculativeCompiler`` is the JAX package's background
thread: budgeted, paused while a checkpoint stages, a new prediction
replaces the queue, and a failing build is counted and survived.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from dlrover_tpu_torch.common import storage
from dlrover_tpu_torch.common.log import default_logger as logger


# the disk layer's directory (``enable_compile_cache`` sets it)
STRATEGY_CACHE_ENV = "DLROVER_TPU_STRATEGY_CACHE"


def fingerprint(*parts: Any) -> str:
    """Stable hex key from value-like parts (``repr`` of each), so two
    processes computing the same logical key agree (the disk layer
    depends on that)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


def mesh_signature(mesh) -> Tuple:
    """(axis names, axis sizes, world size, device type) of a port mesh
    (``parallel/mesh.Mesh``): what pins a strategy to a world."""
    dm = getattr(mesh, "device_mesh", None)
    return (
        tuple(mesh.axis_names),
        tuple(mesh.layout.shape),
        int(mesh.layout.size),
        getattr(dm, "device_type", "none") if dm is not None else "none",
    )


def tree_signature(tree: Dict) -> Tuple:
    """Per-leaf (path, shape, dtype) of a state dict whose leaves are
    tensors, on any device (``meta`` included), or numpy arrays."""
    from dlrover_tpu_torch.ckpt.sharding import flatten_state

    out = []
    for path, leaf in flatten_state(tree):
        dtype = str(getattr(leaf, "dtype", type(leaf).__name__)).removeprefix("torch.")
        out.append((path, tuple(getattr(leaf, "shape", ())), dtype))
    return tuple(out)


@dataclass
class _Entry:
    obj: Any
    serializable: bool = False


class CompileCache:
    """LRU of built artifacts keyed by ``fingerprint`` keys.

    - ``get_or_build``: in-memory memo for any artifact;
    - ``get_or_compile``: misses consult the disk layer before building,
      and a fresh build that is a ``str`` or ``bytes`` is written back
      (durably); any other artifact stays in memory only.

    Hit / miss counters land in an ``accel.profiler.PipelineStats`` when
    one is attached (``compile_cache_hit_pct``)."""

    def __init__(self, capacity: int = 8, cache_dir: Optional[str] = None, stats=None):
        self._capacity = max(1, int(capacity))
        self._cache_dir = (
            cache_dir if cache_dir is not None else os.getenv(STRATEGY_CACHE_ENV, "")
        )
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.stats = stats
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    @property
    def hit_pct(self) -> Optional[float]:
        n = self.hits + self.misses
        if not n:
            return None
        return round(100.0 * self.hits / n, 2)

    def peek(self, key: str) -> bool:
        """True when ``key`` is resident (no counters touched)."""
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _count(self, hit: bool):
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        if self.stats is not None:
            if hit:
                self.stats.compile_cache_hits += 1
            else:
                self.stats.compile_cache_misses += 1

    def _get_locked(self, key: str) -> Optional[_Entry]:
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def _put(self, key: str, entry: _Entry):
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                evicted, _ = self._entries.popitem(last=False)
                logger.info(f"compile cache evicted {evicted[:12]}…")

    def get_or_build(self, key: str, build: Callable[[], Any]) -> Tuple[Any, bool]:
        """Memory-only memo: ``(artifact, hit)``."""
        with self._lock:
            e = self._get_locked(key)
        if e is not None:
            self._count(True)
            return e.obj, True
        obj = build()
        self._count(False)
        self._put(key, _Entry(obj))
        return obj, False

    def get_or_compile(self, key: str, build: Callable[[], Any]) -> Tuple[Any, bool]:
        """Memory LRU -> disk layer -> build: ``(artifact, hit)``, a disk
        load counting as a hit (the build was skipped)."""
        with self._lock:
            e = self._get_locked(key)
        if e is not None:
            self._count(True)
            return e.obj, True
        obj = self._load_disk(key)
        if obj is not None:
            self._count(True)
            self.disk_hits += 1
            self._put(key, _Entry(obj, serializable=True))
            return obj, True
        t0 = time.perf_counter()
        obj = build()
        self._count(False)
        logger.info(f"compile cache miss {key[:12]}…: built in {time.perf_counter() - t0:.3f}s")
        serializable = isinstance(obj, (str, bytes))
        self._put(key, _Entry(obj, serializable=serializable))
        if serializable:
            self._save_disk(key, obj)
        return obj, False

    # -- disk layer (best-effort) --------------------------------------
    def _disk_path(self, key: str, kind: str) -> str:
        return os.path.join(self._cache_dir, f"{key}.{kind}")

    def _load_disk(self, key: str) -> Optional[Any]:
        if not self._cache_dir:
            return None
        for kind in ("str", "bin"):
            try:
                with open(self._disk_path(key, kind), "rb") as f:
                    blob = f.read()
            except OSError:
                continue
            if kind == "str":
                try:
                    return blob.decode()
                except UnicodeDecodeError:
                    # a torn or foreign entry: drop it so the next miss rewrites
                    storage.PosixDiskStorage().safe_remove(self._disk_path(key, kind))
                    return None
            return blob
        return None

    def _save_disk(self, key: str, obj) -> None:
        if not self._cache_dir:
            return
        kind, blob = ("str", obj.encode()) if isinstance(obj, str) else ("bin", obj)
        try:
            os.makedirs(self._cache_dir, exist_ok=True)
            # durable, not just atomic: a torn entry after a crash would
            # be read by the next process's warm start
            storage.durable_replace(self._disk_path(key, kind), lambda f: f.write(blob), mode="wb")
        except OSError as e:
            logger.warning(f"compile cache disk write failed: {e!r}")


@dataclass
class CompileTask:
    """One speculative build: ``build`` returns the artifact for ``key``."""

    label: str
    key: str
    build: Callable[[], Any]


class SpeculativeCompiler:
    """Background builds for the likely next worlds.

    ``submit`` REPLACES the pending queue (the newest prediction wins)
    and resets the wall-clock budget; the thread then drains tasks into
    the cache unless ``pause_fn()`` holds (a checkpoint staging window)
    or the budget is spent (the rest are dropped with a log)."""

    def __init__(
        self,
        cache: CompileCache,
        pause_fn: Optional[Callable[[], bool]] = None,
        budget_s: float = 120.0,
        poll_s: float = 0.05,
    ):
        self.cache = cache
        self._pause_fn = pause_fn
        self._budget_s = float(budget_s)
        self._poll_s = poll_s
        self._cond = threading.Condition()
        self._tasks: deque = deque()
        self._spent = 0.0
        self._closed = False
        self._gen = 0  # bumped per submit; stale pops never requeue
        self.compiled = 0
        self.dropped = 0
        self.errors = 0
        # the key being built now: a resize landing on it waits for it
        self.in_flight_key: Optional[str] = None
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True, name="speculative-compile")
        self._thread.start()

    def submit(self, tasks: Sequence[CompileTask]):
        """Replace the pending candidates with a fresh prediction."""
        with self._cond:
            self._tasks.clear()
            self._tasks.extend(tasks)
            self._spent = 0.0
            self._gen += 1
            if tasks:
                self._idle.clear()
            self._cond.notify_all()

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until the queue drains."""
        return self._idle.wait(timeout)

    def _run(self):
        while True:
            with self._cond:
                while not self._closed and not self._tasks:
                    self._idle.set()
                    self._cond.wait()
                if self._closed:
                    self._idle.set()
                    return
                task = self._tasks.popleft()
                gen = self._gen
            if self._pause_fn is not None and self._pause_fn():
                # a staging window: put the task back, unless a newer
                # submit replaced the prediction meanwhile
                with self._cond:
                    if self._gen == gen:
                        self._tasks.appendleft(task)
                time.sleep(self._poll_s)
                continue
            if self.cache.peek(task.key):
                continue
            if self._spent >= self._budget_s:
                self.dropped += 1
                logger.info(
                    f"speculative compile budget spent ({self._spent:.1f}s); dropping {task.label}"
                )
                continue
            t0 = time.perf_counter()
            self.in_flight_key = task.key
            try:
                _, hit = self.cache.get_or_compile(task.key, task.build)
                if not hit:
                    self.compiled += 1
                    logger.info(
                        f"speculatively built {task.label} in {time.perf_counter() - t0:.3f}s"
                    )
            except Exception as e:
                # a candidate that cannot build must not kill the thread:
                # the real resize surfaces the error
                self.errors += 1
                logger.warning(f"speculative build of {task.label} failed: {e!r}")
            finally:
                self.in_flight_key = None
            with self._cond:
                self._spent += time.perf_counter() - t0

    def close(self):
        with self._cond:
            self._closed = True
            self._tasks.clear()
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
