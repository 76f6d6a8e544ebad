"""Deterministic fault injection: named fault points in production code
(a copy of ``dlrover_tpu/common/faults.py``, trimmed to the sites the
port's checkpoint path, prefetcher, control plane, trainer and sparse
trainer fire).

Production code declares *fault points* (named sites like
``ckpt.shard_write``), and a test or an operator arms them with spec
strings::

    site:kind:prob[:seed]
    site:kind:@N[:seed]

    ckpt.shard_write:bit_flip:1.0          # every shard write flips a bit
    ckpt.persist:enospc:0.5:42             # seeded coin per persist
    node.preempt:kill:@7                   # die at exactly the 7th step

``@N`` fires on exactly the Nth evaluation of its site. Specs are armed
programmatically (``configure``) or through ``DLROVER_TPU_FAULTS``
(read once at first use). Multiple specs separate with ``;`` or ``,``.
Each armed spec owns a ``random.Random`` seeded by its ``seed`` field
(or a stable hash of the spec string), so a fixed call order replays
the same decisions.

Kinds: ``enospc`` / ``io_error`` raise ``OSError``; ``delay`` sleeps
``DELAY_S``; ``torn_write`` truncates a payload (zeroes the tail half at
fixed-size sites); ``bit_flip`` flips one seeded bit; ``kill`` is a
hard process death (``os._exit(137)``, no atexit, no flushes), a
SIGKILL / OOM-killer / hard-preemption stand-in at sites like
``node.preempt``; ``scale`` multiplies a deterministic slice of a
numeric array by ``SCALE_FACTOR`` at :func:`corrupt_array` sites (raw
bytes have no dtype to scale), and at ``device.sdc`` the train step
reads it as one lane's gradient scale (``parallel/sdc.py``
``injection_plan``). Control kinds fire through
:func:`fire`; data kinds act only where a payload passes through
:func:`corrupt` / :func:`corrupt_array`, or a written file through
:func:`corrupt_file`. Every triggered fault counts
into ``obs.metrics`` (``dlrover_faults_triggered_total{site,kind}``).
The inactive fast path is one bool.
"""

from __future__ import annotations

import errno
import os
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger

ENV_VAR = "DLROVER_TPU_FAULTS"

# seconds slept by the ``delay`` kind (kept small: the point is to widen
# race windows deterministically, not to stall test suites)
DELAY_S = 0.05

KINDS = ("enospc", "io_error", "delay", "torn_write", "bit_flip", "scale", "kill")
_DATA_KINDS = ("torn_write", "bit_flip", "scale")

# the ``scale`` kind's corruption factor: large enough that a robust
# z-score over replica peers saturates, small enough to stay finite
# through a full fp32 backward pass (the point of the kind)
SCALE_FACTOR = 32.0

# the registered sites — arming a typo'd site is a hard error, so a
# test can never silently test nothing
FAULT_SITES = frozenset(
    {
        "ckpt.shard_write",  # shard payload bytes → storage
        "ckpt.done_write",  # per-shard done file → storage
        "ckpt.tracker_write",  # commit tracker / history publish
        "ckpt.persist",  # whole persist pass (saver or sync engine)
        "ckpt.shm_stage",  # device/host bytes → shm segment
        "rpc.send",  # MasterClient._call request leg
        "rpc.recv",  # MasterClient._call response leg
        "rendezvous.join",  # agent's join-rendezvous report
        "prefetch.pull",  # prefetch producer's source pull
        "node.preempt",  # trainer step boundary (preemption arrival)
        "device.sdc",  # one device silently computing wrong numbers
        # (``scale`` corrupts that lane's local gradient)
        "embedding.export",  # embedding ckpt bytes → storage (data
        # kinds corrupt the serialized npz/delta payload)
        "embedding.import",  # embedding ckpt read leg (restore)
        "transfer.stripe",  # one striped chunk move on a rail (the
        # multi-rail scheduler's per-chunk grant + mover)
    }
)


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault: parsed form of ``site:kind:prob[:seed]`` or the
    scripted ``site:kind:@N[:seed]`` form (``nth`` > 0 ⇒ fire on
    exactly the Nth evaluation, never again)."""

    site: str
    kind: str
    prob: float
    seed: int
    nth: int = 0

    @classmethod
    def parse(cls, raw: str) -> "FaultSpec":
        parts = [p.strip() for p in raw.strip().split(":")]
        if len(parts) not in (3, 4):
            raise ValueError(
                f"fault spec {raw!r}: want site:kind:prob[:seed] "
                f"or site:kind:@N[:seed]"
            )
        site, kind = parts[0], parts[1]
        if site != "*" and site not in FAULT_SITES:
            raise ValueError(
                f"fault spec {raw!r}: unknown site {site!r} "
                f"(known: {sorted(FAULT_SITES)})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"fault spec {raw!r}: unknown kind {kind!r} "
                f"(known: {list(KINDS)})"
            )
        nth = 0
        if parts[2].startswith("@"):
            # scripted trigger: exactly the Nth evaluation of the site
            try:
                nth = int(parts[2][1:])
            except ValueError:
                raise ValueError(f"fault spec {raw!r}: bad @N trigger")
            if nth <= 0:
                raise ValueError(
                    f"fault spec {raw!r}: @N trigger must be >= 1"
                )
            prob = 1.0
        else:
            try:
                prob = float(parts[2])
            except ValueError:
                raise ValueError(f"fault spec {raw!r}: bad probability")
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"fault spec {raw!r}: probability must be in [0, 1]"
                )
        if len(parts) == 4:
            seed = int(parts[3])
        else:
            # no explicit seed: still deterministic — derive from the
            # spec text so the same spec string replays the same run
            seed = zlib.crc32(raw.strip().encode())
        return cls(site=site, kind=kind, prob=prob, seed=seed, nth=nth)


class _Armed:
    """A spec plus its private RNG (the determinism unit)."""

    __slots__ = ("spec", "_rng", "_lock", "_visits")

    def __init__(self, spec: FaultSpec):
        import random

        self.spec = spec
        self._rng = random.Random(spec.seed)
        self._lock = threading.Lock()
        self._visits = 0  # evaluations of the site (@N scripting)

    def draw(self) -> bool:
        with self._lock:
            if self.spec.nth:
                # scripted: exactly the Nth evaluation, never again
                self._visits += 1
                if self._visits != self.spec.nth:
                    return False
                # consume a draw for downstream seeded decisions
                self._rng.random()
                return True
            if self.spec.prob >= 1.0:
                # still consume a draw so downstream decisions (torn
                # fraction, flipped bit) stay on the seeded sequence
                self._rng.random()
                return True
            return self._rng.random() < self.spec.prob

    def uniform(self) -> float:
        with self._lock:
            return self._rng.random()


class FaultInjector:
    """Process-wide registry of armed fault specs."""

    def __init__(self):
        self._by_site: Dict[str, List[_Armed]] = {}
        self._wildcards: List[_Armed] = []
        self._lock = threading.Lock()

    # -- arming --------------------------------------------------------
    def configure(self, spec_str: str):
        """Arm every spec in ``spec_str`` (``;``/``,`` separated),
        replacing the current configuration."""
        self.clear()
        for raw in spec_str.replace(",", ";").split(";"):
            if raw.strip():
                self.arm(FaultSpec.parse(raw))

    def arm(self, spec: FaultSpec):
        global _active
        armed = _Armed(spec)
        with self._lock:
            if spec.site == "*":
                self._wildcards.append(armed)
            else:
                self._by_site.setdefault(spec.site, []).append(armed)
        _active = True
        logger.info(
            f"fault armed: {spec.site}:{spec.kind}:{spec.prob}"
            f" (seed={spec.seed})"
        )

    def clear(self):
        global _active
        with self._lock:
            self._by_site.clear()
            self._wildcards.clear()
        _active = False

    # -- accounting ----------------------------------------------------
    def _count(self, site: str, kind: str):
        try:
            from dlrover_tpu_torch.obs.metrics import default_registry

            default_registry().counter(
                "dlrover_faults_triggered_total",
                "injected faults that fired, by site and kind",
                labelnames=("site", "kind"),
            ).labels(site, kind).inc()
        except Exception:  # metrics must never break the fault itself
            pass
        logger.warning(f"fault injected: {site}:{kind}")

    # -- firing --------------------------------------------------------
    def active(self) -> bool:
        return bool(self._by_site or self._wildcards)

    def specs(self) -> List[FaultSpec]:
        with self._lock:
            out = [a.spec for a in self._wildcards]
            for lst in self._by_site.values():
                out.extend(a.spec for a in lst)
            return out

    def _armed_for(self, site: str) -> List[_Armed]:
        with self._lock:
            return list(self._by_site.get(site, ())) + list(
                self._wildcards
            )

    def _raise_or_delay(self, site: str, armed: _Armed):
        kind = armed.spec.kind
        self._count(site, kind)
        if kind == "enospc":
            raise OSError(
                errno.ENOSPC,
                f"injected ENOSPC at {site}",
            )
        if kind == "io_error":
            raise OSError(errno.EIO, f"injected I/O error at {site}")
        if kind == "delay":
            time.sleep(DELAY_S)
        if kind == "kill":
            # hard process death: no atexit, no finally, no flushes —
            # the closest in-process stand-in for SIGKILL / OOM-killer /
            # hard preemption
            logger.warning(f"fault kill: hard exit(137) at {site}")
            os._exit(137)

    def fire(self, site: str):
        """Evaluate the control-kind specs armed for ``site``: raise
        OSError (enospc/io_error) or sleep (delay). Data kinds are
        ignored here — they only act where a payload flows through
        ``corrupt``/``corrupt_array``."""
        for armed in self._armed_for(site):
            if armed.spec.kind in _DATA_KINDS:
                continue
            if armed.draw():
                self._raise_or_delay(site, armed)

    def corrupt(self, site: str, blob: bytes) -> bytes:
        """Pass write-path payload bytes through the armed specs:
        control kinds raise/sleep, ``torn_write`` truncates to a seeded
        fraction, ``bit_flip`` flips one seeded bit. Returns the
        (possibly corrupted) payload."""
        for armed in self._armed_for(site):
            kind = armed.spec.kind
            if kind not in _DATA_KINDS:
                if armed.draw():
                    self._raise_or_delay(site, armed)
                continue
            if kind == "scale":
                # raw bytes carry no dtype to scale — the kind only
                # acts at corrupt_array sites
                continue
            if not armed.draw():
                continue
            self._count(site, kind)
            if kind == "torn_write":
                blob = blob[:_torn_cut(armed, len(blob))]
            elif kind == "bit_flip" and blob:
                pos, bit = _flip_at(armed, len(blob))
                b = bytearray(blob)
                b[pos] ^= 1 << bit
                blob = bytes(b)
        return blob

    def corrupt_file(self, site: str, path: str):
        """File flavor of :meth:`corrupt` for a payload already written
        to the local file ``path`` (a streamed write): ``torn_write``
        truncates the file, ``bit_flip`` flips one bit in place, at the
        seeded positions :meth:`corrupt` would pick for the same bytes.
        Control kinds are left to :meth:`fire`, which the site calls
        before it writes."""
        for armed in self._armed_for(site):
            kind = armed.spec.kind
            if kind not in ("torn_write", "bit_flip") or not armed.draw():
                continue
            self._count(site, kind)
            n = os.path.getsize(path)
            if kind == "torn_write":
                os.truncate(path, _torn_cut(armed, n))
            elif n:
                pos, bit = _flip_at(armed, n)
                with open(path, "r+b") as f:
                    f.seek(pos)
                    b = f.read(1)[0] ^ (1 << bit)
                    f.seek(pos)
                    f.write(bytes([b]))
                    f.flush()
                    os.fsync(f.fileno())

    def corrupt_array(self, site: str, arr: np.ndarray) -> np.ndarray:
        """Array flavor of :meth:`corrupt` for fixed-size destinations
        (shm chunks): ``bit_flip`` flips one seeded bit in a copy,
        ``torn_write`` zeroes the tail half (a partial memcpy) — the
        byte length never changes."""
        for armed in self._armed_for(site):
            kind = armed.spec.kind
            if kind not in _DATA_KINDS:
                if armed.draw():
                    self._raise_or_delay(site, armed)
                continue
            if not armed.draw():
                continue
            self._count(site, kind)
            if kind == "scale":
                # operate on the TYPED values, not the byte view: the
                # corruption must stay finite and dtype-shaped
                typed = np.ascontiguousarray(arr).reshape(-1).copy()
                if typed.size == 0 or not np.issubdtype(typed.dtype, np.number):
                    continue
                span = max(1, typed.size // 8)
                start = int(armed.uniform() * max(1, typed.size - span)) % typed.size
                typed[start:start + span] = (
                    typed[start:start + span] * typed.dtype.type(SCALE_FACTOR)
                )
                arr = typed
                continue
            flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            flat = flat.copy()
            if flat.size == 0:
                continue
            if kind == "torn_write":
                flat[flat.size // 2:] = 0
            else:  # bit_flip
                pos = int(armed.uniform() * flat.size) % flat.size
                flat[pos] ^= np.uint8(
                    1 << (int(armed.uniform() * 8) % 8)
                )
            arr = flat
        return arr


def _torn_cut(armed: _Armed, n: int) -> int:
    """Where ``torn_write`` cuts ``n`` bytes: at least one byte kept and
    strictly fewer than all (both extremes would be a different failure
    class)."""
    frac = 0.1 + 0.8 * armed.uniform()
    return max(1, min(n - 1, int(n * frac)))


def _flip_at(armed: _Armed, n: int):
    """The byte and the bit ``bit_flip`` flips in ``n`` bytes."""
    pos = int(armed.uniform() * n) % n
    return pos, int(armed.uniform() * 8) % 8


# -- process-wide singleton --------------------------------------------------

_injector = FaultInjector()
_active = False  # True while any spec is armed; the zero-cost gate
_env_loaded = False


def injector() -> FaultInjector:
    _load_env_once()
    return _injector


def _load_env_once():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    raw = os.getenv(ENV_VAR, "")
    if raw:
        try:
            _injector.configure(raw)
        except ValueError as e:
            # a typo'd env spec must fail loudly, not silently test
            # nothing — but not crash an unrelated import path
            logger.error(f"bad {ENV_VAR}: {e}")
            raise


def configure(spec_str: str):
    injector().configure(spec_str)


def reset():
    """Disarm everything (test teardown)."""
    global _env_loaded
    _env_loaded = True  # an explicit reset wins over the env
    _injector.clear()


def active() -> bool:
    return _active


def fire(site: str):
    """Production call site: no-op unless a fault is armed (the first
    call pays one env read; every later inactive call is one bool)."""
    if _env_loaded and not _active:
        return
    _load_env_once()
    if _active:
        _injector.fire(site)


def corrupt(site: str, blob: bytes) -> bytes:
    if _env_loaded and not _active:
        return blob
    _load_env_once()
    return _injector.corrupt(site, blob) if _active else blob


def corrupt_file(site: str, path: str):
    if _env_loaded and not _active:
        return
    _load_env_once()
    if _active:
        _injector.corrupt_file(site, path)


def corrupt_array(site: str, arr: np.ndarray) -> np.ndarray:
    if _env_loaded and not _active:
        return arr
    _load_env_once()
    return _injector.corrupt_array(site, arr) if _active else arr
