"""Host-offloaded optimizer state (the CPU-offload Adam analog; the port
of ``dlrover_tpu/ops/host_offload.py``).

Parity: the reference ships a CPU-offload Adam that keeps the Adam
moments in host DRAM and streams them through the GPU per update
(atorch/atorch/optimizers/). The JAX package makes host residency a
sharding property (XLA's ``pinned_host`` memory kind). Here it is a
stream of copies:

- between steps the optimizer state lives in pinned host memory, pinned
  once, when the optimizer is wrapped (``offload_optimizer``; the first
  pin of a large segment is slow, so it is never paid on a step);
- each update streams the state through the card one unit at a time (a
  packed group of ``adamw_8bit_flat``, or a run of leaves of at most
  ``UNIT_BYTES`` of ``torch.optim.AdamW`` state), double-buffered: the
  host-to-card copy of unit i+1 runs on a side stream while unit i
  computes, and unit i's new state goes back to its pinned host tensors
  on the same stream once the compute stream has passed it. The two
  slots of the double buffer, each the size of the largest unit, are
  the only state bytes the card holds;
- the update itself is the resident one: ``adam8_flat`` on each group
  of ``adamw_8bit_flat``, the foreach AdamW of ``torch.optim.AdamW`` on
  each run of leaves (its arithmetic is per tensor, so the result is
  bitwise the resident step's).

``placement_active()`` is true on CUDA. On the CPU the state is already
host memory: offload is a numeric no-op there, as in the JAX package
(logged once), and no ``HostStream`` is built.

Readers of the host state on the CPU (Flash Checkpoint's staging, which
copies host tensors into shm with a memcpy instead of a card-to-host
copy, and the checkpoint conversion) call ``wait_host_state()`` first:
it waits for the last update's card-to-host copies.

Support: ``adamw_8bit_flat`` and ``torch.optim.AdamW`` (the optimizers
of ``build_optimizer("adamw_8bit_flat")`` and ``build_optimizer("adamw")``);
any other optimizer raises rather than keep its state on the card while
the strategy says it left. The pipeline path (pp > 1) refuses offload
in ``accel/dry_runner._build``, as the JAX package does.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Sequence

import torch

# the most state bytes one unit of torch.optim.AdamW streams (a leaf
# larger than this is a unit of its own)
UNIT_BYTES = 256 << 20
# byte alignment of each tensor inside a slot
_ALIGN = 256

_warned = False
# the streamers whose last update's card-to-host copies a host reader
# may have to wait for (weak: a closed trainer's slots are freed)
_pending: "weakref.WeakSet[HostStream]" = weakref.WeakSet()


def placement_active(device=None) -> bool:
    """True where the state really leaves the device (CUDA). On the CPU
    offload is a numeric no-op: warn once so a CPU run never silently
    believes its optimizer state left device memory."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return True
    if dev is None and torch.cuda.is_available():
        return True
    global _warned
    if not _warned:
        from dlrover_tpu_torch.common.log import default_logger

        default_logger.info(
            "host_offload: the optimizer state is host memory on the CPU "
            "already; offload_opt is a numeric no-op here (real on CUDA)"
        )
        _warned = True
    return False


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class HostStream:
    """Double-buffered streaming of host-resident units through a CUDA
    device. ``units``: for each unit, its pinned host tensors.
    Per update: ``begin()``, then for each unit in order ``fetch(i)``
    (device views of its tensors, ready on the compute stream) and
    ``store(i)`` (its device views back to the host tensors once the
    compute stream has passed this point), then ``end()``."""

    def __init__(self, units: Sequence[Sequence[torch.Tensor]], device):
        self.device = torch.device(device)
        self.units = [list(u) for u in units]
        self.unit_bytes = [sum(_aligned(t.numel() * t.element_size()) for t in u) for u in self.units]
        cap = max(self.unit_bytes, default=0)
        # the double buffer: the only state bytes on the device
        self.slots = [torch.empty((cap,), dtype=torch.uint8, device=self.device) for _ in range(2)]
        self.stream = torch.cuda.Stream(self.device)
        self._views = {}
        self._ready = {}
        self._free: List[Optional[torch.cuda.Event]] = [None, None]
        self._last: Optional[torch.cuda.Event] = None
        self.bytes_streamed = 0  # both directions, every update so far
        self.updates = 0

    @property
    def slot_bytes(self) -> int:
        return sum(s.numel() for s in self.slots)

    @property
    def host_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for u in self.units for t in u)

    def _issue(self, i: int) -> None:
        """Start unit i's host-to-device copy into its slot (after the
        slot's previous unit went back to the host)."""
        s = i % 2
        views, off = [], 0
        with torch.cuda.stream(self.stream):
            if self._free[s] is not None:
                self.stream.wait_event(self._free[s])
            for h in self.units[i]:
                n = h.numel() * h.element_size()
                d = self.slots[s][off:off + n].view(h.dtype).view(h.shape)
                d.copy_(h, non_blocking=True)
                views.append(d)
                off += _aligned(n)
            self._ready[i] = torch.cuda.Event()
            self._ready[i].record(self.stream)
        self._views[i] = views

    def begin(self) -> None:
        # nothing of an update that raised midway is reused
        self._views.clear()
        self._ready.clear()
        # the copies must see what the compute stream did before this
        # update
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.units:
            self._issue(0)

    def fetch(self, i: int) -> List[torch.Tensor]:
        if i not in self._views:
            self._issue(i)
        if i + 1 < len(self.units) and (i + 1) not in self._views:
            self._issue(i + 1)
        torch.cuda.current_stream(self.device).wait_event(self._ready.pop(i))
        return self._views[i]

    def store(self, i: int) -> None:
        views = self._views.pop(i)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(done)
            for h, d in zip(self.units[i], views):
                h.copy_(d, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._free[i % 2] = self._last = ev
        self.bytes_streamed += 2 * sum(t.numel() * t.element_size() for t in self.units[i])

    def end(self) -> None:
        self.updates += 1
        if self._last is not None:
            # later work on the compute stream (a checkpoint's device
            # copies, the next step) is ordered after the state is home
            torch.cuda.current_stream(self.device).wait_event(self._last)
            _pending.add(self)

    def synchronize(self) -> None:
        if self._last is not None:
            self._last.synchronize()


def wait_host_state() -> None:
    """Block until every offloaded optimizer's last card-to-host copies
    have landed (call before reading host state on the CPU)."""
    for s in list(_pending):
        s.synchronize()


def settle_host_sources(sources) -> None:
    """``wait_host_state`` when any of ``sources`` is a pinned host
    tensor (what a checkpoint reads of an offloaded state)."""
    if any(isinstance(t, torch.Tensor) and t.is_pinned() for t in sources):
        wait_host_state()


def _inner(opt):
    return getattr(opt, "opt", opt)


def offload_optimizer(opt, device=None):
    """Move ``opt``'s state (a ``build_optimizer`` optimizer or the
    optimizer itself) to pinned host memory and make its ``step`` stream
    it through ``device``. A numeric no-op where ``placement_active`` is
    False. Returns ``opt``; the streamer is
    ``opt.offload`` (inner optimizer's attribute)."""
    from dlrover_tpu_torch.ops import quantized_optim as qo

    inner = _inner(opt)
    dev = torch.device(device) if device is not None else None
    if dev is None:
        dev = inner.param_groups[0]["params"][0].device
    if not placement_active(dev):
        return opt
    if isinstance(inner, qo.adamw_8bit_flat):
        _offload_flat(inner, dev)
    elif type(inner) is torch.optim.AdamW:
        _offload_adamw(inner, dev)
    else:
        raise NotImplementedError(
            f"offload_opt supports adamw and adamw_8bit_flat, not "
            f"{type(inner).__name__}"
        )
    return opt


def _offload_flat(inner, dev) -> None:
    """Each packed group's moment pair (codes and scales) is a unit; the
    small leaves' f32 pair is the last unit."""
    units = []
    for gi in range(len(inner.mu)):
        for q in (inner.mu[gi], inner.nu[gi]):
            q.codes = _pinned_copy(q.codes)
            q.scales = _pinned_copy(q.scales)
        units.append([inner.mu[gi].codes, inner.mu[gi].scales,
                      inner.nu[gi].codes, inner.nu[gi].scales])
    inner.mu_small = _pinned_copy(inner.mu_small)
    inner.nu_small = _pinned_copy(inner.nu_small)
    if inner.mu_small.numel():
        units.append([inner.mu_small, inner.nu_small])
    inner.offload = HostStream(units, dev)
    torch.cuda.empty_cache()  # the device copies are gone


_ADAMW_KEYS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


def _offload_adamw(inner, dev) -> None:
    """The state of every leaf made now (AdamW makes it at its first
    step, on the device), in pinned host memory; runs of leaves of at
    most ``UNIT_BYTES`` of state are the units."""
    params = [p for g in inner.param_groups for p in g["params"]]
    amsgrad = any(g["amsgrad"] for g in inner.param_groups)
    for p in params:
        st = inner.state[p]
        if not st:
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            st["exp_avg"] = torch.zeros(p.shape, dtype=p.dtype, pin_memory=True)
            st["exp_avg_sq"] = torch.zeros(p.shape, dtype=p.dtype, pin_memory=True)
            if amsgrad:
                st["max_exp_avg_sq"] = torch.zeros(p.shape, dtype=p.dtype, pin_memory=True)
        else:
            for k in _ADAMW_KEYS:
                if k in st:
                    st[k] = _pinned_copy(st[k])
    runs, cur, cur_bytes = [], [], 0
    for p in params:
        b = sum(inner.state[p][k].numel() * inner.state[p][k].element_size()
                for k in _ADAMW_KEYS if k in inner.state[p])
        if cur and cur_bytes + b > UNIT_BYTES:
            runs.append(cur)
            cur, cur_bytes = [], 0
        cur.append(p)
        cur_bytes += b
    if cur:
        runs.append(cur)
    keys = [k for k in _ADAMW_KEYS if params and k in inner.state[params[0]]]
    units = [[inner.state[p][k] for p in run for k in keys] for run in runs]
    inner.offload = HostStream(units, dev)
    inner._offload_runs = runs
    inner._offload_keys = keys
    cls_step = type(inner).step

    def step(closure=None):
        if closure is not None:
            raise NotImplementedError("an offloaded AdamW takes no closure")
        io = inner.offload
        grads = {p: p.grad for p in params}
        io.begin()
        try:
            for i, run in enumerate(runs):
                views = io.fetch(i)
                hosts = {}
                for j, p in enumerate(run):
                    st = inner.state[p]
                    for kk, k in enumerate(keys):
                        hosts[(p, k)] = st[k]
                        st[k] = views[j * len(keys) + kk]
                # one run at a time: AdamW skips leaves without a grad
                in_run = set(run)
                for p in params:
                    p.grad = grads[p] if p in in_run else None
                cls_step(inner)
                for (p, k), h in hosts.items():
                    inner.state[p][k] = h
                io.store(i)
        finally:
            for p in params:
                p.grad = grads[p]
        io.end()

    inner.step = step
