"""Measured, hierarchical link-cost model (the port of
``dlrover_tpu/parallel/topology.py``).

``LinkModel`` keeps the JAX package's fields and JSON format, so a model
written by either package reads back in the other. The link classes
keep their names: ``ici_*`` is the link between cards inside a node
(NVLink on an H100 SXM node), ``dcn_*`` the network between nodes
(InfiniBand), ``host_*`` the card's link to its host (PCIe). Consumers
ask ``sec_per_ici_byte()`` / ``sec_per_dcn_byte()`` instead of importing
constants.

- **``probe_link_model``** — the startup probe: ``dist.all_reduce`` on
  each data axis's group of the mesh (``parallel/mesh.build_mesh``),
  timed with CUDA events, and pinned host-to-card and card-to-host
  ``copy_`` timed the same way. The result is JSON-persisted per
  **device fingerprint** (card name and count, world size, node count,
  backend) so warm restarts skip the probe. At world size 1 there is no
  link between cards to time: those legs keep the spec fallback and the
  model is marked ``source="measured-host"``, which
  ``note_fallback_use`` flags as unprobed (it never invents a number).
- **Fallback** — the H100 platform's published link rates
  (``FALLBACK_*``), each a specification, not a measurement: a model
  made of them has ``source="fallback"`` (``"fallback-cpu"`` on the
  CPU), and consumers log once when they price from it.

The cache directory honours ``DLROVER_TPU_TOPOLOGY_CACHE``.

Downstream consumers: ``accel/dry_runner._comm_estimate``,
``grad_sync`` per-link bucket sizing (``bucket_bytes_for``) and
``grad_compress="auto"``, the trainer's startup probe, the step
auditor's budget (``obs/audit.py``), and ``slice_throughput_weights``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict, dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger

# -- documented fallback constants ------------------------------------------
# Published rates of the H100 SXM platform, per direction, each a
# SPECIFICATION and not a measurement (a model made of them is marked
# unprobed and consumers log it once, note_fallback_use):
# - ici: NVLink 4 between the cards of one node, 18 links x 25 GB/s a
#   direction (900 GB/s both ways), NVIDIA H100 SXM5 datasheet;
# - dcn: one 400 Gb/s InfiniBand NDR port a card (ConnectX-7, as on a
#   DGX H100), 50 GB/s;
# - host: PCIe Gen5 x16, 64 GB/s a direction.
# The latencies are no specification: they are the order of one small
# NCCL collective inside a node, one across nodes, and one cudaMemcpy,
# kept only so tiny transfers never price as free. On this platform the
# JAX package's ordering invariant (ici >= dcn >= host) does not hold
# for the fallback: a card's PCIe link outruns its share of the network.
FALLBACK_ICI_GBPS = 450.0
FALLBACK_DCN_GBPS = 50.0
FALLBACK_HOST_GBPS = 64.0
FALLBACK_ICI_LAT_S = 10e-6
FALLBACK_DCN_LAT_S = 20e-6
FALLBACK_HOST_LAT_S = 10e-6

_CACHE_ENV = "DLROVER_TPU_TOPOLOGY_CACHE"


@dataclass(frozen=True)
class LinkModel:
    """Per-link bandwidth/latency of the current device world.

    ``ici_axis_gbps`` carries the per-mesh-axis measurements when the
    probe ran per axis (different ICI axes can ride different numbers
    of physical links); ``ici_gbps`` is the bottleneck (min) of those,
    which is what a conservative cost model should price with.
    """

    ici_gbps: float = FALLBACK_ICI_GBPS
    dcn_gbps: float = FALLBACK_DCN_GBPS
    host_d2h_gbps: float = FALLBACK_HOST_GBPS
    host_h2d_gbps: float = FALLBACK_HOST_GBPS
    ici_lat_s: float = FALLBACK_ICI_LAT_S
    dcn_lat_s: float = FALLBACK_DCN_LAT_S
    host_lat_s: float = FALLBACK_HOST_LAT_S
    ici_axis_gbps: Tuple[Tuple[str, float], ...] = ()
    # "measured" | "measured-host" (the host legs probed, the links
    # between cards from the spec: one rank, nothing to time) |
    # "fallback-cpu" | "fallback"; consumers log once when pricing from
    # a model that is not wholly measured (note_fallback_use)
    source: str = "fallback"
    fingerprint: str = ""
    probed_at: float = 0.0

    # -- pricing ------------------------------------------------------
    def sec_per_ici_byte(self) -> float:
        return 1.0 / max(self.ici_gbps * 1e9, 1.0)

    def sec_per_dcn_byte(self) -> float:
        return 1.0 / max(self.dcn_gbps * 1e9, 1.0)

    def sec_per_host_byte(self, h2d: bool = False) -> float:
        bw = self.host_h2d_gbps if h2d else self.host_d2h_gbps
        return 1.0 / max(bw * 1e9, 1.0)

    def axis_gbps(self, axis: str) -> float:
        for a, bw in self.ici_axis_gbps:
            if a == axis:
                return bw
        return self.ici_gbps

    def sec_per_axis_byte(self, axis: str) -> float:
        """Per-ICI-axis pricing: different mesh axes can ride
        different numbers of physical links, and the probe measures
        each axis with size > 1 (e.g. a dp x fsdp mesh carries both a
        "dp" and an "fsdp" entry). Falls back to the conservative
        bottleneck ``ici_gbps`` for unmeasured axes."""
        return 1.0 / max(self.axis_gbps(axis) * 1e9, 1.0)

    @property
    def ordering_ok(self) -> bool:
        """The sanity invariant: chip fabric >= cross-slice network >=
        host staging link."""
        return (
            self.ici_gbps >= self.dcn_gbps >= min(
                self.host_d2h_gbps, self.host_h2d_gbps
            )
        )

    def describe(self) -> str:
        return (
            f"links[{self.source}]: ici {self.ici_gbps:.1f} GB/s, "
            f"dcn {self.dcn_gbps:.1f} GB/s, host "
            f"{self.host_d2h_gbps:.1f}/{self.host_h2d_gbps:.1f} GB/s "
            f"d2h/h2d (fp {self.fingerprint or '-'})"
        )

    # -- persistence --------------------------------------------------
    def to_json(self) -> str:
        d = asdict(self)
        d["ici_axis_gbps"] = [list(p) for p in self.ici_axis_gbps]
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "LinkModel":
        d = json.loads(s)
        d["ici_axis_gbps"] = tuple(
            (str(a), float(b)) for a, b in d.get("ici_axis_gbps", [])
        )
        return LinkModel(**d)


def fallback_link_model(
    fingerprint: str = "", source: str = "fallback"
) -> LinkModel:
    return LinkModel(source=source, fingerprint=fingerprint)


# -- device fingerprint / cache ---------------------------------------------


def device_fingerprint(devices=None) -> str:
    """Stable id of the device world a probe is valid for: the device
    type and name, the card count of this host, the world size, the node
    count (``DLROVER_TPU_NODE_NUM``, 1 when unset) and the process
    group's backend. ``devices``: a ``torch.device`` or spec (the
    current card by default; ``"cpu"`` for the CPU)."""
    import torch
    import torch.distributed as dist

    dev = devices
    if isinstance(dev, (list, tuple)):
        dev = dev[0] if dev else None
    if dev is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(dev)
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    backend = str(dist.get_backend()) if dist.is_initialized() else "none"
    nodes = int(os.getenv("DLROVER_TPU_NODE_NUM", "") or 1)
    raw = "|".join(
        ["torch", dev.type, kind, str(count), str(world), str(nodes), backend]
    )
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def cache_dir(override: Optional[str] = None) -> str:
    return (
        override
        or os.getenv(_CACHE_ENV)
        or os.path.join(
            os.path.expanduser("~"), ".cache", "dlrover_tpu"
        )
    )


def cache_path(fingerprint: str, dir_override: Optional[str] = None) -> str:
    return os.path.join(
        cache_dir(dir_override), f"linkmodel-{fingerprint}.json"
    )


def load_cached(
    fingerprint: str, dir_override: Optional[str] = None
) -> Optional[LinkModel]:
    try:
        with open(cache_path(fingerprint, dir_override)) as f:
            model = LinkModel.from_json(f.read())
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if model.fingerprint != fingerprint:
        return None  # stale file copied across worlds
    return model


def save_cache(
    model: LinkModel, dir_override: Optional[str] = None
) -> Optional[str]:
    """Best-effort persist (atomic rename); a read-only filesystem must
    never take down the probe."""
    path = cache_path(model.fingerprint, dir_override)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(model.to_json())
        # best effort: a torn file fails the json / fingerprint check on
        # load and the next start just probes again
        os.replace(tmp, path)
        return path
    except OSError as e:
        logger.warning(f"link-model cache write failed: {e!r}")
        return None


# -- observed rail rates ------------------------------------------------------

# EWMA weight of one NEW realized-rate sample: a changed link settles
# in ~3 stripes without letting a single anomalous transfer (page-cache
# hit, one congested instant) own the price
RAIL_RATE_EWMA_WEIGHT = 0.3
# a transfer smaller than this prices latency, not bandwidth — the
# striper's fold skips rails that moved less
RAIL_RATE_MIN_BYTES = 1 << 20

# observed-rate key ("rail direction") -> the LinkModel field it
# overrides; the same vocabulary rail_link_gbps prices by
_RAIL_RATE_FIELDS = {
    "d2h": "host_d2h_gbps",
    "h2d": "host_h2d_gbps",
    "peer": "dcn_gbps",
}


@dataclass
class ObservedRailRates:
    """Realized per-rail throughput (GB/s), EWMA-folded from finished
    striped transfers and persisted next to the probed ``LinkModel``
    cache under the same device fingerprint. The startup probe measures
    each link once with a synthetic payload; these numbers come from
    the job's actual traffic — ``get_link_model`` overlays them onto
    whatever model it returns, so bucket auto-sizing, stripe shares,
    arbiter pricing and the dry-runner's est_step_s track the link the
    job really has, not the link it had at startup. Keys are rail
    directions (``"d2h"`` | ``"h2d"`` | ``"peer"``)."""

    fingerprint: str = ""
    gbps: Dict[str, float] = field(default_factory=dict)
    samples: Dict[str, int] = field(default_factory=dict)
    updated_at: float = 0.0

    def to_payload(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "gbps": {k: float(v) for k, v in self.gbps.items()},
            "samples": {k: int(v) for k, v in self.samples.items()},
            "updated_at": float(self.updated_at),
        }

    @staticmethod
    def from_payload(d: dict) -> "ObservedRailRates":
        return ObservedRailRates(
            fingerprint=str(d["fingerprint"]),
            gbps={
                str(k): float(v) for k, v in dict(d["gbps"]).items()
            },
            samples={
                str(k): int(v)
                for k, v in dict(d.get("samples", {})).items()
            },
            updated_at=float(d.get("updated_at", 0.0)),
        )


_OBSERVED: Optional[ObservedRailRates] = None
# fingerprints whose disk file this process already looked for — the
# overlay rides every get_link_model() call, which must stay a dict
# lookup, not a stat() per pricing query
_OBS_DISK_CHECKED: set = set()


def rail_rates_path(
    fingerprint: str, dir_override: Optional[str] = None
) -> str:
    return os.path.join(
        cache_dir(dir_override), f"railrates-{fingerprint}.json"
    )


def load_rail_rates(
    fingerprint: Optional[str] = None,
    dir_override: Optional[str] = None,
) -> Optional[ObservedRailRates]:
    if fingerprint is None:
        try:
            fingerprint = device_fingerprint()
        except Exception:  # no backend yet (early import paths)
            return None
    try:
        with open(rail_rates_path(fingerprint, dir_override)) as f:
            rates = ObservedRailRates.from_payload(json.load(f))
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if rates.fingerprint != fingerprint:
        return None  # stale file copied across worlds
    return rates


def save_rail_rates(
    rates: ObservedRailRates, dir_override: Optional[str] = None
) -> Optional[str]:
    """Durable persist (fsync-before-rename: the EWMA is long-lived
    state a crash should not tear). Best-effort all the same — a
    read-only cache dir must never take down the transfer that fed the
    sample; the EWMA just stays process-local."""
    path = rail_rates_path(rates.fingerprint, dir_override)
    try:
        from dlrover_tpu_torch.agent.monitor import atomic_write_json

        atomic_write_json(path, rates.to_payload(), durable=True)
        return path
    except OSError as e:
        logger.warning(f"observed rail-rate cache write failed: {e!r}")
        return None


def set_rail_rates(rates: Optional[ObservedRailRates]) -> None:
    """Install an observed-rates snapshot as the process-current one
    (tests/bench; ``observe_rail_rate`` maintains it in production)."""
    global _OBSERVED
    _OBSERVED = rates


def reset_rail_rates() -> None:
    global _OBSERVED
    _OBSERVED = None
    _OBS_DISK_CHECKED.clear()


def _observed_for(
    fp: str, dir_override: Optional[str] = None
) -> Optional[ObservedRailRates]:
    """The observed-rates snapshot applicable to ``fp``: the in-process
    one when its fingerprint matches (or either side has none), else a
    one-time disk probe per fingerprint."""
    global _OBSERVED
    obs = _OBSERVED
    if obs is not None and (
        not fp or not obs.fingerprint or obs.fingerprint == fp
    ):
        return obs
    if fp and fp not in _OBS_DISK_CHECKED:
        _OBS_DISK_CHECKED.add(fp)
        disk = load_rail_rates(fp, dir_override)
        if disk is not None:
            if _OBSERVED is None:
                _OBSERVED = disk
            return disk
    return None


def get_rail_rates(
    devices=None, dir_override: Optional[str] = None
) -> Optional[ObservedRailRates]:
    """Process-current observed rates for this device world, else the
    disk cache, else None. Never measures — samples arrive only from
    real transfers through ``observe_rail_rate``."""
    try:
        fp = device_fingerprint(devices)
    except Exception:
        fp = ""
    return _observed_for(fp, dir_override)


def observe_rail_rate(
    rail: str,
    gbps: float,
    devices=None,
    dir_override: Optional[str] = None,
) -> Optional[ObservedRailRates]:
    """Fold one realized-throughput sample (GB/s over a finished
    transfer of at least ``RAIL_RATE_MIN_BYTES``) into the per-rail
    EWMA, persist the snapshot, and export the gauge. ``rail`` is a
    direction key from ``_RAIL_RATE_FIELDS``; anything else (a custom
    bench rail with no LinkModel leg) is ignored."""
    global _OBSERVED
    if rail not in _RAIL_RATE_FIELDS or not gbps > 0.0:
        return _OBSERVED
    try:
        fp = device_fingerprint(devices)
    except Exception:
        fp = ""
    obs = _observed_for(fp, dir_override)
    if obs is None:
        obs = ObservedRailRates(fingerprint=fp)
    prev = obs.gbps.get(rail)
    if prev is None:
        new = float(gbps)
    else:
        w = RAIL_RATE_EWMA_WEIGHT
        new = (1.0 - w) * prev + w * float(gbps)
    obs.gbps[rail] = new
    obs.samples[rail] = obs.samples.get(rail, 0) + 1
    obs.updated_at = time.time()
    _OBSERVED = obs
    save_rail_rates(obs, dir_override)
    export_rail_rate_metrics(obs)
    return obs


def apply_observed_rates(
    model: LinkModel, rates: ObservedRailRates
) -> LinkModel:
    """``model`` with every observed rail rate overriding the probed
    (or fallback) figure for its leg. Latency and ICI stay as probed —
    the striper only ever realizes host/DCN legs."""
    kw = {}
    for rail, gbps in rates.gbps.items():
        fld = _RAIL_RATE_FIELDS.get(rail)
        if fld is not None and gbps > 0.0:
            kw[fld] = float(gbps)
    return dc_replace(model, **kw) if kw else model


def export_rail_rate_metrics(
    rates: ObservedRailRates, registry=None
) -> None:
    """``dlrover_link_observed_gbps{rail}`` gauges
    (docs/observability.md)."""
    if registry is None:
        from dlrover_tpu_torch.obs.metrics import default_registry

        registry = default_registry()
    g = registry.gauge(
        "dlrover_link_observed_gbps",
        "EWMA realized rail throughput from striped transfers "
        "(parallel/topology.py)",
        labelnames=("rail",),
    )
    for rail, gbps in rates.gbps.items():
        g.labels(rail).set(float(gbps))


# -- measurement -------------------------------------------------------------


def _events_ms(device, fn, iters: int) -> float:
    """Median ms of ``fn()`` over ``iters`` runs after one warm-up:
    CUDA events around each run on the card, the host clock on the
    CPU."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _time_allreduce(group, nbytes: int, device, iters: int = 3) -> Tuple[float, float]:
    """(bandwidth GB/s, latency s) of ``dist.all_reduce`` on ``group``
    (every rank of it calls this together). Bandwidth from the ring cost
    2(n-1)/n x payload per rank; latency from a 4-byte collective. A
    group of one rank has no link to time: (0.0, 0.0), and the caller
    keeps the spec fallback."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group) if (group is not None and dist.is_initialized()) else 1
    if n <= 1:
        return 0.0, 0.0
    elems = max(n, (nbytes // 4 // n) * n)

    def _run(size):
        x = torch.zeros((size,), dtype=torch.float32, device=device)
        return _events_ms(device, lambda: dist.all_reduce(x, group=group), iters) / 1e3

    lat = _run(1)
    t = _run(elems)
    ring_bytes = 2.0 * (n - 1) / n * elems * 4
    bw = ring_bytes / max(t - lat, 1e-9)
    return bw / 1e9, max(lat, 0.0)


def _time_host_link(nbytes: int, device, iters: int = 3) -> Tuple[float, float]:
    """(d2h GB/s, h2d GB/s): ``copy_`` between a pinned host buffer and
    a buffer on the card, timed with CUDA events."""
    import torch

    elems = max(1, nbytes // 4)
    dev = torch.empty((elems,), dtype=torch.float32, device=device).fill_(1.0)
    host = torch.empty((elems,), dtype=torch.float32, pin_memory=device.type == "cuda")
    d2h = _events_ms(device, lambda: host.copy_(dev, non_blocking=True), iters)
    h2d = _events_ms(device, lambda: dev.copy_(host, non_blocking=True), iters)
    b = elems * 4
    return (
        b / max(d2h / 1e3, 1e-9) / 1e9,
        b / max(h2d / 1e3, 1e-9) / 1e9,
    )


def probe_link_model(
    mesh_config=None,
    devices=None,
    force: bool = False,
    cache_dir: Optional[str] = None,
    measure_on_cpu: bool = False,
    probe_mb: int = 4,
    mesh=None,
) -> LinkModel:
    """The startup probe. Returns the cached model when one exists for
    this device fingerprint (warm restarts skip the measurement,
    ``force=True`` overrides); measures otherwise: the all-reduce of each
    data axis with more than one rank on the mesh's groups (every rank
    calls this together; ``mesh``: a built ``parallel/mesh.Mesh``, else
    one is built from ``mesh_config``), a whole DCN axis or the stripe
    groups of a hybrid dp axis as the cross-node leg, and the pinned host
    link. Legs with nothing to time keep the spec fallback: a model whose
    links between cards were not probed is ``"measured-host"``. On
    several ranks rank 0 decides between its cache and a measurement,
    and every rank takes rank 0's model (the plans priced from it must
    agree). The CPU
    gets the fallback unless ``measure_on_cpu`` (tests exercise the
    machinery with it; a memcpy "bandwidth" is no real model)."""
    import torch

    import torch.distributed as dist

    dev = devices[0] if isinstance(devices, (list, tuple)) and devices else devices
    if dev is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(dev)
    fp = device_fingerprint(dev)
    several = dist.is_initialized() and dist.get_world_size() > 1
    cached = None if force else load_cached(fp, cache_dir)
    if several:
        # rank 0 decides: every rank uses its cache, or every rank
        # measures (the probe's collectives need them all)
        cached = _from_rank0(cached)
    if cached is not None:
        set_link_model(cached)
        return cached
    if dev.type == "cpu" and not measure_on_cpu:
        model = fallback_link_model(fp, source="fallback-cpu")
        save_cache(model, cache_dir)
        set_link_model(model)
        logger.info(model.describe())
        return model

    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    if mesh is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh_config is None:
            mesh_config = MeshConfig(dp=world)
        mesh = build_mesh(mesh_config, dev.type)
    mesh_config = mesh.config
    nbytes = probe_mb << 20
    axis_bws: List[Tuple[str, float]] = []
    ici_lat = FALLBACK_ICI_LAT_S
    dcn_bw, dcn_lat = 0.0, 0.0
    slices = mesh_config.dp_slices()
    for a in ("dp", "fsdp"):
        if getattr(mesh_config, a) <= 1:
            continue
        if a in mesh_config.dcn_axes and not (a == "dp" and slices > 1):
            bw, lat = _time_allreduce(mesh.groups.get(a), nbytes, dev)
            if bw > 0:
                dcn_bw, dcn_lat = bw, lat
            continue
        if a == "dp" and slices > 1:
            # the groups the two-level sync runs on
            bw, lat = _time_allreduce(mesh.groups.get("ici"), nbytes, dev)
            if bw > 0:
                axis_bws.append((a, bw))
                ici_lat = lat
            bw, lat = _time_allreduce(mesh.groups.get("dcn"), nbytes, dev)
            if bw > 0:
                dcn_bw, dcn_lat = bw, lat
            continue
        bw, lat = _time_allreduce(mesh.groups.get(a), nbytes, dev)
        if bw > 0:
            axis_bws.append((a, bw))
            ici_lat = lat
    d2h, h2d = _time_host_link(nbytes, dev)
    ici_bw = min((bw for _, bw in axis_bws), default=FALLBACK_ICI_GBPS)
    model = LinkModel(
        ici_gbps=ici_bw,
        dcn_gbps=dcn_bw or FALLBACK_DCN_GBPS,
        host_d2h_gbps=d2h,
        host_h2d_gbps=h2d,
        ici_lat_s=ici_lat,
        dcn_lat_s=dcn_lat or FALLBACK_DCN_LAT_S,
        host_lat_s=FALLBACK_HOST_LAT_S,
        ici_axis_gbps=tuple(axis_bws),
        source="measured" if axis_bws or dcn_bw else "measured-host",
        fingerprint=fp,
        probed_at=time.time(),
    )
    if several:
        # one model on every rank: each rank's timings differ a little,
        # and the plans priced from it (auto bucket sizes, auto
        # compression) must be the same on all
        model = _from_rank0(model)
    save_cache(model, cache_dir)
    set_link_model(model)
    logger.info(model.describe())
    return model


def _from_rank0(model: Optional[LinkModel]) -> Optional[LinkModel]:
    """Rank 0's model (or None) on every rank of the default group."""
    import torch.distributed as dist

    box = [model.to_json() if model is not None else None]
    dist.broadcast_object_list(box, src=0)
    return LinkModel.from_json(box[0]) if box[0] is not None else None


# -- process-level accessor ---------------------------------------------------

_MEMO: Dict[str, LinkModel] = {}
# the most recently probed/installed model in THIS process. Consumers
# that cannot know the exact device subset in play (the dry-runner and
# bucket sizer call get_link_model() with no devices, which fingerprints
# the current card and world) would otherwise miss a model the trainer probed
# for its mesh's subset — e.g. right after an elastic resize — and
# silently price from the fallback constants.
_CURRENT: Optional[LinkModel] = None
_FALLBACK_WARNED = False


def get_link_model(
    devices=None, cache_dir: Optional[str] = None
) -> LinkModel:
    """The cost model's view, in preference order: the in-process
    model for this exact device fingerprint, else whatever this
    process most recently probed/installed (a subset probe from a
    resize beats stale disk files from other runs), else a persisted
    probe cache for the fingerprint, else the documented fallback
    constants. NEVER probes — probing is an explicit startup/bench
    action (``probe_link_model``); estimation paths must stay cheap
    and deterministic.

    Observed rail rates (``observe_rail_rate`` — realized throughput
    from the job's own striped transfers) overlay the result AFTER the
    memo lookup, so a sample folded mid-run reprices every consumer on
    its next query without invalidating the cached probe. ``devices``:
    the device the fingerprint is taken for (the current card, or the
    CPU when no card is present)."""
    try:
        fp = device_fingerprint(devices)
    except Exception:  # no backend yet (early import paths)
        fp = ""
    if fp in _MEMO:
        model = _MEMO[fp]
    elif _CURRENT is not None:
        model = _CURRENT
    else:
        model = load_cached(fp, cache_dir) if fp else None
        if model is None:
            model = fallback_link_model(fp, source="fallback")
        _MEMO[fp] = model
    obs = _observed_for(fp, cache_dir)
    if obs is not None and obs.gbps:
        model = apply_observed_rates(model, obs)
    return model


def set_link_model(model: LinkModel, devices=None) -> None:
    """Install a model as the process-current one (tests/bench, and
    any consumer asking without an exact fingerprint match)."""
    global _CURRENT
    fp = model.fingerprint or device_fingerprint(devices)
    _MEMO[fp] = model
    _CURRENT = model


def reset_link_model() -> None:
    global _FALLBACK_WARNED, _CURRENT
    _MEMO.clear()
    _CURRENT = None
    _FALLBACK_WARNED = False
    # observed rail rates overlay whatever get_link_model returns, so a
    # full model reset (tests/bench teardown) must drop them too or the
    # "pristine" fallback would come back pre-overlaid
    reset_rail_rates()


def note_fallback_use(model: LinkModel) -> None:
    """Log ONCE per process when a consumer prices wire time from a
    non-measured model — the old hardcoded constants are now an
    explicit, visible fallback instead of a silent assumption."""
    global _FALLBACK_WARNED
    if model.source == "measured" or _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED = True
    logger.info(
        f"comm cost model: no measured link probe for this backend — "
        f"pricing from documented constants ({model.describe()}); run "
        f"parallel.topology.probe_link_model on real hardware to "
        f"replace them"
    )


def rail_link_gbps(model: LinkModel, direction: str) -> float:
    """Bandwidth of a transfer-arbiter rail under this model, by the
    rail's direction: ``d2h``/``h2d`` price the host legs, ``peer``
    prices the DCN path the batched RPC legs traverse. The multi-rail
    striper plans completion-time-balanced chunk shares from these
    numbers, so a measured model directly shapes the stripe."""
    if direction == "h2d":
        return model.host_h2d_gbps
    if direction == "peer":
        return model.dcn_gbps
    return model.host_d2h_gbps


def price_host_transfer(
    nbytes: int, h2d: bool = False, model: Optional[LinkModel] = None
) -> float:
    """Seconds a host↔device transfer of ``nbytes`` costs on the
    host leg (bandwidth + per-transfer latency). The embedding row
    pipeline prices its fault-in (H2D) and spill/scatter-back (D2H)
    traffic through here so the dry-runner's est_step_s and the Brain's
    job telemetry see the same host-link physics the collectives and
    checkpoint staging are priced with — not an invented constant."""
    if nbytes <= 0:
        return 0.0
    m = model if model is not None else get_link_model()
    note_fallback_use(m)
    return m.host_lat_s + nbytes * m.sec_per_host_byte(h2d=h2d)


def export_link_metrics(model: LinkModel, registry=None) -> None:
    """Per-link gauges into the metrics registry
    (docs/observability.md): ``dlrover_link_{ici,dcn,host_d2h,
    host_h2d}_gbps`` + ``dlrover_link_model_measured`` (1 when the
    numbers come from a real probe)."""
    if registry is None:
        from dlrover_tpu_torch.obs.metrics import default_registry

        registry = default_registry()
    for name, value in (
        ("dlrover_link_ici_gbps", model.ici_gbps),
        ("dlrover_link_dcn_gbps", model.dcn_gbps),
        ("dlrover_link_host_d2h_gbps", model.host_d2h_gbps),
        ("dlrover_link_host_h2d_gbps", model.host_h2d_gbps),
        (
            "dlrover_link_model_measured",
            1.0 if model.source == "measured" else 0.0,
        ),
    ):
        registry.gauge(
            name, "link cost model (parallel/topology.py)"
        ).set(float(value))


# -- derived knobs ------------------------------------------------------------

# target wire time per sync bucket: small enough that the scheduler
# has multiple independent collectives to interleave with backward
# compute, large enough that per-collective latency stays amortized
BUCKET_TARGET_COMM_MS = 2.0
_BUCKET_MIN_BYTES = 1 << 20
_BUCKET_MAX_BYTES = 64 << 20


def bucket_bytes_for(
    model: LinkModel,
    link: str = "ici",
    target_ms: float = BUCKET_TARGET_COMM_MS,
) -> int:
    """Per-link bucket size: the byte count whose wire time on ``link``
    is ~``target_ms`` (clamped to [1, 64] MiB). A DCN-bound two-level
    sync gets smaller buckets than a pure-ICI one because the same
    2 ms window holds fewer cross-slice bytes."""
    bw = {
        "ici": model.ici_gbps,
        "dcn": model.dcn_gbps,
        "host": model.host_d2h_gbps,
    }.get(link)
    if bw is None:
        raise ValueError(f"unknown link {link!r} (ici|dcn|host)")
    b = int(bw * 1e9 * target_ms / 1e3)
    return max(_BUCKET_MIN_BYTES, min(_BUCKET_MAX_BYTES, b))


def alltoall_time_s(
    nbytes: int,
    n: int,
    model: Optional[LinkModel] = None,
    dcn: bool = False,
) -> float:
    """Seconds of one all-to-all over an ``n``-device group where each
    device holds ``nbytes`` of payload: ``(n-1)/n`` of it leaves the
    device, at the ICI rate (or DCN when the group crosses slices) plus
    one collective's latency. The MoE dispatch/combine legs
    (``parallel/moe.py``) are priced through here so the dry-runner's
    est_step_s sees the same link physics the gradient collectives are
    priced with."""
    if n <= 1 or nbytes <= 0:
        return 0.0
    m = model if model is not None else get_link_model()
    note_fallback_use(m)
    rate = m.sec_per_dcn_byte() if dcn else m.sec_per_ici_byte()
    lat = m.dcn_lat_s if dcn else m.ici_lat_s
    return (n - 1) / n * nbytes * rate + n * lat


# -- heterogeneous per-slice throughput weighting -----------------------------


def slice_throughput_weights(
    step_times_s: Sequence[float],
) -> List[float]:
    """Normalized data-shard weights from per-slice step times: a slice
    twice as fast gets twice the data (arXiv 2602.18007's unequal
    shards for unequal slices). Non-positive/missing entries get the
    mean throughput so one bad measurement cannot zero out a slice."""
    times = [float(t) for t in step_times_s]
    if not times:
        return []
    thr = [1.0 / t if t > 0 else 0.0 for t in times]
    positive = [t for t in thr if t > 0]
    if not positive:
        return [1.0 / len(times)] * len(times)
    mean_thr = sum(positive) / len(positive)
    thr = [t if t > 0 else mean_thr for t in thr]
    total = sum(thr)
    return [t / total for t in thr]
