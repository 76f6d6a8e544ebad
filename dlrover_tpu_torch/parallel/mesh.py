"""Named-axis mesh over the ranks of the default process group (the port
of ``dlrover_tpu/parallel/mesh.py``).

``MeshConfig`` is the JAX package's, copied: sizes per named axis
(``AXIS_ORDER``, outermost first), the DCN axes, and the slice count of
a hybrid dp axis. On the TPU the mesh is a ``jax.sharding.Mesh`` and
GSPMD derives the collectives' groups from shardings; here
``build_mesh`` lays the ranks out in the JAX mesh's device order and
makes the process groups the gradient sync runs on:

- ``dp``, ``fsdp`` and ``data`` (dp x fsdp, the axes a global batch is
  split over);
- ``sp``: the ranks that share a row and split its sequence (the ring's
  hops and Ulysses' all-to-alls run on it, and the gradients are summed
  over it: sp shards no parameter), and with sp the ``replica`` group
  (dp x fsdp x sp: the ranks that hold one copy of the state);
- for a hybrid dp axis (``dp_slices() > 1``) the slice-local groups
  (``ici``: one slice's run of ``dp / slices`` dp ranks) and the
  cross-slice stripe groups (``dcn``: the ranks of one intra-slice
  position, one per slice);
- ``tp``: the ranks that differ only in their tp coordinate (adjacent
  ranks: tp is the innermost axis), over which the model's tensor-
  parallel collectives run;
- ``ep``: the ranks that differ only in their ep coordinate, over which
  the MoE layers' dispatch and return all-to-alls run (each holds
  ``E/ep`` experts) and the dense gradients are summed. Every other
  group is one per setting of the other axes, so the data, dp, fsdp, sp
  and replica groups are each tp (ep) coordinate's own.

Rank ``r`` is device ``r`` of the JAX mesh built from
``range(world_size)``: ``AXIS_ORDER`` row-major, and with DCN axes every
DCN factor outside every ICI factor, so a hybrid dp axis enumerates
slice-major (coordinate ``slice * (dp / slices) + j``).

``batch_sharding`` returns the rows of a global batch a rank owns: its
``data`` coordinate's contiguous block, as ``P(("dp", "fsdp"))`` lays
the batch dim on the JAX mesh; ``sequence_sharding`` its block of a
row's positions, as ``P(("dp", "fsdp"), "sp")`` lays the sequence dim.
The ep ranks of one data coordinate hold the same rows, and so do its pp
ranks (each stage reads its coordinate's rows; stage 0 embeds them, the
last stage scores them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes per named axis; unspecified axes default to 1 and are kept in
    the mesh (size-1 axes are free) so sharding rules never dangle."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    # axes whose communication crosses slices/hosts over DCN; they are laid
    # out outermost so ICI keeps the bandwidth-hungry collectives
    dcn_axes: Tuple[str, ...] = ()
    # number of DCN-connected slices the dp axis spans (requires "dp" in
    # dcn_axes and slices | dp). 1 keeps the historical semantics (an
    # axis in dcn_axes is *entirely* DCN); 1 < slices < dp makes dp a
    # HYBRID axis — dp factors as [slices (DCN, outermost), dp/slices
    # (ICI)], so each run of dp/slices consecutive dp coordinates is one
    # ICI-adjacent slice. grad_sync's two-level sync and the topology
    # cost model key off this factorization (dp_slices()).
    slices: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def dp_slices(self) -> int:
        """The dp axis's DCN slice count when it is a valid hybrid axis
        (dp = slices x per-slice-ICI-degree), else 1. slices == dp means
        every dp rank is its own slice — that is the whole-axis-DCN case
        with no ICI level, so it reports 1 (no two-level structure)."""
        if (
            "dp" in self.dcn_axes
            and 1 < self.slices < self.dp
            and self.dp % self.slices == 0
        ):
            return self.slices
        return 1

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "MeshConfig":
        known = {k: v for k, v in d.items() if k in AXIS_ORDER}
        return MeshConfig(**known)


def rank_layout(config: MeshConfig) -> np.ndarray:
    """The ranks ``0 .. num_devices - 1`` in the mesh's shape
    (``AXIS_ORDER``): where the JAX package's ``build_mesh`` puts device
    ``r`` of a device list without slice metadata."""
    sizes = tuple(getattr(config, a) for a in AXIS_ORDER)
    n = int(np.prod(sizes))
    if config.slices > 1 and (
        "dp" not in config.dcn_axes or config.dp % config.slices
    ):
        raise ValueError(
            f"slices={config.slices} needs 'dp' in dcn_axes "
            f"({config.dcn_axes}) and slices | dp (dp={config.dp})"
        )
    ranks = np.arange(n)
    if not config.dcn_axes:
        return ranks.reshape(sizes)
    # per-axis (dcn_factor, ici_factor): an axis in dcn_axes is entirely
    # DCN, EXCEPT dp with slices>1, which is hybrid — slices (DCN) x
    # dp/slices (ICI), DCN factor outermost
    factors = {}
    for a in AXIS_ORDER:
        size = getattr(config, a)
        if a == "dp" and config.slices > 1:
            factors[a] = (config.slices, size // config.slices)
        elif a in config.dcn_axes:
            factors[a] = (size, 1)
        else:
            factors[a] = (1, size)
    dcn_sizes = [factors[a][0] for a in AXIS_ORDER]
    ici_sizes = [factors[a][1] for a in AXIS_ORDER]
    arr = ranks.reshape(dcn_sizes + ici_sizes)
    n_ax = len(AXIS_ORDER)
    perm = []
    for i in range(n_ax):
        perm.extend([i, n_ax + i])
    return arr.transpose(perm).reshape(
        [d * i for d, i in zip(dcn_sizes, ici_sizes)]
    )


def _axis_runs(layout: np.ndarray, axes: Sequence[str]) -> List[List[int]]:
    """The rank lists that vary along ``axes`` (in their mesh order,
    first axis outermost) with every other coordinate fixed."""
    idx = [AXIS_ORDER.index(a) for a in axes]
    rest = [i for i in range(len(AXIS_ORDER)) if i not in idx]
    moved = np.transpose(layout, rest + idx)
    k = int(np.prod([layout.shape[i] for i in idx]))
    return [list(map(int, row)) for row in moved.reshape(-1, k)]


@dataclass
class Mesh:
    """This rank's view of the mesh: the layout, its coordinates, and
    the process groups of the axes the sync runs on (``None`` for a
    group of one rank, which no collective needs). ``groups[name]`` is
    this rank's group; ``ranks[name]`` its members in mesh order."""

    config: MeshConfig
    rank: int
    layout: np.ndarray
    device_mesh: object = None
    coords: Dict[str, int] = field(default_factory=dict)
    groups: Dict[str, object] = field(default_factory=dict)
    ranks: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    def axis_sizes(self) -> Dict[str, int]:
        return self.config.axis_sizes()

    @property
    def data_index(self) -> int:
        """This rank's lane on the data axes: ``dp * fsdp + fsdp``."""
        return self.coords["dp"] * self.config.fsdp + self.coords["fsdp"]

    @property
    def stage(self) -> int:
        """This rank's pipeline stage: its coordinate on ``pp``."""
        return self.coords.get("pp", 0)

    def group_index(self, name: str) -> int:
        """This rank's position in ``ranks[name]`` (mesh order)."""
        return self.ranks[name].index(self.rank)

    @property
    def idle(self) -> bool:
        """True on a rank of the process group outside the mesh (a
        resize that degraded to fewer ranks than the world): it has no
        coordinates and no group."""
        return self.rank >= self.layout.size


def build_mesh(config: MeshConfig, device_type: str = "cpu") -> Mesh:
    """The mesh over the first ``num_devices`` ranks of the default
    process group (or over one process when none is initialized and
    ``config`` has one device). Every rank must call this, in the same
    order, with the same config: each group is made by all ranks
    (``new_group`` is collective), those outside the mesh too, which get
    an ``idle`` mesh (the ranks a resize leaves idle when the batch does
    not divide over the world). A mesh larger than the world raises."""
    import torch
    import torch.distributed as dist

    layout = rank_layout(config)
    n = layout.size
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(
            f"mesh {config.axis_sizes()} needs {n} ranks, the process "
            f"group has {world}"
        )
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = {}
    if rank < n:
        where = np.argwhere(layout == rank)[0]
        coords = {a: int(c) for a, c in zip(AXIS_ORDER, where)}
    mesh = Mesh(config=config, rank=rank, layout=layout, coords=coords)
    if dist.is_initialized() and not mesh.idle:
        from torch.distributed.device_mesh import DeviceMesh

        # the layout alone: the sync's groups are made below, only for
        # the axes it runs on (a group per dim of all six would cost a
        # communicator each on NCCL)
        mesh.device_mesh = DeviceMesh(
            device_type, torch.as_tensor(layout), mesh_dim_names=AXIS_ORDER,
            _init_backend=False,
        )
    wanted = {"dp": ("dp",), "fsdp": ("fsdp",), "data": ("dp", "fsdp"), "sp": ("sp",),
              "tp": ("tp",), "ep": ("ep",), "pp": ("pp",)}
    if config.sp > 1:
        # the ranks that hold one replica of the state under sp
        wanted["replica"] = ("dp", "fsdp", "sp")
    runs = {name: _axis_runs(layout, axes) for name, axes in wanted.items()}
    S = config.dp_slices()
    if S > 1:
        per = config.dp // S
        ici, dcn = [], []
        for run in runs["dp"]:
            ici += [run[s * per:(s + 1) * per] for s in range(S)]
            dcn += [[run[s * per + j] for s in range(S)] for j in range(per)]
        runs["ici"], runs["dcn"] = ici, dcn
    for name, lists in runs.items():
        mine = next((r for r in lists if rank in r), [])
        mesh.ranks[name] = mine
        mesh.groups[name] = None
        if len(lists[0]) > 1 and dist.is_initialized():
            # every rank makes every group of the axis, in one order
            for r in lists:
                g = dist.new_group(sorted(r))
                if rank in r:
                    mesh.groups[name] = g
    return mesh


def data_axes() -> Tuple[str, ...]:
    """Mesh axes a global batch is sharded over."""
    return ("dp", "fsdp")


def batch_sharding(mesh: Mesh, global_rows: int, microbatches: int = 1,
                   axes: Sequence[str] = ("dp", "fsdp")) -> np.ndarray:
    """The rows of a global batch of ``global_rows`` this rank owns, in
    order: of each of the ``microbatches`` consecutive microbatches (the
    JAX step's ``grad_accum`` reshape), the ``data_index``-th of
    ``dp * fsdp`` equal contiguous blocks, as ``P(("dp", "fsdp"))`` lays
    a microbatch's batch dim on the JAX mesh. The rank's k-th
    microbatch is then the k-th equal chunk of its rows. ``axes``: the
    data axes a microbatch is split over (its index over them, in mesh
    order; the ranks that differ only on another data axis read the
    same rows), as ``P(axes)`` lays it."""
    sizes = [getattr(mesh.config, a) for a in axes]
    n = int(np.prod(sizes)) if sizes else 1
    if global_rows % (n * microbatches):
        raise ValueError(
            f"global batch {global_rows} does not divide into "
            f"{microbatches} microbatch(es) over the {n} data ranks "
            f"({' x '.join(axes) or 'none'})"
        )
    mb = global_rows // microbatches
    per = mb // n
    i = 0
    for a, size in zip(axes, sizes):
        i = i * size + mesh.coords.get(a, 0)
    return np.concatenate([
        np.arange(k * mb + i * per, k * mb + (i + 1) * per)
        for k in range(microbatches)
    ])


def sequence_sharding(mesh: Mesh, seq_len: int) -> slice:
    """The positions of a row this rank holds: the ``sp``-th of ``sp``
    equal contiguous blocks of ``seq_len``, as ``P(("dp", "fsdp"), "sp")``
    lays the sequence dim on the JAX mesh (``sp`` shares every row of
    its data rank's rows)."""
    sp = mesh.config.sp
    if seq_len % sp:
        raise ValueError(f"sequence length {seq_len} does not divide over sp={sp}")
    per = seq_len // sp
    i = mesh.coords.get("sp", 0)
    return slice(i * per, (i + 1) * per)


def process_axis_index(mesh: Mesh, axis: str) -> int:
    """This process's coordinate along ``axis`` (for per-host data
    feeds); one process drives one device here."""
    return mesh.coords.get(axis, 0)
