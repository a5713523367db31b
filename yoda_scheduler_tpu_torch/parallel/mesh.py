"""The rank mesh for dp/fsdp/ep/sp/tp/pp parallelism over torch.distributed.

The port of yoda_scheduler_tpu/parallel/mesh.py. A JAX mesh is a grid of
devices with named axes; here it is a grid of process ranks with the same
axis names and order, and one process group for each axis and for each
compound axis the training step communicates over. `make_mesh` lays ranks
out exactly as the JAX package lays devices out,
`arange(world).reshape(sizes in AXIS_ORDER)`, so rank r holds the shard that
device r holds in the JAX mesh. tp is innermost, so that on a host of
NVLink-connected cards its all-reduces stay inside one node.
"""

from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist

from .._device import resolve_device

# outer-to-inner order: tp innermost (all-reduce every layer) rides the
# fastest links; ep's all-to-all pair next; pp outermost, with dp just
# inside it (the JAX package's order)
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")
DATA_AXES = ("dp", "fsdp", "ep", "sp")  # the axes that split the tokens
# the compound axes the training step communicates over, besides each axis:
# the batch split of the expert dispatch, the batch axes of the tokens, and
# the axes a gradient is summed over (parallel/sharding.py:grad_axes)
COMPOUND_AXES = (("dp", "fsdp"), ("dp", "fsdp", "ep"), DATA_AXES,
                 ("dp", "ep", "sp"), ("dp", "sp"))


def mesh_shape_for(n_devices: int, tp: int = 1, sp: int = 1, fsdp: int | None = None,
                   dp: int | None = None, pp: int = 1, ep: int = 1) -> dict[str, int]:
    """Fill in unspecified axes to cover n_devices: fsdp absorbs what dp
    doesn't claim."""
    fixed = tp * sp * pp * ep
    rest = n_devices // fixed
    if rest * fixed != n_devices:
        raise ValueError(
            f"pp*ep*sp*tp={fixed} does not divide {n_devices} devices")
    if dp is None and fsdp is None:
        dp, fsdp = 1, rest
    elif dp is None:
        dp = rest // fsdp
    elif fsdp is None:
        fsdp = rest // dp
    if dp * fsdp * fixed != n_devices:
        raise ValueError(
            f"pp*dp*fsdp*ep*sp*tp = {pp}*{dp}*{fsdp}*{ep}*{sp}*{tp}"
            f" != {n_devices} devices")
    return {"pp": pp, "dp": dp, "fsdp": fsdp, "ep": ep, "sp": sp, "tp": tp}


def _check_axes(shape: dict[str, int]) -> None:
    unknown = set(shape) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}")


def rank_grid(shape: dict[str, int], world: int) -> np.ndarray:
    """The ranks of `make_mesh`: arange(world).reshape(sizes in AXIS_ORDER),
    the JAX package's device grid with ranks for devices."""
    _check_axes(shape)
    sizes = [shape.get(a, 1) for a in AXIS_ORDER]
    want = math.prod(sizes)
    if want > world:
        raise ValueError(f"mesh {shape} wants {want} devices, have {world}")
    return np.arange(want).reshape(sizes)


def hybrid_rank_grid(ici_shape: dict[str, int], dcn_shape: dict[str, int] | None,
                     world: int, ranks_per_node: int) -> np.ndarray:
    """The ranks of `make_hybrid_mesh`: ranks [g r, (g + 1) r) form node g
    (r = ranks_per_node, the granule), the `ici_shape` axes stay inside a
    node and the `dcn_shape` axes cross nodes. Each axis's index is
    dcn_index * ici_size + ici_index, as jax's create_hybrid_device_mesh
    blocks its per-granule meshes; inside a node ranks go in order (the
    cards of an NVLink node reach each other alike)."""
    dcn_shape = dcn_shape or {}
    overlap = set(ici_shape) & set(dcn_shape)
    if overlap:
        raise ValueError(f"axes {sorted(overlap)} listed in both tiers")
    _check_axes({**ici_shape, **dcn_shape})
    ici = [ici_shape.get(a, 1) for a in AXIS_ORDER]
    dcn = [dcn_shape.get(a, 1) for a in AXIS_ORDER]
    if world % ranks_per_node:
        raise ValueError(f"{world} ranks do not fill nodes of {ranks_per_node}")
    n_nodes = world // ranks_per_node
    if math.prod(dcn) != n_nodes:
        raise ValueError(f"number of nodes {n_nodes} must equal the product of "
                         f"dcn_shape {dcn_shape}")
    if math.prod(ici) != ranks_per_node:
        raise ValueError(f"each node holds {ranks_per_node} ranks, ici_shape "
                         f"{ici_shape} wants {math.prod(ici)}")
    nodes = np.arange(n_nodes).reshape(dcn)
    blocks = np.empty(dcn, dtype=object)
    for idx in np.ndindex(*dcn):
        blocks[idx] = (nodes[idx] * ranks_per_node
                       + np.arange(ranks_per_node).reshape(ici))
    return np.block(blocks.tolist())


class Axis:
    """One (possibly compound) mesh axis as this rank sees it: the global
    ranks of its group in index order (`ranks`), this rank's `index` among
    them, and the process group (None where the axis has size 1). `perm[i]`
    is the group rank of ranks[i]: torch orders a group by global rank, a
    hybrid grid's compound axis need not."""

    def __init__(self, ranks: list[int], rank: int, group=None):
        self.ranks = ranks
        self.size = len(ranks)
        self.index = ranks.index(rank)
        self.group = group
        order = sorted(ranks)
        self.perm = [order.index(r) for r in ranks]


class Mesh:
    """A grid of ranks with AXIS_ORDER's names; `shape` maps every axis to
    its size. `axis(axes)` gives an `Axis` for one name or a tuple of names
    (a compound axis, major to minor). Built by `make_mesh` or
    `make_hybrid_mesh`, by every rank of the process group, in one order.
    Without a process group, `Mesh(grid, device, rank)` is rank's view of
    the layout alone (its shards, no collectives)."""

    def __init__(self, grid: np.ndarray, device, rank: int | None = None):
        self.grid = grid
        self.shape = dict(zip(AXIS_ORDER, grid.shape))
        self.device = device
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        self.rank = rank
        if not (grid == self.rank).any():
            raise ValueError(f"rank {self.rank} is not in the mesh {self.shape}")
        self._axes: dict[tuple, Axis] = {}
        self._groups: dict[tuple, object] = {}  # sorted ranks -> group
        for axes in [(a,) for a in AXIS_ORDER] + list(COMPOUND_AXES):
            self._make_axis(axes)

    def _group_ranks(self, axes: tuple, fixed: dict) -> list[int]:
        """The ranks that share `fixed` coordinates on the other axes, in
        the index order of `axes`."""
        moved = self.grid.transpose(
            [AXIS_ORDER.index(a) for a in AXIS_ORDER if a not in axes]
            + [AXIS_ORDER.index(a) for a in axes])
        lead = tuple(fixed[a] for a in AXIS_ORDER if a not in axes)
        return [int(r) for r in moved[lead].reshape(-1)]

    def _make_axis(self, axes: tuple) -> None:
        size = math.prod(self.shape[a] for a in axes)
        if size == 1:
            self._axes[axes] = Axis([self.rank], self.rank)
            return
        # every rank creates every group of this axis, in one order, as
        # torch.distributed.new_group requires; it keeps its own
        others = [a for a in AXIS_ORDER if a not in axes]
        mine = None
        for lead in np.ndindex(*(self.shape[a] for a in others)):
            ranks = self._group_ranks(axes, dict(zip(others, lead)))
            key = tuple(sorted(ranks))
            if key not in self._groups and dist.is_initialized():
                # a compound axis over one split axis reuses that axis's group
                self._groups[key] = dist.new_group(ranks=list(key))
            group = self._groups.get(key)
            if self.rank in ranks:
                mine = Axis(ranks, self.rank, group)
        self._axes[axes] = mine

    def axis(self, axes) -> Axis:
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self._axes:
            raise ValueError(f"the mesh has no group for axes {key}; it builds "
                             f"{list(self._axes)}")
        return self._axes[key]

    def size(self, axes) -> int:
        return self.axis(axes).size

    def index(self, axes) -> int:
        return self.axis(axes).index


def one_device_mesh(device="cuda") -> Mesh:
    """The mesh of one device, whatever process group is initialised."""
    return Mesh(rank_grid({}, 1), resolve_device(device), rank=0)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: dict[str, int] | None = None, device="cuda", **axes) -> Mesh:
    """Build a Mesh over the initialised process group (or this process
    alone, when none is initialised and every axis is 1). `shape` maps axis
    name -> size in AXIS_ORDER; axes not named get size 1. With no shape,
    fsdp takes every rank (`mesh_shape_for`). The mesh must cover the
    world exactly: every rank holds a place in it."""
    if shape is None:
        shape = axes or None
    world = _world()
    if shape is None:
        shape = mesh_shape_for(world)
    grid = rank_grid(shape, world)
    if grid.size != world:
        raise ValueError(f"mesh {shape} covers {grid.size} ranks, the world has "
                         f"{world}")
    return Mesh(grid, resolve_device(device))


def make_hybrid_mesh(ici_shape: dict[str, int],
                     dcn_shape: dict[str, int] | None = None,
                     ranks_per_node: int | None = None, device="cuda") -> Mesh:
    """Multi-node mesh split across the two interconnect tiers: `ici_shape`
    axes stay inside one node (NVLink: tp/sp/fsdp), `dcn_shape` axes cross
    nodes (InfiniBand: pp/dp), as the JAX package splits ICI from DCN. A
    node is `ranks_per_node` consecutive ranks (default: every rank, one
    node); every node must hold exactly prod(ici_shape) ranks, and the node
    count must equal prod(dcn_shape)."""
    world = _world()
    grid = hybrid_rank_grid(ici_shape, dcn_shape, world, ranks_per_node or world)
    return Mesh(grid, resolve_device(device))
