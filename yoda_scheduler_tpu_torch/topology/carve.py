"""Geometric torus carving over the HOST grid of a pod slice.

torus.py models chips within one host's view of a slice; this module
models the slice's *hosts* as a 2-D/3-D torus with wraparound links and
carves gang demand as contiguous axis-aligned host blocks. A v4 slice of
8x8x1 chips is a 4x4x1 grid of 4-chip hosts; a gang of 8 members wants 8
of those hosts as one block so its collectives ride ICI, not DCN.

Three planes compute the same carve — scalar Python (the reference),
numpy (window-sum feasibility over all origins at once), and the native
kernel (native/carveplane.cc via topology/carvenative.py) — op-for-op
bit-identical, the placement.cc discipline (parity fuzz in
tests/test_torus_carve.py). The fallback chain is native <- numpy <-
scalar; every plane scores candidate blocks by the SAME all-integer key:

  (-bisection_links, exposed_free_surface, compactness, bz, by, bx,
   oz, oy, ox)

maximising the carved block's ICI bisection bandwidth first (a full-ring
carve keeps its wraparound links and doubles the cut), then nestling the
block against occupied/boundary cells (the corner heuristic: minimal
free surface left exposed keeps the REMAINING free space consolidated),
then preferring cube-ish shapes and the low corner. The key totally
orders candidates, so the minimum is unique and iteration order cannot
matter — that is what makes three independent implementations provably
identical rather than accidentally so.

Wraparound: a torus axis has distinct wrap links only when its extent is
>= 3 (at extent 2 the wrap link coincides with the direct link, at 1
there is no link), so ``wrap_of`` derives per-axis wrap from the grid.
Pure integer functions over coordinate sets, lru-cached like torus.py.
"""

from __future__ import annotations

from functools import lru_cache

from .torus import Shape, chips_in, _factor_shapes

Coord = tuple[int, int, int]
Wrap = tuple[bool, bool, bool]

try:
    import numpy as np
except Exception:  # pragma: no cover - numpy-less install
    np = None


def host_grid(slice_shape: Shape, host_block: Shape) -> Shape:
    """The slice's host-grid shape: chips per axis over the host block's
    contribution per axis (host_blocks tiles exactly this grid)."""
    sx, sy, sz = slice_shape
    hx, hy, hz = host_block
    if sx % hx or sy % hy or sz % hz:
        raise ValueError(
            f"slice {slice_shape} not divisible by host block {host_block}")
    return (sx // hx, sy // hy, sz // hz)


def host_coord(index: int, grid: Shape) -> Coord:
    """Host index -> host-grid coordinate. Inverse of the host_blocks
    enumeration order (bz outer, by, bx inner), which is also the order
    make_slice assigns host_index in."""
    gx, gy, _ = grid
    return (index % gx, (index // gx) % gy, index // (gx * gy))


def wrap_of(grid: Shape) -> Wrap:
    """Per-axis wraparound: distinct wrap links exist only at extent >= 3."""
    return (grid[0] >= 3, grid[1] >= 3, grid[2] >= 3)


def bisection_links(block: Shape, grid: Shape, wrap: Wrap) -> int:
    """ICI links crossing the carved block's narrowest bisection: cutting
    perpendicular to axis a severs volume/block[a] host-to-host links,
    doubled when the block spans axis a's full wrapped ring (its wrap
    links are then internal and cross the same cut). 0 for a single
    host — no internal links to bisect."""
    vol = chips_in(block)
    best = 0
    for a in range(3):
        if block[a] <= 1:
            continue
        cross = vol // block[a]
        if wrap[a] and block[a] == grid[a]:
            cross *= 2
        if best == 0 or cross < best:
            best = cross
    return best


def bisection_gbps(block: Shape, grid: Shape, wrap: Wrap,
                   ici_gbps: float) -> float:
    """The carved block's bisection bandwidth in GB/s: links times the
    generation's per-link ICI rate (what the MLPerf-style all-reduce
    actually rides)."""
    return bisection_links(block, grid, wrap) * float(ici_gbps)


@lru_cache(maxsize=65536)
def _block_coords(origin: Coord, block: Shape, grid: Shape) -> frozenset:
    """Block cells with per-axis modular wrap (identity when the origin
    range already keeps the block in-grid)."""
    ox, oy, oz = origin
    bx, by, bz = block
    gx, gy, gz = grid
    return frozenset(
        ((ox + dx) % gx, (oy + dy) % gy, (oz + dz) % gz)
        for dx in range(bx) for dy in range(by) for dz in range(bz))


def _origins(dim: int, b: int, wrapped: bool) -> range:
    """Candidate origins along one axis: a full-span block is one
    placement; a wrapped axis admits every origin (blocks may cross the
    seam); a flat axis admits only in-bounds origins."""
    if b == dim:
        return range(1)
    if wrapped:
        return range(dim)
    return range(dim - b + 1)


def _exposure(grid: Shape, free: frozenset, origin: Coord, block: Shape,
              wrap: Wrap, coords: frozenset) -> int:
    """Free cells adjacent to the block's faces, outside the block —
    wrap-aware (a full-span axis has no outside along it; a flat axis's
    out-of-grid side exposes nothing). The corner heuristic minimises
    this: a carve hugging occupied cells and boundaries leaves the
    remaining free space in one large region instead of splitting it."""
    gx, gy, gz = grid
    dims = (gx, gy, gz)
    exp = 0
    for (x, y, z) in coords:
        for a, d in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
            n = [x, y, z]
            n[a] += d
            if wrap[a]:
                n[a] %= dims[a]
            elif not 0 <= n[a] < dims[a]:
                continue
            nc = (n[0], n[1], n[2])
            if nc in coords:
                continue
            if nc in free:
                exp += 1
    return exp


def _key(grid: Shape, free: frozenset, origin: Coord, block: Shape,
         wrap: Wrap, coords: frozenset) -> tuple:
    ox, oy, oz = origin
    bx, by, bz = block
    return (-bisection_links(block, grid, wrap),
            _exposure(grid, free, origin, block, wrap, coords),
            bx + by + bz, bz, by, bx, oz, oy, ox)


def _carve_scalar(grid: Shape, free: frozenset, n_hosts: int,
                  wrap: Wrap):
    """Reference carve: every factor shape at every admissible origin,
    unique minimum of the total-order key. Returns (origin, block,
    coords, links) or None."""
    gx, gy, gz = grid
    best = None
    for block in _factor_shapes(n_hosts):
        bx, by, bz = block
        if bx > gx or by > gy or bz > gz:
            continue
        for oz in _origins(gz, bz, wrap[2]):
            for oy in _origins(gy, by, wrap[1]):
                for ox in _origins(gx, bx, wrap[0]):
                    origin = (ox, oy, oz)
                    coords = _block_coords(origin, block, grid)
                    if not coords <= free:
                        continue
                    k = _key(grid, free, origin, block, wrap, coords)
                    if best is None or k < best[0]:
                        best = (k, origin, block, coords)
    if best is None:
        return None
    return best[1], best[2], best[3], -best[0][0]


def _carve_numpy(grid: Shape, free: frozenset, n_hosts: int, wrap: Wrap):
    """numpy twin: feasibility (the dominant subset test, |shapes| x
    |origins| of them) vectorised as wrap-aware window sums over the
    free-cell grid; the few surviving origins score through the SAME
    integer key helpers as the scalar plane, so the keys — and therefore
    the unique minimum — are identical by construction."""
    if np is None:
        return _carve_scalar(grid, free, n_hosts, wrap)
    gx, gy, gz = grid
    arr = np.zeros((gx, gy, gz), dtype=np.int32)
    for (x, y, z) in free:
        arr[x, y, z] = 1
    best = None
    for block in _factor_shapes(n_hosts):
        bx, by, bz = block
        if bx > gx or by > gy or bz > gz:
            continue
        # window[o] = free cells inside the block at origin o (wrapped
        # roll; flat axes mask out-of-bounds origins below)
        win = arr
        for axis, b in ((0, bx), (1, by), (2, bz)):
            if b > 1:
                win = sum(np.roll(win, -k, axis=axis) for k in range(b))
        feas = win == (bx * by * bz)
        for oz in _origins(gz, bz, wrap[2]):
            for oy in _origins(gy, by, wrap[1]):
                for ox in _origins(gx, bx, wrap[0]):
                    if not feas[ox, oy, oz]:
                        continue
                    origin = (ox, oy, oz)
                    coords = _block_coords(origin, block, grid)
                    k = _key(grid, free, origin, block, wrap, coords)
                    if best is None or k < best[0]:
                        best = (k, origin, block, coords)
    if best is None:
        return None
    return best[1], best[2], best[3], -best[0][0]


@lru_cache(maxsize=1)
def _native_on() -> bool:
    try:
        from . import carvenative

        return carvenative.available()
    except Exception:
        return False


@lru_cache(maxsize=131072)
def _carve_cached(grid: Shape, free: frozenset, n_hosts: int, wrap: Wrap):
    if _native_on():
        from . import carvenative

        out = carvenative.carve_block(grid, free, n_hosts, wrap)
        if out is not NotImplemented:
            return out
    if np is not None:
        return _carve_numpy(grid, free, n_hosts, wrap)
    return _carve_scalar(grid, free, n_hosts, wrap)


def carve_block(grid: Shape, free, n_hosts: int, wrap: Wrap | None = None,
                plane: str | None = None):
    """Best contiguous axis-aligned block of exactly `n_hosts` free
    hosts on the wrapped host grid, or None. Returns (origin,
    block_shape, coords, bisection_links). `plane` forces an
    implementation for the parity tests ("scalar" | "numpy" |
    "native"); None takes the native <- numpy <- scalar chain."""
    if n_hosts <= 0 or n_hosts > chips_in(grid):
        return None
    w = wrap if wrap is not None else wrap_of(grid)
    f = frozenset(free)
    if plane == "scalar":
        return _carve_scalar(grid, f, n_hosts, w)
    if plane == "numpy":
        return _carve_numpy(grid, f, n_hosts, w)
    if plane == "native":
        from . import carvenative

        return carvenative.carve_block(grid, f, n_hosts, w)
    return _carve_cached(grid, f, n_hosts, w)


@lru_cache(maxsize=131072)
def _largest_carvable(grid: Shape, free: frozenset, wrap: Wrap) -> int:
    if _native_on():
        from . import carvenative

        out = carvenative.largest_carvable(grid, free, wrap)
        if out is not NotImplemented:
            return out
    gx, gy, gz = grid
    for n in range(len(free), 0, -1):
        for block in _factor_shapes(n):
            bx, by, bz = block
            if bx > gx or by > gy or bz > gz:
                continue
            for oz in _origins(gz, bz, wrap[2]):
                for oy in _origins(gy, by, wrap[1]):
                    for ox in _origins(gx, bx, wrap[0]):
                        if _block_coords((ox, oy, oz), block, grid) <= free:
                            return n
    return 0


def largest_carvable(grid: Shape, free, wrap: Wrap | None = None) -> int:
    """Volume of the largest whole-host block carvable from `free` — the
    geometric capacity metric the FragmentationScore term, the defrag
    controller, and scale-down shape conservation all steer by."""
    w = wrap if wrap is not None else wrap_of(grid)
    return _largest_carvable(grid, frozenset(free), w)
