"""ICI torus topology model: slice shapes, sub-block enumeration, bin-packing.

This is new TPU-native capability with no counterpart in the GPU reference
(its cards are an unordered list, reference pkg/yoda/filter/filter.go:22).
TPU chips within a pod slice form an ICI torus (v4: 3-D, e.g. a v4-32 slice
is 2x2x4 chips over 4 hosts); XLA collectives ride ICI only between chips
that are torus neighbours, so placement quality = does a job get an
*axis-aligned contiguous sub-block* of the torus, and does packing leave the
remaining free chips in large contiguous blocks for future jobs.

Pure functions over coordinate sets — trivially unit-testable, no k8s types.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations, product

Coord = tuple[int, int, int]
Shape = tuple[int, int, int]


def parse_topology(spec: str) -> Shape:
    """'2x2x4' -> (2, 2, 4); '2x2' -> (2, 2, 1); '4' -> (4, 1, 1)."""
    parts = [p.strip() for p in spec.lower().split("x") if p.strip()]
    if not parts or len(parts) > 3:
        raise ValueError(f"bad topology spec: {spec!r}")
    dims = [int(p) for p in parts]
    if any(d <= 0 for d in dims):
        raise ValueError(f"bad topology spec: {spec!r}")
    while len(dims) < 3:
        dims.append(1)
    return tuple(dims)  # type: ignore[return-value]


def format_topology(shape: Shape) -> str:
    return "x".join(str(d) for d in shape)


def chips_in(shape: Shape) -> int:
    x, y, z = shape
    return x * y * z


def all_coords(shape: Shape) -> list[Coord]:
    return list(product(range(shape[0]), range(shape[1]), range(shape[2])))


def host_blocks(slice_shape: Shape, host_shape: Shape = (2, 2, 1)) -> list[list[Coord]]:
    """Partition a slice torus into per-host chip blocks (v4 boards hold a
    2x2x1 block of 4 chips). Host order follows z-major placement, matching
    how Cloud TPU assigns workers along the slice."""
    hx, hy, hz = host_shape
    sx, sy, sz = slice_shape
    if sx % hx or sy % hy or sz % hz:
        raise ValueError(f"slice {slice_shape} not divisible by host block {host_shape}")
    blocks: list[list[Coord]] = []
    for bz in range(sz // hz):
        for by in range(sy // hy):
            for bx in range(sx // hx):
                blocks.append(
                    [
                        (bx * hx + dx, by * hy + dy, bz * hz + dz)
                        for dz in range(hz)
                        for dy in range(hy)
                        for dx in range(hx)
                    ]
                )
    return blocks


@lru_cache(maxsize=None)
def _factor_shapes(n: int) -> tuple[Shape, ...]:
    """All (x, y, z) with x*y*z == n — candidate block shapes for n chips."""
    out = []
    for x in range(1, n + 1):
        if n % x:
            continue
        rem = n // x
        for y in range(1, rem + 1):
            if rem % y:
                continue
            out.append((x, y, rem // y))
    return tuple(out)


@lru_cache(maxsize=8192)
def enumerate_subblocks(shape: Shape, n_chips: int) -> tuple[tuple[Coord, Shape], ...]:
    """All axis-aligned sub-blocks of exactly `n_chips` chips inside `shape`,
    as (origin, block_shape) pairs. Small closed world (slices are tiny:
    <=4096 chips, jobs request small factors), so brute force is fine and
    exact — no heuristics to go wrong. Cached: the scheduler asks for the
    same (shape, n) thousands of times per burst."""
    out: list[tuple[Coord, Shape]] = []
    sx, sy, sz = shape
    for bx, by, bz in _factor_shapes(n_chips):
        if bx > sx or by > sy or bz > sz:
            continue
        for ox in range(sx - bx + 1):
            for oy in range(sy - by + 1):
                for oz in range(sz - bz + 1):
                    out.append(((ox, oy, oz), (bx, by, bz)))
    return tuple(out)


@lru_cache(maxsize=65536)
def _block_coords(origin: Coord, block: Shape) -> frozenset[Coord]:
    ox, oy, oz = origin
    bx, by, bz = block
    return frozenset(
        (ox + dx, oy + dy, oz + dz)
        for dx in range(bx)
        for dy in range(by)
        for dz in range(bz)
    )


def _compactness(block: Shape) -> int:
    """Prefer cube-ish blocks — lower is better. For fixed volume, the sum of
    dimensions is minimised by the most cube-like factorization, which has the
    shortest ICI diameter (a 2x2x2 beats an 8x1x1 for the same 8 chips)."""
    bx, by, bz = block
    return bx + by + bz


def _best_placement(
    slice_shape: Shape,
    free: frozenset[Coord],
    candidate_shapes: tuple[Shape, ...],
) -> tuple[Coord, Shape, frozenset[Coord]] | None:
    """Shared placement search (pure, uncached — the public entry points
    below carry the cache): try every candidate block shape at every origin;
    keep the placement that (1) minimises leftover fragmentation, (2)
    prefers compact shapes (short ICI diameter), (3) carves from the low
    corner. Returns (origin, block_shape, coords) or None."""
    sx, sy, sz = slice_shape
    best: tuple[tuple, Coord, Shape, set[Coord]] | None = None
    for block in candidate_shapes:
        bx, by, bz = block
        if bx > sx or by > sy or bz > sz:
            continue
        for ox in range(sx - bx + 1):
            for oy in range(sy - by + 1):
                for oz in range(sz - bz + 1):
                    coords = _block_coords((ox, oy, oz), block)
                    if not coords <= free:
                        continue
                    frag = fragmentation_after(slice_shape, frozenset(free - coords))
                    key = (frag, _compactness(block), oz, oy, ox)
                    if best is None or key < best[0]:
                        best = (key, (ox, oy, oz), block, coords)
    if best is None:
        return None
    return best[1], best[2], best[3]


@lru_cache(maxsize=131072)
def _best_fit_cached(slice_shape: Shape, free: frozenset[Coord], n_chips: int):
    if _native_on():
        from . import native

        out = native.best_fit_block(slice_shape, free, n_chips)
        if out is not NotImplemented:
            return out
    return _best_placement(slice_shape, free, _factor_shapes(n_chips))


def best_fit_block(
    slice_shape: Shape,
    free: set[Coord],
    n_chips: int,
) -> tuple[Coord, Shape, frozenset[Coord]] | None:
    """Best contiguous block of exactly `n_chips` free chips, any shape
    whose volume is n_chips. Uses the native engine when built
    (native/placement.cc), pure Python otherwise — identical results."""
    return _best_fit_cached(slice_shape, frozenset(free), n_chips)


@lru_cache(maxsize=131072)
def _fits_shape_cached(slice_shape: Shape, free: frozenset[Coord], req_shape: Shape):
    if _native_on():
        from . import native

        out = native.fits_shape(slice_shape, free, req_shape)
        if out is not NotImplemented:
            return out
    return _best_placement(slice_shape, free,
                           tuple(sorted(set(permutations(req_shape)))))


def fits_shape(slice_shape: Shape, free: set[Coord], req_shape: Shape) -> tuple[Coord, Shape, frozenset[Coord]] | None:
    """Place an exact requested block shape (any axis permutation) into free
    space. Used for the ``tpu/topology`` label."""
    return _fits_shape_cached(slice_shape, frozenset(free), req_shape)


@lru_cache(maxsize=1)
def _native_on() -> bool:
    try:
        from . import native

        return native.available()
    except Exception:
        return False


def largest_free_block(shape: Shape, free: set[Coord]) -> int:
    """Size of the largest axis-aligned sub-block fully inside `free`."""
    return _largest_free_block(shape, frozenset(free))


@lru_cache(maxsize=131072)
def _largest_free_block(shape: Shape, free: frozenset[Coord]) -> int:
    if _native_on():
        from . import native

        out = native.largest_free_block(shape, free)
        if out is not NotImplemented:
            return out
    if not free:
        return 0
    best = 1
    max_n = len(free)
    # check decreasing sizes; early-out at first found
    for n in range(max_n, 0, -1):
        if n <= best:
            break
        for origin, block in enumerate_subblocks(shape, n):
            if _block_coords(origin, block) <= free:
                best = n
                break
    return best


def fragmentation_after(shape: Shape, free: set[Coord]) -> float:
    """0 = perfectly contiguous free space, 1 = fully fragmented.
    Defined as 1 - largest_free_block / |free| (0 when nothing free)."""
    if not free:
        return 0.0
    return 1.0 - largest_free_block(shape, frozenset(free)) / len(free)


@lru_cache(maxsize=131072)
def _contiguity_cached(shape: Shape, free: frozenset[Coord], n_chips: int) -> float:
    fit = _best_fit_cached(shape, free, n_chips)
    if fit is None:
        return 0.0
    _, _, coords = fit
    frag = fragmentation_after(shape, free - coords)
    return 100.0 * (1.0 - frag)


def contiguity_score(shape: Shape, free: set[Coord], n_chips: int) -> float:
    """How well can a `n_chips` job land contiguously in `free`? 0..100.

    100: an exact-fit contiguous block exists and taking the best one leaves
    zero extra fragmentation. Decreases with induced fragmentation; 0 when no
    contiguous block exists (job would span non-adjacent chips — XLA
    collectives would hop through occupied chips' links).
    """
    return _contiguity_cached(shape, frozenset(free), n_chips)
