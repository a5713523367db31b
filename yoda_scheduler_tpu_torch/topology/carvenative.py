"""ctypes bridge to the native carve plane (native/carveplane.cc).

Same shared-loader discipline as native.py (one dlopen of
``libyodaplace.so`` serves every kernel, each binding its OWN symbol
set), plus the ABI handshake the fused/commit planes use: the library's
``yoda_carve_abi()`` must match ``_ABI`` here, so a stale .so degrades
the carve kernel only — carve.py silently falls back to its numpy or
scalar plane, never the whole process. The Python implementation in
carve.py remains the reference; results here are bit-identical
(tests/test_torus_carve.py parity fuzz).
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

from ..utils import nativeloader

# must match yoda_carve_abi() in native/carveplane.cc — a mismatch means
# the .so predates (or postdates) this bridge's argument contract
_ABI = 1

_i64 = ctypes.c_int64


@lru_cache(maxsize=1)
def _lib():
    lib = nativeloader.bind_symbols({
        "yoda_carve_abi": (_i64, None),
        "yoda_carve": (ctypes.c_int, None),
        "yoda_largest_carvable": (ctypes.c_int, None),
    })
    if lib is None or lib.yoda_carve_abi() != _ABI:
        return None
    return lib


def available() -> bool:
    return _lib() is not None and os.environ.get("YODA_NO_NATIVE") != "1"


def _pack(shape, wrap, free):
    grid = (ctypes.c_int32 * 3)(*shape)
    wrp = (ctypes.c_int32 * 3)(*(1 if w else 0 for w in wrap))
    flat = (ctypes.c_int32 * (3 * len(free)))()
    for i, (x, y, z) in enumerate(free):
        flat[3 * i], flat[3 * i + 1], flat[3 * i + 2] = x, y, z
    return grid, wrp, flat, len(free)


def _wrapped_coords(origin, block, grid):
    ox, oy, oz = origin
    bx, by, bz = block
    gx, gy, gz = grid
    return frozenset(
        ((ox + dx) % gx, (oy + dy) % gy, (oz + dz) % gz)
        for dx in range(bx) for dy in range(by) for dz in range(bz)
    )


def carve_block(shape, free, n_hosts, wrap):
    grid, wrp, flat, n = _pack(shape, wrap, free)
    origin = (ctypes.c_int32 * 3)()
    block = (ctypes.c_int32 * 3)()
    links = ctypes.c_int32()
    rc = _lib().yoda_carve(grid, wrp, flat, n, n_hosts, origin, block,
                           ctypes.byref(links))
    if rc <= 0:
        return None if rc == 0 else NotImplemented
    o, b = tuple(origin), tuple(block)
    return o, b, _wrapped_coords(o, b, shape), int(links.value)


def largest_carvable(shape, free, wrap):
    grid, wrp, flat, n = _pack(shape, wrap, free)
    rc = _lib().yoda_largest_carvable(grid, wrp, flat, n)
    return NotImplemented if rc < 0 else rc
