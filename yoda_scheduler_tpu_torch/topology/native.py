"""ctypes bridge to the native placement engine (native/placement.cc).

Loads ``libyodaplace.so`` through the shared hardened loader
(utils/nativeloader.py — one dlopen serves this kernel and the fused
scheduling kernel, each resolving its OWN symbol set so a stale library
degrades per kernel, never process-wide) and exposes drop-in twins of
the torus placement functions. torus.py routes through here
automatically when the library is available; the pure-Python
implementation remains the reference and the fallback.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

from ..utils import nativeloader


@lru_cache(maxsize=1)
def _lib():
    return nativeloader.bind_symbols({
        "yoda_best_fit": (ctypes.c_int, None),
        "yoda_fits_shape": (ctypes.c_int, None),
        "yoda_largest_free_block": (ctypes.c_int, None),
        "yoda_contiguity": (ctypes.c_double, None),
    })


def available() -> bool:
    return _lib() is not None and os.environ.get("YODA_NO_NATIVE") != "1"


def _pack(shape, free):
    grid = (ctypes.c_int32 * 3)(*shape)
    flat = (ctypes.c_int32 * (3 * len(free)))()
    for i, (x, y, z) in enumerate(free):
        flat[3 * i], flat[3 * i + 1], flat[3 * i + 2] = x, y, z
    return grid, flat, len(free)


def _coords_of(origin, block):
    ox, oy, oz = origin
    bx, by, bz = block
    return frozenset(
        (ox + dx, oy + dy, oz + dz)
        for dx in range(bx) for dy in range(by) for dz in range(bz)
    )


def best_fit_block(shape, free, n_chips):
    grid, flat, n = _pack(shape, free)
    origin = (ctypes.c_int32 * 3)()
    block = (ctypes.c_int32 * 3)()
    rc = _lib().yoda_best_fit(grid, flat, n, n_chips, origin, block)
    if rc <= 0:
        return None if rc == 0 else NotImplemented
    o, b = tuple(origin), tuple(block)
    return o, b, _coords_of(o, b)


def fits_shape(shape, free, req_shape):
    grid, flat, n = _pack(shape, free)
    req = (ctypes.c_int32 * 3)(*req_shape)
    origin = (ctypes.c_int32 * 3)()
    block = (ctypes.c_int32 * 3)()
    rc = _lib().yoda_fits_shape(grid, flat, n, req, origin, block)
    if rc <= 0:
        return None if rc == 0 else NotImplemented
    o, b = tuple(origin), tuple(block)
    return o, b, _coords_of(o, b)


def largest_free_block(shape, free):
    grid, flat, n = _pack(shape, free)
    rc = _lib().yoda_largest_free_block(grid, flat, n)
    return NotImplemented if rc < 0 else rc


def contiguity_score(shape, free, n_chips):
    grid, flat, n = _pack(shape, free)
    v = _lib().yoda_contiguity(grid, flat, n, n_chips)
    return NotImplemented if v < 0 else v
