"""Shared hardened loader for the native library (libyodaplace.so).

Both native kernels — the torus placement engine (topology/native.py)
and the fused scheduling kernel (scheduler/nativeplane.py) — live in one
shared object but must degrade INDEPENDENTLY: an old .so built before
the fused kernel existed still serves placement, and a .so with a stale
fused-kernel ABI falls back to the numpy path without touching torus
search. So the dlopen/candidate-path logic is shared here, while symbol
resolution is per kernel: ``bind_symbols`` returns None for exactly the
kernel whose symbols are missing, never process-wide.

No build-time dependency: ``make native`` produces the library; a
pure-Python install (no g++) simply gets None everywhere and loses
nothing but speed.
"""

from __future__ import annotations

import ctypes
import os
import threading

_LIB_NAME = "libyodaplace.so"
_ENV_PATH = "YODA_PLACEMENT_LIB"

_lock = threading.Lock()
_cached: dict[str, "ctypes.CDLL | None"] = {}


def _candidates() -> list[str]:
    here = os.path.dirname(__file__)
    return [
        os.environ.get(_ENV_PATH, ""),
        os.path.abspath(os.path.join(here, "..", "..", "native", _LIB_NAME)),
        os.path.join(here, "..", "topology", _LIB_NAME),
    ]


def load_library() -> "ctypes.CDLL | None":
    """dlopen the shared native library, trying the env override first.
    An unloadable candidate (wrong arch, truncated file) is skipped, not
    fatal — the next candidate may still work. Cached per process."""
    with _lock:
        if "lib" in _cached:
            return _cached["lib"]
        lib = None
        for c in _candidates():
            if c and os.path.exists(c):
                try:
                    lib = ctypes.CDLL(c)
                    break
                except OSError:
                    continue  # wrong arch / corrupt build: try the next
        _cached["lib"] = lib
        return lib


def bind_symbols(symbols: dict) -> "ctypes.CDLL | None":
    """Resolve one kernel's symbol set against the shared library:
    ``{name: (restype, argtypes | None)}``. Returns the library with
    those symbols configured, or None when the library is absent OR any
    symbol is missing — a per-KERNEL verdict, so a stale .so degrades
    only the kernel it predates."""
    lib = load_library()
    if lib is None:
        return None
    for name, (restype, argtypes) in symbols.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            return None  # this kernel is newer than the built library
        fn.restype = restype
        if argtypes is not None:
            fn.argtypes = argtypes
    return lib
