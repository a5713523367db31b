"""Shared hardened loader for the native library (libyodaplace.so).

Both native kernels — the torus placement engine (topology/native.py)
and the fused scheduling kernel (scheduler/nativeplane.py) — live in one
shared object but must degrade INDEPENDENTLY: an old .so built before
the fused kernel existed still serves placement, and a .so with a stale
fused-kernel ABI falls back to the numpy path without touching torus
search. So the dlopen/candidate-path logic is shared here, while symbol
resolution is per kernel: ``bind_symbols`` returns None for exactly the
kernel whose symbols are missing, never process-wide.

The library is built from the package's own sources (`native/*.cc`) by
`g++` at first use, into the gitignored `build/native/` at the repository
root, named by a hash of the sources and the flags: importing the engine
builds nothing, and an unchanged source is compiled once per checkout.
`YODA_PLACEMENT_LIB` names a library to load instead. A pure-Python install
(no g++, or a failed build) gets None everywhere and loses nothing but
speed; `build()` raises instead, for callers that must have the planes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

_LIB_NAME = "libyodaplace.so"
_ENV_PATH = "YODA_PLACEMENT_LIB"
SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_cached: dict[str, "ctypes.CDLL | None"] = {}
log = logging.getLogger("yoda-tpu")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cc"))


def _target() -> Path:
    """The library's path, named by a hash of every source and the flags."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libyodaplace-{digest.hexdigest()[:16]}.so"


def build() -> str:
    """The path of the library built from this package's sources, compiling
    it when it is missing. Raises RuntimeError when there is no C++
    compiler or the build fails, with the compiler's output."""
    target = _target()
    if target.exists():
        return str(target)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ to build the native planes")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, _sources())],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build the native planes "
                           f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent builder loads either copy
    return str(target)


def _built() -> str:
    """`build()`'s path, or "" after logging why there is none."""
    try:
        return build()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        log.warning("native planes unavailable, the numpy plane places instead: %s", e)
        return ""


def _candidates():
    """Library paths in the order to try them; the build runs only when the
    override is absent or cannot be loaded."""
    yield os.environ.get(_ENV_PATH, "")
    yield _built()
    yield os.path.join(os.path.dirname(__file__), "..", "topology", _LIB_NAME)


def load_library() -> "ctypes.CDLL | None":
    """dlopen the shared native library, trying the env override first,
    then the package's own build (compiled here on the first call).
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
