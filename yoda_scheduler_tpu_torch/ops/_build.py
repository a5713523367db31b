"""Builds the package's CUDA kernels at first use and loads them with ctypes.

Each kernel is one source under `csrc/` with a plain C entry point; the
sources share headers (`csrc/*.cuh`). It is compiled by `nvcc` for sm_90a
into a shared library under `build/kernels/` at the repository root (listed
in .gitignore), named by a hash of the source, the headers and the flags, so
an unchanged kernel is compiled once per checkout; nvcc's output (ptxas's
registers and spills) is kept beside it and read back with it. All missing
kernels of one `load` call compile in parallel, one `nvcc` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of its nvcc (None if built before this
# process), "log": nvcc's output (ptxas -v)}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared header
    under csrc/ (a kernel includes them) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load(*names: str) -> list[ctypes.CDLL]:
    """The loaded libraries of the named kernels, compiling the missing ones
    in parallel. Raises RuntimeError with nvcc's output if a build fails."""
    with _lock:
        todo = {n: _target(n) for n in names if n not in _libs}
        missing = {n: t for n, t in todo.items()
                   if not (t.exists() and t.with_suffix(".log").exists())}
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for n, target in missing.items():
                tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True),
                            tmp, time.perf_counter())
            failed = []
            for n, (proc, tmp, t0) in procs.items():
                log, _ = proc.communicate()
                build_info[n] = {"seconds": time.perf_counter() - t0, "log": log}
                if proc.returncode:
                    failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
                else:
                    missing[n].with_suffix(".log").write_text(log)
                    os.replace(tmp, missing[n])
            if failed:
                raise RuntimeError("\n".join(failed))
        for n, target in todo.items():
            build_info.setdefault(n, {"seconds": None,
                                      "log": target.with_suffix(".log").read_text()})
            _libs[n] = ctypes.CDLL(str(target))
        return [_libs[n] for n in names]
