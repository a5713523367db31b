"""Time variants of the flash forward kernel's source against each other on
one card, in turns (A, B, ..., B, A), at the main path's shapes.

    python3 -m yoda_scheduler_tpu_torch.ops.fwd_variants [--probe] A.cu B.cu ...

Each argument is a copy of `csrc/flash_fwd.cu` with a change (or "cur" for
the package's own), built with the package's nvcc flags into
`build/variants/` and launched through `attention.flash_fwd` on its
automatic route. Every launch is checked against the plain version. With
`--probe` each variant runs once at three shapes, so that a variant that
hangs or faults can be run alone under a time limit before the timing.
Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import attention as attn

# (name, b, h, kvh, sq, sk, causal, window); head_dim 128, bf16, [B, H, S, D]
SHAPES = [
    ("main", 1, 32, 32, 2048, 2048, True, None),
    ("gqa", 1, 32, 8, 2048, 2048, True, None),
    ("cross_length", 1, 32, 32, 256, 1024, True, None),
    ("window_512", 1, 32, 32, 2048, 2048, True, 512),
    ("non_causal", 1, 32, 32, 1024, 1024, False, None),
    ("ragged_300", 2, 8, 4, 300, 300, True, None),
]
PROBE = ("main", "window_512", "ragged_300")


def _load(variant: str) -> ctypes.CDLL:
    if variant == "cur":
        return attn._flash_lib()
    src = Path(variant).resolve()
    out = _build.BUILD_DIR.parent / "variants" / f"{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.flash_fwd.argtypes = attn._ARGTYPES
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def _time_ms(fn, iters: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str]) -> int:
    probe = argv[:1] == ["--probe"]
    variants = argv[1:] if probe else argv
    if not torch.cuda.is_available() or not variants:
        print(__doc__, file=sys.stderr)
        return 1
    libs = {v: _load(v) for v in variants}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = variants if probe else variants + variants[::-1]
    ok_all = True
    for name, b, h, kvh, sq, sk, causal, window in SHAPES:
        if probe and name not in PROBE:
            continue
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((b, h, sq, 128), (b, kvh, sk, 128), (b, kvh, sk, 128)))
        ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
        row = {"shape": name}
        for var in order:
            attn._flash_lib = lambda lib=libs[var]: lib
            o, lse = attn.flash_fwd(q, k, v, causal, window)
            torch.cuda.synchronize()
            ok = bool(torch.allclose(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
                      and torch.allclose(lse, rl, atol=1e-3, rtol=1e-3))
            ok_all = ok_all and ok
            ms = _time_ms(lambda: attn.flash_fwd(q, k, v, causal, window))
            row.setdefault(var, []).append({"ms": ms, "ok": ok})
        print(json.dumps(row), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
