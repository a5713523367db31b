"""Time variants of a flash kernel's source against each other on one card,
in turns (A, B, ..., B, A), at the main path's shapes.

    python3 -m yoda_scheduler_tpu_torch.ops.variants fwd|bwd [--probe] A.cu B.cu ...

Each argument is a copy of `csrc/flash_fwd.cu` (fwd) or `csrc/flash_bwd.cu`
(bwd) with a change, or "cur" for the package's own, built with the
package's nvcc flags into `build/variants/`. fwd launches
`attention.flash_fwd` on its automatic route; bwd launches
`attention.flash_bwd_dq` and `attention.flash_bwd_dkv` on the wgmma route
and first prints ptxas's registers and spills of each variant's wgmma
kernels with its performance notes. Every launch is checked against the
plain version (the backward also by `tile_rel_l2`). With `--probe` each
variant runs once at three shapes, so that a variant that hangs or faults
can be run alone under a time limit before the timing. Prints the card's
name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import math
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
# the largest tile_rel_l2 of a bf16 backward output against the plain
# backward: sound kernels read below 4e-3 on an H100 (they round P and dS
# where the plain backward does, and differ in the order of fp32 sums); a
# dropped k-step, a wrong mask or wrongly staged LSE/delta on one tile reads
# several times more however small that tile's values are
BWD_TILE_REL_L2 = 1e-2


def tile_rel_l2(got, ref, rows: int = 64) -> float:
    """The largest relative L2 error of `got` against `ref` ([B, H, S, D])
    over the tiles of `rows` rows of one (batch, head), the tiles the
    kernels own: a wrong tile shows at its own size, however small its
    values are beside the rest. A tile whose reference is zero reads 0 if
    `got` is zero there too, else inf."""
    b, h, s, d = ref.shape
    pad = -s % rows

    def tiles(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.reshape(b, h, (s + pad) // rows, rows * d)

    err = torch.linalg.vector_norm(tiles(got) - tiles(ref), dim=-1)
    scale = torch.linalg.vector_norm(tiles(ref), dim=-1)
    return float(torch.nan_to_num(err / scale, nan=0.0, posinf=math.inf).max())


def build_variant(variant: str) -> tuple[ctypes.CDLL, str]:
    """A copy of a kernel source built with the package's nvcc flags (and
    its csrc/ headers) into build/variants/: (library, nvcc's output)."""
    src = Path(variant).resolve()
    out = _build.BUILD_DIR.parent / "variants" / f"{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out)), res.stdout + res.stderr


def wgmma_ptxas(log: str) -> list[str]:
    """ptxas's lines about the wgmma kernels and its performance notes."""
    keep, kernel = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            kernel = "wgmma_kernel" in ln
            if kernel:
                keep.append(ln.split("'")[1][-60:])
        elif kernel and ("spill" in ln or "Used" in ln):
            keep.append(ln.strip())
        elif "Performance" in ln or "C75" in ln:
            keep.append(ln.strip()[:200])
    return keep


def time_ms(fn, iters: int = 50) -> float:
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


def _randn(gen, *shapes):
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in shapes]


def _fwd_case(gen, b, h, kvh, sq, sk, causal, window):
    """-> (check, timed): check() launches once and returns its readings
    against the plain version with "ok"; timed maps a name to a launch."""
    q, k, v = _randn(gen, (b, h, sq, 128), (b, kvh, sk, 128), (b, kvh, sk, 128))
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)

    def check():
        o, lse = attn.flash_fwd(q, k, v, causal, window)
        return {"ok": bool(torch.allclose(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
                           and torch.allclose(lse, rl, atol=1e-3, rtol=1e-3))}

    return check, {"ms": lambda: attn.flash_fwd(q, k, v, causal, window)}


def _bwd_case(gen, b, h, kvh, sq, sk, causal, window):
    q, k, v, do = _randn(gen, (b, h, sq, 128), (b, kvh, sk, 128), (b, kvh, sk, 128),
                         (b, h, sq, 128))
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    args = (q, k, v, do, lse, attn.backward_delta(o, do).contiguous(), causal, window)
    ref = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window)

    def check():
        dk, dv = attn.flash_bwd_dkv(*args, route="wgmma")
        got = (attn.flash_bwd_dq(*args, route="wgmma"), attn.group_sum(dk, kvh),
               attn.group_sum(dv, kvh))
        tiles = {n: tile_rel_l2(g, r) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        close = all(bool(torch.allclose(g.float(), r.float(), atol=2e-2, rtol=2e-2))
                    for g, r in zip(got, ref))
        return {"tile_rel_l2": tiles, "allclose": close,
                "ok": close and max(tiles.values()) <= BWD_TILE_REL_L2}

    return check, {"dq_ms": lambda: attn.flash_bwd_dq(*args, route="wgmma"),
                   "dkv_ms": lambda: attn.flash_bwd_dkv(*args, route="wgmma")}


# kind -> (the source's name, its entries' argtypes, attention's loader of
# the package's library, the case builder)
KINDS = {
    "fwd": ("flash_fwd", {"flash_fwd": attn._ARGTYPES}, "_flash_lib", _fwd_case),
    "bwd": ("flash_bwd", attn._BWD_ARGTYPES, "_bwd_lib", _bwd_case),
}


def _load(kind: str, variant: str) -> tuple[ctypes.CDLL, str]:
    src, argtypes, loader, _ = KINDS[kind]
    if variant == "cur":
        return getattr(attn, loader)(), _build.build_info[src]["log"]
    lib, log = build_variant(variant)
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib, log


def main(argv: list[str]) -> int:
    kind, argv = (argv[0], argv[1:]) if argv else (None, [])
    probe = argv[:1] == ["--probe"]
    variants = argv[1:] if probe else argv
    if kind not in KINDS or not torch.cuda.is_available() or not variants:
        print(__doc__, file=sys.stderr)
        return 1
    _, _, loader, make_case = KINDS[kind]
    own_loader = getattr(attn, loader)
    libs = {}
    for v in variants:
        libs[v], log = _load(kind, v)
        if kind == "bwd":
            print(json.dumps({"variant": v, "ptxas": wgmma_ptxas(log)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = variants if probe else variants + variants[::-1]
    ok_all = True
    try:
        for name, *shape in SHAPES:
            if probe and name not in PROBE:
                continue
            check, timed = make_case(gen, *shape)
            row = {"shape": name}
            for var in order:
                setattr(attn, loader, lambda lib=libs[var]: lib)
                readings = check()
                torch.cuda.synchronize()
                ok_all = ok_all and readings["ok"]
                row.setdefault(var, []).append(
                    {**{n: time_ms(fn) for n, fn in timed.items()}, **readings})
            print(json.dumps(row), flush=True)
    finally:
        setattr(attn, loader, own_loader)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
