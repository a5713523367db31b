"""Time variants of a flash kernel's source against each other on one card,
in turns (A, B, ..., B, A), at the main path's shapes.

    python3 -m yoda_scheduler_tpu_torch.ops.variants fwd|bwd [--probe] \\
        [--head-dim 64|80|96|100|256] [--dtype float16] [--route mma] A.cu B.cu ...

Each argument is a copy of `csrc/flash_fwd.cu` (fwd) or `csrc/flash_bwd.cu`
(bwd) with a change (an earlier commit's copy with its own headers beside
it, too), or "cur" for the package's own, built with the package's nvcc
flags into `build/variants/`; each build's nvcc seconds are printed. fwd
launches `attention.flash_fwd` on its automatic route; bwd launches
`attention.flash_bwd_dq` and `attention.flash_bwd_dkv` on theirs (wgmma at
head dims 64, 80, 96, 100, 128 and 256, in bf16 and in fp16); both first
print ptxas's registers and spills of each variant's wgmma kernels with its
performance notes. `--route mma` launches both kinds on the mma route
instead. Every launch is checked against the
plain version, elementwise and by `tile_rel_l2`; bwd also reads, for each
of dQ, dK and dV, the share of its entries that differ from the plain
version's per q head (`unequal_share`). With `--probe` each
variant runs once at the `PROBE` shapes, so that a variant that hangs or faults
can be run alone under a time limit before the timing. Each reading says
whether the variant's outputs equal the first variant's bit for bit. `--head-dim 64`
takes the shapes of `SHAPES_64` (bench_mfu's d1024 train widths first, as
the model's [B, S, H, D] views), where both backward kernels run their
head-dim-64 wgmma kernels (`flash_bwd_dq_wgmma64_kernel`,
`flash_bwd_dkv_wgmma64_kernel`); `--head-dim 96` those of `SHAPES_96`
(Phi-3-mini's attention, 32 heads of 96, as its model gives it), where the
three kernels run `flash_fwd_wgmma96_kernel`, `flash_bwd_dq_wgmma96_kernel`
and `flash_bwd_dkv_wgmma96_kernel`; `--head-dim 80` those of `SHAPES_80`
(StableLM-3B-4E1T's attention, 32 heads of 80, as its model gives it),
where they run `flash_fwd_wgmma80_kernel`, `flash_bwd_dq_wgmma80_kernel`
and `flash_bwd_dkv_wgmma80_kernel`; `--head-dim 100` those of `SHAPES_100`
(OpenLLaMA-3B's attention, 32 heads of 100, as its model gives it: half of
its heads' rows start 8 bytes off a 16-byte boundary), where the three
kernels run `flash_fwd_wgmma100_kernel`, `flash_bwd_dq_wgmma100_kernel` and
`flash_bwd_dkv_wgmma100_kernel`; `--head-dim 256` those of `SHAPES_256`
(Gemma-2B's attention, 8 heads of 256 over one, as its model gives it),
where the three kernels run `flash_fwd_wgmma256_kernel`,
`flash_bwd_dq_wgmma256_kernel` and `flash_bwd_dkv_wgmma256_kernel`. `--dtype float16` takes `SHAPES` in fp16 at head dim 128
(`fp16_main` first: Llama-2-7B's attention in the dtype of its published
weights), where the three kernels run `flash_fwd_wgmma_f16_kernel`,
`flash_bwd_dq_wgmma_f16_kernel` and `flash_bwd_dkv_wgmma_f16_kernel`, and
with `--head-dim 64` those of `SHAPES_F16_64` (OPT-1.3B's attention, 32
heads of 64, first), where the three kernels run
`flash_fwd_wgmma64_f16_kernel`, `flash_bwd_dq_wgmma64_f16_kernel` and
`flash_bwd_dkv_wgmma64_f16_kernel`; with `--head-dim 80` those of
`SHAPES_F16_80` (OPT-2.7B's attention, 32 heads of 80, first), where the
three kernels run `flash_fwd_wgmma80_f16_kernel`,
`flash_bwd_dq_wgmma80_f16_kernel` and `flash_bwd_dkv_wgmma80_f16_kernel`, and
with
`--head-dim 100` those of `SHAPES_F16_100` (OpenLLaMA-3B's attention in
fp16 first), where the three kernels run `flash_fwd_wgmma100_f16_kernel`,
`flash_bwd_dq_wgmma100_f16_kernel` and `flash_bwd_dkv_wgmma100_f16_kernel`;
with `--head-dim 96` those of `SHAPES_F16_96` (GPT-NeoX-20B's attention, 64
heads of 96, first), where the three kernels run
`flash_fwd_wgmma96_f16_kernel`, `flash_bwd_dq_wgmma96_f16_kernel` and
`flash_bwd_dkv_wgmma96_f16_kernel`, and with `--head-dim 256` those of
`SHAPES_F16_256`
(GPT-J-6B's attention, 16 heads of 256, first), where the three kernels run
`flash_fwd_wgmma256_f16_kernel`, `flash_bwd_dq_wgmma256_f16_kernel` and
`flash_bwd_dkv_wgmma256_f16_kernel`; each launch is held to fp16's bounds,
the bf16 ones over 8 (a variant without an fp16 wgmma kernel takes `--route mma`,
which no kernel offers at head dim 100).
Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import time
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
# head dim 64: (name, b, h, kvh, sq, sk, causal, window); all in the model's
# layout, transposed views of a contiguous [B, S, H, D]
SHAPES_64 = [
    ("d1024_bshd", 8, 16, 16, 2048, 2048, True, None),
    ("gqa_d64", 1, 16, 4, 2048, 2048, True, None),
    ("window_d64", 1, 16, 16, 2048, 2048, True, 512),
    ("ragged_d64", 2, 8, 4, 300, 300, True, None),
]
# head dim 96: Phi-3-mini's attention (32 heads of 96, S=2048), as SHAPES_64
SHAPES_96 = [
    ("phi3_d96_bshd", 1, 32, 32, 2048, 2048, True, None),
    ("gqa_d96", 1, 32, 8, 2048, 2048, True, None),
    ("window_d96", 1, 32, 32, 2048, 2048, True, 512),
    ("ragged_d96", 2, 8, 4, 300, 300, True, None),
]
# head dim 80: StableLM-3B-4E1T's attention (32 heads of 80, S=2048), as SHAPES_64
SHAPES_80 = [
    ("d80_bshd", 1, 32, 32, 2048, 2048, True, None),
    ("gqa_d80", 1, 32, 8, 2048, 2048, True, None),
    ("window_d80", 1, 32, 32, 2048, 2048, True, 512),
    ("ragged_d80", 2, 8, 4, 300, 300, True, None),
]
# head dim 100: OpenLLaMA-3B's attention (32 heads of 100, S=2048), as SHAPES_64
SHAPES_100 = [
    ("d100_bshd", 1, 32, 32, 2048, 2048, True, None),
    ("gqa_d100", 1, 32, 8, 2048, 2048, True, None),
    ("window_d100", 1, 32, 32, 2048, 2048, True, 512),
    ("ragged_d100", 2, 8, 4, 300, 300, True, None),
]
# head dim 256: Gemma-2B's attention (8 heads over one KV head, S=2048) and
# Gemma-7B's (16 over 16), as SHAPES_64
SHAPES_256 = [
    ("gemma_d256", 1, 8, 1, 2048, 2048, True, None),
    ("gemma7b_d256", 1, 16, 16, 2048, 2048, True, None),
    ("window_d256", 1, 8, 1, 2048, 2048, True, 512),
    ("ragged_d256", 2, 8, 1, 300, 300, True, None),
]
SHAPES_BY_DIM = {128: SHAPES, 64: SHAPES_64, 80: SHAPES_80, 96: SHAPES_96,
                 100: SHAPES_100, 256: SHAPES_256}
# fp16 at head dim 128: SHAPES, contiguous; at 64: OPT-1.3B's attention (32
# heads of 64, S=2048) and bench_mfu's d1024 widths, as SHAPES_64
SHAPES_F16 = [(f"fp16_{name}", *shape) for name, *shape in SHAPES]
SHAPES_F16_64 = [
    ("opt13b_d64_bshd", 1, 32, 32, 2048, 2048, True, None),
    ("fp16_d1024_bshd", 8, 16, 16, 2048, 2048, True, None),
    ("fp16_window_d64", 1, 16, 16, 2048, 2048, True, 512),
    ("fp16_ragged_d64", 2, 8, 4, 300, 300, True, None),
]
# fp16 at 80: OPT-2.7B's attention (32 heads of 80, S=2048), as SHAPES_64;
# at 100: OpenLLaMA-3B's in fp16 (32 heads of 100), as SHAPES_100
SHAPES_F16_80 = [
    ("opt27b_d80_bshd", 1, 32, 32, 2048, 2048, True, None),
    ("fp16_gqa_d80", 1, 32, 8, 2048, 2048, True, None),
    ("fp16_window_d80", 1, 32, 32, 2048, 2048, True, 512),
    ("fp16_ragged_d80", 2, 8, 4, 300, 300, True, None),
]
SHAPES_F16_100 = [
    ("openllama3b_fp16_d100_bshd", 1, 32, 32, 2048, 2048, True, None),
    ("fp16_gqa_d100", 1, 32, 8, 2048, 2048, True, None),
    ("fp16_window_d100", 1, 32, 32, 2048, 2048, True, 512),
    ("fp16_ragged_d100", 2, 8, 4, 300, 300, True, None),
]
# fp16 at 96: GPT-NeoX-20B's attention (64 heads of 96, S=2048), as
# SHAPES_64; at 256: GPT-J-6B's (16 heads of 256), as SHAPES_256
SHAPES_F16_96 = [
    ("neox20b_fp16_d96_bshd", 1, 64, 64, 2048, 2048, True, None),
    ("fp16_gqa_d96", 1, 32, 8, 2048, 2048, True, None),
    ("fp16_window_d96", 1, 32, 32, 2048, 2048, True, 512),
    ("fp16_ragged_d96", 2, 8, 4, 300, 300, True, None),
]
SHAPES_F16_256 = [
    ("gptj6b_fp16_d256_bshd", 1, 16, 16, 2048, 2048, True, None),
    ("fp16_gqa_d256", 1, 16, 8, 2048, 2048, True, None),
    ("fp16_window_d256", 1, 16, 16, 2048, 2048, True, 512),
    ("fp16_ragged_d256", 2, 8, 1, 300, 300, True, None),
]
SHAPES_F16_BY_DIM = {128: SHAPES_F16, 64: SHAPES_F16_64, 80: SHAPES_F16_80,
                     100: SHAPES_F16_100, 96: SHAPES_F16_96, 256: SHAPES_F16_256}
PROBE = ("main", "window_512", "ragged_300", "d1024_bshd", "window_d64", "ragged_d64",
         "d80_bshd", "window_d80", "ragged_d80", "phi3_d96_bshd", "window_d96",
         "ragged_d96", "d100_bshd", "window_d100",
         "ragged_d100", "fp16_main", "fp16_window_512", "fp16_ragged_300", "gemma_d256",
         "window_d256", "ragged_d256", "opt13b_d64_bshd", "fp16_window_d64",
         "fp16_ragged_d64", "opt27b_d80_bshd", "fp16_window_d80", "fp16_ragged_d80",
         "openllama3b_fp16_d100_bshd", "fp16_window_d100", "fp16_ragged_d100",
         "neox20b_fp16_d96_bshd", "fp16_window_d96", "fp16_ragged_d96",
         "gptj6b_fp16_d256_bshd", "fp16_window_d256", "fp16_ragged_d256")
# the largest tile_rel_l2 of a bf16 backward output against the plain
# backward: sound kernels read below 4e-3 on an H100 (they round P and dS
# where the plain backward does, and differ in the order of fp32 sums); a
# dropped k-step, a wrong mask or wrongly staged LSE/delta on one tile reads
# several times more however small that tile's values are. The forward's O
# is held to the same bound (a missed or repeated V tile of late rows).
BWD_TILE_REL_L2 = 1e-2
# each launch's bounds against the plain version: (elementwise atol and
# rtol, tile_rel_l2); fp16 rounds one fp16 ulp deep, 8x finer than bf16
BOUNDS = {torch.bfloat16: (2e-2, BWD_TILE_REL_L2), torch.float16: (2.5e-3, BWD_TILE_REL_L2 / 8)}


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


def unequal_share(got, ref) -> float:
    """The share of `got`'s entries that differ from `ref`'s, both in one
    dtype, so that each one that differs is a unit in the last place or
    more off: small where both round the same values and differ only in
    the order of fp32 sums, near half where one rounds values the other
    does not."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise ValueError(f"{got.dtype} {tuple(got.shape)} against {ref.dtype} "
                         f"{tuple(ref.shape)}")
    return float((got != ref).float().mean())


def build_variant(variant: str) -> tuple[ctypes.CDLL, str, float]:
    """A copy of a kernel source built with the package's nvcc flags (and
    its csrc/ headers, after the headers beside it) into build/variants/:
    (library, nvcc's output, nvcc's seconds)."""
    src = Path(variant).resolve()
    out = _build.BUILD_DIR.parent / "variants" / f"{src.parent.name}_{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out)), res.stdout + res.stderr, seconds


def wgmma_ptxas(log: str) -> list[str]:
    """ptxas's lines about the wgmma kernels and its performance notes."""
    keep, kernel = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            name = re.search(r"\d(flash_\w+?_kernel)", ln)
            kernel = bool(name) and "wgmma" in name.group(1)
            if kernel:
                keep.append(name.group(1))
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


def _randn(gen, d, dtype, *shapes):
    """Normals of `shapes` ([B, H, S, D]) in `dtype`: contiguous at head dim
    128, at 64, 80, 96, 100 and 256 the model's transposed views of a
    contiguous [B, S, H, D]."""
    if d == 128:
        return [torch.randn(s, generator=gen, device="cuda").to(dtype) for s in shapes]
    return [torch.randn((b, s, h, d_), generator=gen, device="cuda").to(dtype)
            .transpose(1, 2) for b, h, s, d_ in shapes]


def _fwd_case(gen, d, dtype, route, b, h, kvh, sq, sk, causal, window):
    """-> (check, timed): check() launches once on `route` (None: the
    automatic one) and returns its readings against the plain version with
    "ok"; timed maps a name to a launch."""
    q, k, v = _randn(gen, d, dtype, (b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    tol, tile_bound = BOUNDS[dtype]

    def check():
        o, lse = attn.flash_fwd(q, k, v, causal, window, route=route)
        tile = tile_rel_l2(o, ro)
        return {"tile_rel_l2": tile, "outputs": (o, lse),
                "ok": bool(torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
                           and torch.allclose(lse, rl, atol=1e-3, rtol=1e-3))
                and tile <= tile_bound}

    return check, {"ms": lambda: attn.flash_fwd(q, k, v, causal, window, route=route)}


def _bwd_case(gen, d, dtype, route, b, h, kvh, sq, sk, causal, window):
    q, k, v, do = _randn(gen, d, dtype, (b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d),
                         (b, h, sq, d))
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    args = (q, k, v, do, lse, attn.backward_delta(o, do).contiguous(), causal, window)
    ref = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window)
    # per q head: K and V repeated to q's heads, each head's dK/dV rounded once
    heads = attn.flash_backward_reference(
        q, *(t.repeat_interleave(h // kvh, dim=1) for t in (k, v)), o, lse, do, causal,
        window)[1:]
    tol, tile_bound = BOUNDS[dtype]

    def check():
        dk, dv = attn.flash_bwd_dkv(*args, route=route)
        got = (attn.flash_bwd_dq(*args, route=route), attn.group_sum(dk, kvh),
               attn.group_sum(dv, kvh))
        tiles = {n: tile_rel_l2(g, r) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        close = all(bool(torch.allclose(g.float(), r.float(), atol=tol, rtol=tol))
                    for g, r in zip(got, ref))
        unequal = {n: unequal_share(g, r)
                for n, g, r in zip(("dq", "dk", "dv"), (got[0], dk, dv), (ref[0], *heads))}
        return {"tile_rel_l2": tiles, "allclose": close, "unequal_share": unequal,
                "outputs": got, "ok": close and max(tiles.values()) <= tile_bound}

    return check, {"dq_ms": lambda: attn.flash_bwd_dq(*args, route=route),
                   "dkv_ms": lambda: attn.flash_bwd_dkv(*args, route=route)}


# kind -> (the source's name, its entries' argtypes, attention's loader of
# the package's library, the case builder)
KINDS = {
    "fwd": ("flash_fwd", {"flash_fwd": attn._ARGTYPES}, "_flash_lib", _fwd_case),
    "bwd": ("flash_bwd", attn._BWD_ARGTYPES, "_bwd_lib", _bwd_case),
}


def _load(kind: str, variant: str) -> tuple[ctypes.CDLL, str, float | None]:
    src, argtypes, loader, _ = KINDS[kind]
    if variant == "cur":
        lib = getattr(attn, loader)()
        return lib, _build.build_info[src]["log"], _build.build_info[src]["seconds"]
    lib, log, seconds = build_variant(variant)
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib, log, seconds


def main(argv: list[str]) -> int:
    kind, argv = (argv[0], argv[1:]) if argv else (None, [])
    probe = argv[:1] == ["--probe"]
    argv = argv[1:] if probe else argv
    d, dtype, route = 128, "bfloat16", None
    if argv[:1] == ["--head-dim"]:
        d, argv = int(argv[1]), argv[2:]
    if argv[:1] == ["--dtype"]:
        dtype, argv = argv[1], argv[2:]
    if argv[:1] == ["--route"]:
        route, argv = argv[1], argv[2:]
    variants = argv
    if (kind not in KINDS or d not in SHAPES_BY_DIM or route not in (None, "mma")
            or dtype not in ("bfloat16", "float16")
            or (dtype == "float16" and d not in SHAPES_F16_BY_DIM)
            or not torch.cuda.is_available() or not variants):
        print(__doc__, file=sys.stderr)
        return 1
    _, _, loader, make_case = KINDS[kind]
    own_loader = getattr(attn, loader)
    libs = {}
    for v in variants:
        libs[v], log, seconds = _load(kind, v)
        print(json.dumps({"variant": v, "nvcc_s": seconds, "ptxas": wgmma_ptxas(log)}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = variants if probe else variants + variants[::-1]
    ok_all = True
    try:
        shapes = SHAPES_F16_BY_DIM[d] if dtype == "float16" else SHAPES_BY_DIM[d]
        for name, *shape in shapes:
            if probe and name not in PROBE:
                continue
            check, timed = make_case(gen, d, getattr(torch, dtype), route, *shape)
            row, first = {"shape": name}, None
            for var in order:
                setattr(attn, loader, lambda lib=libs[var]: lib)
                readings = check()
                torch.cuda.synchronize()
                ok_all = ok_all and readings["ok"]
                outputs = readings.pop("outputs")
                first = first or outputs
                readings["equal_to_first"] = all(
                    torch.equal(a, b) for a, b in zip(outputs, first))
                row.setdefault(var, []).append(
                    {**{n: time_ms(fn) for n, fn in timed.items()}, **readings})
            print(json.dumps(row), flush=True)
    finally:
        setattr(attn, loader, own_loader)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
