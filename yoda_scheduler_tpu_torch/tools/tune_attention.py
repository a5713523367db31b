"""Flash-attention route sweep on one NVIDIA GPU: the port's twin of the
JAX package's tools/tune_attention.py.

    python3 -m yoda_scheduler_tpu_torch.tools.tune_attention [--bwd] \\
        [--seqs 2048,4096,8192] [--routes wgmma,mma,simt] [--repeats 3]

Kept from the reference: causal attention with H=16, D=128, B = max(1,
8192 // S), bf16, [B, H, S, D]; inputs seeded per S (a `torch.Generator`
seeded with S where the reference takes `PRNGKey(S)`); the forward sweep,
and with --bwd the forward with the gradient with respect to all of q, k
and v (only then does the dK/dV kernel run); the useful causal FLOPs
4 S^2 D / 2 B H for the TF/s column, whatever the backward adds; the plain
version as the baseline.

Changed, and why:

- Routes, not blocks. The CUDA kernels pick their own tiles (the port's
  `flash_attention` only validates `block_*`), so a block sweep would time
  one kernel five times. The sweep times each route `attention._routes`
  admits of those asked for (for the backward, a route all three kernels
  take): the forward as `flash_fwd(route=...)`, the
  backward as `flash_fwd`, `backward_delta`, `flash_bwd_dq`,
  `flash_bwd_dkv` and `group_sum` on that route, each backward kernel also
  alone. The backward also times "autograd", `flash_attention` forward and
  backward as the model pays for them.
- SDPA beside the kernels, under its flash backend forced through
  `torch.nn.attention.sdpa_kernel`: a shape that backend refuses raises
  rather than timing another backend as the library's. Its backward alone
  is timed from one graph differentiated again and again, as is autograd's.
- Every candidate at every S is checked before any time is taken: the
  forward's O within 2e-2 of `reference_attention_with_lse` and by
  `variants.tile_rel_l2` <= `FWD_TILE_REL_L2`, and its LSE within 1e-3
  (atol and rtol); the backward's dQ, dK and dV against
  `flash_backward_reference` within 2e-2 and by `variants.tile_rel_l2` <=
  `variants.BWD_TILE_REL_L2`. The tile check is what holds O at long S: a
  row that sees n keys has |O| near sqrt(e / n), 0.018 at n = 8192, so
  2e-2 alone lets a missed or repeated V tile of late rows through. A failed check names the shape and candidate
  and exits 1. The reference's `kernel_time` catches every exception and
  carries on; the twin does not.
- The backward's cotangent dO is drawn from the same generator, not the
  reference's ones (the gradient of sum(O)), so that the check sees every
  column of dO.
- CUDA events, in turns: each shape's candidates run A, B, ..., B, A for
  --repeats rounds through `variants.time_ms` after a warm-up, and each row
  gives the median and the min-max spread. B S = 8192 at every S, so q, k
  and v hold 96 MiB of bf16, more than the H100's 50 MB L2 cache: a launch
  finds its inputs cold without a flush.
- Each row carries the card's bound for its work (`ops/bounds.py`) and its
  share of it.

Output: the card's name and power limit (`nvidia-smi`), then one JSON line
per (S, direction, candidate). Without CUDA it exits 2 and sweeps nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys

import torch

from ..ops import attention as attn
from ..ops import bounds, variants

H, D, TOKENS = 16, 128, 8192
ROUTES = ("wgmma", "mma", "simt")
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
FWD_TOL = {"o": 2e-2, "lse": 1e-3}
BWD_TOL = 2e-2
# O is bf16 like the backward's outputs and its sound error is the same
# rounding (of P before P V, and of O), so it is held to the same bound
FWD_TILE_REL_L2 = variants.BWD_TILE_REL_L2
# time_ms's launches a reading: enough for ~TARGET_MS of device time
TARGET_MS, MAX_ITERS = 25.0, 50


class CheckFailed(RuntimeError):
    """A candidate disagrees with the plain version."""


def shape_for(s: int) -> tuple[int, int, int, int]:
    """(B, H, S, D) at sequence length S: B S = 8192 tokens."""
    return max(1, TOKENS // s), H, s, D


def causal_flops(b: int, h: int, s: int, d: int) -> float:
    """The reference's useful causal FLOPs: the two products over half the
    scores."""
    return 4 * s * s * d * 0.5 * b * h


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m yoda_scheduler_tpu_torch.tools.tune_attention",
        description="Flash-attention route sweep on one NVIDIA GPU.")
    ap.add_argument("--bwd", action="store_true",
                    help="sweep fwd+bwd (grad wrt q/k/v) instead of fwd")
    ap.add_argument("--seqs", default="2048,4096,8192",
                    type=lambda v: [int(x) for x in v.split(",")])
    ap.add_argument("--routes", default=",".join(ROUTES),
                    type=lambda v: v.split(","))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    bad = [r for r in args.routes if r not in ROUTES]
    if bad:
        ap.error(f"unknown route(s) {bad}; known: {list(ROUTES)}")
    if args.repeats < 1 or any(s < 1 for s in args.seqs):
        ap.error("--repeats and every --seqs value must be positive")
    return args


def make_inputs(s: int, bwd: bool):
    """q, k, v (and dO for the backward) at S, bf16 on the card, from a
    generator seeded with S."""
    gen = torch.Generator(device="cuda").manual_seed(s)
    b, h, _, d = shape_for(s)
    return [torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4 if bwd else 3)]


def _sdpa(q, k, v, **kw):
    """The library's causal attention under its flash backend alone; `kw`
    goes on to the call (bench_mfu's GQA row passes enable_gqa)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                **kw)


def _grads(fn, q, k, v, do):
    """(dQ, dK, dV) of fn(q, k, v) for the cotangent dO, through autograd:
    fn's forward and its backward."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves), leaves, do)


def _backward_alone(fn, q, k, v, do):
    """A launch of fn's backward alone: one graph built once (inputs that
    require grad), differentiated again and again."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def _fwd_check(o, lse, ref):
    ro, rl = ref
    err = {"max_abs_err_o": float((o.float() - ro.float()).abs().max()),
           "tile_rel_l2_o": variants.tile_rel_l2(o, ro)}
    ok = bool(torch.isfinite(o).all()) and torch.allclose(
        o.float(), ro.float(), atol=FWD_TOL["o"], rtol=FWD_TOL["o"]) \
        and err["tile_rel_l2_o"] <= FWD_TILE_REL_L2
    if lse is not None:
        err["max_abs_err_lse"] = float((lse - rl).abs().max())
        ok = ok and torch.allclose(lse, rl, atol=FWD_TOL["lse"], rtol=FWD_TOL["lse"])
    return {**err, "ok": bool(ok)}


def _bwd_check(got, ref):
    tiles = {n: variants.tile_rel_l2(g, r) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    close = all(bool(torch.isfinite(g).all()) and torch.allclose(
        g.float(), r.float(), atol=BWD_TOL, rtol=BWD_TOL) for g, r in zip(got, ref))
    return {"tile_rel_l2": tiles, "worst_tile": max(tiles.values()), "allclose": close,
            "ok": close and max(tiles.values()) <= variants.BWD_TILE_REL_L2}


def forward_candidates(q, k, v, routes):
    """name -> (check(ref) -> readings with "ok", {reading: launch}); ref
    is (O, LSE) of the plain version."""
    def route_case(r):
        return (lambda ref: _fwd_check(*attn.flash_fwd(q, k, v, True, None, route=r), ref),
                {"ms": lambda: attn.flash_fwd(q, k, v, True, None, route=r)})

    cands = {r: route_case(r) for r in routes if r in attn._routes("flash_fwd", q, k, v)}
    cands["sdpa"] = (lambda ref: _fwd_check(_sdpa(q, k, v), None, ref),
                     {"ms": lambda: _sdpa(q, k, v)})
    cands["plain"] = (lambda ref: {"reference": True, "ok": True},
                      {"ms": lambda: attn.reference_attention_with_lse(q, k, v, True)})
    return cands


def backward_candidates(q, k, v, do, routes):
    """As forward_candidates, for the forward and the gradient with respect
    to q, k and v; ref is (O, LSE, dQ, dK, dV) of the plain version, the
    backward's from the forward kernel's own O and LSE (`_route`'s)."""
    kvh = k.shape[1]
    o, lse = attn.flash_fwd(q, k, v)
    args = (q, k, v, do, lse, attn.backward_delta(o, do).contiguous(), True, None)

    def chain(r):
        o_r, lse_r = attn.flash_fwd(q, k, v, True, None, route=r)
        delta = attn.backward_delta(o_r, do).contiguous()
        dk, dv = attn.flash_bwd_dkv(q, k, v, do, lse_r, delta, True, None, route=r)
        return (attn.flash_bwd_dq(q, k, v, do, lse_r, delta, True, None, route=r),
                attn.group_sum(dk, kvh), attn.group_sum(dv, kvh))

    def route_case(r):
        def check(ref):
            fwd = _fwd_check(*attn.flash_fwd(q, k, v, True, None, route=r), ref[:2])
            dk, dv = attn.flash_bwd_dkv(*args, route=r)
            bwd = _bwd_check((attn.flash_bwd_dq(*args, route=r), attn.group_sum(dk, kvh),
                              attn.group_sum(dv, kvh)), ref[2:])
            return {**fwd, **bwd, "ok": fwd["ok"] and bwd["ok"]}

        return check, {"ms": lambda: chain(r),
                       "dq_ms": lambda: attn.flash_bwd_dq(*args, route=r),
                       "dkv_ms": lambda: attn.flash_bwd_dkv(*args, route=r)}

    def library_case(fn):
        return (lambda ref: _bwd_check(_grads(fn, q, k, v, do), ref[2:]),
                {"ms": lambda: _grads(fn, q, k, v, do),
                 "backward_ms": _backward_alone(fn, q, k, v, do)})

    def plain():
        ro, rl = attn.reference_attention_with_lse(q, k, v, True)
        return attn.flash_backward_reference(q, k, v, ro, rl, do, True)

    # a route is a candidate where all three kernels take it
    cands = {r: route_case(r) for r in routes
             if r in attn._routes("flash_fwd", q, k, v)
             and all(r in attn._routes(n, q, k, v, do) for n in BWD_KERNELS)}
    cands["autograd"] = library_case(attn.flash_attention)
    cands["sdpa"] = library_case(_sdpa)
    cands["plain"] = (lambda ref: {"reference": True, "ok": True}, {"ms": plain})
    return cands


def reference(q, k, v, do=None):
    """The plain version's (O, LSE) and, given dO, its (dQ, dK, dV) from
    the forward kernel's O and LSE, as the backward kernels take them."""
    ro, rl = attn.reference_attention_with_lse(q, k, v, True)
    if do is None:
        return ro, rl
    o, lse = attn.flash_fwd(q, k, v)
    return (ro, rl, *attn.flash_backward_reference(q, k, v, o, lse, do, True))


def _iters(fn) -> int:
    """Launches a reading, for about TARGET_MS of device time."""
    return max(1, min(MAX_ITERS, math.ceil(TARGET_MS / variants.time_ms(fn, 1))))


def time_in_turns(cands, repeats: int) -> dict:
    """name -> {reading: [ms, ...]}: the candidates in turns A, B, ..., B,
    A, `repeats` times, each launch through variants.time_ms after a
    warm-up."""
    iters = {(n, key): _iters(fn) for n, (_, timed) in cands.items()
             for key, fn in timed.items()}
    out = {n: {key: [] for key in timed} for n, (_, timed) in cands.items()}
    names = list(cands)
    for _ in range(repeats):
        for n in names + names[::-1]:
            for key, fn in cands[n][1].items():
                out[n][key].append(variants.time_ms(fn, iters[n, key]))
    return out


def _candidates(s, routes, bwd):
    tensors = make_inputs(s, bwd)
    return tensors, (backward_candidates(*tensors, routes) if bwd
                     else forward_candidates(*tensors, routes))


def check_all(seqs, routes, bwd: bool) -> dict:
    """{S: {candidate: readings}}, every candidate at every S checked
    against the plain version; raises CheckFailed naming the first that
    disagrees."""
    out = {}
    for s in seqs:
        tensors, cands = _candidates(s, routes, bwd)
        ref = reference(*tensors)
        out[s] = {}
        for name, (check, _) in cands.items():
            readings = check(ref)
            torch.cuda.synchronize()
            out[s][name] = readings
            if not readings["ok"]:
                raise CheckFailed(
                    f"S={s} {'fwd+bwd' if bwd else 'fwd'} {name}: disagrees with "
                    f"the plain version: {readings}")
        del tensors, cands, ref
        torch.cuda.empty_cache()
    return out


def _row(s, bwd, name, readings, times) -> dict:
    b, h, _, d = shape_for(s)
    args = (b, h, h, s, s, d, True, None, torch.bfloat16)
    bound_ms, bound_by = (bounds.forward_backward_bound(*args) if bwd
                          else bounds.attention_bound(*args))
    ms = statistics.median(times["ms"])
    row = dict(s=s, b=b, h=h, d=d, direction="fwd+bwd" if bwd else "fwd", candidate=name,
               ms=ms, spread_ms=[min(times["ms"]), max(times["ms"])],
               tflops=causal_flops(b, h, s, d) / ms / 1e9, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms, **readings)
    for key, values in times.items():
        if key != "ms":
            row[key] = statistics.median(values)
            row[key.replace("_ms", "_spread_ms")] = [min(values), max(values)]
    if "dq_ms" in times:
        for kernel, (kb, by) in bounds.backward_bounds(*args).items():
            row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = kb, by
    return row


def sweep(seqs, routes=ROUTES, bwd: bool = False, repeats: int = 3, emit=None) -> list:
    """Check every candidate at every S, then time each S's candidates in
    turns: one row a (S, candidate), each passed to `emit` as it is
    timed. Raises CheckFailed before any time is taken if a check fails."""
    checked = check_all(seqs, routes, bwd)
    rows = []
    for s in seqs:
        tensors, cands = _candidates(s, routes, bwd)
        times = time_in_turns(cands, repeats)
        for name in cands:
            rows.append(_row(s, bwd, name, checked[s][name], times[name]))
            if emit is not None:
                emit(rows[-1])
        del tensors, cands
        torch.cuda.empty_cache()
    return rows


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("tune_attention: CUDA is not available; the sweep runs on an NVIDIA GPU "
              "only", file=sys.stderr)
        return 2
    print(card(), flush=True)
    try:
        sweep(args.seqs, args.routes, args.bwd, args.repeats,
              emit=lambda row: print(json.dumps(row), flush=True))
    except CheckFailed as e:
        print(f"tune_attention: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
