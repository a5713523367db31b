"""The route sweep (yoda_scheduler_tpu_torch/tools/tune_attention.py), the
twin of the JAX package's tools/tune_attention.py, and the one copy of the
kernels' bounds (ops/bounds.py) it shares with chip_smoke.py.

On the CPU: its arguments, the reference's shape rule and FLOP formula,
the bounds at the main shape, its refusal without CUDA, and its control
flow with the kernels' plain versions standing in for the kernels (every
candidate checked before any is timed; a wrong one stops the sweep). One
test runs the sweep on the card. This file imports no JAX:

    python -m pytest tests/test_torch_tune.py -q --noconftest
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from yoda_scheduler_tpu_torch.ops import attention as attn
from yoda_scheduler_tpu_torch.ops import bounds, variants
from yoda_scheduler_tpu_torch.tools import tune_attention as tune

ROOT = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16


# ------------------------------------------------------------ arguments
def test_defaults_are_the_references():
    args = tune.parse_args([])
    assert (args.bwd, args.seqs, args.routes, args.repeats) == (
        False, [2048, 4096, 8192], ["wgmma", "mma", "simt"], 3)


def test_arguments_parse():
    args = tune.parse_args(["--bwd", "--seqs", "256,512", "--routes", "mma", "--repeats",
                            "1"])
    assert (args.bwd, args.seqs, args.routes, args.repeats) == (True, [256, 512], ["mma"], 1)


@pytest.mark.parametrize("argv", [["--routes", "wgmma,tpu"], ["--repeats", "0"],
                                  ["--seqs", "2048,x"], ["--seqs", "0"]])
def test_bad_arguments_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        tune.parse_args(argv)
    assert e.value.code == 2


@pytest.mark.parametrize("s,b", [(1024, 8), (2048, 4), (4096, 2), (8192, 1), (16384, 1)])
def test_shape_rule(s, b):
    """B = max(1, 8192 // S) at H=16, D=128, as the reference sweeps."""
    assert tune.shape_for(s) == (b, 16, s, 128)


@pytest.mark.parametrize("s", [2048, 4096, 8192])
def test_useful_causal_flops_are_the_references(s):
    """4 S^2 D 0.5 B H (tools/tune_attention.py:77), the TF/s column's
    numerator: with B S fixed at 8192 it grows as S."""
    b, h, _, d = tune.shape_for(s)
    assert tune.causal_flops(b, h, s, d) == 4 * s * s * d * 0.5 * b * h
    assert tune.causal_flops(b, h, s, d) == 4 * 8192 * s * 128 * 0.5 * 16


# --------------------------------------------------------------- bounds
MAIN = (1, 32, 32, 2048, 2048, 128, True, None, BF16)


def test_bounds_at_the_main_shape():
    """The kernel table's bounds (PERF.md): forward 0.0348 ms, dQ 0.0521,
    dK/dV 0.0695, each bound by operations at 989 TF/s."""
    ms, by = bounds.attention_bound(*MAIN)
    assert by == "operations" and ms == pytest.approx(0.0348, abs=1e-4)
    bwd = bounds.backward_bounds(*MAIN)
    assert bwd["dq"][1] == bwd["dkv"][1] == "operations"
    assert bwd["dq"][0] == pytest.approx(0.0521, abs=1e-4)
    assert bwd["dkv"][0] == pytest.approx(0.0695, abs=1e-4)
    assert bounds.attention_bound(1, 32, 32, 8192, 8192, 128, True, None, BF16)[0] == \
        pytest.approx(0.556, abs=1e-3)


def test_forward_backward_bound_is_the_functions_operations():
    """12 D flops a visible pair (six products), not the 18 D the three
    kernels do between them: the recomputed S and dP are not counted."""
    ms, by = bounds.forward_backward_bound(*MAIN)
    pairs = bounds.visible_pairs(2048, 2048, True, None)
    assert by == "operations"
    assert ms == pytest.approx(12 * 128 * 32 * pairs / 989e12 * 1e3, rel=1e-12)
    s8k = bounds.forward_backward_bound(1, 16, 16, 8192, 8192, 128, True, None, BF16)
    assert s8k[0] == pytest.approx(0.834, abs=1e-3)


def test_small_shapes_are_bound_by_bytes():
    ms, by = bounds.attention_bound(1, 1, 1, 16, 16, 128, False, None, BF16)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 4 * 16 * 128 + 4 * 16) / 3.35e12 * 1e3)


@pytest.mark.parametrize("sq,sk,causal,window", [(8, 8, False, None), (8, 8, True, None),
                                                 (4, 8, True, None), (8, 8, True, 3)])
def test_visible_pairs_count_the_mask(sq, sk, causal, window):
    qi = torch.arange(sq)[:, None] + (sk - sq)
    ki = torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask = ki <= qi
        if window is not None:
            mask &= ki > qi - window
    assert bounds.visible_pairs(sq, sk, causal, window) == int(mask.sum())


def test_chip_smoke_uses_the_one_copy():
    for name in ("attention_bound", "backward_bounds", "visible_pairs",
                 "H100_BF16_FLOPS", "H100_HBM_BYTES"):
        assert getattr(chip_smoke, name) is getattr(bounds, name)
    assert not hasattr(chip_smoke, "_bound")


# ------------------------------------------------------- without CUDA
def test_exits_2_without_cuda():
    """One line on stderr, no traceback, nothing swept (the card is hidden
    where there is one)."""
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-m", "yoda_scheduler_tpu_torch.tools.tune_attention",
                          "--bwd"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert len(res.stderr.strip().splitlines()) == 1 and "Traceback" not in res.stderr
    assert "CUDA is not available" in res.stderr


def test_failed_check_exits_1(monkeypatch, capsys):
    def fail(*args, **kw):
        raise tune.CheckFailed("S=2048 fwd mma: disagrees with the plain version")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tune, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(tune, "sweep", fail)
    assert tune.main([]) == 1
    out = capsys.readouterr()
    assert "S=2048 fwd mma" in out.err and out.out.startswith("NVIDIA H100")


# -------------------------------------- the sweep's control flow, on the CPU
@pytest.fixture
def plain_kernels(monkeypatch):
    """The three wrappers and flash_attention replaced by their plain
    versions on CPU tensors, each route admitted as `_routes` admits it;
    CPU inputs at H=2; a host clock for time_ms, its calls recorded."""
    ref = attn.reference_attention_with_lse

    def fwd(q, k, v, causal=True, window=None, route=None):
        attn._pick_route("flash_fwd", attn._routes("flash_fwd", q, k, v), route)
        return ref(q, k, v, causal, window)

    def bwd(name, q, k, v, do, lse, delta, causal=True, window=None, route=None):
        attn._pick_route(name, attn._routes(name, q, k, v, do), route)
        return attn.flash_backward_reference(q, k, v, ref(q, k, v, causal, window)[0], lse,
                                             do, causal, window)

    monkeypatch.setattr(attn, "flash_fwd", fwd)
    monkeypatch.setattr(attn, "flash_bwd_dq", lambda *a, **kw: bwd("flash_bwd_dq", *a, **kw)[0])
    monkeypatch.setattr(attn, "flash_bwd_dkv",
                        lambda *a, **kw: bwd("flash_bwd_dkv", *a, **kw)[1:])
    monkeypatch.setattr(attn, "flash_attention", lambda q, k, v, causal=True: ref(q, k, v)[0])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(tune, "shape_for", lambda s: (1, 2, s, 128))

    def inputs(s, bwd_):
        gen = torch.Generator().manual_seed(s)
        return [torch.randn((1, 2, s, 128), generator=gen).to(BF16)
                for _ in range(4 if bwd_ else 3)]

    monkeypatch.setattr(tune, "make_inputs", inputs)
    timed = []

    def time_ms(fn, iters=50):
        fn()
        timed.append(iters)
        return 1.0

    monkeypatch.setattr(variants, "time_ms", time_ms)
    return timed


@pytest.mark.parametrize("bwd", [False, True])
def test_sweep_checks_then_times_every_candidate(plain_kernels, bwd):
    rows = tune.sweep([32, 64], bwd=bwd, repeats=2)
    names = (["wgmma", "mma", "simt", "autograd", "sdpa", "plain"] if bwd
             else ["wgmma", "mma", "simt", "sdpa", "plain"])
    assert [(r["s"], r["candidate"]) for r in rows] == [(s, n) for s in (32, 64)
                                                       for n in names]
    assert all(r["ok"] for r in rows)
    for r in rows:
        assert r["direction"] == ("fwd+bwd" if bwd else "fwd")
        assert r["spread_ms"] == [1.0, 1.0] and r["ms"] == 1.0
        assert r["share_of_bound"] == r["bound_ms"] / r["ms"]
        if bwd and r["candidate"] in ("wgmma", "mma", "simt"):
            assert {"dq_ms", "dkv_ms", "dq_bound_ms", "dkv_bound_ms"} <= set(r)
        if bwd and r["candidate"] in ("autograd", "sdpa"):
            assert "backward_ms" in r and r["worst_tile"] <= variants.BWD_TILE_REL_L2
    # per S: one sizing launch a reading, then 2 rounds of A, ..., A
    readings = sum(len(tune.backward_candidates(*tune.make_inputs(8, True), tune.ROUTES)
                       [n][1]) for n in names) if bwd else len(names)
    assert len(plain_kernels) == 2 * readings * (1 + 2 * 2)


def test_routes_narrow_the_sweep(plain_kernels):
    rows = tune.sweep([32], routes=["mma"], bwd=False, repeats=1)
    assert [r["candidate"] for r in rows] == ["mma", "sdpa", "plain"]


@pytest.mark.parametrize("bwd", [False, True])
def test_a_wrong_route_stops_the_sweep_before_any_timing(plain_kernels, monkeypatch, bwd):
    """The mma route planted non-causal at the second S: the sweep names it
    and times nothing, not even the first S."""
    fwd = attn.flash_fwd

    def wrong(q, k, v, causal=True, window=None, route=None):
        return fwd(q, k, v, causal and not (route == "mma" and q.shape[2] == 64), window,
                   route)

    monkeypatch.setattr(attn, "flash_fwd", wrong)
    with pytest.raises(tune.CheckFailed, match="S=64 .* mma"):
        tune.sweep([32, 64], bwd=bwd, repeats=1)
    assert plain_kernels == []


def test_a_wrong_backward_kernel_stops_the_sweep(plain_kernels, monkeypatch):
    """dK/dV on the simt route scaled by 1.05: within neither bound."""
    dkv = attn.flash_bwd_dkv

    def wrong(*a, route=None, **kw):
        dk, dv = dkv(*a, route=route, **kw)
        return (dk * 1.05, dv) if route == "simt" else (dk, dv)

    monkeypatch.setattr(attn, "flash_bwd_dkv", wrong)
    with pytest.raises(tune.CheckFailed, match="S=32 fwd\\+bwd simt"):
        tune.sweep([32], bwd=True, repeats=1)


def test_forward_check_catches_a_missed_v_tile_that_allclose_lets_through():
    """The last 64 rows at S=4096 skip the first 64 keys' V (a missed P V
    tile): every element stays within 2e-2 of the plain O, since |O| is
    near sqrt(e / 4096) there, but its tiles read far above the bound; the
    sound O (P rounded to bf16, then O) passes."""
    gen = torch.Generator().manual_seed(4096)
    q, k, v = (torch.randn((1, 1, 4096, 128), generator=gen).to(BF16) for _ in range(3))
    ref = attn.reference_attention_with_lse(q, k, v, True)
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / 128 ** 0.5
                      + torch.full((4096, 4096), float("-inf")).triu(1), dim=-1)
    assert tune._fwd_check((p.to(BF16).float() @ v.float()).to(BF16), ref[1], ref)["ok"]
    p[..., -64:, :64] = 0
    wrong = (p.to(BF16).float() @ v.float()).to(BF16)
    assert torch.allclose(wrong.float(), ref[0].float(), atol=2e-2, rtol=2e-2)
    got = tune._fwd_check(wrong, ref[1], ref)
    assert not got["ok"] and got["tile_rel_l2_o"] > 5 * tune.FWD_TILE_REL_L2


# -------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sweep_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for bwd in (False, True):
        rows = tune.sweep([256], bwd=bwd, repeats=1)
        assert {r["candidate"] for r in rows} >= {"wgmma", "mma", "simt", "sdpa", "plain"}
        assert all(r["ok"] and r["ms"] > 0 for r in rows)
