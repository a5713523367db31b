"""The PyTorch port on the card: the CUDA kernels behind `flash_attention`
and its gradient, their refusals, the tiny model and train step on CUDA
against the same on the CPU, and the MoE FFN at Mixtral-8x7B width. Every test needs an NVIDIA GPU and skips
without one.

This file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import ctypes
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from yoda_scheduler_tpu_torch.models import (LlamaConfig, init_llama, llama_forward,
                                             llama_loss)
from yoda_scheduler_tpu_torch.models import moe
from yoda_scheduler_tpu_torch.ops import _build
from yoda_scheduler_tpu_torch.ops import attention as attn
from yoda_scheduler_tpu_torch.ops.variants import BWD_TILE_REL_L2, tile_rel_l2
from yoda_scheduler_tpu_torch.parallel import (build_llama_train_step, init_opt_state,
                                               param_leaves)

generate_mod = importlib.import_module("yoda_scheduler_tpu_torch.models.generate")

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(gpu, dtype, b, h, kvh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(gpu, dtype) for s in shapes]


# bf16: about one bf16 ulp of O at |O| < 4 (the plain version rounds its
# probabilities, the kernel its output); fp32: summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


SHAPES = [
    ((1, 4, 4, 128, 128, 64), True, None),
    ((2, 4, 2, 100, 100, 128), True, None),
    ((1, 2, 2, 64, 200, 32), True, 48),
    ((1, 2, 1, 70, 130, 64), False, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,causal,window", SHAPES)
def test_flash_attention_launches_the_kernel(gpu, dtype, shape, causal, window):
    q, k, v = _qkv(gpu, dtype, *shape)
    before = attn.flash_fwd.launches
    o, lse = attn.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches == before + 1
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,causal,window", SHAPES)
def test_gradients_through_the_kernels_equal_the_plain_backward(
        gpu, dtype, shape, causal, window):
    """A loss of both outputs: each backward launches each kernel once, and
    the gradients are the plain backward's (whose P and dS are rounded
    where the kernels round them, so the tolerance is the forward's)."""
    q, k, v = (t.requires_grad_(True) for t in _qkv(gpu, dtype, *shape))
    rng = np.random.default_rng(5)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(gpu, dtype)
    g_lse = torch.from_numpy(rng.standard_normal(q.shape[:3], dtype=np.float32)).to(gpu)
    o, lse = attn.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    before = (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches)
    ((o.float() * do.float()).sum() + (lse * g_lse).sum()).backward()
    torch.cuda.synchronize()
    assert (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = attn.flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                         o.detach(), lse.detach(), do, causal,
                                         window, g_lse)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_backward_kernels_are_bit_repeatable(gpu):
    q, k, v = _qkv(gpu, torch.bfloat16, 2, 4, 2, 100, 100, 128)
    do = _qkv(gpu, torch.bfloat16, 2, 4, 2, 100, 100, 128, seed=1)[0]
    o, lse = attn.flash_fwd(q, k, v)
    delta = attn.backward_delta(o, do).contiguous()
    runs = [(attn.flash_bwd_dq(q, k, v, do, lse, delta),
             *attn.flash_bwd_dkv(q, k, v, do, lse, delta)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# the Hopper primitives (csrc/hopper.cuh), one tile each, through
# csrc/hopper_check.cu: run these first after a change to them
def _hopper_lib():
    (lib,) = _build.load("hopper_check")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hopper_tma_tile.argtypes = [p] + [i64] * 7 + [i32] * 5 + [p, p]
    lib.hopper_wgmma_ss.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs.argtypes = [p, p, p, p]
    lib.hopper_wgmma_ss64.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs64.argtypes = [p, p, p, p]
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _swizzled(tile):
    """A [rows, 64] bf16 tile as TMA's 128-byte swizzle lays it out: the
    16-byte chunk c of row r at chunk c ^ (r % 8)."""
    rows = tile.shape[0]
    chunks = tile.view(rows, 8, 8)
    out = torch.empty_like(chunks)
    for r in range(rows):
        out[r, torch.arange(8) ^ (r % 8)] = chunks[r]
    return out.view(rows, 64)


@pytest.mark.parametrize("layout,c0,row0,rows", [
    ("bhsd", 0, 0, 128), ("bhsd", 64, 64, 128), ("bhsd", 0, 240, 64),
    ("bshd", 64, 200, 128)])
def test_tma_tile_is_the_swizzled_slice(gpu, layout, c0, row0, rows):
    """One box of a 4-D map, rows past the sequence (300) zero-filled, from a
    contiguous [B, H, S, D] tensor or the model's transposed [B, S, H, D]
    view."""
    b, h, s, d = 2, 3, 300, 128
    x = torch.randn(b, s, h, d, generator=torch.Generator(gpu).manual_seed(0),
                    device=gpu).to(torch.bfloat16)
    x = x.transpose(1, 2) if layout == "bshd" else x.transpose(1, 2).contiguous()
    out = torch.empty(rows, 64, dtype=torch.bfloat16, device=gpu)
    bi, hi = 1, 2
    st = x.stride()
    err = _hopper_lib().hopper_tma_tile(
        x.data_ptr(), d, s, h, b, st[2], st[1], st[0], c0, row0, hi, bi, rows,
        out.data_ptr(), _stream())
    assert err == 0
    torch.cuda.synchronize()
    want = torch.zeros(rows, 64, dtype=torch.bfloat16, device=gpu)
    part = x[bi, hi, row0:row0 + rows, c0:c0 + 64]
    want[:part.shape[0]] = part
    assert torch.equal(out.view(torch.int16), _swizzled(want).view(torch.int16))


@pytest.mark.parametrize("a_row0", [0, 64])
def test_wgmma_ss_tile_is_a_matmul(gpu, a_row0):
    gen = torch.Generator(gpu).manual_seed(1)
    a, bm = (torch.randn(128, 128, generator=gen, device=gpu).to(torch.bfloat16)
             for _ in range(2))
    out = torch.empty(64, 128, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss(a.data_ptr(), bm.data_ptr(), a_row0,
                                         out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    want = a[a_row0:a_row0 + 64].float() @ bm.float().T
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-4)


def test_wgmma_rs_tile_is_a_matmul(gpu):
    gen = torch.Generator(gpu).manual_seed(2)
    p = torch.rand(64, 128, generator=gen, device=gpu).to(torch.bfloat16)
    v = torch.randn(128, 128, generator=gen, device=gpu).to(torch.bfloat16)
    out = torch.empty(64, 128, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs(p.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("a_row0", [0, 64])
def test_wgmma_ss64_tile_is_a_matmul(gpu, a_row0):
    """m64n64k16 with A from a 128-row tile and B a 64-row tile, both
    K-major: flash_bwd.cu's S^T = K Q^T and S = Q K^T."""
    gen = torch.Generator(gpu).manual_seed(3)
    a = torch.randn(128, 128, generator=gen, device=gpu).to(torch.bfloat16)
    bm = torch.randn(64, 128, generator=gen, device=gpu).to(torch.bfloat16)
    out = torch.empty(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss64(a.data_ptr(), bm.data_ptr(), a_row0,
                                           out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    want = a[a_row0:a_row0 + 64].float() @ bm.float().T
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-4)


def test_wgmma_rs64_tile_is_a_matmul(gpu):
    """m64n128k16 with A from registers and B a 64-row MN-major tile
    (halves 8 KB apart): flash_bwd.cu's P^T dO, dS^T Q and dS K."""
    gen = torch.Generator(gpu).manual_seed(4)
    p = torch.rand(64, 64, generator=gen, device=gpu).to(torch.bfloat16)
    v = torch.randn(64, 128, generator=gen, device=gpu).to(torch.bfloat16)
    out = torch.empty(64, 128, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs64(p.data_ptr(), v.data_ptr(), out.data_ptr(),
                                           _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-4)


# (b, h, kvh, sq, sk), causal, window: shapes that reach each path of the
# wgmma kernels (diagonal, ragged tails, cross length, window start, GQA)
WGMMA_SHAPES = {
    "s128": ((1, 2, 2, 128, 128), True, None),
    "s2048": ((1, 4, 4, 2048, 2048), True, None),
    "ragged_300": ((2, 4, 4, 300, 300), True, None),
    "cross_256x1024": ((1, 4, 4, 256, 1024), True, None),
    "window_512": ((1, 2, 2, 2048, 2048), True, 512),
    "gqa_32_8": ((1, 32, 8, 512, 512), True, None),
    "gqa_32_8_s2048": ((1, 32, 8, 2048, 2048), True, None),  # Mixtral-8x7B attention
    "non_causal": ((1, 4, 2, 320, 448), False, None),
}


@pytest.mark.parametrize("case", list(WGMMA_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_route_matches_the_plain_version(gpu, case, layout):
    (b, h, kvh, sq, sk), causal, window = WGMMA_SHAPES[case]
    q, k, v = _qkv(gpu, torch.bfloat16, b, h, kvh, sq, sk, 128)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert attn._route(q, k, v) == "wgmma"
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)


def test_wgmma_route_matches_the_mma_route(gpu):
    q, k, v = _qkv(gpu, torch.bfloat16, 1, 8, 4, 1024, 1024, 128, seed=2)
    o1, l1 = attn.flash_fwd(q, k, v, route="mma")
    o2, l2 = attn.flash_fwd(q, k, v, route="wgmma")
    torch.cuda.synchronize()
    torch.testing.assert_close(o2.float(), o1.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)


def _bwd_inputs(gpu, case, layout, seed=0):
    """q, k, v, dO of a WGMMA_SHAPES case in `layout`, with the forward's O
    and LSE, a random LSE cotangent and delta."""
    (b, h, kvh, sq, sk), causal, window = WGMMA_SHAPES[case]
    q, k, v = _qkv(gpu, torch.bfloat16, b, h, kvh, sq, sk, 128, seed=seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(gpu, q.dtype)
    g_lse = torch.from_numpy(rng.standard_normal(q.shape[:3], dtype=np.float32)).to(gpu)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v, do))
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    delta = attn.backward_delta(o, do, g_lse).contiguous()
    return (q, k, v, do, lse, delta, causal, window), (o, g_lse)


def _bwd_kernels(args, route):
    kvh = args[1].shape[1]
    dk, dv = attn.flash_bwd_dkv(*args, route=route)
    return attn.flash_bwd_dq(*args, route=route), attn.group_sum(dk, kvh), attn.group_sum(dv, kvh)


@pytest.mark.parametrize("case", list(WGMMA_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_backward_routes_match_the_plain_backward(gpu, case, layout):
    """Elementwise as the forward, and each output by its worst 64-row tile
    (`tile_rel_l2`), which holds the small dK and dV of late keys to their
    own size."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout)
    q, k, v, do, lse, _, causal, window = args
    assert attn._route(q, k, v, do) == "wgmma"
    before = [fn.launches_by_route["wgmma"] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)] == [
        n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


def test_wgmma_backward_routes_match_the_mma_route(gpu):
    args, _ = _bwd_inputs(gpu, "gqa_32_8", "bhsd", seed=2)
    for g, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma")):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", ["ragged_300", "window_512"])
def test_wgmma_backward_routes_are_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd")
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.bfloat16, 96)])
def test_kernel_refuses_what_it_does_not_take(gpu, dtype, d):
    q, k, v = _qkv(gpu, dtype, 1, 2, 2, 32, 32, d)
    with pytest.raises(ValueError, match="flash_fwd takes"):
        attn.flash_attention(q, k, v)
    lse = torch.zeros(q.shape[:3], device=gpu)
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        with pytest.raises(ValueError, match=f"{fn.__name__} takes"):
            fn(q, k, v, q, lse, lse)


@pytest.fixture
def tiny_f32(gpu):
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype="float32")
    params = init_llama(cfg, seed=0, device=gpu)
    cpu = {"embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
           "lm_head": params["lm_head"].cpu(),
           "layers": [{n: t.cpu() for n, t in layer.items()}
                      for layer in params["layers"]]}
    return cfg, params, cpu


def test_tiny_forward_on_cuda_matches_cpu(gpu, tiny_f32):
    cfg, params, cpu = tiny_f32
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 96)))
    before = attn.flash_fwd.launches
    got = llama_forward(params, tokens.to(gpu), cfg)
    assert attn.flash_fwd.launches == before + cfg.n_layers
    want = llama_forward(cpu, tokens, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


def test_tiny_gradient_on_cuda_matches_cpu(gpu, tiny_f32):
    """The fp32 loss gradient through the kernels (with remat) against the
    plain attention's on the CPU, every leaf: summation order only."""
    cfg, params, cpu = tiny_f32
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64)))
    grads = []
    for p, toks in ((params, tokens.to(gpu)), (cpu, tokens)):
        leaves = param_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        llama_loss(p, toks, cfg, remat=True).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_tiny_train_step_on_cuda_matches_cpu(gpu, tiny_f32):
    """Three fp32 steps from the same weights: the kernels and the fused
    AdamW on the card against the plain attention and AdamW on the CPU.
    Adam moves each element by about the learning rate whatever its
    gradient's size, so an element whose gradient is near zero may move
    the other way on the other device: the weights agree to 1e-5 but for
    such rare elements, which stay within one learning rate."""
    cfg, params, cpu = tiny_f32
    lr = 3e-4
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64)))
    _, step_gpu, _ = build_llama_train_step(cfg, learning_rate=lr, device=gpu)
    _, step_cpu, _ = build_llama_train_step(cfg, learning_rate=lr, device="cpu")
    opt_gpu, opt_cpu = init_opt_state(params, lr), init_opt_state(cpu, lr)
    before = attn.flash_bwd_dq.launches
    for _ in range(3):
        params, opt_gpu, loss_gpu = step_gpu(params, opt_gpu, tokens.to(gpu))
        cpu, opt_cpu, loss_cpu = step_cpu(cpu, opt_cpu, tokens)
        assert float(loss_gpu) == pytest.approx(float(loss_cpu), rel=1e-5)
    assert attn.flash_bwd_dq.launches == before + 3 * cfg.n_layers
    for got, want in zip(param_leaves(params), param_leaves(cpu)):
        diff = (got.detach().cpu() - want.detach()).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3
        assert float(diff.max()) < lr


def test_greedy_tokens_on_cuda_equal_cpu(gpu, tiny_f32):
    cfg, params, cpu = tiny_f32
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)))
    got = generate_mod.generate(params, prompt.to(gpu), cfg, 8)
    want = generate_mod.generate(cpu, prompt, cfg, 8)
    assert torch.equal(got.cpu(), want)


# ----------------------------------------------------------------- MoE FFN
@pytest.fixture
def mixtral_ffn(gpu):
    """One MoE FFN layer at Mixtral-8x7B's widths (d 4096, f 14336, 8
    experts, top-2), bf16 weights from a seed, and bf16 x [1, 2048, d]: on
    the card, and as fp32 copies of the same values on the CPU."""
    gen = torch.Generator(device=gpu).manual_seed(0)
    layer = moe.init_moe_layer(4096, 14336, 8, torch.bfloat16, gen, gpu)
    x = torch.randn((1, 2048, 4096), generator=gen, device=gpu).to(torch.bfloat16)
    cpu = {n: t.cpu().float() for n, t in layer.items()}
    return layer, x, cpu, x.cpu().float()


def test_mixtral_moe_ffn_on_cuda_matches_cpu_fp32(gpu, mixtral_ffn):
    """The card's bf16 MoE FFN against the same function in fp32 on the CPU
    from the same values. The router's product is true fp32 on both (TF32
    off), so the routing is equal; gate and up are fp32 sums of exact
    products on both. The card rounds the SwiGLU product, the down product
    and y to bf16, three roundings of 2^-9 relative: rel. L2 within 1e-2."""
    layer, x, cpu, x_cpu = mixtral_ffn
    with chip_smoke.recording_routes(moe) as routes, torch.no_grad():
        y, aux = moe.moe_ffn(x, layer, 8, 2, 1.25)
        y_cpu, aux_cpu = moe.moe_ffn(x_cpu, cpu, 8, 2, 1.25)
    (e_gpu, d_gpu), (e_cpu, d_cpu) = routes
    assert torch.equal(e_gpu.cpu(), e_cpu) and torch.equal(d_gpu.cpu(), d_cpu)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    rel = float((y.cpu().float() - y_cpu).norm() / y_cpu.norm())
    assert rel < 1e-2, rel
    assert float(aux) == pytest.approx(float(aux_cpu), rel=1e-5)


def test_mixtral_moe_ffn_gradient_is_bit_repeatable(gpu, mixtral_ffn):
    """Dispatch and combine differentiate by gathers, so two backward
    passes give equal bits."""
    layer, x, _, _ = mixtral_ffn
    w = torch.randn(x.shape, generator=torch.Generator(device=gpu).manual_seed(1),
                    device=gpu).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [x.detach().requires_grad_(True)] + [
            t.detach().requires_grad_(True) for t in layer.values()]
        y, aux = moe.moe_ffn(leaves[0], dict(zip(layer, leaves[1:])), 8, 2, 1.25)
        ((y.float() * w.float()).sum() + aux).backward()
        runs.append([t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", [0, 1])
def test_bmm_fp32_cotangent_is_the_fp32_product(gpu, side):
    """The MoE expert backward's products of the fp32 cotangent g [E, C, f]
    and bf16 operands at Mixtral's widths (8 experts, 648 slots, d 4096, f
    14336), on the tensor cores from a bf16 high part and the bf16 rounding
    of the rest (`moe.cotangent_products`: g @ we^T and x^T @ g), against the
    same products in fp64: the split leaves g to about 2^-16 relative, so
    rel. L2 within 1e-4 (the fp32 sums add ~1e-6). Rounding g to bf16 first,
    as the port did before, reads ~2^-9: the bound tells the two apart."""
    gen = torch.Generator(device=gpu).manual_seed(3)
    g = torch.randn((8, 648, 14336), generator=gen, device=gpu)
    x = torch.randn((8, 648, 4096), generator=gen, device=gpu).to(torch.bfloat16)
    we = torch.randn((8, 4096, 14336), generator=gen, device=gpu).to(torch.bfloat16)
    got = moe.cotangent_products(g, x, we)[side]
    pair = [(g, we.transpose(1, 2)), (x.transpose(1, 2), g)][side]
    want = torch.bmm(*(t.double() for t in pair))
    rounded = torch.bmm(*(t.to(torch.bfloat16) for t in pair), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.is_contiguous()

    def rel(y):
        return float((y.double() - want).norm() / want.norm())

    assert rel(got) < 1e-4, rel(got)
    assert rel(rounded) > 1e-3


# -------------------------------------------------- sharded step and ring
def test_ring_on_cuda_matches_the_plain_attention(gpu):
    """Ring attention over sp=4 through the one-process rotation, bf16, S=512
    in chunks of 128, GQA 8/2: 10 launches of each kernel on the wgmma route
    (4 diagonal and 6 full chunks; the 6 future ones launch nothing);
    output and gradients against the plain attention over the whole
    sequence by the worst 64-row tile (phase 3's bound)."""
    from yoda_scheduler_tpu_torch.parallel import ring

    q, k, v = _qkv(gpu, torch.bfloat16, 1, 8, 2, 512, 512, 128, seed=5)
    do = _qkv(gpu, torch.bfloat16, 1, 8, 2, 512, 512, 128, seed=6)[0]
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        attn._reset_counts(fn)
    out = ring.ring_attention_emulated(*leaves, sp=4)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        assert fn.launches_by_route == {"simt": 0, "mma": 0, "wgmma": 10}, fn.__name__
    o, lse = attn.reference_attention_with_lse(q.detach(), k.detach(), v.detach())
    want = (o, *attn.flash_backward_reference(q.detach(), k.detach(), v.detach(), o,
                                              lse, do))
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert tile_rel_l2(got.detach(), ref) <= BWD_TILE_REL_L2, name


def test_world1_nccl_sharded_step_is_the_one_device_step(gpu, tiny_f32):
    """The tiny fp32 step through a world-1 NCCL mesh (every axis 1, an
    in-process store) against the one-device step from the same weights:
    every collective is skipped, so the losses and weights are equal."""
    import torch.distributed as dist

    from yoda_scheduler_tpu_torch.parallel import make_mesh, shard_params

    cfg, params, _ = tiny_f32
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 64))).to(gpu)
    one = {"embed": params["embed"].clone(), "final_norm": params["final_norm"].clone(),
           "lm_head": params["lm_head"].clone(),
           "layers": [{n: t.clone() for n, t in layer.items()}
                      for layer in params["layers"]]}
    _, step_one, _ = build_llama_train_step(cfg, device=gpu)
    opt_one = init_opt_state(one)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh({"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}, device="cuda")
        _, step_mesh, batch_fn = build_llama_train_step(cfg, mesh)
        sharded = shard_params(params, mesh, cfg)
        opt_mesh = init_opt_state(sharded)
        for _ in range(2):
            sharded, opt_mesh, loss_mesh = step_mesh(sharded, opt_mesh, batch_fn(tokens))
            one, opt_one, loss_one = step_one(one, opt_one, tokens)
            assert torch.equal(loss_mesh, loss_one)
    finally:
        dist.destroy_process_group()
    for a, b in zip(param_leaves(sharded), param_leaves(one)):
        assert torch.equal(a, b)
