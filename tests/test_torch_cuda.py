"""The PyTorch port on the card: the CUDA kernels behind `flash_attention`
and its gradient, their refusals, the tiny model and train step on CUDA
against the same on the CPU, the MoE FFN at Mixtral-8x7B width, the
checkpoint, the rendezvous and the ResNet on the card. Every test needs an
NVIDIA GPU and skips without one.

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
from yoda_scheduler_tpu_torch.ops.variants import BWD_TILE_REL_L2, tile_rel_l2, unequal_share
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
# fp16: the same roundings one fp16 ulp deep (chip_smoke.TOL's fp16 bound)
TOL[torch.float16] = chip_smoke.TOL[torch.float16]["o"]


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
    lib.hopper_wgmma_rs96.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs80.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs104.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs80_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs96_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs104_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_cp_async_tile.argtypes = [p, p, i64, i32, i32, p, p, p, p]
    lib.hopper_cp_async_tile64.argtypes = [p, p, p, i64, i32, i32, i32, p, p, p, p]
    lib.hopper_wgmma_ss_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs_f16.argtypes = [p, p, p, p]
    lib.hopper_wgmma_ss64_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_ss96_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_ss80_f16.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_rs64_f16.argtypes = [p, p, p, p]
    lib.hopper_wgmma_chain64_f16.argtypes = [p, p, p, p, p]
    lib.hopper_wgmma_ss256.argtypes = [p, p, i32, p, p]
    lib.hopper_wgmma_ss256_a64.argtypes = [p, p, p, p]
    lib.hopper_wgmma_rs256.argtypes = [p, p, p, p]
    lib.hopper_wgmma_ss256_a64_f16.argtypes = [p, p, p, p]
    lib.hopper_wgmma_rs256_f16.argtypes = [p, p, p, p]
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
def test_wgmma_ss_f16_tile_is_a_matmul(gpu, a_row0):
    """The fp16 form of the SS product (the .f16 instruction over FLOAT16
    maps), as the fp16 forward's Q K^T: the operands' bits read as bf16
    would give another product."""
    gen = torch.Generator(gpu).manual_seed(11)
    a, bm = (torch.randn(128, 128, generator=gen, device=gpu).to(torch.float16)
             for _ in range(2))
    out = torch.empty(64, 128, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss_f16(a.data_ptr(), bm.data_ptr(), a_row0,
                                             out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    want = a[a_row0:a_row0 + 64].float() @ bm.float().T
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-4)


def test_wgmma_rs_f16_tile_is_a_matmul(gpu):
    """The fp16 form of the RS product, as the fp16 forward's P V."""
    gen = torch.Generator(gpu).manual_seed(12)
    p = torch.rand(64, 128, generator=gen, device=gpu).to(torch.float16)
    v = torch.randn(128, 128, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, 128, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs_f16(p.data_ptr(), v.data_ptr(), out.data_ptr(),
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


@pytest.mark.parametrize("a_row0", [0, 64])
def test_wgmma_ss64_f16_tile_is_a_matmul(gpu, a_row0):
    """The fp16 form of m64n64k16 SS over FLOAT16 maps, as the fp16 backward
    kernels' S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T."""
    gen = torch.Generator(gpu).manual_seed(13)
    a = torch.randn(128, 128, generator=gen, device=gpu).to(torch.float16)
    bm = torch.randn(64, 128, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss64_f16(a.data_ptr(), bm.data_ptr(), a_row0,
                                               out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    want = a[a_row0:a_row0 + 64].float() @ bm.float().T
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("a_row0", [0, 64])
def test_wgmma_ss96_f16_tile_is_a_matmul(gpu, a_row0):
    """The fp16 m64n64k16 SS form over rows 96 wide: A [128, 96] and B [64,
    96] each read through a 96-wide FLOAT16 map as two 64-column boxes, the
    second zero-filled past column 96, and 6 k-steps, as the fp16 D = 96
    backward kernels' S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T
    (a K or Q tile of 128 rows against a streamed tile of 64)."""
    gen = torch.Generator(gpu).manual_seed(31)
    a = torch.randn(128, 96, generator=gen, device=gpu).to(torch.float16)
    bm = torch.randn(64, 96, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss96_f16(a.data_ptr(), bm.data_ptr(), a_row0,
                                               out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    want = a[a_row0:a_row0 + 64].float() @ bm.float().T
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("a_row0", [0, 64])
def test_wgmma_ss80_f16_tile_is_a_matmul(gpu, a_row0):
    """The fp16 m64n64k16 SS form over rows 80 wide: A [128, 80] and B [64,
    80] each read through an 80-wide FLOAT16 map as two 64-column boxes, the
    second zero-filled past column 80, and 5 k-steps (the 5th over the
    second box's columns 64-79), as the fp16 D = 80 backward kernels' S^T =
    K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T (a K or Q tile of 128
    rows against a streamed tile of 64)."""
    gen = torch.Generator(gpu).manual_seed(32)
    a = torch.randn(128, 80, generator=gen, device=gpu).to(torch.float16)
    bm = torch.randn(64, 80, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss80_f16(a.data_ptr(), bm.data_ptr(), a_row0,
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


def test_wgmma_rs64_f16_tile_is_a_matmul(gpu):
    """The fp16 m64n64k16 RS form: P [64, 128] from registers times V [128,
    64], one MN-major box, as flash_fwd_wgmma64_f16_kernel's P V."""
    torch.manual_seed(11)
    p = torch.randn(64, 128, device=gpu).to(torch.float16)
    v = torch.randn(128, 64, device=gpu).to(torch.float16)
    out = torch.zeros(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs64_f16(p.data_ptr(), v.data_ptr(), out.data_ptr(),
                                               _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-3)


def test_wgmma_chain64_f16_tile_is_two_matmuls(gpu):
    """The fp16 head-dim-64 backward's chain on one warpgroup: S = A B^T by
    SS m64n64k16 (A, B [64, 64], one K-major box each), S rounded to fp16
    in registers as the RS form's A operand, times C [64, 64] (one 64-row
    MN-major box) by RS m64n64k16, as flash_bwd_dkv_wgmma64_f16_kernel's
    S^T = K Q^T, P^T and dV += P^T dO. A and B hold small integers, so S
    is exact in fp32 and in fp16, and the product differs from torch's by
    its fp32 summation order alone."""
    gen = torch.Generator(gpu).manual_seed(26)
    a, b = (torch.randint(-2, 3, (64, 64), generator=gen, device=gpu).to(torch.float16)
            for _ in range(2))
    c = torch.randn(64, 64, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_chain64_f16(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                  out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    s = (a.float() @ b.float().T).half()
    torch.testing.assert_close(out, s.float() @ c.float(), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("a_row0", [0, 64])
def test_wgmma_ss256_tile_is_a_matmul(gpu, a_row0):
    """Rows of A [128, 256] times B^T, B [64, 256], each row four 64-column
    boxes (A's 16 KB apart, B's 8 KB), 16 SS m64n64k16 k-steps, as
    flash_fwd_wgmma256_kernel's Q K^T."""
    torch.manual_seed(12)
    a = torch.randn(128, 256, device=gpu).to(torch.bfloat16)
    b = torch.randn(64, 256, device=gpu).to(torch.bfloat16)
    out = torch.zeros(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss256(a.data_ptr(), b.data_ptr(), a_row0,
                                            out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    want = a[a_row0:a_row0 + 64].float() @ b.float().T
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-3)


def test_wgmma_ss256_a64_tile_is_a_matmul(gpu):
    """A [64, 256] times B^T, B [64, 256], both four 64-row boxes 8 KB
    apart, 16 SS m64n64k16 k-steps: the head-dim-256 backward kernels' S^T =
    K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T (`scores256`)."""
    torch.manual_seed(14)
    a = torch.randn(64, 256, device=gpu).to(torch.bfloat16)
    b = torch.randn(64, 256, device=gpu).to(torch.bfloat16)
    out = torch.zeros(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss256_a64(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, a.float() @ b.float().T, atol=1e-3, rtol=1e-3)


def test_wgmma_rs256_tile_is_a_matmul(gpu):
    """P [64, 64] from registers times V [64, 256], V four 64-row MN-major
    boxes 8 KB apart read as two RS m64n128k16 products over its column
    halves, as flash_fwd_wgmma256_kernel's P V."""
    torch.manual_seed(13)
    p = torch.randn(64, 64, device=gpu).to(torch.bfloat16)
    v = torch.randn(64, 256, device=gpu).to(torch.bfloat16)
    out = torch.zeros(64, 256, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs256(p.data_ptr(), v.data_ptr(), out.data_ptr(),
                                            _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-3)


def test_wgmma_ss256_a64_f16_tile_is_a_matmul(gpu):
    """hopper_wgmma_ss256_a64 on fp16 operands (the .f16 SS m64n64k16 form
    over FLOAT16 maps): A [64, 256] times B^T, B [64, 256], both four 64-row
    boxes 8 KB apart, as the fp16 head-dim-256 backward kernels'
    `scores256`."""
    torch.manual_seed(15)
    a = torch.randn(64, 256, device=gpu).to(torch.float16)
    b = torch.randn(64, 256, device=gpu).to(torch.float16)
    out = torch.zeros(64, 64, device=gpu)
    assert _hopper_lib().hopper_wgmma_ss256_a64_f16(a.data_ptr(), b.data_ptr(),
                                                    out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, a.float() @ b.float().T, atol=1e-3, rtol=1e-3)


def test_wgmma_rs256_f16_tile_is_a_matmul(gpu):
    """hopper_wgmma_rs256 on fp16 operands (the .f16 RS m64n128k16 form over
    a FLOAT16 map): P [64, 64] from registers times V [64, 256], V four
    64-row MN-major boxes 8 KB apart read as two products over its column
    halves, as the fp16 head-dim-256 backward kernels' `sum256`."""
    torch.manual_seed(16)
    p = torch.randn(64, 64, device=gpu).to(torch.float16)
    v = torch.randn(64, 256, device=gpu).to(torch.float16)
    out = torch.zeros(64, 256, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs256_f16(p.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("rows", [64, 128])
def test_wgmma_rs96_tile_is_a_matmul(gpu, rows):
    """m64n96k16 with A from registers and B a [rows, 96] MN-major tile read
    as two 64-column boxes, the second zero-filled past column 96: the D = 96
    kernels' P V (128 rows), P^T dO and dS^T Q (64 rows)."""
    gen = torch.Generator(gpu).manual_seed(5)
    p = torch.rand(64, rows, generator=gen, device=gpu).to(torch.bfloat16)
    v = torch.randn(rows, 96, generator=gen, device=gpu).to(torch.bfloat16)
    out = torch.empty(64, 96, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs96(p.data_ptr(), v.data_ptr(), rows,
                                           out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("n", [80, 104])
def test_wgmma_rs80_and_rs104_tiles_are_matmuls(gpu, n, rows):
    """m64n80k16 and m64n104k16 with A from registers and B a [rows, n]
    MN-major tile read as two 64-column boxes, the second zero-filled past
    column n: the D = 80 forward's P V, and the D = 100 forward's (whose V
    columns 100-103 are zeros)."""
    gen = torch.Generator(gpu).manual_seed(6)
    p = torch.rand(64, rows, generator=gen, device=gpu).to(torch.bfloat16)
    v = torch.randn(rows, n, generator=gen, device=gpu).to(torch.bfloat16)
    out = torch.empty(64, n, device=gpu)
    fn = _hopper_lib().hopper_wgmma_rs80 if n == 80 else _hopper_lib().hopper_wgmma_rs104
    assert fn(p.data_ptr(), v.data_ptr(), rows, out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("n", [80, 104])
def test_wgmma_rs80_and_rs104_f16_tiles_are_matmuls(gpu, n, rows):
    """The f16 forms of m64n80k16 and m64n104k16 (A from registers, B a
    [rows, n] MN-major fp16 tile read through FLOAT16 maps as two 64-column
    boxes, the second zero-filled past column n): the fp16 D = 80 and D =
    100 forwards' P V, and the fp16 D = 80 backward's sums dV += P^T dO, dK
    += dS^T Q and dQ += dS K."""
    gen = torch.Generator(gpu).manual_seed(6)
    p = torch.rand(64, rows, generator=gen, device=gpu).to(torch.float16)
    v = torch.randn(rows, n, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, n, device=gpu)
    lib = _hopper_lib()
    fn = lib.hopper_wgmma_rs80_f16 if n == 80 else lib.hopper_wgmma_rs104_f16
    assert fn(p.data_ptr(), v.data_ptr(), rows, out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("rows", [64, 128])
def test_wgmma_rs96_f16_tile_is_a_matmul(gpu, rows):
    """The f16 form of m64n96k16 (A from registers, B a [rows, 96] MN-major
    fp16 tile read through FLOAT16 maps as two 64-column boxes, the second
    zero-filled past column 96): the fp16 D = 96 forward's P V."""
    gen = torch.Generator(gpu).manual_seed(7)
    p = torch.rand(64, rows, generator=gen, device=gpu).to(torch.float16)
    v = torch.randn(rows, 96, generator=gen, device=gpu).to(torch.float16)
    out = torch.empty(64, 96, device=gpu)
    assert _hopper_lib().hopper_wgmma_rs96_f16(p.data_ptr(), v.data_ptr(), rows,
                                               out.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, p.float() @ v.float(), atol=1e-3, rtol=1e-4)


# (rows S, row stride, offset of the base in elements, a_row0): rows of 100
# bf16 (200 bytes) as the D = 100 forward's producer copies them, with bases
# 8 bytes off a 16-byte boundary, a ragged end and a [B, S, H, 100] view's
# second head
CP_ASYNC_TILES = {
    "contiguous": (128, 100, 0, 0),
    "base_8_bytes_off": (128, 100, 4, 64),
    "ragged_100_rows": (100, 100, 0, 64),
    "bshd_head_1": (128, 3200, 100, 0),
}


@pytest.mark.parametrize("case", list(CP_ASYNC_TILES))
def test_cp_async_tile_reads_back_through_wgmma(gpu, case):
    """Two row sets A and B copied by `cp_async_rows` into the 128-wide
    swizzled layout (zeros past row S and in columns 100-127), read back
    through wgmma: A B^T over 7 SS k-steps and P B with m64n104k16, as the
    D = 100 forward's Q K^T and P V; a wrong swizzle or piece breaks both."""
    s, ss, offset, a_row0 = CP_ASYNC_TILES[case]
    gen = torch.Generator(gpu).manual_seed(7)
    flat = [torch.randn(offset + (s - 1) * ss + 100, generator=gen, device=gpu)
            .to(torch.bfloat16) for _ in range(2)]
    a, b = (x[offset:].as_strided((s, 100), (ss, 1)) for x in flat)
    assert a.data_ptr() % 8 == 0
    p = torch.rand(64, 128, generator=gen, device=gpu).to(torch.bfloat16)
    out_s = torch.empty(64, 128, device=gpu)
    out_o = torch.empty(64, 104, device=gpu)
    assert _hopper_lib().hopper_cp_async_tile(
        a.data_ptr(), b.data_ptr(), ss, s, a_row0, p.data_ptr(), out_s.data_ptr(),
        out_o.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    a128, b128 = (torch.zeros(128, 100, device=gpu) for _ in range(2))
    a128[:s], b128[:s] = a.float(), b.float()
    torch.testing.assert_close(out_s, a128[a_row0:a_row0 + 64] @ b128.T, atol=1e-3,
                               rtol=1e-4)
    torch.testing.assert_close(out_o[:, :100], p.float() @ b128, atol=1e-3, rtol=1e-4)
    assert not out_o[:, 100:].any()


# (rows S, row stride, offset of the base in elements, row0, a_row0): rows of
# 100 bf16 as the D = 100 backward kernels' producers copy them, a 128-row
# tile and two 64-row tiles in one pass (the stage's rows [row0, row0 + 64)),
# with bases 8 bytes off a 16-byte boundary, a ragged end inside the second
# stage and a [B, S, H, 100] view's second head
CP_ASYNC_TILES64 = {
    "contiguous": (128, 100, 0, 0, 0),
    "base_8_bytes_off": (128, 100, 4, 64, 64),
    "ragged_100_rows": (100, 100, 0, 64, 0),
    "bshd_head_1": (128, 3200, 100, 64, 64),
}


@pytest.mark.parametrize("case", list(CP_ASYNC_TILES64))
def test_cp_async_tile64_reads_back_through_wgmma(gpu, case):
    """Row set A copied by `cp_async_rows` into a 128-row tile and rows
    [row0, row0 + 64) of B and C into two 64-row tiles in one pass
    (`cp_async_rows<100, 64>`), zeros past row S and in columns 100-127,
    read back through the backward's products: A B^T over 7 SS m64n64k16
    k-steps and P C with m64n104k16, C a 64-row MN-major B, as the D = 100
    dK/dV kernel's S^T = K Q^T and dV += P^T dO; a wrong swizzle, half
    stride or piece breaks both."""
    s, ss, offset, row0, a_row0 = CP_ASYNC_TILES64[case]
    gen = torch.Generator(gpu).manual_seed(8)
    flat = [torch.randn(offset + (s - 1) * ss + 100, generator=gen, device=gpu)
            .to(torch.bfloat16) for _ in range(3)]
    a, b, c = (x[offset:].as_strided((s, 100), (ss, 1)) for x in flat)
    assert a.data_ptr() % 8 == 0
    p = torch.rand(64, 64, generator=gen, device=gpu).to(torch.bfloat16)
    out_s = torch.empty(64, 64, device=gpu)
    out_o = torch.empty(64, 104, device=gpu)
    assert _hopper_lib().hopper_cp_async_tile64(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), ss, s, row0, a_row0, p.data_ptr(),
        out_s.data_ptr(), out_o.data_ptr(), _stream()) == 0
    torch.cuda.synchronize()
    a128, b128, c128 = (torch.zeros(128, 100, device=gpu) for _ in range(3))
    a128[:s], b128[:s], c128[:s] = a.float(), b.float(), c.float()
    torch.testing.assert_close(out_s, a128[a_row0:a_row0 + 64] @ b128[row0:row0 + 64].T,
                               atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(out_o[:, :100], p.float() @ c128[row0:row0 + 64], atol=1e-3,
                               rtol=1e-4)
    assert not out_o[:, 100:].any()


def test_cp_async_tile64_refuses_rows_off_8_bytes(gpu):
    x = torch.zeros(2 + 128 * 102, dtype=torch.bfloat16, device=gpu)
    out = torch.empty(64, 104, device=gpu)
    lib = _hopper_lib()
    for ptr, ss in ((x[2:].data_ptr(), 100), (x.data_ptr(), 102)):
        assert lib.hopper_cp_async_tile64(x.data_ptr(), ptr, x.data_ptr(), ss, 128, 0, 0,
                                          x.data_ptr(), out.data_ptr(), out.data_ptr(),
                                          _stream()) == 1


def test_cp_async_tile_refuses_rows_off_8_bytes(gpu):
    x = torch.zeros(2 + 128 * 100, dtype=torch.bfloat16, device=gpu)
    out = torch.empty(64, 128, device=gpu)
    lib = _hopper_lib()
    for ptr, ss in ((x[2:].data_ptr(), 100), (x.data_ptr(), 102)):
        assert lib.hopper_cp_async_tile(ptr, x.data_ptr(), ss, 128, 0, x.data_ptr(),
                                        out.data_ptr(), out.data_ptr(), _stream()) == 1


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
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
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


def _bwd_inputs(gpu, case, layout, seed=0, d=128, dtype=torch.bfloat16):
    """q, k, v, dO of a WGMMA_SHAPES case (at head dim 128; WGMMA64_SHAPES
    at 64 and 32, WGMMA64_F16_SHAPES in fp16 there, WGMMA96_SHAPES at 96 and
    F16_96_256_SHAPES[96] in fp16 there, NEW_WIDTH_SHAPES at 80 and 100,
    WGMMA256_SHAPES at 256 and F16_96_256_SHAPES[256] in fp16 there) in
    `layout` and `dtype`, with the forward's O and LSE, a random LSE
    cotangent and delta."""
    shapes = {128: WGMMA_SHAPES,
              96: F16_96_256_SHAPES[96] if dtype == torch.float16 else WGMMA96_SHAPES,
              80: NEW_WIDTH_SHAPES, 100: NEW_WIDTH_SHAPES,
              256: F16_96_256_SHAPES[256] if dtype == torch.float16 else WGMMA256_SHAPES}.get(
                  d, WGMMA64_F16_SHAPES if dtype == torch.float16 else WGMMA64_SHAPES)
    (b, h, kvh, sq, sk), causal, window = shapes[case]
    q, k, v = _qkv(gpu, dtype, b, h, kvh, sq, sk, d, seed=seed)
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
    """(dQ, dK, dV), both kernels on `route` (None: `_route`'s)."""
    kvh = args[1].shape[1]
    dk, dv = attn.flash_bwd_dkv(*args, route=route)
    dq = attn.flash_bwd_dq(*args, route=route)
    return dq, attn.group_sum(dk, kvh), attn.group_sum(dv, kvh)


@pytest.mark.parametrize("case", list(WGMMA_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_backward_routes_match_the_plain_backward(gpu, case, layout):
    """Elementwise as the forward, and each output by its worst 64-row tile
    (`tile_rel_l2`), which holds the small dK and dV of late keys to their
    own size."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout)
    q, k, v, do, lse, _, causal, window = args
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
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


# the head-dim-64 wgmma kernels (flash_fwd_wgmma64_kernel,
# flash_bwd_dq_wgmma64_kernel, flash_bwd_dkv_wgmma64_kernel): bench_mfu's
# d1024 widths (16 heads of 64) and every path of their loops
WGMMA64_SHAPES = {
    "d1024_s2048": ((1, 16, 16, 2048, 2048), True, None),
    "ragged_300": ((2, 4, 4, 300, 300), True, None),
    "cross_256x1024": ((1, 4, 4, 256, 1024), True, None),
    "window_512": ((1, 2, 2, 2048, 2048), True, 512),
    "gqa_16_4": ((1, 16, 4, 1024, 1024), True, None),
    "non_causal": ((1, 4, 2, 320, 448), False, None),
}


@pytest.mark.parametrize("case", list(WGMMA64_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma64_route_matches_the_plain_version(gpu, case, layout):
    (b, h, kvh, sq, sk), causal, window = WGMMA64_SHAPES[case]
    q, k, v = _qkv(gpu, torch.bfloat16, b, h, kvh, sq, sk, 64)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= 1e-2


def test_wgmma64_route_matches_the_mma_route(gpu):
    q, k, v = _qkv(gpu, torch.bfloat16, 2, 16, 4, 1024, 1024, 64, seed=2)
    o1, l1 = attn.flash_fwd(q, k, v, route="mma")
    o2, l2 = attn.flash_fwd(q, k, v, route="wgmma")
    torch.cuda.synchronize()
    torch.testing.assert_close(o2.float(), o1.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("case", list(WGMMA64_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma64_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on wgmma, as `_route` picks them at head dim 64,
    elementwise and by each output's worst 64-row tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=64)
    q, k, v, do, lse, _, causal, window = args
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
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


def test_wgmma64_backward_matches_the_mma_route(gpu):
    args, _ = _bwd_inputs(gpu, "gqa_16_4", "bshd", seed=2, d=64)
    for g, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma")):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "d1024_s2048"])
def test_wgmma64_backward_is_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd", d=64)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# the head-dim-96 wgmma kernels (flash_fwd_wgmma96_kernel,
# flash_bwd_dq_wgmma96_kernel, flash_bwd_dkv_wgmma96_kernel): Phi-3-mini's
# attention (32 heads of 96) and every path of their loops
WGMMA96_SHAPES = {
    "phi3_s2048": ((1, 32, 32, 2048, 2048), True, None),
    "ragged_300": ((2, 4, 4, 300, 300), True, None),
    "cross_256x1024": ((1, 4, 4, 256, 1024), True, None),
    "window_512": ((1, 2, 2, 2048, 2048), True, 512),
    "gqa_32_8": ((1, 32, 8, 512, 512), True, None),
    "non_causal": ((1, 4, 2, 320, 448), False, None),
}


@pytest.mark.parametrize("case", list(WGMMA96_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma96_route_matches_the_plain_version(gpu, case, layout):
    (b, h, kvh, sq, sk), causal, window = WGMMA96_SHAPES[case]
    q, k, v = _qkv(gpu, torch.bfloat16, b, h, kvh, sq, sk, 96)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    assert o.shape == q.shape and o.is_contiguous()
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= 1e-2


def test_wgmma96_route_matches_the_mma_route(gpu):
    q, k, v = _qkv(gpu, torch.bfloat16, 1, 8, 4, 1024, 1024, 96, seed=2)
    o1, l1 = attn.flash_fwd(q, k, v, route="mma")
    o2, l2 = attn.flash_fwd(q, k, v, route="wgmma")
    torch.cuda.synchronize()
    torch.testing.assert_close(o2.float(), o1.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o2, o1) <= 1e-2


@pytest.mark.parametrize("case", list(WGMMA96_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma96_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on wgmma, as `_route` picks them at head dim 96,
    elementwise and by each output's worst 64-row tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=96)
    q, k, v, do, lse, _, causal, window = args
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
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


def test_wgmma96_dkv_matches_the_mma_route(gpu):
    args, _ = _bwd_inputs(gpu, "gqa_32_8", "bshd", seed=2, d=96)
    kvh = args[1].shape[1]
    got = attn.flash_bwd_dkv(*args, route="wgmma")
    want = attn.flash_bwd_dkv(*args, route="mma")
    for g, w in zip(got, want):
        g, w = attn.group_sum(g, kvh), attn.group_sum(w, kvh)
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "phi3_s2048"])
def test_wgmma96_dkv_is_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd", d=96)
    runs = [attn.flash_bwd_dkv(*args, route="wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wgmma96_dq_matches_the_mma_route(gpu):
    """dQ's head-dim-96 wgmma kernel against its padded mma kernel (d=96 in
    the DP=128 build) on the same inputs."""
    args, _ = _bwd_inputs(gpu, "gqa_32_8", "bshd", seed=2, d=96)
    got = attn.flash_bwd_dq(*args, route="wgmma")
    want = attn.flash_bwd_dq(*args, route="mma")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert tile_rel_l2(got, want) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "phi3_s2048"])
def test_wgmma96_dq_is_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd", d=96)
    runs = [attn.flash_bwd_dq(*args, route="wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


# the forward's wgmma kernels at head dims 80 and 100 (flash_fwd_wgmma80_kernel,
# flash_fwd_wgmma100_kernel: StableLM-3B's and OpenLLaMA-3B's attention), at
# the models' shape and every path of their loops; at 100 the model's views
# put every other head's base 8 bytes off a 16-byte boundary
NEW_WIDTH_SHAPES = {
    "s2048_32_heads": ((1, 32, 32, 2048, 2048), True, None),
    "ragged_300": ((2, 4, 4, 300, 300), True, None),
    "cross_256x1024": ((1, 4, 4, 256, 1024), True, None),
    "window_512": ((1, 2, 2, 2048, 2048), True, 512),
    "gqa_32_8": ((1, 32, 8, 512, 512), True, None),
    "non_causal": ((1, 4, 2, 320, 448), False, None),
}


@pytest.mark.parametrize("case", list(NEW_WIDTH_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d", [80, 100])
def test_wgmma_forward_at_80_and_100_matches_the_plain_version(gpu, d, case, layout):
    (b, h, kvh, sq, sk), causal, window = NEW_WIDTH_SHAPES[case]
    q, k, v = _qkv(gpu, torch.bfloat16, b, h, kvh, sq, sk, d)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    assert o.shape == q.shape and o.is_contiguous()
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= 1e-2


def test_wgmma_forward_at_100_takes_bases_8_bytes_off(gpu):
    """Tensors that start 4 elements (8 bytes) into their storage: the
    head-dim-100 forward takes them on wgmma, as the plain version."""
    flat = [t.flatten() for t in _qkv(gpu, torch.bfloat16, 1, 4, 4, 260, 260, 100)]
    q, k, v = (torch.cat([x.new_zeros(4), x])[4:].view(1, 4, 260, 100) for x in flat)
    assert q.data_ptr() % 16 == 8 and attn._route("flash_fwd", q, k, v) == "wgmma"
    o, lse = attn.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    ro, rl = attn.reference_attention_with_lse(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= 1e-2


@pytest.mark.parametrize("d,old", [(80, "mma"), (100, "simt")])
def test_wgmma_forward_at_80_and_100_matches_the_old_route(gpu, d, old):
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(gpu, torch.bfloat16, 1, 8, 4, 1024, 1024, d, seed=2))
    o1, l1 = attn.flash_fwd(q, k, v, route=old)
    o2, l2 = attn.flash_fwd(q, k, v, route="wgmma")
    torch.cuda.synchronize()
    torch.testing.assert_close(o2.float(), o1.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o2, o1) <= 1e-2


# the backward's wgmma kernels at head dim 100 (flash_bwd_dq_wgmma100_kernel,
# flash_bwd_dkv_wgmma100_kernel: OpenLLaMA-3B's attention), whose producers
# copy the rows with cp.async, at NEW_WIDTH_SHAPES: the model's shape and
# every path of their loops, contiguous and as the model's views
@pytest.mark.parametrize("case", list(NEW_WIDTH_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma100_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on wgmma, as `_route` picks them at head dim 100,
    elementwise and by each output's worst 64-row tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=100)
    q, k, v, do, lse, _, causal, window = args
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
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


def test_wgmma100_backward_takes_bases_8_bytes_off(gpu):
    """q, k, v and dO that start 4 elements (8 bytes) into their storage:
    dQ and dK/dV take them on wgmma, as the plain backward."""
    flat = [t.flatten() for t in _qkv(gpu, torch.bfloat16, 1, 4, 4, 260, 260, 100)]
    flat.append(_qkv(gpu, torch.bfloat16, 1, 4, 4, 260, 260, 100, seed=1)[0].flatten())
    q, k, v, do = (torch.cat([x.new_zeros(4), x])[4:].view(1, 4, 260, 100) for x in flat)
    assert q.data_ptr() % 16 == 8
    o, lse = attn.flash_fwd(q, k, v)
    delta = attn.backward_delta(o, do).contiguous()
    args = (q, k, v, do, lse, delta, True, None)
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    want = attn.flash_backward_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


def test_wgmma100_backward_matches_the_simt_route(gpu):
    """Both head-dim-100 wgmma kernels against the simt kernels (the route
    they took before) on the same inputs: GQA 32/8 as the model's views."""
    args, _ = _bwd_inputs(gpu, "gqa_32_8", "bshd", seed=2, d=100)
    for g, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "simt")):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "s2048_32_heads"])
def test_wgmma100_backward_is_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd", d=100)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wgmma100_backward_refuses_fp16(gpu):
    """The fp16 inputs the wgmma backward still refuses: at 80 and 96 rows
    that start 8 bytes off a 16-byte boundary, and at 100 rows that start 2
    or 4 bytes off an 8-byte boundary or whose sequence stride is no
    multiple of 4 elements. Named, the route of dQ and of dK/dV raises and
    launches nothing; csrc/'s entry, called past `_routes`, returns
    cudaErrorInvalidValue (1) for each, and launches (0) the aligned fp16
    rows at 100."""
    half = torch.float16
    flat = torch.randn(2 + 4 * 64 * 100, device=gpu).to(half)
    flat80 = torch.randn(4 + 4 * 64 * 80, device=gpu).to(half)
    flat96 = torch.randn(4 + 4 * 64 * 96, device=gpu).to(half)
    refused = [flat80[4:4 + 4 * 64 * 80].view(1, 4, 64, 80),
               flat96[4:4 + 4 * 64 * 96].view(1, 4, 64, 96)]
    refused += [flat[o:o + 4 * 64 * 100].view(1, 4, 64, 100) for o in (1, 2)]
    refused.append(torch.randn(1, 4, 64, 102, device=gpu).to(half)[..., :100])
    aligned = _qkv(gpu, half, 1, 4, 4, 64, 64, 100)[0]
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        for q in refused:
            lse = torch.zeros(q.shape[:3], device=gpu)
            assert "wgmma" not in attn._routes(fn.__name__, q, q, q, q)
            before = (fn.launches, dict(fn.launches_by_route))
            with pytest.raises(ValueError, match=f"{fn.__name__} route 'wgmma' cannot take"):
                fn(q, q, q, q, lse, lse, route="wgmma")
            assert (fn.launches, fn.launches_by_route) == before
            assert _c_entry(fn.__name__, (q,) * 4, "wgmma") == 1, (fn.__name__, q.shape)
        assert "wgmma" in attn._routes(fn.__name__, *(aligned,) * 4)
        assert _c_entry(fn.__name__, (aligned,) * 4, "wgmma") == 0
    torch.cuda.synchronize()


# the backward's wgmma kernels at head dim 80 (flash_bwd_dq_wgmma80_kernel,
# flash_bwd_dkv_wgmma80_kernel: StableLM-3B-4E1T's attention), the D = 96
# bodies at 80 with TMA-fed 160-byte rows, at NEW_WIDTH_SHAPES (the model's
# shape, GQA 32/8, window 512, ragged, cross-length and non-causal),
# contiguous and as the model's views
@pytest.mark.parametrize("case", list(NEW_WIDTH_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma80_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on wgmma, as `_route` picks them at head dim 80, one
    launch each, elementwise, by rel. L2 and by each output's worst 64-row
    tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=80)
    q, k, v, do, lse, _, causal, window = args
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
    before = [fn.launches_by_route["wgmma"] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)] == [
        n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.shape[-1] == 80
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert chip_smoke.rel_l2(g, w) <= 2e-2
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


def test_wgmma80_backward_matches_the_mma_route(gpu):
    """Both head-dim-80 wgmma kernels and the mma kernels (the route they
    took before) on the same inputs, GQA 32/8 as the model's views: each
    against the plain backward elementwise and by tile, and the two routes
    against each other by tile. Elementwise the two may stand up to twice
    the bound apart: each rounds dS to bf16 after fp32 sums in its own
    order, and the dK of key 0, a sum over every query row of 4 heads with
    much cancellation, carries the flips of both (one entry of 327680 read
    0.025 apart on an H100)."""
    args, (o, g_lse) = _bwd_inputs(gpu, "gqa_32_8", "bshd", seed=2, d=80)
    q, k, v, do, lse, _, causal, window = args
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    for g, m, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma"), want):
        for got in (g, m):
            torch.testing.assert_close(got.float(), w.float(), atol=2e-2, rtol=2e-2)
            assert tile_rel_l2(got, w) <= BWD_TILE_REL_L2
        assert tile_rel_l2(g, m) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "s2048_32_heads", "gqa_32_8",
                                  "non_causal"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma80_backward_is_bit_repeatable(gpu, case, layout):
    args, _ = _bwd_inputs(gpu, case, layout, d=80)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _c_entry(name, tensors, route, out_scale=None):
    """csrc/'s entry `name` called straight on `route` with the wrapper's
    arguments (q, k, v for the forward, q, k, v, dO and the backward's
    `out_scale` for the backward), past `_routes`: its cudaError_t."""
    q, k = tensors[0], tensors[1]
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    strides = [st for t in tensors for st in t.stride()[:3]]
    tail = (attn._KERNEL_DTYPES[q.dtype], attn._ROUTES[route], q.get_device(), b, h, kvh,
            sq, sk, d, *strides, 1, 0, 1.0 / d ** 0.5, _stream())
    lse = torch.zeros((b, h, sq), device=q.device)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if name == "flash_fwd":
        return attn._flash_lib().flash_fwd(*(t.data_ptr() for t in (*tensors, o, lse)), *tail)
    outs = (o,) if name == "flash_bwd_dq" else (o, torch.empty_like(o))
    return getattr(attn._bwd_lib(), name)(
        *(t.data_ptr() for t in (*tensors, lse, lse, *outs)),
        None if out_scale is None else out_scale.data_ptr(), *tail)


@pytest.mark.parametrize("d", [80, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_c_entries_admit_what_routes_admits_at_80_and_100(gpu, d, dtype):
    """For each kernel, every base offset (0, 1, 2 and 4 elements) and both
    layouts: csrc/'s entry takes the wgmma route (returns 0, and launches)
    exactly where `_routes` offers it, and refuses it (cudaErrorInvalidValue,
    1) elsewhere: the forward, dQ and dK/dV in bf16 and in fp16 at 80 and
    100."""
    seen = set()
    for offset in (0, 1, 2, 4):
        for layout in ("bhsd", "bshd"):
            n = 2 * 4 * 64 * d
            x = torch.randn(offset + n, device=gpu).to(dtype)[offset:]
            t = (x.view(2, 64, 4, d).transpose(1, 2) if layout == "bshd"
                 else x.view(2, 4, 64, d))
            for name, tensors in (("flash_fwd", (t,) * 3), ("flash_bwd_dq", (t,) * 4),
                                  ("flash_bwd_dkv", (t,) * 4)):
                admitted = "wgmma" in attn._routes(name, *tensors)
                err = _c_entry(name, tensors, "wgmma")
                torch.cuda.synchronize()
                assert err == (0 if admitted else 1), (name, offset, layout)
                seen.add((name, admitted))
    assert seen == {(name, admitted) for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                    for admitted in (True, False)}


def test_the_wgmma100_backward_c_entries_refuse_what_they_cannot_take(gpu):
    """csrc/'s dQ and dK/dV entries at head dim 100 on the wgmma route,
    past `_routes`: a sequence stride that is no multiple of 4 elements, an
    empty kv and fp16 rows 4 bytes off an 8-byte boundary each return
    cudaErrorInvalidValue (1) and launch nothing; the same rows with a
    stride of 104, and aligned fp16 rows, launch (0)."""
    wide = torch.randn(1, 4, 64, 104, device=gpu).to(torch.bfloat16)
    odd = torch.randn(1, 4, 64, 102, device=gpu).to(torch.bfloat16)[..., :100]
    empty = torch.zeros(1, 4, 0, 100, device=gpu, dtype=torch.bfloat16)
    half = torch.randn(2 + 4 * 64 * 100, device=gpu).to(torch.float16)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _c_entry(name, (wide[..., :100],) * 4, "wgmma") == 0
        assert _c_entry(name, (odd,) * 4, "wgmma") == 1
        assert _c_entry(name, (wide[..., :100], empty, empty, wide[..., :100]), "wgmma") == 1
        assert _c_entry(name, (half[:4 * 64 * 100].view(1, 4, 64, 100),) * 4, "wgmma") == 0
        assert _c_entry(name, (half[2:].view(1, 4, 64, 100),) * 4, "wgmma") == 1
    torch.cuda.synchronize()


# the forward's fp16 wgmma kernels at head dims 80 and 100
# (flash_fwd_wgmma80_f16_kernel: OPT-2.7B's attention, TMA-fed 160-byte rows;
# flash_fwd_wgmma100_f16_kernel: OpenLLaMA-3B's in fp16, 200-byte rows copied
# by cp.async) at NEW_WIDTH_SHAPES, contiguous and as the models' views
@pytest.mark.parametrize("case", list(NEW_WIDTH_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d", [80, 100])
def test_wgmma_f16_forward_at_80_and_100_matches_the_plain_version(gpu, d, case, layout):
    """One launch on wgmma, as `_route` picks it, within fp16's bounds
    (chip_smoke's: bf16's over 8) elementwise and by O's worst 64-row
    tile."""
    (b, h, kvh, sq, sk), causal, window = NEW_WIDTH_SHAPES[case]
    q, k, v = _qkv(gpu, torch.float16, b, h, kvh, sq, sk, d)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    assert o.dtype == torch.float16 and o.shape == q.shape and o.is_contiguous()
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    tol = TOL[torch.float16]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("d,old", [(80, "mma"), (100, "simt")])
def test_wgmma_f16_forward_at_80_and_100_matches_the_old_route(gpu, d, old):
    """The fp16 kernels against the route each took before (mma at 80, simt
    at 100) on the same inputs (the models' views, GQA 8/4), and each
    bit-repeatable."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(gpu, torch.float16, 1, 8, 4, 1024, 1024, d, seed=2))
    o1, l1 = attn.flash_fwd(q, k, v, route=old)
    runs = [attn.flash_fwd(q, k, v, route="wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    o2, l2 = runs[0]
    tol = TOL[torch.float16]
    torch.testing.assert_close(o2.float(), o1.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o2, o1) <= chip_smoke.TILE_REL_L2_FP16
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wgmma_f16_forward_at_100_takes_bases_8_bytes_off(gpu):
    """fp16 tensors that start 4 elements (8 bytes) into their storage: the
    fp16 head-dim-100 forward takes them on wgmma, as the plain version."""
    flat = [t.flatten() for t in _qkv(gpu, torch.float16, 1, 4, 4, 260, 260, 100)]
    q, k, v = (torch.cat([x.new_zeros(4), x])[4:].view(1, 4, 260, 100) for x in flat)
    assert q.data_ptr() % 16 == 8 and attn._route("flash_fwd", q, k, v) == "wgmma"
    o, lse = attn.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    ro, rl = attn.reference_attention_with_lse(q, k, v)
    tol = TOL[torch.float16]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= chip_smoke.TILE_REL_L2_FP16


def test_the_fp16_wgmma_forwards_refuse_what_they_cannot_take(gpu):
    """The fp16 refusals that still hold on the wgmma route: the forward at
    head dim 112 (no kernel there in either dtype), and at 100 rows 2 or 4
    bytes off an 8-byte boundary, a sequence stride that is no multiple of 4
    elements and an empty kv. The wrapper raises with no launch where
    `_routes` refuses; csrc/'s entry, called past `_routes`, returns
    cudaErrorInvalidValue (1) for each; the same rows at a stride of 104
    launch (0), and so do aligned rows at 80 and 96. dQ and dK/dV take fp16
    at 80, 96 and 100 too."""
    half = torch.float16
    d112 = _qkv(gpu, half, 1, 4, 4, 64, 64, 112)[0]
    wide = torch.randn(1, 4, 64, 104, device=gpu).to(half)
    odd = torch.randn(1, 4, 64, 102, device=gpu).to(half)[..., :100]
    empty = torch.zeros(1, 4, 0, 100, device=gpu, dtype=half)
    flat = torch.randn(2 + 4 * 64 * 100, device=gpu).to(half)
    off = [flat[o:o + 4 * 64 * 100].view(1, 4, 64, 100) for o in (1, 2)]
    fn = attn.flash_fwd
    for tensors in [(d112,) * 3, (odd,) * 3, (wide[..., :100], empty, empty)] + [
            (t,) * 3 for t in off]:
        assert "wgmma" not in attn._routes("flash_fwd", *tensors)
        before = (fn.launches, dict(fn.launches_by_route))
        with pytest.raises(ValueError, match="flash_fwd route 'wgmma' cannot take"):
            fn(*tensors, causal=False, route="wgmma")
        assert (fn.launches, fn.launches_by_route) == before
        assert _c_entry("flash_fwd", tensors, "wgmma") == 1
    assert _c_entry("flash_fwd", (wide[..., :100],) * 3, "wgmma") == 0
    for d in (80, 96, 100):
        t = _qkv(gpu, half, 1, 4, 4, 64, 64, d)[0]
        assert _c_entry("flash_fwd", (t,) * 3, "wgmma") == 0
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert "wgmma" in attn._routes(name, t, t, t, t)
            assert _c_entry(name, (t,) * 4, "wgmma") == 0, (name, d)
    torch.cuda.synchronize()


# the forward's fp16 wgmma kernels at head dims 96 (flash_fwd_wgmma96_f16_kernel:
# GPT-NeoX-20B's attention, 64 heads of 96) and 256
# (flash_fwd_wgmma256_f16_kernel: GPT-J-6B's, 16 heads of 256): (b, h, kvh,
# sq, sk), causal, window at each head dim, the model's shape first
F16_96_256_SHAPES = {
    96: {"neox20b_s2048": ((1, 64, 64, 2048, 2048), True, None),
         "gqa_32_8": ((1, 32, 8, 512, 512), True, None),
         "window_512": ((1, 4, 4, 2048, 2048), True, 512),
         "ragged_300": ((2, 8, 4, 300, 300), True, None),
         "cross_256x1024": ((1, 4, 4, 256, 1024), True, None),
         "non_causal": ((1, 4, 2, 320, 448), False, None)},
    256: {"gptj6b_s2048": ((1, 16, 16, 2048, 2048), True, None),
          "gqa_16_8": ((1, 16, 8, 512, 512), True, None),
          "window_512": ((1, 4, 4, 2048, 2048), True, 512),
          "ragged_300": ((2, 8, 1, 300, 300), True, None),
          "cross_256x1024": ((1, 8, 1, 256, 1024), True, None),
          "non_causal": ((1, 4, 2, 320, 448), False, None)},
}


def _f16_inputs(gpu, d, case, layout, seed=0):
    (b, h, kvh, sq, sk), causal, window = F16_96_256_SHAPES[d][case]
    q, k, v = _qkv(gpu, torch.float16, b, h, kvh, sq, sk, d, seed=seed)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    return q, k, v, causal, window


@pytest.mark.parametrize("d,case", [(d, case) for d, cases in F16_96_256_SHAPES.items()
                                    for case in cases])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_f16_forward_at_96_and_256_matches_the_plain_version(gpu, d, case, layout):
    """One launch on wgmma, as `_route` picks it, within fp16's bounds
    (chip_smoke's) elementwise and by O's worst 64-row tile; dQ and dK/dV
    take their own fp16 wgmma kernels at these inputs too."""
    q, k, v, causal, window = _f16_inputs(gpu, d, case, layout)
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attn._route(name, q, k, v, q) == "wgmma", name
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    assert o.dtype == torch.float16 and o.shape == q.shape and o.is_contiguous()
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    tol = TOL[torch.float16]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("d,case", [(96, "neox20b_s2048"), (96, "window_512"),
                                    (256, "gptj6b_s2048"), (256, "ragged_300")])
def test_wgmma_f16_forward_at_96_and_256_matches_the_mma_route(gpu, d, case):
    """The new kernels against the mma kernel, the route they took before,
    on the same inputs (the models' views), and each bit-repeatable."""
    q, k, v, causal, window = _f16_inputs(gpu, d, case, "bshd", seed=2)
    o1, l1 = attn.flash_fwd(q, k, v, causal, window, route="mma")
    runs = [attn.flash_fwd(q, k, v, causal, window, route="wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    o2, l2 = runs[0]
    tol = TOL[torch.float16]
    torch.testing.assert_close(o2.float(), o1.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o2, o1) <= chip_smoke.TILE_REL_L2_FP16
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("d", [96, 256])
def test_the_fp16_wgmma_forwards_at_96_and_256_refuse_rows_off_16_bytes(gpu, d):
    """fp16 rows that start 1, 2 or 4 elements into their storage (2, 4 or
    8 bytes off a 16-byte boundary), a sequence stride that is no multiple
    of 8 elements and an empty kv: `_routes` offers no wgmma, the named
    route raises with no launch (the empty kv is refused by csrc/ alone),
    and csrc/'s entry, called past `_routes`, returns cudaErrorInvalidValue
    (1) for each; the same rows at a stride of d + 8 launch (0). fp32 at
    d is refused by csrc/ too; fp16 dQ and dK/dV launch at both
    (GPT-NeoX-20B's and GPT-J-6B's fp16 backward kernels)."""
    half = torch.float16
    n = 4 * 64 * d
    flat = torch.randn(4 + n, device=gpu).to(half)
    wide = torch.randn(1, 4, 64, d + 8, device=gpu).to(half)
    odd = torch.randn(1, 4, 64, d + 4, device=gpu).to(half)[..., :d]
    empty = torch.zeros(1, 4, 0, d, device=gpu, dtype=half)
    fn = attn.flash_fwd
    for t in [flat[o:o + n].view(1, 4, 64, d) for o in (1, 2, 4)] + [odd]:
        assert "wgmma" not in attn._routes("flash_fwd", t, t, t)
        before = (fn.launches, dict(fn.launches_by_route))
        with pytest.raises(ValueError, match="flash_fwd route 'wgmma' cannot take"):
            fn(t, t, t, causal=False, route="wgmma")
        assert (fn.launches, fn.launches_by_route) == before
        assert _c_entry("flash_fwd", (t,) * 3, "wgmma") == 1
    assert _c_entry("flash_fwd", (wide[..., :d], empty, empty), "wgmma") == 1
    assert _c_entry("flash_fwd", (wide[..., :d],) * 3, "wgmma") == 0
    assert _c_entry("flash_fwd", (wide[..., :d].float().contiguous(),) * 3, "wgmma") == 1
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _c_entry(name, (wide[..., :d],) * 4, "wgmma") == 0, name
    torch.cuda.synchronize()


# the forward's wgmma kernels at head dim 256 in bf16 (flash_fwd_wgmma256_kernel:
# Gemma's attention) and at 64 in fp16 (flash_fwd_wgmma64_f16_kernel:
# OPT-1.3B's), at the models' shapes and every path of their loops: dtype,
# head dim, (b, h, kvh, sq, sk), causal, window
FWD_NEW_CASES = {
    "gemma2b_s2048": (torch.bfloat16, 256, (1, 8, 1, 2048, 2048), True, None),
    "gemma7b_s2048": (torch.bfloat16, 256, (1, 16, 16, 2048, 2048), True, None),
    "d256_ragged_300": (torch.bfloat16, 256, (2, 8, 1, 300, 300), True, None),
    "d256_cross_256x1024": (torch.bfloat16, 256, (1, 8, 1, 256, 1024), True, None),
    "d256_window_512": (torch.bfloat16, 256, (1, 4, 2, 2048, 2048), True, 512),
    "d256_non_causal": (torch.bfloat16, 256, (1, 4, 2, 320, 448), False, None),
    "opt13b_s2048": (torch.float16, 64, (1, 32, 32, 2048, 2048), True, None),
    "fp16_d64_ragged_300": (torch.float16, 64, (2, 8, 4, 300, 300), True, None),
    "fp16_d64_cross_256x1024": (torch.float16, 64, (1, 4, 4, 256, 1024), True, None),
    "fp16_d64_window_512": (torch.float16, 64, (1, 2, 2, 2048, 2048), True, 512),
    "fp16_d64_non_causal": (torch.float16, 64, (1, 4, 2, 320, 448), False, None),
}
FWD_NEW_TILE = {torch.bfloat16: 1e-2, torch.float16: chip_smoke.TILE_REL_L2_FP16}


def _fwd_new_inputs(gpu, case, layout, seed=0):
    dtype, d, (b, h, kvh, sq, sk), causal, window = FWD_NEW_CASES[case]
    q, k, v = _qkv(gpu, dtype, b, h, kvh, sq, sk, d, seed=seed)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    return q, k, v, causal, window


@pytest.mark.parametrize("case", list(FWD_NEW_CASES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_forward_at_256_and_fp16_64_matches_the_plain_version(gpu, case, layout):
    q, k, v, causal, window = _fwd_new_inputs(gpu, case, layout)
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    assert o.dtype == q.dtype and o.shape == q.shape and o.is_contiguous()
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    tol = TOL[q.dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= FWD_NEW_TILE[q.dtype]


@pytest.mark.parametrize("case", ["gemma2b_s2048", "d256_window_512", "opt13b_s2048",
                                  "fp16_d64_ragged_300"])
def test_wgmma_forward_at_256_and_fp16_64_matches_the_mma_route(gpu, case):
    """The new kernels against the mma kernel, the route they took before,
    on the same inputs (the model's views), and each bit-repeatable."""
    q, k, v, causal, window = _fwd_new_inputs(gpu, case, "bshd", seed=2)
    o1, l1 = attn.flash_fwd(q, k, v, causal, window, route="mma")
    runs = [attn.flash_fwd(q, k, v, causal, window, route="wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    o2, l2 = runs[0]
    tol = TOL[q.dtype]
    torch.testing.assert_close(o2.float(), o1.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o2, o1) <= FWD_NEW_TILE[q.dtype]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("d,dtype", [(256, torch.bfloat16), (64, torch.float16),
                                     (256, torch.float16)])
def test_the_c_entries_admit_what_routes_admits_at_256_and_fp16_64(gpu, d, dtype):
    """For each kernel, every base offset (0, 1, 2 and 4 elements) and both
    layouts: csrc/'s entry takes the wgmma route (returns 0, and launches)
    exactly where `_routes` offers it, and refuses it (cudaErrorInvalidValue,
    1) elsewhere: on 16-byte aligned rows alone, every kernel at 256 in bf16
    and fp16 and at 64 in fp16."""
    seen = set()
    for offset in (0, 1, 2, 4):
        for layout in ("bhsd", "bshd"):
            n = 2 * 4 * 64 * d
            x = torch.randn(offset + n, device=gpu).to(dtype)[offset:]
            t = (x.view(2, 64, 4, d).transpose(1, 2) if layout == "bshd"
                 else x.view(2, 4, 64, d))
            for name, tensors in (("flash_fwd", (t,) * 3), ("flash_bwd_dq", (t,) * 4),
                                  ("flash_bwd_dkv", (t,) * 4)):
                admitted = "wgmma" in attn._routes(name, *tensors)
                err = _c_entry(name, tensors, "wgmma")
                torch.cuda.synchronize()
                assert err == (0 if admitted else 1), (name, offset, layout)
                seen.add((name, admitted))
    assert seen == {(name, admitted) for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                    for admitted in (True, False)}


@pytest.mark.parametrize("d,dtype", [(256, torch.bfloat16), (64, torch.float16)])
def test_the_new_wgmma_forwards_refuse_what_they_cannot_take(gpu, d, dtype):
    """csrc/'s entries on the wgmma route at 256 (bf16) and 64 (fp16), the
    forward, dQ and dK/dV, past `_routes`: an empty kv, a sequence stride
    that is no multiple of 8 elements and a dtype no wgmma kernel of that
    entry takes at that head dim (fp32 for every entry: fp16 at 256 is
    GPT-J-6B's, whose forward, dQ and dK/dV have wgmma kernels) each return
    cudaErrorInvalidValue (1); the same rows at a stride of d + 8 launch
    (0)."""
    wide = torch.randn(1, 4, 64, d + 8, device=gpu).to(dtype)
    odd = torch.randn(1, 4, 64, d + 4, device=gpu).to(dtype)[..., :d]
    empty = torch.zeros(1, 4, 0, d, device=gpu, dtype=dtype)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        n = 3 if name == "flash_fwd" else 4
        other = wide[..., :d].to(torch.float32)
        assert _c_entry(name, (wide[..., :d],) * n, "wgmma") == 0, name
        assert _c_entry(name, (odd,) * n, "wgmma") == 1, name
        assert _c_entry(name, (wide[..., :d], empty, empty, wide[..., :d])[:n],
                        "wgmma") == 1, name
        assert _c_entry(name, (other.contiguous(),) * n, "wgmma") == 1, name
    torch.cuda.synchronize()


# the backward's wgmma kernels at head dim 256 in bf16 (flash_bwd_dq_wgmma256_kernel,
# flash_bwd_dkv_wgmma256_kernel: Gemma's attention) at FWD_NEW_CASES' rows at
# 256: Gemma-2B's shape (8 q heads over one KV head) and Gemma-7B's (16 over
# 16), ragged, cross-length, window 512 and non-causal, contiguous and as
# the models' views
WGMMA256_SHAPES = {case: (shape, causal, window)
                   for case, (_, d, shape, causal, window) in FWD_NEW_CASES.items() if d == 256}


@pytest.mark.parametrize("case", list(WGMMA256_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma256_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on wgmma, as `_route` picks them at head dim 256, one
    launch each, elementwise, by rel. L2 and by each output's worst 64-row
    tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=256)
    q, k, v, do, lse, _, causal, window = args
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
    before = [fn.launches_by_route["wgmma"] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)] == [
        n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.shape[-1] == 256
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert chip_smoke.rel_l2(g, w) <= 2e-2
        assert tile_rel_l2(g, w) <= BWD_TILE_REL_L2


def test_wgmma256_backward_matches_the_mma_route(gpu):
    """Both head-dim-256 wgmma kernels and the mma kernels (the route they
    took before) on the same inputs, Gemma-2B's 8 q heads over one KV head as
    the model's views: each against the plain backward elementwise and by
    tile, and the two routes against each other by tile (elementwise they
    may stand twice the bound apart: each rounds dS to bf16 after fp32 sums
    in its own order; test_wgmma80_backward_matches_the_mma_route)."""
    args, (o, g_lse) = _bwd_inputs(gpu, "gemma2b_s2048", "bshd", seed=2, d=256)
    q, k, v, do, lse, _, causal, window = args
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    for g, m, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma"), want):
        for got in (g, m):
            torch.testing.assert_close(got.float(), w.float(), atol=2e-2, rtol=2e-2)
            assert tile_rel_l2(got, w) <= BWD_TILE_REL_L2
        assert tile_rel_l2(g, m) <= BWD_TILE_REL_L2


@pytest.mark.parametrize("case", list(WGMMA256_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma256_backward_is_bit_repeatable(gpu, case, layout):
    """No atomics: dQ's two warpgroups' sums join in one order."""
    args, _ = _bwd_inputs(gpu, case, layout, d=256)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wgmma256_backward_refuses_fp16_and_its_out_scale(gpu):
    """At head dim 256 dQ and dK/dV take fp16 on wgmma (GPT-J-6B's
    kernels) but not fp32: named on fp32 rows, the route of each raises and
    launches nothing, and csrc/'s entries refuse it (cudaErrorInvalidValue);
    on fp16 rows the wrappers launch once each, and the entries take the
    call with the fp16 cotangent's out_scale and without, as the mma route
    does; in bf16 the entries refuse an out_scale."""
    args, _ = _bwd_inputs(gpu, "ragged_300", "bshd", seed=4, d=256, dtype=torch.float16)
    out_scale = torch.tensor(0.125, device=gpu)
    fp32 = [t.float().contiguous() for t in args[:4]]
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        assert "wgmma" not in attn._routes(fn.__name__, *fp32)
        before = (fn.launches, dict(fn.launches_by_route))
        with pytest.raises(ValueError, match=f"{fn.__name__} route 'wgmma' cannot take"):
            fn(*fp32, *args[4:], route="wgmma")
        assert (fn.launches, fn.launches_by_route) == before
        for scale in (None, out_scale):
            fn(*args, route="wgmma", out_scale=scale)
        torch.cuda.synchronize()
        assert fn.launches_by_route["wgmma"] == before[1]["wgmma"] + 2
    bf16 = [t.to(torch.bfloat16) for t in args[:4]]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _c_entry(name, fp32, "wgmma") == 1, name
        for scale in (None, out_scale):
            assert _c_entry(name, args[:4], "wgmma", scale) == 0, (name, scale)
        assert _c_entry(name, args[:4], "mma", out_scale) == 0, name
        assert _c_entry(name, bf16, "wgmma", out_scale) == 1, name
        assert _c_entry(name, bf16, "wgmma") == 0, name
    torch.cuda.synchronize()


@pytest.mark.parametrize("lse_scale, sink", [(8.0, False), (1e3, False), (1e3, True)],
                         ids=["8.0", "1000.0", "sink-1000.0"])
def test_fp16_backward_keeps_a_large_lse_cotangent(gpu, lse_scale, sink):
    """F10 on the card: the fp16 backward through the kernels' autograd node
    (the fp16 wgmma kernels at head dim 128) with dO of a model's size and a
    large LSE cotangent, finite and within twice the fp32 backward's own
    rounding to fp16 of it (chip_smoke's phase 3 rows, smaller). With an
    attention sink at key 0 and the cotangent of one sign, the sink's dK
    (~2.7e4) times the cotangent scale (32) lies past fp16's largest value:
    finite only because the kernels multiply their sums by the inverse
    scale before rounding them."""
    row = chip_smoke.fp16_lse_cotangent_row(attn, 1, 2, 256, 128, 1e-5, lse_scale, sink)
    assert row["ok"], row
    if sink:
        assert row["errors"]["dk"]["max_abs"] * 32 > torch.finfo(torch.float16).max


@pytest.mark.parametrize("route", ["simt", "mma", "wgmma"])
def test_out_scale_multiplies_each_fp16_output_before_its_rounding(gpu, route):
    """Each fp16 backward kernel at head dim 128 with out_scale 2^-3: its
    outputs are those without it times 2^-3 (exact in fp16's normal range;
    at most 2^-24 apart where the product is subnormal), one launch a call."""
    args, _ = _bwd_inputs(gpu, "gqa_32_8", "bshd", seed=3, dtype=torch.float16)
    out_scale = torch.tensor(0.125, device=gpu)
    before = [fn.launches_by_route[route] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)]
    got = (attn.flash_bwd_dq(*args, route=route, out_scale=out_scale),
           *attn.flash_bwd_dkv(*args, route=route, out_scale=out_scale))
    assert [fn.launches_by_route[route] for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)] == [
        n + 1 for n in before]
    want = (attn.flash_bwd_dq(*args, route=route), *attn.flash_bwd_dkv(*args, route=route))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float() * 0.125, rtol=0, atol=2.0 ** -24)


def test_out_scale_is_fp16_alone(gpu):
    """An out_scale beside bf16 inputs: the wrappers raise before any
    launch, and csrc/'s entries refuse it (cudaErrorInvalidValue) on every
    route."""
    args, _ = _bwd_inputs(gpu, "s128", "bhsd")
    out_scale = torch.tensor(0.5, device=gpu)
    before = (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches)
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        with pytest.raises(ValueError, match="out_scale"):
            fn(*args, out_scale=out_scale)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        for route in ("simt", "mma", "wgmma"):
            assert _c_entry(name, args[:4], route, out_scale) == 1, (name, route)
    torch.cuda.synchronize()
    assert (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches) == before


# the fp16 wgmma forward (flash_fwd_wgmma_f16_kernel, head dim 128: Llama-2's
# published dtype) at WGMMA_SHAPES, in both layouts, held to fp16's bounds
# (chip_smoke.TOL's, and the bf16 tile bound over 8)
@pytest.mark.parametrize("case", list(WGMMA_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_f16_route_matches_the_plain_version(gpu, case, layout):
    (b, h, kvh, sq, sk), causal, window = WGMMA_SHAPES[case]
    q, k, v = _qkv(gpu, torch.float16, b, h, kvh, sq, sk, 128)
    if layout == "bshd":  # the model's transposed views of [B, S, H, D]
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    before = attn.flash_fwd.launches_by_route["wgmma"]
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches_by_route["wgmma"] == before + 1
    assert o.dtype == torch.float16 and o.shape == q.shape
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    tol = TOL[torch.float16]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o, ro) <= chip_smoke.TILE_REL_L2_FP16


def test_wgmma_f16_route_matches_the_mma_route(gpu):
    q, k, v = _qkv(gpu, torch.float16, 1, 8, 4, 1024, 1024, 128, seed=2)
    o1, l1 = attn.flash_fwd(q, k, v, route="mma")
    o2, l2 = attn.flash_fwd(q, k, v, route="wgmma")
    torch.cuda.synchronize()
    tol = TOL[torch.float16]
    torch.testing.assert_close(o2.float(), o1.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l2, l1, atol=1e-3, rtol=1e-3)
    assert tile_rel_l2(o2, o1) <= chip_smoke.TILE_REL_L2_FP16


# the fp16 wgmma backward (flash_bwd_dq_wgmma_f16_kernel,
# flash_bwd_dkv_wgmma_f16_kernel, head dim 128) at the smoke's five fp16 edge
# rows (the main shape, GQA 32/8, window 512, ragged 300, cross length
# 256/1024), in both layouts, held to fp16's bounds
F16_BWD_CASES = ["s2048", "gqa_32_8_s2048", "window_512", "ragged_300", "cross_256x1024"]


@pytest.mark.parametrize("case", F16_BWD_CASES)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_f16_backward_matches_the_plain_backward(gpu, case, layout):
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    fns = (attn.flash_bwd_dq, attn.flash_bwd_dkv)
    assert [attn._route(fn.__name__, q, k, v, do) for fn in fns] == ["wgmma", "wgmma"]
    before = [fn.launches_by_route["wgmma"] for fn in fns]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in fns] == [n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("case", F16_BWD_CASES)
def test_wgmma_f16_backward_matches_the_mma_route(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bhsd", seed=2, dtype=torch.float16)
    tol = TOL[torch.float16]
    for g, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma")):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "gqa_32_8_s2048"])
def test_wgmma_f16_backward_is_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd", dtype=torch.float16)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# the fp16 wgmma backward at head dim 64 (flash_bwd_dq_wgmma64_f16_kernel,
# flash_bwd_dkv_wgmma64_f16_kernel: OPT-1.3B's attention in its published
# dtype) at WGMMA64_SHAPES (bench_mfu's d1024 widths and every path of the
# kernels' loops) and OPT-1.3B's 32 heads, in both layouts, held to fp16's
# bounds
WGMMA64_F16_SHAPES = {**WGMMA64_SHAPES, "opt13b_s2048": ((1, 32, 32, 2048, 2048), True, None)}


@pytest.mark.parametrize("case", list(WGMMA64_F16_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma64_f16_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on their fp16 head-dim-64 wgmma kernels, as `_route`
    picks them, one launch each, elementwise and by each output's worst
    64-row tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=64, dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    fns = (attn.flash_bwd_dq, attn.flash_bwd_dkv)
    assert [attn._route(fn.__name__, q, k, v, do) for fn in fns] == ["wgmma", "wgmma"]
    before = [fn.launches_by_route["wgmma"] for fn in fns]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in fns] == [n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("case", ["opt13b_s2048", "gqa_16_4", "ragged_300"])
def test_wgmma64_f16_backward_matches_the_mma_route(gpu, case):
    """The new kernels against the mma kernels, the route they took before,
    on the same inputs (the model's views): each against the plain backward,
    and the two routes against each other by tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, "bshd", seed=2, d=64,
                                   dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, m, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma"), want):
        for got in (g, m):
            torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)
            assert tile_rel_l2(got, w) <= chip_smoke.TILE_REL_L2_FP16
        assert tile_rel_l2(g, m) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "opt13b_s2048"])
def test_wgmma64_f16_backward_is_bit_repeatable(gpu, case):
    args, _ = _bwd_inputs(gpu, case, "bshd", d=64, dtype=torch.float16)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("route", ["mma", "wgmma"])
def test_wgmma64_f16_out_scale_multiplies_before_the_rounding(gpu, route):
    """At head dim 64 in fp16, on the new kernels and on mma: with out_scale
    2^-3 each output (per q head, as the kernels write it) is the one
    without it times 2^-3 (exact in fp16's normal range, at most 2^-24
    apart where subnormal); and with the cotangents 2^6 times larger and
    out_scale 2^-6, as `_FlashFwd.backward` passes them, the outputs equal
    the plain backward's with the same out_scale, which multiplies before
    its one rounding, within fp16's bounds."""
    args, (o, g_lse) = _bwd_inputs(gpu, "gqa_16_4", "bshd", seed=3, d=64,
                                   dtype=torch.float16)
    q, k, v, do, lse, delta, causal, window = args
    kvh = k.shape[1]
    got = _bwd_kernels_scaled(args, route, torch.tensor(0.125, device=gpu))
    want = _bwd_kernels_scaled(args, route, None)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float() * 0.125, rtol=0, atol=2.0 ** -24)
    big = (q, k, v, (do.float() * 64).half(), lse, delta * 64, causal, window)
    scale = torch.tensor(2.0 ** -6, device=gpu)
    dq, dk, dv = _bwd_kernels_scaled(big, route, scale)
    ref = attn.flash_backward_reference(q, k, v, o, lse, big[3], causal, window,
                                        g_lse * 64, scale)
    tol = TOL[torch.float16]
    for g, w in zip((dq, attn.group_sum(dk, kvh), attn.group_sum(dv, kvh)), ref):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


def _bwd_kernels_scaled(args, route, out_scale):
    """(dQ, dK, dV), dK and dV per q head, each kernel on `route` with
    `out_scale`."""
    return (attn.flash_bwd_dq(*args, route=route, out_scale=out_scale),
            *attn.flash_bwd_dkv(*args, route=route, out_scale=out_scale))


@pytest.mark.parametrize("lse_scale, sink", [(1e3, False), (1e3, True)],
                         ids=["1000.0", "sink-1000.0"])
def test_fp16_d64_backward_keeps_a_large_lse_cotangent(gpu, lse_scale, sink):
    """F10 at head dim 64, through the kernels' autograd node on the new
    fp16 kernels (chip_smoke's large-cotangent rows at OPT-1.3B's width,
    smaller): finite and within twice the fp32 backward's own rounding to
    fp16 of it; with the sink the unscaled dK of key 0 times the cotangent
    scale (32, as at head dim 128) lies past fp16's largest value."""
    row = chip_smoke.fp16_lse_cotangent_row(attn, 1, 2, 256, 64, 1e-5, lse_scale, sink)
    assert row["ok"], row
    if sink:
        assert row["errors"]["dk"]["max_abs"] * 32 > torch.finfo(torch.float16).max


# the fp16 wgmma backward at head dim 100 (flash_bwd_dq_wgmma100_f16_kernel,
# flash_bwd_dkv_wgmma100_f16_kernel: OpenLLaMA-3B's attention in its
# published dtype, 200-byte rows copied by cp.async) at NEW_WIDTH_SHAPES (the
# model's shape and every path of the kernels' loops), in both layouts, held
# to fp16's bounds
@pytest.mark.parametrize("case", list(NEW_WIDTH_SHAPES))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma100_f16_backward_matches_the_plain_backward(gpu, case, layout):
    """dQ and dK/dV on their fp16 head-dim-100 wgmma kernels, as `_route`
    picks them, one launch each, elementwise and by each output's worst
    64-row tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=100, dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    fns = (attn.flash_bwd_dq, attn.flash_bwd_dkv)
    assert [attn._route(fn.__name__, q, k, v, do) for fn in fns] == ["wgmma", "wgmma"]
    before = [fn.launches_by_route["wgmma"] for fn in fns]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in fns] == [n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float16 and g.shape == w.shape
        assert g.shape[-1] == 100
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("case", ["s2048_32_heads", "gqa_32_8", "ragged_300"])
def test_wgmma100_f16_backward_matches_the_simt_route(gpu, case):
    """The new kernels against the simt kernels, the route they took
    before, on the same inputs (the model's views): each against the plain
    backward, and the two routes against each other by tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, "bshd", seed=2, d=100, dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, m, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "simt"), want):
        for got in (g, m):
            torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)
            assert tile_rel_l2(got, w) <= chip_smoke.TILE_REL_L2_FP16
        assert tile_rel_l2(g, m) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("case", ["ragged_300", "window_512", "s2048_32_heads", "gqa_32_8"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma100_f16_backward_is_bit_repeatable(gpu, case, layout):
    args, _ = _bwd_inputs(gpu, case, layout, d=100, dtype=torch.float16)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wgmma100_f16_backward_takes_bases_8_bytes_off(gpu):
    """fp16 q, k, v and dO that start 4 elements (8 bytes) into their
    storage: dQ and dK/dV take them on their fp16 wgmma kernels, as the
    plain backward."""
    half = torch.float16
    flat = [t.flatten() for t in _qkv(gpu, half, 1, 4, 4, 260, 260, 100)]
    flat.append(_qkv(gpu, half, 1, 4, 4, 260, 260, 100, seed=1)[0].flatten())
    q, k, v, do = (torch.cat([x.new_zeros(4), x])[4:].view(1, 4, 260, 100) for x in flat)
    assert q.data_ptr() % 16 == 8
    o, lse = attn.flash_fwd(q, k, v)
    delta = attn.backward_delta(o, do).contiguous()
    args = (q, k, v, do, lse, delta, True, None)
    assert [attn._route(n, q, k, v, do) for n in ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "wgmma", "wgmma"]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    want = attn.flash_backward_reference(q, k, v, o, lse, do)
    tol = TOL[half]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("lse_scale, sink", [(1e3, False), (1e3, True)],
                         ids=["1000.0", "sink-1000.0"])
def test_fp16_d100_backward_keeps_a_large_lse_cotangent(gpu, lse_scale, sink):
    """F10 at head dim 100, through the kernels' autograd node on the new
    fp16 kernels (chip_smoke's large-cotangent rows at OpenLLaMA-3B's
    width, smaller): every output finite and within twice the fp32
    backward's own rounding to fp16 of it, one launch of each kernel on
    wgmma."""
    row = chip_smoke.fp16_lse_cotangent_row(attn, 1, 2, 256, 100, 1e-5, lse_scale, sink)
    assert row["ok"], row
    assert all(e["finite"] for e in row["errors"].values())


# the fp16 wgmma backward at head dims 80, 96 and 256 (OPT-2.7B's,
# GPT-NeoX-20B's and GPT-J-6B's attention in their published dtype:
# flash_bwd_dq_wgmma{80,96,256}_f16_kernel, flash_bwd_dkv_wgmma{80,96,256}_f16_kernel,
# the bodies of the bf16 kernels at those widths on fp16 operands) at
# F16_WIDE_BWD_SHAPES[d] (the model's shape and every path of the kernels'
# loops), in both layouts, held to fp16's bounds; each width's model case
# and GQA case
F16_WIDE_BWD_SHAPES = {80: NEW_WIDTH_SHAPES, **F16_96_256_SHAPES}
F16_WIDE_MODEL = {80: "s2048_32_heads", 96: "neox20b_s2048", 256: "gptj6b_s2048"}
F16_WIDE_GQA = {80: "gqa_32_8", 96: "gqa_32_8", 256: "gqa_16_8"}


@pytest.mark.parametrize("d,case", [(d, case) for d, cases in F16_WIDE_BWD_SHAPES.items()
                                    for case in cases])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_f16_wide_backward_matches_the_plain_backward(gpu, d, case, layout):
    """dQ and dK/dV on their fp16 wgmma kernels at head dim d, as `_route`
    picks them, one launch each, elementwise and by each output's worst
    64-row tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, layout, d=d, dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    fns = (attn.flash_bwd_dq, attn.flash_bwd_dkv)
    assert [attn._route(fn.__name__, q, k, v, do) for fn in fns] == ["wgmma", "wgmma"]
    before = [fn.launches_by_route["wgmma"] for fn in fns]
    got = _bwd_kernels(args, None)
    torch.cuda.synchronize()
    assert [fn.launches_by_route["wgmma"] for fn in fns] == [n + 1 for n in before]
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float16 and g.shape == w.shape
        assert g.shape[-1] == d
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("d,case", [(d, case) for d in F16_WIDE_BWD_SHAPES
                                    for case in (F16_WIDE_MODEL[d], F16_WIDE_GQA[d],
                                                 "ragged_300")])
def test_wgmma_f16_wide_backward_matches_the_mma_route(gpu, d, case):
    """The fp16 wgmma kernels at head dim d against the mma kernels, the
    route they took before, on the same inputs (the model's views): each
    against the plain backward, and the two routes against each other by
    tile."""
    args, (o, g_lse) = _bwd_inputs(gpu, case, "bshd", seed=2, d=d, dtype=torch.float16)
    q, k, v, do, lse, _, causal, window = args
    want = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
    tol = TOL[torch.float16]
    for g, m, w in zip(_bwd_kernels(args, "wgmma"), _bwd_kernels(args, "mma"), want):
        for got in (g, m):
            torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)
            assert tile_rel_l2(got, w) <= chip_smoke.TILE_REL_L2_FP16
        assert tile_rel_l2(g, m) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("d,case", [(d, case) for d in F16_WIDE_BWD_SHAPES
                                    for case in ("ragged_300", "window_512",
                                                 F16_WIDE_MODEL[d], F16_WIDE_GQA[d])])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wgmma_f16_wide_backward_is_bit_repeatable(gpu, d, case, layout):
    """No atomics: dQ's two warpgroups' sums join in one order in fp16 too."""
    args, _ = _bwd_inputs(gpu, case, layout, d=d, dtype=torch.float16)
    runs = [_bwd_kernels(args, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("route", ["mma", "wgmma"])
@pytest.mark.parametrize("d", list(F16_WIDE_BWD_SHAPES))
def test_wgmma_f16_wide_out_scale_multiplies_before_the_rounding(gpu, d, route):
    """At head dim d in fp16, on the wgmma kernels and on mma: with
    out_scale 2^-3 each output (per q head, as the kernels write it) is the
    one without it times 2^-3 (exact in fp16's normal range, at most 2^-24
    apart where subnormal); and with the cotangents 2^6 times larger and
    out_scale 2^-6, as `_FlashFwd.backward` passes them, the outputs equal
    the plain backward's with the same out_scale, which multiplies before
    its one rounding, within fp16's bounds."""
    args, (o, g_lse) = _bwd_inputs(gpu, F16_WIDE_GQA[d], "bshd", seed=3, d=d,
                                   dtype=torch.float16)
    q, k, v, do, lse, delta, causal, window = args
    kvh = k.shape[1]
    got = _bwd_kernels_scaled(args, route, torch.tensor(0.125, device=gpu))
    want = _bwd_kernels_scaled(args, route, None)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float() * 0.125, rtol=0, atol=2.0 ** -24)
    big = (q, k, v, (do.float() * 64).half(), lse, delta * 64, causal, window)
    scale = torch.tensor(2.0 ** -6, device=gpu)
    dq, dk, dv = _bwd_kernels_scaled(big, route, scale)
    ref = attn.flash_backward_reference(q, k, v, o, lse, big[3], causal, window,
                                        g_lse * 64, scale)
    tol = TOL[torch.float16]
    for g, w in zip((dq, attn.group_sum(dk, kvh), attn.group_sum(dv, kvh)), ref):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert tile_rel_l2(g, w) <= chip_smoke.TILE_REL_L2_FP16


@pytest.mark.parametrize("d", list(F16_WIDE_BWD_SHAPES))
def test_wgmma_f16_wide_backward_refuses_rows_off_16_bytes(gpu, d):
    """fp16 q, k, v and dO at head dim d that start 1, 2 or 4 elements (2, 4
    or 8 bytes) into their storage, a sequence stride that is no multiple of
    8 elements and an empty kv: `_routes` offers dQ and dK/dV no wgmma, the
    named route raises with no launch (the empty kv is refused by csrc/
    alone), and csrc/'s entries, called past `_routes`, return
    cudaErrorInvalidValue (1) for each, with no fallback, with the fp16
    cotangent's out_scale and without; the same rows at a stride of d + 8
    launch (0), and fp16 at 112, which has no wgmma backward kernel, is
    refused on rows that are aligned."""
    half = torch.float16
    n = 4 * 64 * d
    flat = torch.randn(4 + n, device=gpu).to(half)
    wide = torch.randn(1, 4, 64, d + 8, device=gpu).to(half)
    odd = torch.randn(1, 4, 64, d + 4, device=gpu).to(half)[..., :d]
    empty = torch.zeros(1, 4, 0, d, device=gpu, dtype=half)
    lse = torch.zeros(1, 4, 64, device=gpu)
    d112 = torch.randn(1, 4, 64, 120, device=gpu).to(half)[..., :112]
    out_scale = torch.tensor(0.125, device=gpu)
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        name = fn.__name__
        for t in [flat[o:o + n].view(1, 4, 64, d) for o in (1, 2, 4)] + [odd, d112]:
            assert "wgmma" not in attn._routes(name, t, t, t, t)
            before = (fn.launches, dict(fn.launches_by_route))
            for scale in (None, out_scale):
                with pytest.raises(ValueError, match=f"{name} route 'wgmma' cannot take"):
                    fn(t, t, t, t, lse, lse, causal=False, route="wgmma", out_scale=scale)
                assert _c_entry(name, (t,) * 4, "wgmma", scale) == 1, name
            assert (fn.launches, fn.launches_by_route) == before
        ok = wide[..., :d]
        assert _c_entry(name, (ok, empty, empty, ok), "wgmma") == 1, name
        for scale in (None, out_scale):
            assert _c_entry(name, (ok,) * 4, "wgmma", scale) == 0, name
    torch.cuda.synchronize()


@pytest.mark.parametrize("lse_scale, sink", [(1e3, False), (1e3, True)],
                         ids=["1000.0", "sink-1000.0"])
@pytest.mark.parametrize("d", list(F16_WIDE_BWD_SHAPES))
def test_fp16_wide_backward_keeps_a_large_lse_cotangent(gpu, d, lse_scale, sink):
    """F10 at head dim d, through the kernels' autograd node on the fp16
    wgmma kernels (chip_smoke's large-cotangent rows at the model's width,
    smaller): every output finite and within twice the fp32 backward's own
    rounding to fp16 of it, one launch of each kernel on wgmma."""
    row = chip_smoke.fp16_lse_cotangent_row(attn, 1, 2, 256, d, 1e-5, lse_scale, sink)
    assert row["ok"], row
    assert all(e["finite"] for e in row["errors"].values())


def test_wgmma80_f16_backward_launches_its_own_kernels(gpu):
    """fp16 at head dim 80 on the wgmma route launches
    flash_bwd_dq_wgmma80_f16_kernel and flash_bwd_dkv_wgmma80_f16_kernel,
    once each, by the names torch.profiler reads on the device, and neither
    of D = 128's fp16 kernels, which the launchers reach for any other fp16
    head dim that `has_wgmma` takes."""
    args, _ = _bwd_inputs(gpu, "gqa_32_8", "bshd", d=80, dtype=torch.float16)
    _bwd_kernels(args, "wgmma")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _bwd_kernels(args, "wgmma")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel in ("flash_bwd_dq_wgmma80_f16_kernel", "flash_bwd_dkv_wgmma80_f16_kernel"):
        assert sum(kernel in n for n in names) == 1, names
    assert not any("wgmma_f16_kernel" in n for n in names), names



# a GQA case of each wgmma backward kernel pair: (head dim, dtype, case of
# `_bwd_inputs`)
ROUNDING_CASES = {
    "bf16_d64": (64, torch.bfloat16, "gqa_16_4"),
    "bf16_d80": (80, torch.bfloat16, "gqa_32_8"),
    "bf16_d96": (96, torch.bfloat16, "gqa_32_8"),
    "bf16_d100": (100, torch.bfloat16, "gqa_32_8"),
    "bf16_d128": (128, torch.bfloat16, "gqa_32_8"),
    "bf16_d256": (256, torch.bfloat16, "d256_ragged_300"),
    "fp16_d64": (64, torch.float16, "gqa_16_4"),
    "fp16_d100": (100, torch.float16, "gqa_32_8"),
    "fp16_d128": (128, torch.float16, "gqa_32_8"),
    "fp16_d256": (256, torch.float16, "gqa_16_8"),
    "fp16_d96": (96, torch.float16, "gqa_32_8"),
    "fp16_d80": (80, torch.float16, "gqa_32_8"),
}
# the largest share of an output's entries that differ from the plain
# backward's per q head, by dtype: fp16's ulp is 8x finer than bf16's, so 8x
# as many fp32 sums land across a rounding boundary in another order (dV,
# whose P no scale touches, reads 0.3% in bf16 and 2.4% in fp16 on an H100);
# rounding dS before its scale (not a power of two at 80, 96, 100 and 128)
# reads near half of dQ's and dK's entries off
ROUNDING_SHARE = {torch.bfloat16: 1e-2, torch.float16: 8e-2}


@pytest.mark.parametrize("case", list(ROUNDING_CASES))
def test_wgmma_backward_rounds_ds_where_the_plain_backward_does(gpu, case):
    """dQ and dK/dV on wgmma against the plain backward per q head (K and V
    repeated to q's heads, so that the plain dK/dV is each head's, rounded
    once, as the kernels write it): under `ROUNDING_SHARE` of each output's
    entries differ (`unequal_share`). Both round dS = P (dP - delta) scale,
    and differ only in fp32 rounding and the order of sums."""
    d, dtype, shape = ROUNDING_CASES[case]
    args, (o, g_lse) = _bwd_inputs(gpu, shape, "bshd", d=d, dtype=dtype)
    q, k, v, do, lse, _, causal, window = args
    rep = q.shape[1] // k.shape[1]
    want = attn.flash_backward_reference(
        q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1), o, lse, do,
        causal, window, g_lse)
    got = (attn.flash_bwd_dq(*args, route="wgmma"), *attn.flash_bwd_dkv(*args, route="wgmma"))
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert unequal_share(g, w) < ROUNDING_SHARE[dtype], name


@pytest.mark.parametrize("d", [64, 96, 80])
def test_wgmma_takes_fp16_at_head_dim_128_alone(gpu, d):
    """In fp16 every kernel has a wgmma kernel at head dims 128, 64
    (OPT-1.3B's), 96 (GPT-NeoX-20B's) and 80 (OPT-2.7B's): named, each
    launches on it at d and at 128."""
    q = _qkv(gpu, torch.float16, 1, 4, 4, 128, 128, d)[0]
    q128 = _qkv(gpu, torch.float16, 1, 4, 4, 128, 128, 128)[0]
    lse = torch.zeros(q.shape[:3], device=gpu)
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        args = (q,) * 3 if fn is attn.flash_fwd else (q,) * 4 + (lse, lse)
        before = (fn.launches, dict(fn.launches_by_route))
        fn(*args, route="wgmma")
        torch.cuda.synchronize()
        assert fn.launches_by_route["wgmma"] == before[1]["wgmma"] + 1
        before = (fn.launches, dict(fn.launches_by_route))
        args = (q128,) * 3 if fn is attn.flash_fwd else (q128,) * 4 + (lse, lse)
        fn(*args, route="wgmma")
        torch.cuda.synchronize()
        assert fn.launches_by_route["wgmma"] == before[1]["wgmma"] + 1


def test_wgmma_refuses_dq_at_head_dim_32(gpu):
    """No wgmma kernel takes head dim 32: named, the route of dQ (and of
    dK/dV) raises and launches nothing."""
    args, _ = _bwd_inputs(gpu, "ragged_300", "bhsd", d=32)
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        before = (fn.launches, dict(fn.launches_by_route))
        with pytest.raises(ValueError, match=f"{fn.__name__} route 'wgmma' cannot take"):
            fn(*args, route="wgmma")
        assert (fn.launches, fn.launches_by_route) == before


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 520), (torch.float64, 64)])
def test_kernel_refuses_what_it_does_not_take(gpu, dtype, d):
    """A head dim past the widest padded width (512, simt's) and a dtype the
    kernels lack are refused by every wrapper, with no launch."""
    q, k, v = _qkv(gpu, dtype, 1, 2, 2, 32, 32, d)
    before = [(fn.launches, dict(fn.launches_by_route))
              for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)]
    with pytest.raises(ValueError, match="flash_fwd takes"):
        attn.flash_attention(q, k, v)
    lse = torch.zeros(q.shape[:3], device=gpu)
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        with pytest.raises(ValueError, match=f"{fn.__name__} takes"):
            fn(q, k, v, q, lse, lse)
    assert [(fn.launches, fn.launches_by_route)
            for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)] == before


# head dims other than 32, 64 and 128, and fp16: the simt and mma kernels at
# their padded widths (at 80, 96, 100 and 256, and fp16 at 64, 80, 96, 100,
# 128 and 256, on wgmma). (dtype, d, (b, h, kvh, sq, sk), causal, window, layout, the
# route `_route` picks for every kernel, or for the forward and the
# backward); "offset1" starts each tensor one element into its storage,
# off 16-byte alignment
WIDE_CASES = {
    "bf16_d96_bshd": (torch.bfloat16, 96, (1, 8, 8, 512, 512), True, None, "bshd",
                      "wgmma"),
    "bf16_d96_gqa_window": (torch.bfloat16, 96, (1, 8, 2, 300, 300), True, 64, "bhsd",
                            "wgmma"),
    "bf16_d80_cross": (torch.bfloat16, 80, (1, 4, 4, 128, 400), True, None, "bhsd",
                       "wgmma"),
    "bf16_d256_gqa_8_1": (torch.bfloat16, 256, (1, 8, 1, 384, 384), True, None, "bshd",
                          "wgmma"),
    "bf16_d40_ragged": (torch.bfloat16, 40, (2, 4, 2, 300, 300), True, None, "bhsd", "mma"),
    "bf16_d8_non_causal": (torch.bfloat16, 8, (1, 2, 2, 70, 130), False, None, "bhsd",
                           "mma"),
    "bf16_d100": (torch.bfloat16, 100, (1, 4, 4, 256, 256), True, None, "bhsd", "wgmma"),
    "bf16_d1": (torch.bfloat16, 1, (1, 2, 2, 100, 100), True, None, "bhsd", "simt"),
    "fp16_d128": (torch.float16, 128, (1, 8, 8, 512, 512), True, None, "bhsd", "wgmma"),
    "fp16_d64_bshd": (torch.float16, 64, (2, 8, 8, 256, 256), True, None, "bshd",
                      "wgmma"),
    "fp16_d200_window": (torch.float16, 200, (1, 4, 2, 300, 300), True, 50, "bhsd", "mma"),
    "fp16_d72_offset": (torch.float16, 72, (1, 4, 4, 200, 200), True, None, "offset1",
                        "simt"),
    "fp32_d96": (torch.float32, 96, (1, 4, 4, 200, 200), True, None, "bhsd", "simt"),
    "fp32_d256": (torch.float32, 256, (1, 2, 1, 130, 130), True, None, "bhsd", "simt"),
    # past the mma kernels' 256: simt at its widest padded width (512)
    "bf16_d320_bshd": (torch.bfloat16, 320, (1, 4, 4, 200, 200), True, None, "bshd",
                       "simt"),
    "fp16_d512_window": (torch.float16, 512, (1, 4, 2, 150, 150), True, 40, "bhsd", "simt"),
    "fp32_d264_cross": (torch.float32, 264, (1, 2, 2, 70, 130), True, None, "bhsd", "simt"),
}
WIDE_TILE = {torch.bfloat16: BWD_TILE_REL_L2, torch.float16: chip_smoke.TILE_REL_L2_FP16,
             torch.float32: chip_smoke.TILE_REL_L2_FP32}


def _wide_inputs(gpu, case):
    dtype, d, (b, h, kvh, sq, sk), causal, window, layout, _ = WIDE_CASES[case]
    rng = np.random.default_rng(9)
    out = []
    for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d), (b, h, sq, d)):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(gpu, dtype)
        if layout == "bshd":  # the model's transposed views of [B, S, H, D]
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        elif layout == "offset1":
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
        out.append(x)
    return out, causal, window


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_head_dims_and_fp16_match_the_plain_versions(gpu, case):
    """Each kernel on every route that takes the inputs (the route `_route`
    picks among them) against its plain version: O and LSE, then dQ, dK and
    dV from the forward's LSE with an LSE cotangent, elementwise and by each
    output's worst 64-row tile."""
    (q, k, v, do), causal, window = _wide_inputs(gpu, case)
    dtype, want = q.dtype, chip_smoke.shape_routes(WIDE_CASES[case][-1])
    fns = (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)
    taken = {fn: attn._routes(fn.__name__, q, k, v, *(() if fn is attn.flash_fwd else (do,)))
             for fn in fns}
    assert {fn.__name__: routes[-1] for fn, routes in taken.items()} == want
    assert ("wgmma" in taken[attn.flash_fwd]) == (want["flash_fwd"] == "wgmma")
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    g_lse = torch.randn(q.shape[:3], generator=torch.Generator(gpu).manual_seed(1),
                        device=gpu)
    grads = attn.flash_backward_reference(q, k, v, ro, rl, do, causal, window, g_lse)
    delta = attn.backward_delta(ro, do, g_lse).contiguous()
    args = (q, k, v, do, rl, delta, causal, window)
    kvh = k.shape[1]
    for route in taken[attn.flash_fwd]:
        before = [fn.launches_by_route[route] for fn in fns]
        o, lse = attn.flash_fwd(q, k, v, causal, window, route=route)
        got = {}
        if route in taken[attn.flash_bwd_dq]:
            got["dq"] = attn.flash_bwd_dq(*args, route=route)
        if route in taken[attn.flash_bwd_dkv]:
            got["dk"], got["dv"] = (attn.group_sum(t, kvh)
                                    for t in attn.flash_bwd_dkv(*args, route=route))
        torch.cuda.synchronize()
        assert [fn.launches_by_route[route] for fn in fns] == [
            n + (route in taken[fn]) for n, fn in zip(before, fns)]
        assert o.dtype == dtype and o.shape == ro.shape
        torch.testing.assert_close(o.float(), ro.float(), atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-3)
        assert tile_rel_l2(o, ro) <= WIDE_TILE[dtype], route
        for name, w in zip(("dq", "dk", "dv"), grads):
            if name not in got:
                continue
            g = got[name]
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), atol=TOL[dtype],
                                       rtol=TOL[dtype])
            assert tile_rel_l2(g, w) <= WIDE_TILE[dtype], route


@pytest.mark.parametrize("case", ["bf16_d256_gqa_8_1", "fp16_d200_window", "fp32_d96",
                                  "bf16_d320_bshd"])
def test_wide_backward_is_bit_repeatable(gpu, case):
    (q, k, v, do), causal, window = _wide_inputs(gpu, case)
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    args = (q, k, v, do, lse, attn.backward_delta(o, do).contiguous(), causal, window)
    runs = [_bwd_kernels(args, None) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_48_gradient_on_cuda_matches_cpu(gpu, dtype):
    """A tiny Llama with head dim 48 (dim 96 over 2 heads, one KV head): the
    loss gradient through the kernels (simt in fp32, mma in bf16; remat)
    against the plain attention's on the CPU, every leaf: fp32 by summation
    order, bf16 by each leaf's relative L2 error (chip_smoke's GRAD_REL_L2)."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=96, n_heads=2, n_kv_heads=1,
                              ffn_dim=192, dtype=str(dtype).split(".")[1])
    assert cfg.head_dim == 48
    params = init_llama(cfg, seed=0, device=gpu)
    cpu = {"embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
           "lm_head": params["lm_head"].cpu(),
           "layers": [{n: t.cpu() for n, t in layer.items()} for layer in params["layers"]]}
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64)))
    route = "simt" if dtype == torch.float32 else "mma"
    before = attn.flash_bwd_dq.launches_by_route[route]
    grads = []
    for p, toks in ((params, tokens.to(gpu)), (cpu, tokens)):
        leaves = param_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        llama_loss(p, toks, cfg, remat=True).backward()
        grads.append([t.grad.cpu() for t in leaves])
    assert attn.flash_bwd_dq.launches_by_route[route] == before + cfg.n_layers
    for got, want in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        else:
            assert chip_smoke.rel_l2(got, want) <= chip_smoke.GRAD_REL_L2


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


# ------------------------------------------------- Ulysses and the pipeline
@pytest.mark.parametrize("kvh", [8, 4, 2])
def test_ulysses_on_cuda_matches_the_plain_attention(gpu, kvh):
    """Ulysses over sp=4 through the one-process exchange, bf16, S=512,
    8 query heads: MHA, GQA 8/4 (the kv heads split over sp) and GQA 8/2
    (repeated to full heads first). One launch of each kernel a rank, on
    the wgmma route, over the whole sequence; output and gradients against
    the plain attention by the worst 64-row tile (phase 3's bound)."""
    from yoda_scheduler_tpu_torch.parallel import ulysses

    q, k, v = _qkv(gpu, torch.bfloat16, 1, 8, kvh, 512, 512, 128, seed=8)
    do = _qkv(gpu, torch.bfloat16, 1, 8, kvh, 512, 512, 128, seed=9)[0]
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        attn._reset_counts(fn)
    out = ulysses.ulysses_attention_emulated(*leaves, sp=4)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        assert fn.launches_by_route == {"simt": 0, "mma": 0, "wgmma": 4}, fn.__name__
    o, lse = attn.reference_attention_with_lse(q.detach(), k.detach(), v.detach())
    want = (o, *attn.flash_backward_reference(q.detach(), k.detach(), v.detach(), o,
                                              lse, do))
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert tile_rel_l2(got.detach(), ref) <= BWD_TILE_REL_L2, name


def test_pipelined_loss_on_cuda_matches_the_one_device_loss(gpu):
    """Two layers at head_dim 128 (the wgmma route), bf16, pp=2 stages in
    one process, 4 microbatches of one row, remat: the loss within 5e-3 of
    the one-device llama_loss (the JAX package's pipeline bound) and every
    gradient within chip_smoke's GRAD_REL_L2; 2 layers x 4 microbatches
    forward twice, and once each backward kernel."""
    from yoda_scheduler_tpu_torch.parallel import pipeline

    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=512, n_heads=4, n_kv_heads=2,
                              ffn_dim=1024)
    params = init_llama(cfg, seed=0, device=gpu)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (4, 256))).to(gpu)
    results = []
    for fn in (lambda: llama_loss(params, tokens, cfg, remat=True),
               lambda: pipeline.pipelined_llama_loss(params, tokens, cfg, pp=2,
                                                     num_microbatches=4, remat=True)):
        for f in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
            attn._reset_counts(f)
        loss = fn()
        loss.backward()
        torch.cuda.synchronize()
        results.append((float(loss.detach()), [t.grad for t in leaves]))
        for t in leaves:
            t.grad = None
    assert attn.flash_fwd.launches_by_route["wgmma"] == 16
    assert attn.flash_bwd_dq.launches_by_route["wgmma"] == 8
    assert attn.flash_bwd_dkv.launches_by_route["wgmma"] == 8
    (loss_one, grads_one), (loss_pp, grads_pp) = results
    assert abs(loss_pp - loss_one) < 5e-3, (loss_pp, loss_one)
    for a, b in zip(grads_pp, grads_one):
        assert chip_smoke.rel_l2(a, b) <= chip_smoke.GRAD_REL_L2


# ------------------------------------- checkpoint, rendezvous and ResNet-50
def test_checkpoint_resume_on_the_card_is_bit_exact(gpu, tmp_path):
    """The tiny bf16 step with the fused AdamW (its step count a tensor on
    the card): a round trip keeps every value and the step tensor's place,
    and the resumed step's loss equals the uninterrupted one's."""
    from yoda_scheduler_tpu_torch.parallel import TrainCheckpointer

    cfg = LlamaConfig.tiny()
    init_fn, step_fn, _ = build_llama_train_step(cfg, device=gpu)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 64))).to(gpu)
    params, opt = init_fn(0)
    params, opt, _ = step_fn(params, opt, tokens)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), device=gpu)
    ckpt.save(1, params, opt)
    _, rp, ro = ckpt.restore(init_fn(2))
    for a, b in zip(param_leaves(params), param_leaves(rp)):
        assert torch.equal(a, b)
        for k, v in opt.state[a].items():
            assert torch.equal(v, ro.state[b][k]) and ro.state[b][k].device == v.device
    want = float(step_fn(params, opt, tokens)[2])
    assert float(step_fn(rp, ro, tokens)[2]) == want


def test_multihost_world1_nccl_rendezvous(gpu):
    """initialize_multihost over a TCP rendezvous on 127.0.0.1: a world-1
    NCCL group; global_batch is batch_fn there."""
    import socket

    import torch.distributed as dist

    from yoda_scheduler_tpu_torch.parallel import (ShardPlan, global_batch,
                                                   initialize_multihost, make_mesh)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_multihost(f"127.0.0.1:{port}", 1, 0) is True
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        plan = ShardPlan(LlamaConfig.tiny(), make_mesh({"dp": 1}, device="cuda"))
        tokens = torch.arange(64, device=gpu).view(4, 16)
        assert torch.equal(global_batch(tokens, plan.tokens), plan.tokens(tokens))
    finally:
        dist.destroy_process_group()


def test_resnet_on_the_card_matches_the_cpu_fp32(gpu):
    """The small ResNet in fp32 (TF32 off) on the same weights: train-mode
    logits and running statistics on the card against the CPU's, by rel. L2
    (1e-4 and 1e-5, summation order), with cuDNN's convolutions and with
    PyTorch's own; every gradient (1e-4) with PyTorch's own. cuDNN's fp32
    backward loses precision with TF32 off: on an H100 it read 2.1e-2 on the
    stem's BatchNorm scale against the CPU, PyTorch's convolution 7.2e-6."""
    import torch.nn.functional as F

    from yoda_scheduler_tpu_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 4))
    init_fn, _ = resnet.resnet_forward_fn(
        model=resnet.ResNet((1, 1, 1, 1), 10, torch.float32, device="cpu"))
    weights = init_fn(0, x)
    for n, t in weights["params"].items():
        if n.endswith(".scale"):
            t.fill_(0.5)

    def train_pass(dev):
        _, apply_fn = resnet.resnet_forward_fn(
            model=resnet.ResNet((1, 1, 1, 1), 10, torch.float32, device=dev))
        variables = {k: {n: t.detach().to(dev).requires_grad_(k == "params")
                         for n, t in v.items()}
                     for k, v in weights.items()}
        logits, mutated = apply_fn(variables, x.to(dev), train=True)
        F.cross_entropy(logits, labels.to(dev)).backward()
        return (logits.detach().cpu(), {n: t.cpu() for n, t in mutated["batch_stats"].items()},
                {n: t.grad.cpu() for n, t in variables["params"].items()})

    l_cpu, s_cpu, g_cpu = train_pass("cpu")
    with_cudnn = train_pass(gpu)
    with torch.backends.cudnn.flags(enabled=False):
        native = train_pass(gpu)
    for l_gpu, s_gpu, _ in (with_cudnn, native):
        assert chip_smoke.rel_l2(l_gpu, l_cpu) < 1e-4
        for n in s_cpu:
            assert chip_smoke.rel_l2(s_gpu[n], s_cpu[n]) < 1e-5, n
    for n in g_cpu:
        assert chip_smoke.rel_l2(native[2][n], g_cpu[n]) < 1e-4, n


# -------------------------------------------------------------- bench twins
def test_bench_detect_card_names_its_catalog_row(gpu):
    """bench_util.detect_card finds CUDA's card in NVML by UUID; a catalogued
    product maps to its row, whose bf16 peak is bench_mfu's."""
    from yoda_scheduler_tpu_torch import bench_mfu, bench_util
    from yoda_scheduler_tpu_torch.topology.gpus import GPUS, model_of_nvml_name

    card = bench_util.detect_card()
    model = model_of_nvml_name(card.name)
    assert card.model == (GPUS[model] if model else None)
    assert bench_mfu.peak_flops(card.name) == (
        card.model.bf16_dense_tflops * 1e12 if card.model else None)


def test_bench_fwdbwd_row_launches_both_backward_kernels(gpu):
    """bench_mfu's "fwd+bwd" is the gradient of sum(O) with respect to q
    alone, yet the port's backward launches the dK/dV kernel beside the dQ
    kernel; dQ agrees with the plain backward's for the ones cotangent."""
    from yoda_scheduler_tpu_torch import bench_mfu

    q, k, v = bench_mfu.make_inputs(0, 1, 16, 16, 256, gpu)
    fn = bench_mfu.grad_q(bench_mfu.flash_fwd_fn)
    chip_smoke.reset_launches(attn)
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert chip_smoke.read_launches(attn) == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                              "flash_bwd_dkv": 1}
    assert chip_smoke.read_routes(attn) == {n: {"wgmma": 1} for n in
                                            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    o, lse = attn.flash_fwd(q, k, v)
    want = attn.flash_backward_reference(q, k, v, o, lse, torch.ones_like(q))[0]
    assert tile_rel_l2(got, want) <= BWD_TILE_REL_L2
