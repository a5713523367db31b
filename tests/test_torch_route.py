"""Which kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu the port's
inputs take (`attention._route`, per kernel), decided from
dtype, head_dim, base alignment and strides alone, on CPU tensors; the
refusal of a named route that cannot take the inputs; and the route the
model's own backward reaches. The kernels themselves run in
tests/test_torch_cuda.py."""

import dataclasses

import pytest
import torch

from yoda_scheduler_tpu_torch.models import LlamaConfig, init_llama, llama_loss
from yoda_scheduler_tpu_torch.ops import attention as attn


def _bhsd(b, h, s, d, dtype=torch.bfloat16, offset=0):
    x = torch.zeros(b * h * s * d + offset, dtype=dtype)
    return x[offset:].view(b, h, s, d)


def _model_view(b, s, h, d, dtype=torch.bfloat16):
    """The model's layout: [B, S, H, D] viewed as [B, H, S, D]."""
    return torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)


CASES = {
    "bf16_d128": (lambda: [_bhsd(1, 4, 64, 128)] * 3, "wgmma"),
    "bf16_d128_gqa": (lambda: [_bhsd(1, 4, 64, 128)] + [_bhsd(1, 2, 64, 128)] * 2,
                      "wgmma"),
    "model_bshd_view": (lambda: [_model_view(2, 64, 4, 128)] * 3, "wgmma"),
    "bf16_d64": (lambda: [_bhsd(1, 4, 64, 64)] * 3, "wgmma"),
    "bf16_d32": (lambda: [_bhsd(1, 4, 64, 32)] * 3, "mma"),
    "bf16_offset_by_one": (lambda: [_bhsd(1, 4, 64, 128, offset=1)] * 3, "simt"),
    "bf16_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 132)[..., :128]] * 3, "simt"),
    "fp32_d128": (lambda: [_bhsd(1, 4, 64, 128, torch.float32)] * 3, "simt"),
    "empty_kv": (lambda: [_bhsd(1, 4, 64, 128), _bhsd(1, 4, 0, 128),
                          _bhsd(1, 4, 0, 128)], "mma"),
    # head dims past wgmma's and fp16: mma takes aligned rows whose head dim
    # is a multiple of 8 up to 256, simt the rest; wgmma takes bf16 at 64,
    # 96 (Phi-3-mini's), 100 (OpenLLaMA-3B's, whose rows the kernels copy in
    # 8-byte pieces: bases 8-byte aligned, strides multiples of 4) and 128,
    # and fp16 at 128; the forward's wgmma also bf16 at 80 (StableLM-3B's)
    # and 256 (Gemma's), and fp16 at 64 (OPT-1.3B's), 80 (OPT-2.7B's), 96
    # (GPT-NeoX-20B's), 100 (OpenLLaMA-3B's published dtype; 8-byte aligned
    # rows, as in bf16) and 256 (GPT-J-6B's)
    "bf16_d96": (lambda: [_bhsd(1, 4, 64, 96)] * 3, "wgmma"),
    "bf16_d80": (lambda: [_bhsd(1, 4, 64, 80)] * 3, "wgmma"),
    "bf16_d80_bshd_view": (lambda: [_model_view(2, 64, 4, 80)] * 3, "wgmma"),
    "bf16_d256_gqa": (lambda: [_bhsd(1, 8, 64, 256)] + [_bhsd(1, 1, 64, 256)] * 2,
                      "wgmma"),
    "bf16_d256_bshd_view": (lambda: [_model_view(1, 64, 8, 256)] * 3, "wgmma"),
    "bf16_d256_offset_by_one": (lambda: [_bhsd(1, 8, 64, 256, offset=1)] * 3, "simt"),
    "bf16_d256_odd_seq_stride": (lambda: [_bhsd(1, 8, 64, 260)[..., :256]] * 3, "simt"),
    "fp16_d128": (lambda: [_bhsd(1, 4, 64, 128, torch.float16)] * 3, "wgmma"),
    "fp16_d128_bshd_view": (lambda: [_model_view(2, 64, 4, 128, torch.float16)] * 3,
                            "wgmma"),
    "fp16_d64": (lambda: [_bhsd(1, 4, 64, 64, torch.float16)] * 3, "wgmma"),
    "fp16_d64_bshd_view": (lambda: [_model_view(1, 64, 32, 64, torch.float16)] * 3, "wgmma"),
    "fp16_d64_offset_by_one": (lambda: [_bhsd(1, 4, 64, 64, torch.float16, offset=1)] * 3,
                               "simt"),
    "fp16_d96": (lambda: [_bhsd(1, 4, 64, 96, torch.float16)] * 3, "wgmma"),
    "fp16_d96_bshd_view": (lambda: [_model_view(1, 64, 64, 96, torch.float16)] * 3, "wgmma"),
    "fp16_d96_offset_by_one": (lambda: [_bhsd(1, 4, 64, 96, torch.float16, offset=1)] * 3,
                               "simt"),
    "fp16_d256": (lambda: [_bhsd(1, 4, 64, 256, torch.float16)] * 3, "wgmma"),
    "fp16_d256_bshd_view": (lambda: [_model_view(1, 64, 16, 256, torch.float16)] * 3,
                            "wgmma"),
    "fp16_d256_gqa": (lambda: [_bhsd(1, 8, 64, 256, torch.float16)]
                      + [_bhsd(1, 1, 64, 256, torch.float16)] * 2, "wgmma"),
    "fp16_d256_offset_by_four": (lambda: [_bhsd(1, 4, 64, 256, torch.float16, offset=4)]
                                 * 3, "simt"),
    "bf16_d100": (lambda: [_bhsd(1, 4, 64, 100)] * 3, "wgmma"),
    "bf16_d100_aligned_rows": (lambda: [_bhsd(1, 4, 64, 104)[..., :100]] * 3, "wgmma"),
    "bf16_d100_bshd_view": (lambda: [_model_view(2, 64, 4, 100)] * 3, "wgmma"),
    "bf16_d100_offset_by_one": (lambda: [_bhsd(1, 4, 64, 100, offset=1)] * 3, "simt"),
    "bf16_d100_offset_by_two": (lambda: [_bhsd(1, 4, 64, 100, offset=2)] * 3, "simt"),
    "bf16_d100_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 102)[..., :100]] * 3, "simt"),
    "bf16_d100_empty_kv": (lambda: [_bhsd(1, 4, 64, 100), _bhsd(1, 4, 0, 100),
                                    _bhsd(1, 4, 0, 100)], "simt"),
    "fp16_d100": (lambda: [_bhsd(1, 4, 64, 100, torch.float16)] * 3, "wgmma"),
    "fp16_d100_bshd_view": (lambda: [_model_view(2, 64, 4, 100, torch.float16)] * 3,
                            "wgmma"),
    "fp16_d100_offset_by_four": (lambda: [_bhsd(1, 4, 64, 100, torch.float16, offset=4)]
                                 * 3, "wgmma"),
    "fp16_d100_offset_by_two": (lambda: [_bhsd(1, 4, 64, 100, torch.float16, offset=2)]
                                * 3, "simt"),
    "fp16_d100_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 102, torch.float16)[..., :100]]
                                 * 3, "simt"),
    "fp16_d80": (lambda: [_bhsd(1, 4, 64, 80, torch.float16)] * 3, "wgmma"),
    "fp16_d80_bshd_view": (lambda: [_model_view(2, 64, 4, 80, torch.float16)] * 3, "wgmma"),
    "fp16_d80_offset_by_four": (lambda: [_bhsd(1, 4, 64, 80, torch.float16, offset=4)] * 3,
                                "simt"),
    "fp32_d80": (lambda: [_bhsd(1, 4, 64, 80, torch.float32)] * 3, "simt"),
    "fp16_offset_by_one": (lambda: [_bhsd(1, 4, 64, 128, torch.float16, offset=1)] * 3,
                           "simt"),
    "fp16_d40": (lambda: [_bhsd(1, 4, 64, 40, torch.float16)] * 3, "mma"),
    "bf16_d320": (lambda: [_bhsd(1, 2, 32, 320)] * 3, "simt"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_route_follows_the_inputs(case):
    make, want = CASES[case]
    q, k, v = make()
    assert attn._route("flash_fwd", q, k, v) == want
    assert attn._routes("flash_fwd", q, k, v)[-1] == want
    assert "simt" in attn._routes("flash_fwd", q, k, v)


# the head dims each kernel has a wgmma kernel for (csrc/), by dtype: every
# kernel at 64, 80, 96, 128 and 256 in bf16 and in fp16 (and every kernel at
# 100 in both dtypes, whose rows are not 16-byte aligned: not among these,
# which mma takes too)
WGMMA_TAKES = {torch.bfloat16: {"flash_fwd": (64, 80, 96, 128, 256),
                                "flash_bwd_dq": (64, 80, 96, 128, 256),
                                "flash_bwd_dkv": (64, 80, 96, 128, 256)},
               torch.float16: {"flash_fwd": (64, 80, 96, 128, 256),
                               "flash_bwd_dq": (64, 80, 96, 128, 256),
                               "flash_bwd_dkv": (64, 80, 96, 128, 256)}}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
HEAD_DIMS = (32, 64, 128, 40, 80, 96, 256)


def _assert_wgmma_admits(kernel, d, dtype, wgmma):
    tensors = [_model_view(2, 64, 4, d, dtype)] * (3 if kernel == "flash_fwd" else 4)
    routes = attn._routes(kernel, *tensors)
    assert routes == (("simt", "mma", "wgmma") if wgmma else ("simt", "mma"))
    assert attn._route(kernel, *tensors) == routes[-1]


@pytest.mark.parametrize("kernel,d,wgmma", [
    (kernel, d, d in WGMMA_TAKES[torch.bfloat16][kernel])
    for kernel in KERNELS for d in HEAD_DIMS])
def test_wgmma_admits_each_kernels_head_dims(kernel, d, wgmma):
    """wgmma takes head dims 64, 80, 96, 128 and 256 in bf16 for each kernel
    (`WGMMA_TAKES`); every aligned bf16 head dim keeps mma, up to 256."""
    _assert_wgmma_admits(kernel, d, torch.bfloat16, wgmma)


@pytest.mark.parametrize("kernel,d,wgmma", [
    (kernel, d, d in WGMMA_TAKES[torch.float16][kernel])
    for kernel in KERNELS for d in HEAD_DIMS])
def test_wgmma_admits_fp16_at_head_dim_128_alone(kernel, d, wgmma):
    """In fp16 wgmma takes head dims 128, 64, 80, 96 and 256 alone for each
    kernel (`WGMMA_TAKES`); every other aligned fp16 head dim keeps mma for
    all three kernels, up to 256."""
    _assert_wgmma_admits(kernel, d, torch.float16, wgmma)


@pytest.mark.parametrize("case,route", [
    ("fp32_d128", "wgmma"), ("fp32_d128", "mma"), ("bf16_d32", "wgmma"),
    ("bf16_offset_by_one", "mma"), ("bf16_d128", "tma"), ("fp16_d80_offset_by_four", "wgmma"),
    ("fp16_d40", "wgmma"), ("fp16_d96_offset_by_one", "wgmma"), ("bf16_d100", "mma"),
    ("fp16_d96_offset_by_one", "mma"), ("fp16_d256_offset_by_four", "wgmma"),
    ("fp16_d256_offset_by_four", "mma"),
    ("bf16_d100_aligned_rows", "mma"), ("fp16_offset_by_one", "mma"),
    ("fp16_offset_by_one", "wgmma"), ("bf16_d100_offset_by_two", "wgmma"),
    ("bf16_d100_odd_seq_stride", "wgmma"), ("bf16_d100_empty_kv", "wgmma"),
    ("fp16_d100_offset_by_two", "wgmma"), ("fp16_d100_odd_seq_stride", "wgmma"),
    ("fp16_d100", "mma"), ("fp16_d80_offset_by_four", "mma"),
    ("fp32_d80", "wgmma"), ("bf16_d256_offset_by_one", "wgmma"),
    ("bf16_d256_offset_by_one", "mma"), ("bf16_d256_odd_seq_stride", "wgmma"),
    ("fp16_d64_offset_by_one", "wgmma"), ("fp16_d64_offset_by_one", "mma")])
def test_a_route_that_cannot_take_the_inputs_raises(case, route):
    q, k, v = CASES[case][0]()
    before = attn.flash_fwd.launches
    with pytest.raises(ValueError, match=f"route '{route}' cannot take"):
        attn.flash_fwd(q, k, v, causal=False, route=route)
    assert attn.flash_fwd.launches == before


@pytest.mark.parametrize("d", [0, 513, 520])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_a_head_dim_past_the_limit_is_refused(kernel, d):
    """Every wrapper refuses a head dim past 512 (or none), on every route,
    with the limit in its message, before it asks for CUDA and without a
    launch."""
    fn = getattr(attn, kernel)
    q = _bhsd(1, 2, 32, d)
    args = (q, q, q) if kernel == "flash_fwd" else _bwd_args(q, q, q, q)
    before = (fn.launches, dict(fn.launches_by_route))
    for route in (None, "simt", "mma", "wgmma"):
        with pytest.raises(ValueError, match=f"{kernel} takes head_dim 1 to 512, got {d}"):
            fn(*args, route=route)
    assert attn.KERNEL_MAX_HEAD_DIM == 512
    assert (fn.launches, fn.launches_by_route) == before


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_head_dims_past_256_take_simt_alone(kernel):
    """Head dims 257-512 run on simt alone: aligned bf16 at 264 routes to
    simt, and a named mma or wgmma route raises without a launch."""
    fn = getattr(attn, kernel)
    q = _bhsd(1, 2, 32, 264)
    tensors = (q, q, q) if kernel == "flash_fwd" else (q, q, q, q)
    assert attn._routes(kernel, *tensors) == ("simt",)
    args = (q, q, q) if kernel == "flash_fwd" else _bwd_args(q, q, q, q)
    before = (fn.launches, dict(fn.launches_by_route))
    for route in ("mma", "wgmma"):
        with pytest.raises(ValueError, match=f"{kernel} route '{route}' cannot take"):
            fn(*args, route=route)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, route="simt")
    assert (fn.launches, fn.launches_by_route) == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_a_dtype_the_kernels_lack_is_refused(dtype):
    q = _bhsd(1, 2, 32, 64, dtype)
    with pytest.raises(ValueError, match="flash_fwd takes fp32, bf16 or fp16"):
        attn.flash_fwd(q, q, q)


def test_a_route_that_can_take_them_still_needs_cuda():
    q, k, v = CASES["bf16_d128"][0]()
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_fwd(q, k, v, route="mma")


# the backward's inputs (q, k, v, dO) -> the route `_route` must pick for
# both kernels, or for each kernel by name
BWD_CASES = {
    "bf16_d128": (lambda: [_bhsd(1, 4, 64, 128)] * 4, "wgmma"),
    "bf16_d128_gqa": (lambda: [_bhsd(1, 4, 64, 128)] + [_bhsd(1, 2, 64, 128)] * 2
                      + [_bhsd(1, 4, 64, 128)], "wgmma"),
    "model_views_contiguous_do": (lambda: [_model_view(2, 64, 4, 128)] * 3
                                  + [_bhsd(2, 4, 64, 128)], "wgmma"),
    "model_views_transposed_do": (lambda: [_model_view(2, 64, 4, 128)] * 4, "wgmma"),
    "bf16_d64": (lambda: [_bhsd(1, 4, 64, 64)] * 4, "wgmma"),
    "bf16_d32": (lambda: [_bhsd(1, 4, 64, 32)] * 4, "mma"),
    "do_offset_by_one": (lambda: [_bhsd(1, 4, 64, 128)] * 3
                         + [_bhsd(1, 4, 64, 128, offset=1)], "simt"),
    "do_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 128)] * 3
                          + [_bhsd(1, 4, 64, 132)[..., :128]], "simt"),
    "fp32_d128": (lambda: [_bhsd(1, 4, 64, 128, torch.float32)] * 4, "simt"),
    "empty_kv": (lambda: [_bhsd(1, 4, 64, 128), _bhsd(1, 4, 0, 128),
                          _bhsd(1, 4, 0, 128), _bhsd(1, 4, 64, 128)], "mma"),
    "bf16_d96": (lambda: [_bhsd(1, 4, 64, 96)] * 4, "wgmma"),
    "bf16_d96_model_views": (lambda: [_model_view(1, 64, 4, 96)] * 4, "wgmma"),
    # head dim 80 (StableLM-3B's): wgmma for rows aligned as mma's, contiguous
    # and as the model's views; mma for an empty kv, simt for rows 8 bytes
    # off 16
    "bf16_d80": (lambda: [_bhsd(1, 4, 64, 80)] * 4, "wgmma"),
    "bf16_d80_model_views": (lambda: [_model_view(1, 64, 4, 80)] * 4, "wgmma"),
    "bf16_d80_gqa_model_views": (lambda: [_model_view(1, 64, 8, 80)]
                                 + [_model_view(1, 64, 2, 80)] * 2
                                 + [_model_view(1, 64, 8, 80)], "wgmma"),
    "bf16_d80_offset_by_four": (lambda: [_bhsd(1, 4, 64, 80, offset=4)] * 4, "simt"),
    "bf16_d80_empty_kv": (lambda: [_bhsd(1, 4, 64, 80), _bhsd(1, 4, 0, 80),
                                   _bhsd(1, 4, 0, 80), _bhsd(1, 4, 64, 80)], "mma"),
    # head dim 80 in fp16 (OPT-2.7B's published dtype): wgmma for rows
    # aligned as mma's, as the model's views, contiguous and GQA; mma for an
    # empty kv, simt for rows 2 or 8 bytes off 16
    "fp16_d80": (lambda: [_model_view(1, 64, 4, 80, torch.float16)] * 4, "wgmma"),
    "fp16_d80_contiguous": (lambda: [_bhsd(1, 4, 64, 80, torch.float16)] * 4, "wgmma"),
    "fp16_d80_gqa_model_views": (lambda: [_model_view(1, 64, 8, 80, torch.float16)]
                                 + [_model_view(1, 64, 2, 80, torch.float16)] * 2
                                 + [_model_view(1, 64, 8, 80, torch.float16)], "wgmma"),
    "fp16_d80_offset_by_one": (lambda: [_bhsd(1, 4, 64, 80, torch.float16, offset=1)] * 4,
                               "simt"),
    "fp16_d80_offset_by_four": (lambda: [_bhsd(1, 4, 64, 80, torch.float16, offset=4)] * 4,
                                "simt"),
    "fp16_d80_do_offset_by_four": (lambda: [_bhsd(1, 4, 64, 80, torch.float16)] * 3
                                   + [_bhsd(1, 4, 64, 80, torch.float16, offset=4)], "simt"),
    "fp16_d80_empty_kv": (lambda: [_bhsd(1, 8, 64, 80, torch.float16),
                                   _bhsd(1, 8, 0, 80, torch.float16),
                                   _bhsd(1, 8, 0, 80, torch.float16),
                                   _bhsd(1, 8, 64, 80, torch.float16)], "mma"),
    "fp16_d128": (lambda: [_bhsd(1, 4, 64, 128, torch.float16)] * 4, "wgmma"),
    "fp16_d128_model_views": (lambda: [_model_view(1, 64, 4, 128, torch.float16)] * 4,
                              "wgmma"),
    # head dim 96 in fp16 (GPT-NeoX-20B's published dtype): wgmma for rows
    # aligned as mma's, contiguous, GQA and as the model's views; mma for an
    # empty kv, simt for rows 2 or 8 bytes off 16
    "fp16_d96": (lambda: [_bhsd(1, 4, 64, 96, torch.float16)] * 4, "wgmma"),
    "fp16_d96_model_views": (lambda: [_model_view(1, 64, 64, 96, torch.float16)] * 4,
                             "wgmma"),
    "fp16_d96_gqa_contiguous": (lambda: [_bhsd(1, 8, 64, 96, torch.float16)]
                                + [_bhsd(1, 2, 64, 96, torch.float16)] * 2
                                + [_bhsd(1, 8, 64, 96, torch.float16)], "wgmma"),
    "fp16_d96_offset_by_one": (lambda: [_bhsd(1, 4, 64, 96, torch.float16, offset=1)] * 4,
                               "simt"),
    "fp16_d96_offset_by_four": (lambda: [_bhsd(1, 4, 64, 96, torch.float16, offset=4)] * 4,
                                "simt"),
    "fp16_d96_do_offset_by_four": (lambda: [_bhsd(1, 4, 64, 96, torch.float16)] * 3
                                   + [_bhsd(1, 4, 64, 96, torch.float16, offset=4)], "simt"),
    "fp16_d96_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 100, torch.float16)[..., :96]] * 4,
                                "simt"),
    "fp16_d96_empty_kv": (lambda: [_bhsd(1, 8, 64, 96, torch.float16),
                                   _bhsd(1, 8, 0, 96, torch.float16),
                                   _bhsd(1, 8, 0, 96, torch.float16),
                                   _bhsd(1, 8, 64, 96, torch.float16)], "mma"),
    "fp16_d64": (lambda: [_model_view(1, 64, 4, 64, torch.float16)] * 4, "wgmma"),
    "fp16_d64_do_offset_by_one": (lambda: [_model_view(1, 64, 4, 64, torch.float16)] * 3
                                  + [_bhsd(1, 4, 64, 64, torch.float16, offset=1)], "simt"),
    # head dim 256 (Gemma's, 8 q heads over one KV head): wgmma for rows
    # aligned as mma's, in bf16 and in fp16 (GPT-J-6B's published dtype;
    # contiguous, GQA and as the model's views); mma for an empty kv, simt
    # for rows 8 bytes or 2 bytes off 16
    "bf16_d256_gqa_model_views": (lambda: [_model_view(1, 64, 8, 256)]
                                  + [_model_view(1, 64, 1, 256)] * 2
                                  + [_model_view(1, 64, 8, 256)], "wgmma"),
    "bf16_d256_contiguous": (lambda: [_bhsd(1, 8, 64, 256)] + [_bhsd(1, 1, 64, 256)] * 2
                             + [_bhsd(1, 8, 64, 256)], "wgmma"),
    "bf16_d256_offset_by_four": (lambda: [_bhsd(1, 8, 64, 256, offset=4)] * 4, "simt"),
    "bf16_d256_empty_kv": (lambda: [_bhsd(1, 8, 64, 256), _bhsd(1, 1, 0, 256),
                                    _bhsd(1, 1, 0, 256), _bhsd(1, 8, 64, 256)], "mma"),
    "fp16_d256_model_views": (lambda: [_model_view(1, 64, 8, 256, torch.float16)]
                              + [_model_view(1, 64, 1, 256, torch.float16)] * 2
                              + [_model_view(1, 64, 8, 256, torch.float16)], "wgmma"),
    "fp16_d256_mha_model_views": (lambda: [_model_view(1, 64, 16, 256, torch.float16)] * 4,
                                  "wgmma"),
    "fp16_d256_gqa_contiguous": (lambda: [_bhsd(1, 16, 64, 256, torch.float16)]
                                 + [_bhsd(1, 8, 64, 256, torch.float16)] * 2
                                 + [_bhsd(1, 16, 64, 256, torch.float16)], "wgmma"),
    "fp16_d256_offset_by_one": (lambda: [_bhsd(1, 4, 64, 256, torch.float16, offset=1)] * 4,
                                "simt"),
    "fp16_d256_offset_by_four": (lambda: [_bhsd(1, 4, 64, 256, torch.float16, offset=4)] * 4,
                                 "simt"),
    "fp16_d256_do_offset_by_four": (lambda: [_bhsd(1, 4, 64, 256, torch.float16)] * 3
                                    + [_bhsd(1, 4, 64, 256, torch.float16, offset=4)], "simt"),
    "fp16_d256_empty_kv": (lambda: [_bhsd(1, 8, 64, 256, torch.float16),
                                    _bhsd(1, 1, 0, 256, torch.float16),
                                    _bhsd(1, 1, 0, 256, torch.float16),
                                    _bhsd(1, 8, 64, 256, torch.float16)], "mma"),
    # head dim 100 (OpenLLaMA-3B's): wgmma for 8-byte aligned bases and
    # strides that are multiples of 4, in bf16 and fp16, simt otherwise
    "bf16_d100": (lambda: [_bhsd(1, 4, 64, 100)] * 4, "wgmma"),
    "bf16_d100_model_views": (lambda: [_model_view(1, 64, 4, 100)] * 4, "wgmma"),
    "bf16_d100_aligned_rows": (lambda: [_bhsd(1, 4, 64, 104)[..., :100]] * 4, "wgmma"),
    "bf16_d100_offset_by_four": (lambda: [_bhsd(1, 4, 64, 100, offset=4)] * 4, "wgmma"),
    "bf16_d100_offset_by_one": (lambda: [_bhsd(1, 4, 64, 100, offset=1)] * 4, "simt"),
    "bf16_d100_do_offset_by_two": (lambda: [_bhsd(1, 4, 64, 100)] * 3
                                   + [_bhsd(1, 4, 64, 100, offset=2)], "simt"),
    "bf16_d100_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 102)[..., :100]] * 4, "simt"),
    "bf16_d100_empty_kv": (lambda: [_bhsd(1, 4, 64, 100), _bhsd(1, 4, 0, 100),
                                    _bhsd(1, 4, 0, 100), _bhsd(1, 4, 64, 100)], "simt"),
    "fp16_d100": (lambda: [_bhsd(1, 4, 64, 100, torch.float16)] * 4, "wgmma"),
    "fp16_d100_model_views": (lambda: [_model_view(1, 64, 4, 100, torch.float16)] * 4,
                              "wgmma"),
    "fp16_d100_gqa_model_views": (lambda: [_model_view(1, 64, 8, 100, torch.float16)]
                                  + [_model_view(1, 64, 2, 100, torch.float16)] * 2
                                  + [_model_view(1, 64, 8, 100, torch.float16)], "wgmma"),
    "fp16_d100_offset_by_four": (lambda: [_bhsd(1, 4, 64, 100, torch.float16, offset=4)]
                                 * 4, "wgmma"),
    "fp16_d100_offset_by_one": (lambda: [_bhsd(1, 4, 64, 100, torch.float16, offset=1)]
                                * 4, "simt"),
    "fp16_d100_do_offset_by_two": (lambda: [_bhsd(1, 4, 64, 100, torch.float16)] * 3
                                   + [_bhsd(1, 4, 64, 100, torch.float16, offset=2)], "simt"),
    "fp16_d100_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 102, torch.float16)[..., :100]]
                                 * 4, "simt"),
    "fp16_do_offset_by_one": (lambda: [_bhsd(1, 4, 64, 128, torch.float16)] * 3
                              + [_bhsd(1, 4, 64, 128, torch.float16, offset=1)], "simt"),
}


def _bwd_args(q, k, v, do):
    lse = torch.zeros(q.shape[:3])
    return q, k, v, do, lse, lse


BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_route_follows_the_inputs(case):
    make, want = BWD_CASES[case]
    q, k, v, do = make()
    for kernel in BWD_KERNELS:
        want_k = want[kernel] if isinstance(want, dict) else want
        assert attn._route(kernel, q, k, v, do) == want_k, kernel
        assert attn._routes(kernel, q, k, v, do)[-1] == want_k, kernel
        assert "simt" in attn._routes(kernel, q, k, v, do)


# (case, route) both backward kernels must refuse (fp16 has wgmma backward
# kernels at head dims 64, 80, 96, 100, 128 and 256 alone, for aligned rows;
# bf16 and fp16 at 80, 96 and 256 none for rows off 16 bytes or an empty kv,
# and at 100, in bf16 and fp16, none for rows off 8 bytes, strides off 4
# elements or an empty kv; no mma kernel takes 200-byte rows)
BWD_REFUSALS = [("fp32_d128", "wgmma"), ("fp32_d128", "mma"), ("bf16_d32", "wgmma"),
                ("do_offset_by_one", "mma"), ("do_odd_seq_stride", "wgmma"),
                ("empty_kv", "wgmma"), ("bf16_d128", "tma"), ("fp16_d80_offset_by_one", "wgmma"),
                ("fp16_d80_offset_by_one", "mma"), ("fp16_d80_offset_by_four", "wgmma"),
                ("fp16_d80_do_offset_by_four", "wgmma"), ("fp16_d80_empty_kv", "wgmma"),
                ("fp16_d64_do_offset_by_one", "wgmma"), ("fp16_d96_offset_by_one", "wgmma"),
                ("fp16_d96_offset_by_one", "mma"), ("fp16_d96_offset_by_four", "wgmma"),
                ("fp16_d96_offset_by_four", "mma"), ("fp16_d96_do_offset_by_four", "wgmma"),
                ("fp16_d96_odd_seq_stride", "wgmma"), ("fp16_d96_empty_kv", "wgmma"),
                ("bf16_d100", "mma"), ("fp16_d64_do_offset_by_one", "mma"),
                ("fp16_do_offset_by_one", "mma"), ("fp16_do_offset_by_one", "wgmma"),
                ("bf16_d100_model_views", "mma"), ("bf16_d80_offset_by_four", "wgmma"),
                ("bf16_d80_offset_by_four", "mma"), ("bf16_d80_empty_kv", "wgmma"),
                ("bf16_d100_offset_by_one", "wgmma"), ("bf16_d100_do_offset_by_two", "wgmma"),
                ("bf16_d100_odd_seq_stride", "wgmma"), ("bf16_d100_empty_kv", "wgmma"),
                ("fp16_d100", "mma"), ("fp16_d256_offset_by_one", "wgmma"),
                ("fp16_d256_offset_by_one", "mma"), ("fp16_d256_offset_by_four", "wgmma"),
                ("fp16_d256_offset_by_four", "mma"), ("fp16_d256_do_offset_by_four", "wgmma"),
                ("fp16_d256_empty_kv", "wgmma"), ("bf16_d256_offset_by_four", "wgmma"), ("bf16_d256_offset_by_four", "mma"),
                ("bf16_d256_empty_kv", "wgmma"), ("fp16_d100_offset_by_one", "wgmma"),
                ("fp16_d100_do_offset_by_two", "wgmma"),
                ("fp16_d100_odd_seq_stride", "wgmma"), ("fp16_d100_model_views", "mma")]


@pytest.mark.parametrize("fn,case,route", [
    pytest.param(fn, case, route, id=f"{case}-{route}-{fn.__name__}")
    for case, route in BWD_REFUSALS
    for fn in (attn.flash_bwd_dq, attn.flash_bwd_dkv)])
def test_a_backward_route_that_cannot_take_the_inputs_raises(fn, case, route):
    args = _bwd_args(*BWD_CASES[case][0]())
    before = (fn.launches, dict(fn.launches_by_route))
    with pytest.raises(ValueError, match=f"{fn.__name__} route '{route}' cannot take"):
        fn(*args, causal=False, route=route)
    assert (fn.launches, fn.launches_by_route) == before


@pytest.mark.parametrize("fn", [attn.flash_bwd_dq, attn.flash_bwd_dkv],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("route", ["wgmma", "mma", "simt"])
def test_a_backward_route_that_can_take_them_still_needs_cuda(fn, route):
    args = _bwd_args(*BWD_CASES["bf16_d128"][0]())
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, route=route)


def _a_models_launch_routes(monkeypatch, cfg):
    """The routes of the flash launches of one loss gradient of `cfg`'s one
    layer through the autograd node of the kernels, with the kernels'
    launchers replaced by recorders on the CPU: [(kernel, route)] in launch
    order. The forward's inputs are the model's [B, S, H, D] views; the
    backward launchers get the g_out that `_FlashFwd.backward` hands them,
    with q, k and v."""
    seen = []

    def fwd(q, k, v, causal=True, window=None):
        seen.append(("flash_fwd", attn._route("flash_fwd", q, k, v)))
        return attn.reference_attention_with_lse(q, k, v, causal, window)

    def bwd(name, q, k, v, do, lse, delta, causal=True, window=None, out_scale=None):
        seen.append((name, attn._route(name, q, k, v, do)))
        return attn.flash_backward_reference(q, k, v, q, lse, do, causal, window,
                                             out_scale=out_scale)

    monkeypatch.setattr(attn, "flash_fwd", fwd)
    monkeypatch.setattr(attn, "flash_bwd_dq", lambda *a, **kw: bwd("flash_bwd_dq", *a, **kw)[0])
    monkeypatch.setattr(attn, "flash_bwd_dkv", lambda *a, **kw: (
        [t.repeat_interleave(2, dim=1) for t in bwd("flash_bwd_dkv", *a, **kw)[1:]]))
    monkeypatch.setattr(attn, "_attention", lambda q, k, v, causal, window: (
        attn._FlashFwd.apply(q, k, v, causal, window)))
    params = init_llama(cfg, seed=0, device="cpu")
    for t in params["layers"][0].values():
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(0))
    llama_loss(params, tokens, cfg, remat=True).backward()
    return seen


def _one_layer(dim, dtype="bfloat16"):
    return dataclasses.replace(LlamaConfig.tiny(), dim=dim, n_heads=2, n_kv_heads=1,
                               n_layers=1, dtype=dtype)


def test_the_models_backward_lands_on_wgmma(monkeypatch):
    """A bf16 layer at head_dim 128 (`_a_models_launch_routes`): the
    forward's inputs take the forward's wgmma route, and the g_out that
    `_FlashFwd.backward` hands to both backward launchers, with q, k and v,
    takes the backward's."""
    cfg = _one_layer(256)
    assert cfg.head_dim == 128
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", "wgmma"),
        ("flash_bwd_dkv", "wgmma")]


def test_the_models_backward_at_head_dim_64(monkeypatch):
    """As above at head_dim 64 (bench_mfu's d1024 widths): the forward and
    both backward launchers take wgmma."""
    cfg = _one_layer(128)
    assert cfg.head_dim == 64
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", "wgmma"),
        ("flash_bwd_dkv", "wgmma")]


def test_the_models_backward_at_head_dim_100(monkeypatch):
    """As above at head_dim 100 (OpenLLaMA-3B's widths), whose model views
    put every other head's rows 8 bytes off a 16-byte boundary: the forward
    and both backward launchers take wgmma, on the kernels whose producers
    copy the rows with cp.async."""
    cfg = dataclasses.replace(_one_layer(200), n_kv_heads=2)
    assert cfg.head_dim == 100
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", "wgmma"),
        ("flash_bwd_dkv", "wgmma")]


def test_the_models_backward_at_head_dim_80(monkeypatch):
    """As above at head_dim 80 (StableLM-3B-4E1T's widths), MHA and GQA: the
    forward and both backward launchers take wgmma, on the head-dim-80
    kernels."""
    for kv_heads in (2, 1):
        cfg = dataclasses.replace(_one_layer(160), n_kv_heads=kv_heads)
        assert cfg.head_dim == 80
        assert _a_models_launch_routes(monkeypatch, cfg) == [
            ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", "wgmma"),
            ("flash_bwd_dkv", "wgmma")]


def test_the_models_backward_at_head_dim_96(monkeypatch):
    """As above at head_dim 96 (Phi-3-mini's widths): the forward and both
    backward launchers take wgmma, dQ on its head-dim-96 kernel."""
    cfg = _one_layer(192)
    assert cfg.head_dim == 96
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", "wgmma"),
        ("flash_bwd_dkv", "wgmma")]


def test_the_fp16_models_backward_lands_on_wgmma(monkeypatch):
    """As above in fp16 at head_dim 128 (Llama-2-7B in its published
    weights' dtype): the forward, dQ and dK/dV take their fp16 wgmma
    kernels, the backward with the cotangent that `_FlashFwd.backward`
    scales in fp16."""
    cfg = _one_layer(256, "float16")
    assert cfg.head_dim == 128
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", "wgmma"),
        ("flash_bwd_dkv", "wgmma")]


@pytest.mark.parametrize("d,route", [(64, "wgmma"), (128, "wgmma"), (32, "mma"),
                                     (96, "wgmma"), (100, "wgmma"), (80, "wgmma"),
                                     (256, "wgmma")])
def test_the_smokes_routes_are_the_routes_picks(d, route):
    """chip_smoke's one expectation of the routes at a SHAPES row
    (`shape_routes`) against `_route` on the model's views at head dim `d`:
    at 64, 80, 96, 100, 128 and 256 every kernel on wgmma, dQ's among them;
    at 32, which no wgmma kernel takes, every kernel on mma."""
    import chip_smoke

    want = chip_smoke.shape_routes(route)
    assert want == dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), route)
    q, k, v, do = [_model_view(2, 64, 4, d)] * 4
    assert attn._route("flash_fwd", q, k, v) == want["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attn._route(name, q, k, v, do) == want[name]


def test_bench_mfu_train_expects_no_mma_launch():
    """chip_smoke's expected launches over bench_mfu's train candidates
    (the d1024 widths at head dim 64, d2048 and 7B at 128; a warm step and
    the timed ones, per layer the forward twice under remat and each
    backward kernel once): every one on the wgmma route, the 264 dQ
    launches at head dim 64 among them."""
    import chip_smoke
    from yoda_scheduler_tpu_torch import bench_mfu

    assert chip_smoke.bench_train_routes(bench_mfu) == {
        "flash_fwd": {"wgmma": 1584}, "flash_bwd_dq": {"wgmma": 792},
        "flash_bwd_dkv": {"wgmma": 792}}
    d64 = sum(cfg.n_layers for cfg, _, _ in bench_mfu.train_candidates(True)
              if cfg.head_dim == 64)
    assert d64 * (1 + bench_mfu.CARD_TRAIN_STEPS) == 264


def test_the_smokes_fp16_routes_are_the_routes_picks():
    """chip_smoke's fp16 expectation (the forward, dQ and dK/dV on wgmma)
    against `_route` on the model's fp16 views at head dim 128, and every
    fp16 row of its SHAPES at 128 naming it."""
    import chip_smoke

    want = chip_smoke.shape_routes("wgmma")
    assert want == {"flash_fwd": "wgmma", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}
    q, k, v, do = [_model_view(2, 64, 4, 128, torch.float16)] * 4
    assert attn._route("flash_fwd", q, k, v) == want["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attn._route(name, q, k, v, do) == want[name]
    rows = _fp16_rows()
    assert {row[0] for row in rows} == {
        "fp16_main", "fp16_main_bshd", "fp16_gqa_bshd", "fp16_window_512",
        "fp16_ragged_300", "fp16_cross_length"}
    assert all(row[-1] == "wgmma" for row in rows)
    assert "fp16_main" in chip_smoke.TURN_SHAPES


def _fp16_rows():
    import chip_smoke

    return [row for row in chip_smoke.SHAPES if row[9] == torch.float16 and row[6] == 128]


@pytest.mark.parametrize("row", _fp16_rows(), ids=lambda row: row[0])
def test_the_smokes_fp16_rows_take_their_routes(row):
    """Each fp16 row of chip_smoke at head dim 128 on the CPU in its layout:
    `_route` picks the route it names for each kernel."""
    import chip_smoke

    q, k, v, do = _smoke_row_tensors(row)
    want = chip_smoke.shape_routes(row[-1])
    assert attn._route("flash_fwd", q, k, v) == want["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attn._route(name, q, k, v, do) == want[name]


def test_phi3_train_expects_every_launch_on_wgmma():
    """chip_smoke's expected launches of a phi3_train step (Phi-3-mini's 32
    layers at head dim 96; the forward twice a layer under remat, each
    backward kernel once): all three kernels on wgmma, as `_route` picks
    them on the model's views at its head dim."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import phi3_mini

    cfg = phi3_mini()
    want = chip_smoke.step_routes("wgmma", cfg.n_layers)
    assert want == {"flash_fwd": {"wgmma": 64}, "flash_bwd_dq": {"wgmma": 32},
                    "flash_bwd_dkv": {"wgmma": 32}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim)] * 4
    assert {attn._route("flash_fwd", q, k, v)} == set(want["flash_fwd"])
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert {attn._route(name, q, k, v, do)} == set(want[name])


def test_fp16_gradient_expects_the_forward_on_wgmma():
    """chip_smoke's expected launches of the 4-layer fp16 gradient at
    Llama-2-7B width: 8 forward launches on wgmma, and 4 of dQ and of dK/dV
    on wgmma too, as `_route` picks them on the model's fp16 views at head
    dim 128."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.models import LlamaConfig as Cfg

    cfg = Cfg.llama2_7b()
    want = chip_smoke.step_routes("wgmma", 4)
    assert want == {"flash_fwd": {"wgmma": 8}, "flash_bwd_dq": {"wgmma": 4},
                    "flash_bwd_dkv": {"wgmma": 4}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim, torch.float16)] * 4
    assert {attn._route("flash_fwd", q, k, v)} == set(want["flash_fwd"])
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert {attn._route(name, q, k, v, do)} == set(want[name])


def _smoke_row_tensors(row, seq=64):
    """A chip_smoke SHAPES row's q, k, v, dO as zeros on the CPU in its
    layout (`rand_inputs`'s), at a short sequence: routes do not depend on
    it."""
    _, b, h, kvh, _, _, d, _, _, dtype, layout, _ = row
    out = []
    for heads in (h, kvh, kvh, h):
        shape = (b, heads, seq, d)
        x = torch.zeros(b * heads * seq * d + (layout == "offset1"), dtype=dtype)
        x = x[int(layout == "offset1"):]
        out.append(x.view(b, seq, heads, d).transpose(1, 2) if layout == "bshd"
                   else x.view(shape))
    return out


def _wide_rows():
    import chip_smoke

    return [row for row in chip_smoke.SHAPES if row[0] in chip_smoke.WIDE_SHAPES]


@pytest.mark.parametrize("row", _wide_rows(), ids=lambda row: row[0])
def test_the_smokes_wide_rows_take_their_routes(row):
    """Each row chip_smoke adds at the new head dims and in fp16 names the
    route `_route` picks for each kernel there: wgmma at head dims 80, 96,
    100 and 256 in bf16 and in fp16 at 64, 80, 96, 100, 128 and 256 aligned
    (not one element into its storage), for every kernel."""
    import chip_smoke

    q, k, v, do = _smoke_row_tensors(row)
    want = chip_smoke.shape_routes(row[-1])
    assert attn._route("flash_fwd", q, k, v) == want["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attn._route(name, q, k, v, do) == want[name]
    aligned_bf16 = row[9] == torch.bfloat16 and row[10] != "offset1"
    aligned_fp16 = row[9] == torch.float16 and row[10] != "offset1"
    every = ((row[6] in (80, 96, 100, 256) and aligned_bf16)
             or (row[6] in (64, 80, 96, 100, 128, 256) and aligned_fp16))
    assert ("wgmma" in attn._routes("flash_fwd", q, k, v)) == every
    assert ("wgmma" in attn._routes("flash_bwd_dkv", q, k, v, do)) == every
    assert ("wgmma" in attn._routes("flash_bwd_dq", q, k, v, do)) == every
    assert row[6] <= attn.KERNEL_MAX_HEAD_DIM


def test_the_smoke_covers_each_new_width_and_dtype():
    """chip_smoke's wide rows reach every padded width of the simt and mma
    kernels that is not a width of its own, fp16 on every route, and the
    head dims 40, 80, 96, 100, 256, and 320 past the mma kernels' widest
    (a row's routes: every route `_routes` admits there for its forward and
    its backward kernels, each of which the smoke holds against the plain
    version)."""
    import chip_smoke

    def admitted(row):
        q, k, v, do = _smoke_row_tensors(row)
        return {*attn._routes("flash_fwd", q, k, v),
                *(r for name in BWD_KERNELS for r in attn._routes(name, q, k, v, do))}

    rows = _wide_rows()
    assert {row[6] for row in rows} >= {40, 80, 96, 100, 256, 320}
    assert {row[9] for row in rows if row[6] > 256} >= {torch.float32, torch.bfloat16}
    assert {(row[9], r) for row in rows for r in admitted(row)} >= {
        (torch.float16, "wgmma"),
        (torch.float16, "mma"), (torch.float16, "simt"), (torch.bfloat16, "mma"),
        (torch.bfloat16, "simt"), (torch.float32, "simt")}
    assert chip_smoke.REFUSED_HEAD_DIM > attn.KERNEL_MAX_HEAD_DIM
    assert set(chip_smoke.HEAD_DIM_ROWS) <= set(chip_smoke.WIDE_SHAPES)


def test_d96_on_mma_puts_every_kernel_on_mma_and_restores():
    """`profile_path.d96_on_mma`, the route set the Phi-3 step is timed
    against: within it head dim 96 takes mma for the forward, dQ and dK/dV;
    after it each takes wgmma again, and fp16 at 128 keeps its wgmma
    forward throughout."""
    from yoda_scheduler_tpu_torch.profile_path import d96_on_mma

    q, k, v, do = [_model_view(1, 64, 4, 96)] * 4
    h = [_model_view(1, 64, 4, 128, torch.float16)] * 3
    with d96_on_mma():
        assert attn._route("flash_fwd", q, k, v) == "mma"
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert attn._route(name, q, k, v, do) == "mma"
        assert attn._route("flash_fwd", *h) == "wgmma"
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attn._route(name, q, k, v, do) == "wgmma"


def test_fp16_backward_on_mma_moves_the_backward_alone_and_restores():
    """`profile_path.fp16_backward_on_mma(128)` and `(64)`, the route sets the
    fp16 gradients (Llama-2-7B's at head dim 128, OPT-1.3B's at 64) are
    timed against: within each fp16 takes mma for dQ and dK/dV at its head
    dim while the forward
    keeps wgmma, and bf16 keeps wgmma for every kernel; after it
    `_WGMMA_HEAD_DIMS` is exactly what it was, and the fp16 backward takes
    wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import fp16_backward_on_mma

    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    for d in (128, 64):
        h = [_model_view(1, 64, 4, d, torch.float16)] * 4
        b = [_model_view(1, 64, 4, d)] * 4
        with fp16_backward_on_mma(d):
            assert attn._route("flash_fwd", *h[:3]) == "wgmma"
            for name in ("flash_bwd_dq", "flash_bwd_dkv"):
                assert attn._route(name, *h) == "mma"
                assert attn._route(name, *b) == "wgmma"
        assert attn._WGMMA_HEAD_DIMS == saved
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert attn._route(name, *h) == "wgmma"


# head dims 80 (StableLM-3B-4E1T's) and 100 (OpenLLaMA-3B's): every kernel
# has a wgmma kernel at each in bf16 (after mma at 80; straight after simt
# at 100: no mma kernel takes rows that are no multiple of 8 elements)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d,fwd,bwd", [(80, ("simt", "mma", "wgmma"), ("simt", "mma", "wgmma")),
                                       (100, ("simt", "wgmma"), ("simt", "wgmma"))])
def test_the_forward_alone_takes_wgmma_at_head_dims_80_and_100(d, fwd, bwd, layout):
    """bf16, contiguous and as the model's views: the forward's routes end in
    wgmma (after mma at 80, straight after simt at 100), and dQ's and
    dK/dV's too (since their head-dim-80 kernels, at 80 as well)."""
    q, k, v, do = ([_bhsd(1, 4, 64, d)] if layout == "bhsd" else [_model_view(1, 64, 4, d)]) * 4
    assert attn._routes("flash_fwd", q, k, v) == fwd
    for kernel in BWD_KERNELS:
        assert attn._routes(kernel, q, k, v, do) == bwd


@pytest.mark.parametrize("d", [80, 100])
@pytest.mark.parametrize("dtype,offset", [(torch.float16, 2), (torch.float32, 0),
                                          (torch.bfloat16, 1), (torch.bfloat16, 2)])
def test_no_wgmma_forward_at_80_or_100_but_aligned_bf16(d, dtype, offset):
    """fp32 at those widths, and bf16 and fp16 rows that start one or two
    elements into their storage (2 or 4 bytes off an 8-byte boundary), take
    no wgmma route, and a named one raises with no launch (aligned fp16 has
    the forward's wgmma kernels there since OPT-2.7B's path)."""
    q = _bhsd(1, 4, 64, d, dtype, offset=offset)
    assert "wgmma" not in attn._routes("flash_fwd", q, q, q)
    before = (attn.flash_fwd.launches, dict(attn.flash_fwd.launches_by_route))
    with pytest.raises(ValueError, match="route 'wgmma' cannot take"):
        attn.flash_fwd(q, q, q, route="wgmma")
    assert (attn.flash_fwd.launches, attn.flash_fwd.launches_by_route) == before


@pytest.mark.parametrize("dim,bwd", [(160, "wgmma"), (200, "wgmma")])
def test_the_models_forward_at_head_dims_80_and_100(monkeypatch, dim, bwd):
    """A bf16 layer at head_dim 80 and 100 (`_a_models_launch_routes`):
    both forward launches take wgmma, and the backward launchers their
    head-dim-80 and head-dim-100 wgmma kernels."""
    cfg = _one_layer(dim)
    assert cfg.head_dim == dim // 2
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", bwd),
        ("flash_bwd_dkv", bwd)]


def test_the_new_width_configs_have_their_published_widths():
    """`profile_path.openllama_3b` and `stablelm_3b_4e1t` against their
    published config.json (hidden, layers, heads, KV heads, head dim,
    intermediate, vocab, rope theta, norm eps, positions), bf16."""
    from yoda_scheduler_tpu_torch.profile_path import openllama_3b, stablelm_3b_4e1t

    fields = ("dim", "n_layers", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "rope_theta", "norm_eps", "max_seq_len", "dtype")
    for cfg, want in ((openllama_3b(), (3200, 26, 32, 32, 100, 8640, 32000, 10000.0, 1e-6,
                                        2048, "bfloat16")),
                      (stablelm_3b_4e1t(), (2560, 32, 32, 32, 80, 6912, 50304, 10000.0,
                                            1e-5, 4096, "bfloat16"))):
        assert tuple(getattr(cfg, f) for f in fields) == want
        assert not cfg.is_moe and cfg.sliding_window is None


def test_the_new_width_forwards_expect_every_launch_on_wgmma():
    """chip_smoke's openllama3b_forward and stablelm3b_forward expect one
    flash_fwd launch a layer on wgmma (`phase_forward`'s route): `_route`
    picks it on each config's model views at its head dim, and each old
    route set (`profile_path.d100_forward_on_simt`, `d80_forward_on_mma`)
    moves the forward alone, to simt at 100 and mma at 80 (the backward on
    wgmma at both), and restores."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import (d80_forward_on_mma,
                                                       d100_forward_on_simt, openllama_3b,
                                                       stablelm_3b_4e1t)

    assert chip_smoke.shape_routes("wgmma")["flash_fwd"] == "wgmma"
    saved = dict(attn._WGMMA_HEAD_DIMS)
    for cfg, old_routes, old, bwd in ((openllama_3b(), d100_forward_on_simt, "simt", "wgmma"),
                                      (stablelm_3b_4e1t(), d80_forward_on_mma, "mma", "wgmma")):
        q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim)] * 4
        other = [_model_view(1, 64, 4, 96)] * 3
        assert attn._route("flash_fwd", q, k, v) == "wgmma"
        with old_routes():
            assert attn._route("flash_fwd", q, k, v) == old
            assert attn._route("flash_fwd", *other) == "wgmma"
            for name in BWD_KERNELS:
                assert attn._route(name, q, k, v, do) == bwd
        assert attn._WGMMA_HEAD_DIMS == saved
        assert attn._route("flash_fwd", q, k, v) == "wgmma"


def test_shape_routes_takes_a_forward_and_backward_pair():
    """`shape_routes` takes one route for all three kernels, and every SHAPES
    row names one (no row takes a (forward, backward kernels) pair any
    more: every row at 64 in fp16, 80, 100 or 256 is on wgmma); the smoke's forward turn rows are among its wide rows,
    each with a route before wgmma to be timed against (simt at 100, mma
    elsewhere), the fp16 rows at 80, 96, 100 and 256 among them; its
    backward turn rows are the twelve at 80, 100, 256 and in fp16 at 64, 80,
    96, 100 and 256, where dQ and dK/dV took mma or simt before their wgmma
    kernels, timed beside SDPA's default backend (cuDNN) at 80, 96, 256 and
    64 and its flash backend at 100."""
    import chip_smoke

    assert chip_smoke.shape_routes("simt") == {
        "flash_fwd": "simt", "flash_bwd_dq": "simt", "flash_bwd_dkv": "simt"}
    assert all(isinstance(row[-1], str) for row in chip_smoke.SHAPES)
    rows = {row[0]: row for row in chip_smoke.SHAPES}
    assert set(chip_smoke.FWD_TURN_SHAPES) <= set(chip_smoke.WIDE_SHAPES)
    assert {(rows[n][6], rows[n][9], rows[n][10]) for n in chip_smoke.FWD_TURN_SHAPES} == {
        (80, torch.bfloat16, "bhsd"), (80, torch.bfloat16, "bshd"),
        (100, torch.bfloat16, "bhsd"), (100, torch.bfloat16, "bshd"),
        (256, torch.bfloat16, "bshd"), (64, torch.float16, "bshd"),
        (80, torch.float16, "bshd"), (100, torch.float16, "bshd"),
        (96, torch.float16, "bshd"), (256, torch.float16, "bshd")}
    for name in chip_smoke.FWD_TURN_SHAPES:
        old = "simt" if rows[name][6] == 100 else "mma"
        q, k, v, _ = _smoke_row_tensors(rows[name])
        assert chip_smoke.shape_routes(rows[name][-1])["flash_fwd"] == "wgmma"
        assert attn._routes("flash_fwd", q, k, v)[-2:] == (old, "wgmma")
    turns = chip_smoke.BWD_TURN_SHAPES
    assert set(turns) == (set(chip_smoke.FWD_TURN_SHAPES)
                          | {"opt13b_d64_bshd", "fp16_unaligned_d100"})
    assert set(turns) <= set(chip_smoke.WIDE_SHAPES)
    for name, backend in turns.items():
        d = rows[name][6]
        assert backend == ("flash" if d == 100 else "default"), name
        q, k, v, do = _smoke_row_tensors(rows[name])
        want = ("simt", "wgmma") if d == 100 else ("simt", "mma", "wgmma")
        for kernel in BWD_KERNELS:
            assert attn._routes(kernel, q, k, v, do) == want, name


def test_d100_backward_on_simt_moves_the_backward_alone_and_restores():
    """`profile_path.d100_backward_on_simt`, the route set OpenLLaMA-3B's
    gradient and train step are timed against: within it head dim 100 takes
    simt for dQ and dK/dV while the forward keeps wgmma, and head dim 96
    keeps wgmma for every kernel; after it `_WGMMA_HEAD_DIMS` is exactly what
    it was, and the backward at 100 takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import d100_backward_on_simt

    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 4, 100)] * 4
    other = [_model_view(1, 64, 4, 96)] * 4
    with d100_backward_on_simt():
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "simt"
            assert attn._route(name, *other) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_openllama3b_gradient_and_train_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of openllama3b_gradient (4 layers:
    8/4/4) and of an openllama3b_train step (all 26 layers, the forward
    twice a layer under remat and each backward kernel once: 52/26/26), all
    on wgmma, as `_route` picks them on the model's views at head dim 100;
    both phases appear in the kernels line's launches by path."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import openllama_3b

    cfg = openllama_3b()
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 52}, "flash_bwd_dq": {"wgmma": 26},
        "flash_bwd_dkv": {"wgmma": 26}}
    assert chip_smoke.step_routes("wgmma", 4) == {
        "flash_fwd": {"wgmma": 8}, "flash_bwd_dq": {"wgmma": 4},
        "flash_bwd_dkv": {"wgmma": 4}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("openllama3b_gradient", "openllama3b_train_step"):
        assert main.count(f'"{path}": openllama_') == 2, path


# head dim 256 in bf16 (Gemma's) and 64 in fp16 (OPT-1.3B's): the forward has
# a wgmma kernel at each, and so have dQ and dK/dV (since their head-dim-256
# kernels, and their fp16 head-dim-64 kernels); unaligned rows fall to simt
# as before
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d,dtype", [(256, torch.bfloat16), (64, torch.float16)])
def test_the_forward_alone_takes_wgmma_at_256_and_fp16_64(d, dtype, layout):
    q, k, v, do = ([_bhsd(1, 8, 64, d, dtype)] if layout == "bhsd"
                   else [_model_view(1, 64, 8, d, dtype)]) * 4
    assert attn._routes("flash_fwd", q, k, v) == ("simt", "mma", "wgmma")
    for kernel in BWD_KERNELS:
        assert attn._routes(kernel, q, k, v, do) == ("simt", "mma", "wgmma")
    off = _bhsd(1, 8, 64, d, dtype, offset=1)
    assert attn._routes("flash_fwd", off, off, off) == ("simt",)


@pytest.mark.parametrize("dim,dtype,bwd", [(512, "bfloat16", "wgmma"),
                                           (128, "float16", "wgmma")])
def test_the_models_forward_at_256_and_fp16_64(monkeypatch, dim, dtype, bwd):
    """A layer at head_dim 256 over one KV head in bf16 (Gemma's), and at 64
    in fp16 (OPT-1.3B's) (`_a_models_launch_routes`): both forward launches
    take wgmma, and the backward launchers their head-dim-256 wgmma kernels
    in bf16 and their fp16 head-dim-64 wgmma kernels in fp16."""
    cfg = _one_layer(dim, dtype)
    assert cfg.head_dim == dim // 2 and cfg.n_kv_heads == 1
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", bwd),
        ("flash_bwd_dkv", bwd)]


def test_the_gemma_and_opt_configs_have_their_published_widths():
    """`profile_path.gemma_2b` and `opt_1_3b` against their published
    config.json (hidden, layers, heads, KV heads, head dim, intermediate,
    vocab, rope theta, norm eps, positions, dtype): Gemma-2B's head dim 256
    is hidden / heads, so the Llama config holds it with no field of its
    own."""
    from yoda_scheduler_tpu_torch.profile_path import gemma_2b, opt_1_3b

    fields = ("dim", "n_layers", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "rope_theta", "norm_eps", "max_seq_len", "dtype")
    for cfg, want in ((gemma_2b(), (2048, 18, 8, 1, 256, 16384, 256000, 10000.0, 1e-6,
                                    8192, "bfloat16")),
                      (opt_1_3b(), (2048, 24, 32, 32, 64, 8192, 50272, 10000.0, 1e-5,
                                    2048, "float16"))):
        assert tuple(getattr(cfg, f) for f in fields) == want
        assert not cfg.is_moe and cfg.sliding_window is None


def test_d256_and_fp16_d64_forward_on_mma_move_the_forward_alone_and_restore():
    """`profile_path.d256_forward_on_mma` and `fp16_d64_forward_on_mma`, the
    route sets the Gemma-2B and OPT-1.3B forwards are timed against: within
    each the forward at its width and dtype takes mma, while the backward
    keeps its wgmma kernels, the other dtype at that width keeps its wgmma
    forward and head dim 128 keeps wgmma; after it `_WGMMA_HEAD_DIMS` is
    exactly what it was."""
    from yoda_scheduler_tpu_torch.profile_path import (d256_forward_on_mma,
                                                       fp16_d64_forward_on_mma)

    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    for routes, d, dtype, other, bwd in (
            (d256_forward_on_mma, 256, torch.bfloat16, None, "wgmma"),
            (fp16_d64_forward_on_mma, 64, torch.float16, torch.bfloat16, "wgmma")):
        t = [_model_view(1, 64, 8, d, dtype)] * 4
        rest = [[_model_view(1, 64, 8, 128, dt)] * 3 for dt in (torch.bfloat16, torch.float16)]
        if other is not None:
            rest.append([_model_view(1, 64, 8, d, other)] * 3)
        with routes():
            assert attn._route("flash_fwd", *t[:3]) == "mma"
            for name in BWD_KERNELS:
                assert attn._route(name, *t) == bwd
            for r in rest:
                assert attn._route("flash_fwd", *r) == "wgmma"
        assert attn._WGMMA_HEAD_DIMS == saved
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"


def test_the_gemma_and_opt_forwards_expect_every_launch_on_wgmma():
    """chip_smoke's gemma2b_forward and opt13b_fp16_forward expect one
    flash_fwd launch a layer on wgmma (`phase_forward`'s route), 18 and 24:
    `_route` picks it on each config's model views at its head dim and
    dtype; both run in main's loop of forward phases, timed in turns
    against the forward on mma, and the build expects both new kernels."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import gemma_2b, opt_1_3b

    assert chip_smoke.shape_routes("wgmma")["flash_fwd"] == "wgmma"
    for cfg, layers in ((gemma_2b(), 18), (opt_1_3b(), 24)):
        assert cfg.n_layers == layers
        q = _model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)
        k = _model_view(1, 64, cfg.n_kv_heads, cfg.head_dim, cfg.torch_dtype)
        assert attn._route("flash_fwd", q, k, k) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for phase, manager in (("gemma2b_forward", "d256_forward_on_mma"),
                           ("opt13b_fp16_forward", "fp16_d64_forward_on_mma")):
        assert f'("{phase}", ' in main and f'("forward_on_mma", {manager})' in main
    assert {"flash_fwd_wgmma256_kernel", "flash_fwd_wgmma64_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36


def test_the_smokes_new_rows_at_256_and_fp16_64():
    """chip_smoke's rows at head dim 256 (Gemma-2B's and Gemma-7B's
    attention, Gemma-2B's and Gemma-2-9B's groupings with a window, ragged,
    cross-length, non-causal) and those in fp16 at 64 (OPT-1.3B's,
    bench_mfu's d1024 widths, ragged GQA) name every kernel on wgmma; all
    are held on every route (wide rows), and the models' rows are timed in
    turns against mma (forward and backward turn rows)."""
    import chip_smoke

    rows = {row[0]: row for row in chip_smoke.SHAPES}
    d256 = {"gemma_d256", "gemma7b_d256", "gemma2b_window_d256", "gemma2_window_d256",
            "ragged_d256", "cross_d256", "noncausal_d256"}
    fp16_d64 = {"fp16_d1024_bshd", "opt13b_d64_bshd", "fp16_ragged_d64"}
    assert d256 == {n for n, row in rows.items() if row[6] == 256 and row[9] == torch.bfloat16}
    assert d256 | fp16_d64 <= set(chip_smoke.WIDE_SHAPES)
    for name in d256 | fp16_d64:
        assert rows[name][-1] == "wgmma", name
        assert (rows[name][6], rows[name][9]) in ((256, torch.bfloat16), (64, torch.float16))
    assert rows["gemma7b_d256"][1:7] == (1, 16, 16, 2048, 2048, 256)
    assert rows["gemma2_window_d256"][1:9] == (1, 16, 8, 2048, 2048, 256, True, 512)
    assert rows["gemma2b_window_d256"][1:11] == (1, 8, 1, 2048, 2048, 256, True, 512,
                                                 torch.bfloat16, "bshd")
    assert rows["opt13b_d64_bshd"][1:7] == (1, 32, 32, 2048, 2048, 64)
    assert not rows["noncausal_d256"][7] and rows["cross_d256"][4] < rows["cross_d256"][5]
    assert {"gemma_d256", "fp16_d1024_bshd"} <= set(chip_smoke.FWD_TURN_SHAPES)
    assert {"gemma_d256", "fp16_d1024_bshd", "opt13b_d64_bshd"} <= set(
        chip_smoke.BWD_TURN_SHAPES)
    assert "gemma_d256" in chip_smoke.BWD_G_LSE


def test_d80_backward_on_mma_moves_the_backward_alone_and_restores():
    """`profile_path.d80_backward_on_mma`, the route set StableLM-3B's
    gradient and train step are timed against: within it head dim 80 takes
    mma for dQ and dK/dV while the forward keeps wgmma, and head dims 96 and
    100 keep wgmma for every kernel; after it `_WGMMA_HEAD_DIMS` is exactly
    what it was, and the backward at 80 takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import d80_backward_on_mma

    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 4, 80)] * 4
    others = [[_model_view(1, 64, 4, d)] * 4 for d in (96, 100)]
    with d80_backward_on_mma():
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "mma"
            for other in others:
                assert attn._route(name, *other) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_stablelm3b_gradient_and_train_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of stablelm3b_gradient (4 layers:
    8/4/4) and of a stablelm3b_train step (all 32 layers, the forward twice
    a layer under remat and each backward kernel once: 64/32/32), all on
    wgmma, as `_route` picks them on the model's views at head dim 80; both
    phases run timed in turns against `d80_backward_on_mma` and appear in
    the kernels line's launches by path; the build expects both new
    kernels."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import stablelm_3b_4e1t

    cfg = stablelm_3b_4e1t()
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 64}, "flash_bwd_dq": {"wgmma": 32},
        "flash_bwd_dkv": {"wgmma": 32}}
    assert chip_smoke.step_routes("wgmma", 4) == {
        "flash_fwd": {"wgmma": 8}, "flash_bwd_dq": {"wgmma": 4},
        "flash_bwd_dkv": {"wgmma": 4}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("stablelm3b_gradient", "stablelm3b_train_step"):
        assert main.count(f'"{path}": stablelm_') == 2, path
    for phase in ("stablelm3b_gradient", "stablelm3b_train"):
        assert f'phase="{phase}"' in main, phase
    assert '"backward_on_mma": d80_backward_on_mma' in main
    assert {"flash_bwd_dq_wgmma80_kernel", "flash_bwd_dkv_wgmma80_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)


def test_the_smokes_new_rows_at_80():
    """chip_smoke's rows at head dim 80 (StableLM-3B's attention, contiguous
    and as its model's views, GQA 32/8, window 512, ragged, cross-length,
    non-causal) name every kernel on wgmma, are held on every route (wide
    rows), and the GQA and ragged rows carry an LSE cotangent."""
    import chip_smoke

    rows = {row[0]: row for row in chip_smoke.SHAPES}
    new = {"d80", "d80_bshd", "gqa_d80", "window_d80", "ragged_d80", "cross_length_d80",
           "non_causal_d80"}
    assert new == {n for n, row in rows.items()
                   if row[6] == 80 and row[9] == torch.bfloat16}
    assert new <= set(chip_smoke.WIDE_SHAPES)
    for name in new:
        assert rows[name][-1] == "wgmma", name
    assert rows["gqa_d80"][2:4] == (32, 8) and rows["window_d80"][8] == 512
    assert rows["ragged_d80"][1:6] == (2, 8, 4, 300, 300)
    assert rows["cross_length_d80"][4:6] == (256, 1024) and not rows["non_causal_d80"][7]
    assert {"gqa_d80", "ragged_d80"} <= chip_smoke.BWD_G_LSE


def test_d256_backward_on_mma_moves_the_backward_alone_and_restores():
    """`profile_path.d256_backward_on_mma`, the route set Gemma-2B's gradient
    and train step are timed against: within it head dim 256 takes mma for
    dQ and dK/dV while the forward keeps wgmma, and head dims 80 and 128
    keep wgmma for every kernel; after it `_WGMMA_HEAD_DIMS` is exactly what
    it was, and the backward at 256 takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import d256_backward_on_mma

    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 8, 256)] + [_model_view(1, 64, 1, 256)] * 2 + [
        _model_view(1, 64, 8, 256)]
    others = [[_model_view(1, 64, 4, d)] * 4 for d in (80, 128)]
    with d256_backward_on_mma():
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "mma"
            for other in others:
                assert attn._route(name, *other) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_gemma2b_gradient_and_train_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of gemma2b_gradient (4 layers: 8/4/4)
    and of a gemma2b_train step (all 18 layers, the forward twice a layer
    under remat and each backward kernel once: 36/18/18), all on wgmma, as
    `_route` picks them on the model's views at head dim 256 over one KV
    head; both phases run timed in turns against `d256_backward_on_mma` and
    appear in the kernels line's launches by path; the build expects both
    new kernels."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import gemma_2b

    cfg = gemma_2b()
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 36}, "flash_bwd_dq": {"wgmma": 18},
        "flash_bwd_dkv": {"wgmma": 18}}
    assert chip_smoke.step_routes("wgmma", 4) == {
        "flash_fwd": {"wgmma": 8}, "flash_bwd_dq": {"wgmma": 4},
        "flash_bwd_dkv": {"wgmma": 4}}
    q, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim)] * 2
    k = v = _model_view(1, 64, cfg.n_kv_heads, cfg.head_dim)
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("gemma2b_gradient", "gemma2b_train_step"):
        assert main.count(f'"{path}": gemma_') == 2, path
    for phase in ("gemma2b_gradient", "gemma2b_train"):
        assert f'phase="{phase}"' in main, phase
    assert '"backward_on_mma": d256_backward_on_mma' in main
    assert {"flash_bwd_dq_wgmma256_kernel", "flash_bwd_dkv_wgmma256_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)


def test_opt13b_gradient_and_backward_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of opt13b_fp16_gradient (4 layers:
    8/4/4) and of one opt13b_fp16_backward call (the loss's forward and
    backward at all 24 layers under remat, no optimizer: 48/24/24), all on
    wgmma, as `_route` picks them on the model's fp16 views at head dim 64;
    both phases run timed in turns against `fp16_backward_on_mma(64)` and appear
    in the kernels line's launches by path; the build expects both new
    kernels."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import opt_1_3b

    cfg = opt_1_3b()
    assert (cfg.n_layers, cfg.head_dim, cfg.dtype) == (24, 64, "float16")
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 48}, "flash_bwd_dq": {"wgmma": 24},
        "flash_bwd_dkv": {"wgmma": 24}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("opt13b_fp16_gradient", "opt13b_fp16_backward"):
        assert main.count(f'"{path}": opt_') == 2, path
        assert f'phase="{path}"' in main, path
    assert '"backward_on_mma": functools.partial(fp16_backward_on_mma, 64)' in main
    assert "llama=llama)" in main and "llama.llama_loss(" in inspect.getsource(
        chip_smoke.phase_train)
    assert {"flash_bwd_dq_wgmma64_f16_kernel", "flash_bwd_dkv_wgmma64_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)


# fp16 at head dims 80 (OPT-2.7B's) and 100 (OpenLLaMA-3B's published dtype):
# the forward, dQ and dK/dV have fp16 wgmma kernels at each (after mma at
# 80, straight after simt at 100)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d,bwd", [(80, ("simt", "mma", "wgmma")),
                                   (100, ("simt", "wgmma"))])
def test_the_fp16_forward_alone_takes_wgmma_at_80_and_100(d, bwd, layout):
    """fp16, contiguous and as the model's views: the forward's routes end
    in wgmma (after mma at 80, straight after simt at 100), and so do dQ's
    and dK/dV's."""
    half = torch.float16
    q, k, v, do = ([_bhsd(1, 4, 64, d, half)] if layout == "bhsd"
                   else [_model_view(1, 64, 4, d, half)]) * 4
    fwd = ("simt", "mma", "wgmma") if d == 80 else ("simt", "wgmma")
    assert attn._routes("flash_fwd", q, k, v) == fwd
    for kernel in BWD_KERNELS:
        assert attn._routes(kernel, q, k, v, do) == bwd


@pytest.mark.parametrize("dim,bwd", [(160, "wgmma"), (200, "wgmma")])
def test_the_models_fp16_forward_at_80_and_100(monkeypatch, dim, bwd):
    """An fp16 layer at head_dim 80 and 100 (`_a_models_launch_routes`):
    both forward launches take their fp16 wgmma kernel, and so do the
    backward launchers, with the cotangent that `_FlashFwd.backward` scales
    in fp16."""
    cfg = dataclasses.replace(_one_layer(dim, "float16"), n_kv_heads=2)
    assert cfg.head_dim == dim // 2
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"), ("flash_bwd_dq", bwd),
        ("flash_bwd_dkv", bwd)]


def test_the_opt27b_and_fp16_openllama_configs_have_their_published_widths():
    """`profile_path.opt_2_7b` against facebook/opt-2.7b's config.json, and
    `openllama_3b_fp16` against open_llama_3b's in its published dtype
    (hidden, layers, heads, KV heads, head dim, FFN, vocab, rope theta, norm
    eps, positions, dtype)."""
    from yoda_scheduler_tpu_torch.profile_path import (openllama_3b, openllama_3b_fp16,
                                                       opt_2_7b)

    fields = ("dim", "n_layers", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "rope_theta", "norm_eps", "max_seq_len", "dtype")
    for cfg, want in ((opt_2_7b(), (2560, 32, 32, 32, 80, 10240, 50272, 10000.0, 1e-5,
                                    2048, "float16")),
                      (openllama_3b_fp16(), (3200, 26, 32, 32, 100, 8640, 32000, 10000.0,
                                             1e-6, 2048, "float16"))):
        assert tuple(getattr(cfg, f) for f in fields) == want
        assert not cfg.is_moe and cfg.sliding_window is None
    assert openllama_3b().dtype == "bfloat16"


def test_fp16_d80_and_d100_forward_old_routes_move_the_fp16_forward_alone():
    """`profile_path.fp16_d80_forward_on_mma` and `fp16_d100_forward_on_simt`,
    the route sets the OPT-2.7B and fp16 OpenLLaMA-3B forwards are timed
    against: within each the fp16 forward at its width takes its old route
    (mma at 80, simt at 100), while fp16 dQ and dK/dV keep their wgmma
    kernels, bf16 at that width keeps wgmma for every kernel, and fp16
    at the other width and at 64 and 128 keeps its wgmma forward; after it
    `_WGMMA_HEAD_DIMS` is exactly what it was."""
    from yoda_scheduler_tpu_torch.profile_path import (fp16_d80_forward_on_mma,
                                                       fp16_d100_forward_on_simt)

    half = torch.float16
    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    for routes, d, old, other, bwd in ((fp16_d80_forward_on_mma, 80, "mma", 100, "wgmma"),
                                       (fp16_d100_forward_on_simt, 100, "simt", 80, "wgmma")):
        t = [_model_view(1, 64, 4, d, half)] * 4
        bf16 = [_model_view(1, 64, 4, d)] * 4
        rest = [[_model_view(1, 64, 4, dd, half)] * 3 for dd in (other, 64, 128)]
        with routes():
            assert attn._route("flash_fwd", *t[:3]) == old
            for name in BWD_KERNELS:
                assert attn._route(name, *t) == bwd
                assert attn._route(name, *bf16) == "wgmma"
            assert attn._route("flash_fwd", *bf16[:3]) == "wgmma"
            for r in rest:
                assert attn._route("flash_fwd", *r) == "wgmma"
        assert attn._WGMMA_HEAD_DIMS == saved
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"


def test_the_opt27b_and_fp16_openllama_forwards_expect_every_launch_on_wgmma():
    """chip_smoke's opt27b_fp16_forward and openllama3b_fp16_forward expect
    one flash_fwd launch a layer on wgmma (`phase_forward`'s route), 32 and
    26: `_route` picks it on each config's fp16 model views; both run in
    main's loop of forward phases, timed in turns against the forward on
    its old route, and the build expects both new kernels among 36."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import openllama_3b_fp16, opt_2_7b

    for cfg, layers in ((opt_2_7b(), 32), (openllama_3b_fp16(), 26)):
        assert cfg.n_layers == layers and cfg.dtype == "float16"
        q = _model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)
        k = _model_view(1, 64, cfg.n_kv_heads, cfg.head_dim, cfg.torch_dtype)
        assert attn._route("flash_fwd", q, k, k) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for phase, old in (("opt27b_fp16_forward", '("forward_on_mma", fp16_d80_forward_on_mma)'),
                       ("openllama3b_fp16_forward",
                        '("forward_on_simt", fp16_d100_forward_on_simt)')):
        assert f'("{phase}", ' in main and old in main
    assert {"flash_fwd_wgmma80_f16_kernel", "flash_fwd_wgmma100_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36


def test_the_smokes_fp16_rows_at_80_and_100():
    """chip_smoke's fp16 rows at head dims 80 (OPT-2.7B's attention as its
    model gives it, GQA 32/8, window 512, ragged, cross-length, non-causal)
    and 100 (OpenLLaMA-3B's in fp16 as its model gives it, contiguous, and
    the same five) name the forward, dQ and dK/dV on wgmma; all are wide
    rows, held on every route; the models' rows are forward turn rows and in
    the kernels line; at 100 the model's row and the contiguous one are
    backward turn rows (against simt, SDPA's flash backend after each turn),
    and at 80 the model's row alone (against mma, SDPA's default backend
    after each turn); the unaligned fp16 row at 80 stays on simt."""
    import chip_smoke

    rows = {row[0]: row for row in chip_smoke.SHAPES}
    new = {80: {"opt27b_d80_bshd", "fp16_gqa_d80", "fp16_window_d80", "fp16_ragged_d80",
                "fp16_cross_length_d80", "fp16_non_causal_d80"},
           100: {"openllama3b_fp16_d100_bshd", "fp16_unaligned_d100", "fp16_gqa_d100",
                 "fp16_window_d100", "fp16_ragged_d100", "fp16_cross_length_d100",
                 "fp16_non_causal_d100"}}
    for d in (80, 100):
        assert new[d] | ({"fp16_unaligned_d80"} if d == 80 else set()) == {
            n for n, row in rows.items() if row[6] == d and row[9] == torch.float16}
        assert new[d] <= set(chip_smoke.WIDE_SHAPES)
        for name in new[d]:
            assert chip_smoke.shape_routes(rows[name][-1]) == {
                "flash_fwd": "wgmma", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}, name
    assert rows["opt27b_d80_bshd"][1:11] == (1, 32, 32, 2048, 2048, 80, True, None,
                                             torch.float16, "bshd")
    assert rows["openllama3b_fp16_d100_bshd"][1:11] == (1, 32, 32, 2048, 2048, 100, True,
                                                        None, torch.float16, "bshd")
    assert rows["fp16_unaligned_d100"][1:11] == (1, 32, 32, 1024, 1024, 100, True, None,
                                                 torch.float16, "bhsd")
    for d in (80, 100):
        assert rows[f"fp16_gqa_d{d}"][2:4] == (32, 8)
        assert rows[f"fp16_window_d{d}"][8] == 512
        assert rows[f"fp16_ragged_d{d}"][1:6] == (2, 8, 4, 300, 300)
        assert rows[f"fp16_cross_length_d{d}"][4:6] == (256, 1024)
        assert rows[f"fp16_non_causal_d{d}"][4:8] == (1000, 1000, 100 if d == 100 else 80,
                                                      False)
    models = {"opt27b_d80_bshd", "openllama3b_fp16_d100_bshd"}
    assert models <= set(chip_smoke.FWD_TURN_SHAPES) and models <= set(
        chip_smoke.HEAD_DIM_ROWS)
    turns = {"openllama3b_fp16_d100_bshd", "fp16_unaligned_d100"}
    assert (new[80] | new[100]) & set(chip_smoke.BWD_TURN_SHAPES) == turns | {
        "opt27b_d80_bshd"}
    assert all(chip_smoke.BWD_TURN_SHAPES[name] == "flash" for name in turns)
    assert chip_smoke.BWD_TURN_SHAPES["opt27b_d80_bshd"] == "default"
    assert rows["fp16_unaligned_d80"][-1] == "simt"


def test_fp16_d100_backward_on_simt_moves_the_fp16_backward_alone_and_restores():
    """`profile_path.fp16_d100_backward_on_simt`, the route set the fp16
    OpenLLaMA-3B gradient and backward are timed against: within it fp16 dQ
    and dK/dV at head dim 100 take simt while the fp16 forward there keeps
    wgmma, bf16 at 100 keeps wgmma for every kernel, and fp16 dQ and dK/dV
    at 64 and 128 keep theirs; `fp16_backward_on_mma(64, 128)` moves fp16
    at 64 and 128 alone and leaves 100 on wgmma; after each `_WGMMA_HEAD_DIMS` is
    exactly what it was, and the fp16 backward at 100 takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import (fp16_backward_on_mma,
                                                       fp16_d100_backward_on_simt)

    half = torch.float16
    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 4, 100, half)] * 4
    bf16 = [_model_view(1, 64, 4, 100)] * 4
    rest = [[_model_view(1, 64, 4, d, half)] * 4 for d in (64, 128)]
    with fp16_d100_backward_on_simt():
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        assert attn._route("flash_fwd", *bf16[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "simt"
            assert attn._route(name, *bf16) == "wgmma"
            for r in rest:
                assert attn._route(name, *r) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    with fp16_backward_on_mma(64, 128):
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "wgmma"
            for r in rest:
                assert attn._route(name, *r) == "mma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_openllama3b_fp16_gradient_and_backward_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of openllama3b_fp16_gradient (4
    layers: 8/4/4) and of one openllama3b_fp16_backward call (the loss's
    forward and backward at all 26 layers under remat, no optimizer:
    52/26/26), all on wgmma, as `_route` picks them on the model's fp16
    views at head dim 100; both phases run timed in turns against
    `fp16_d100_backward_on_simt`, as the loss's backward where a call is
    one, and appear in the kernels line's launches by path; the build
    expects both new kernels among 36; the smoke's third sink row is at
    head dim 100."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch.profile_path import openllama_3b_fp16

    cfg = openllama_3b_fp16()
    assert (cfg.n_layers, cfg.head_dim, cfg.dtype) == (26, 100, "float16")
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 52}, "flash_bwd_dq": {"wgmma": 26},
        "flash_bwd_dkv": {"wgmma": 26}}
    assert chip_smoke.step_routes("wgmma", 4) == {
        "flash_fwd": {"wgmma": 8}, "flash_bwd_dq": {"wgmma": 4},
        "flash_bwd_dkv": {"wgmma": 4}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("openllama3b_fp16_gradient", "openllama3b_fp16_backward"):
        assert main.count(f'"{path}":') == 2, path
        assert f'phase="{path}"' in main, path
    assert '"backward_on_simt": fp16_d100_backward_on_simt' in main
    assert "turns=fp16_d100_turns, llama=llama)" in main
    assert {"flash_bwd_dq_wgmma100_f16_kernel", "flash_bwd_dkv_wgmma100_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36
    assert chip_smoke.FP16_SINK_COTANGENT_D100 == dict(chip_smoke.FP16_SINK_COTANGENT, d=100)
    assert "FP16_SINK_COTANGENT_D100" in inspect.getsource(chip_smoke.phase_backward)


# fp16 at head dims 96 (GPT-NeoX-20B's) and 256 (GPT-J-6B's): the forward,
# dQ and dK/dV have fp16 wgmma kernels at each (the forward since it alone
# had them); fp16 at 112, which has no wgmma kernel, keeps dQ and dK/dV on
# mma
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("d", [96, 256])
def test_the_fp16_forward_alone_takes_wgmma_at_96_and_256(d, layout):
    """fp16, contiguous and as the model's views: the forward's, dQ's and
    dK/dV's routes end in wgmma after mma at 96 and 256, while at 112 dQ's
    and dK/dV's end in mma; rows one element into their storage take simt
    alone."""
    half = torch.float16

    def views(dd):
        return ([_bhsd(1, 4, 64, dd, half)] if layout == "bhsd"
                else [_model_view(1, 64, 4, dd, half)]) * 4

    q, k, v, do = views(d)
    assert attn._routes("flash_fwd", q, k, v) == ("simt", "mma", "wgmma")
    for kernel in BWD_KERNELS:
        assert attn._routes(kernel, q, k, v, do) == ("simt", "mma", "wgmma")
        assert attn._routes(kernel, *views(112)) == ("simt", "mma")
    off = _bhsd(1, 4, 64, d, half, offset=1)
    assert attn._routes("flash_fwd", off, off, off) == ("simt",)
    for kernel in BWD_KERNELS:
        assert attn._routes(kernel, off, off, off, off) == ("simt",)


@pytest.mark.parametrize("dim,bwd", [(224, "mma"), (192, "wgmma"), (512, "wgmma")])
def test_the_models_fp16_forward_at_96_and_256(monkeypatch, dim, bwd):
    """An fp16 layer at head_dim 96 and 256 (`_a_models_launch_routes`):
    both forward launches take their fp16 wgmma kernel, and so do the
    backward launchers, with the cotangent that `_FlashFwd.backward` scales
    in fp16; at head_dim 112, which has no wgmma kernel, all four take
    mma."""
    cfg = dataclasses.replace(_one_layer(dim, "float16"), n_kv_heads=2)
    assert cfg.head_dim == dim // 2
    assert _a_models_launch_routes(monkeypatch, cfg) == [
        ("flash_fwd", bwd), ("flash_fwd", bwd), ("flash_bwd_dq", bwd),
        ("flash_bwd_dkv", bwd)]


def _llama_params(cfg) -> int:
    """The parameters of `init_llama(cfg)`: embedding and output head, and
    per layer the four attention matrices, the three FFN matrices and two
    norms, and the final norm."""
    d, hd = cfg.dim, cfg.head_dim
    attn_mats = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    return (2 * cfg.vocab_size * d + cfg.n_layers * (attn_mats + 3 * d * cfg.ffn_dim + 2 * d)
            + d)


def test_the_neox20b_and_gptj6b_configs_have_their_published_widths():
    """`profile_path.gpt_neox_20b` against EleutherAI/gpt-neox-20b's
    config.json and `gptj_6b` against EleutherAI/gpt-j-6b's (hidden,
    layers, heads, KV heads, head dim, FFN, vocab, rope theta, norm eps,
    positions, dtype: fp16, their published weights'); on the Llama block
    they reckon 27,195,365,376 and 7,929,303,040 parameters."""
    from yoda_scheduler_tpu_torch.profile_path import gpt_neox_20b, gptj_6b

    fields = ("dim", "n_layers", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "rope_theta", "norm_eps", "max_seq_len", "dtype")
    for cfg, want, params in (
            (gpt_neox_20b(), (6144, 44, 64, 64, 96, 24576, 50432, 10000.0, 1e-5, 2048,
                              "float16"), 27_195_365_376),
            (gptj_6b(), (4096, 28, 16, 16, 256, 16384, 50400, 10000.0, 1e-5, 2048,
                         "float16"), 7_929_303_040)):
        assert tuple(getattr(cfg, f) for f in fields) == want
        assert not cfg.is_moe and cfg.sliding_window is None
        assert _llama_params(cfg) == params


def test_fp16_d96_and_d256_forward_on_mma_move_the_fp16_forward_alone():
    """`profile_path.fp16_d96_forward_on_mma` and `fp16_d256_forward_on_mma`,
    the route sets the GPT-NeoX-20B and GPT-J-6B forwards are timed against:
    within each the fp16 forward at its width takes mma, while fp16 dQ and
    dK/dV keep their wgmma kernels there, bf16 at that
    width keeps wgmma for every kernel, and fp16 at the other width and at
    64, 80 and 128 keeps its wgmma forward; after it `_WGMMA_HEAD_DIMS` is
    exactly what it was."""
    from yoda_scheduler_tpu_torch.profile_path import (fp16_d96_forward_on_mma,
                                                       fp16_d256_forward_on_mma)

    half = torch.float16
    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    for routes, d, other, bwd in ((fp16_d96_forward_on_mma, 96, 256, "wgmma"),
                                  (fp16_d256_forward_on_mma, 256, 96, "wgmma")):
        t = [_model_view(1, 64, 4, d, half)] * 4
        bf16 = [_model_view(1, 64, 4, d)] * 4
        rest = [[_model_view(1, 64, 4, dd, half)] * 3 for dd in (other, 64, 80, 128)]
        with routes():
            assert attn._route("flash_fwd", *t[:3]) == "mma"
            for name in BWD_KERNELS:
                assert attn._route(name, *t) == bwd
                assert attn._route(name, *bf16) == "wgmma"
            assert attn._route("flash_fwd", *bf16[:3]) == "wgmma"
            for r in rest:
                assert attn._route("flash_fwd", *r) == "wgmma"
        assert attn._WGMMA_HEAD_DIMS == saved
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"


def test_the_neox20b_and_gptj6b_forwards_expect_every_launch_on_wgmma():
    """chip_smoke's neox20b_fp16_forward and gptj6b_fp16_forward expect one
    flash_fwd launch a layer on wgmma (`phase_forward`'s route), 44 and 28:
    `_route` picks it on each config's fp16 model views; both run in main's
    loop of forward phases (whose launches go into the kernels line's
    launches by path), timed in turns against the forward on mma, and the
    build expects both new kernels among 36; profile_path's main traces
    both forwards on each route."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch import profile_path
    from yoda_scheduler_tpu_torch.profile_path import gpt_neox_20b, gptj_6b

    for cfg, layers in ((gpt_neox_20b(), 44), (gptj_6b(), 28)):
        assert cfg.n_layers == layers and cfg.dtype == "float16"
        q = _model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)
        k = _model_view(1, 64, cfg.n_kv_heads, cfg.head_dim, cfg.torch_dtype)
        assert attn._route("flash_fwd", q, k, k) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for phase, manager in (("neox20b_fp16_forward", "fp16_d96_forward_on_mma"),
                           ("gptj6b_fp16_forward", "fp16_d256_forward_on_mma")):
        assert f'("{phase}", ' in main and f'("forward_on_mma", {manager})' in main
    assert "**new_width_routes" in main
    assert {"flash_fwd_wgmma96_f16_kernel", "flash_fwd_wgmma256_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36
    windows = inspect.getsource(profile_path.neox_gptj_forward_windows)
    assert "fp16_d96_forward_on_mma" in windows and "fp16_d256_forward_on_mma" in windows
    assert "neox_gptj_forward_windows()" in inspect.getsource(profile_path.main)


def test_the_smokes_fp16_rows_at_96_and_256():
    """chip_smoke's fp16 rows at head dims 96 (GPT-NeoX-20B's attention as
    its model gives it, 64 heads of 96, then GQA 32/8, window 512, ragged,
    cross-length, non-causal) and 256 (GPT-J-6B's, 16 heads of 256, and the
    same five) name the forward, dQ and dK/dV on wgmma; all are wide rows,
    held on every route; the models' rows are forward turn rows (against
    mma) and in the kernels line, and they alone are backward turn rows too
    (against mma, cuDNN's whole backward after each turn)."""
    import chip_smoke

    rows = {row[0]: row for row in chip_smoke.SHAPES}
    new = {96: {"neox20b_fp16_d96_bshd", "fp16_gqa_d96", "fp16_window_d96",
                "fp16_ragged_d96", "fp16_cross_length_d96", "fp16_non_causal_d96"},
           256: {"gptj6b_fp16_d256_bshd", "fp16_gqa_d256", "fp16_window_d256",
                 "fp16_ragged_d256", "fp16_cross_length_d256", "fp16_non_causal_d256"}}
    for d, bwd in ((96, "wgmma"), (256, "wgmma")):
        assert new[d] == {n for n, row in rows.items() if row[6] == d and row[9] == torch.float16}
        assert new[d] <= set(chip_smoke.WIDE_SHAPES)
        for name in new[d]:
            assert chip_smoke.shape_routes(rows[name][-1]) == {
                "flash_fwd": "wgmma", "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd}, name
        assert rows[f"fp16_window_d{d}"][8] == 512
        assert rows[f"fp16_cross_length_d{d}"][4:6] == (256, 1024)
        assert not rows[f"fp16_non_causal_d{d}"][7]
        assert rows[f"fp16_ragged_d{d}"][4:6] == (300, 300)
    assert rows["neox20b_fp16_d96_bshd"][1:11] == (1, 64, 64, 2048, 2048, 96, True, None,
                                                   torch.float16, "bshd")
    assert rows["gptj6b_fp16_d256_bshd"][1:11] == (1, 16, 16, 2048, 2048, 256, True, None,
                                                   torch.float16, "bshd")
    assert rows["fp16_gqa_d96"][2:4] == (32, 8) and rows["fp16_gqa_d256"][2:4] == (16, 8)
    models = {"neox20b_fp16_d96_bshd", "gptj6b_fp16_d256_bshd"}
    assert models <= set(chip_smoke.FWD_TURN_SHAPES) and models <= set(
        chip_smoke.HEAD_DIM_ROWS)
    assert (new[96] | new[256]) & set(chip_smoke.BWD_TURN_SHAPES) == models
    for name in models:
        assert chip_smoke.BWD_TURN_SHAPES[name] == "default"


def test_fp16_d256_backward_on_mma_moves_the_fp16_backward_alone_and_restores():
    """`profile_path.fp16_backward_on_mma(256)`, the route set the GPT-J-6B
    gradient and backward are timed against: within it fp16 dQ and dK/dV at
    head dim 256 take mma while the fp16 forward there keeps wgmma, bf16 at
    256 keeps wgmma for every kernel, and fp16 dQ and dK/dV at 64, 100 and
    128 keep theirs; `fp16_backward_on_mma(64, 128)` moves fp16 at 64 and
    128 alone and leaves 256 on wgmma; after each `_WGMMA_HEAD_DIMS` is exactly what
    it was, and the fp16 backward at 256 takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import fp16_backward_on_mma

    half = torch.float16
    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 16, 256, half)] * 4
    bf16 = [_model_view(1, 64, 16, 256)] * 4
    rest = [[_model_view(1, 64, 4, d, half)] * 4 for d in (64, 100, 128)]
    with fp16_backward_on_mma(256):
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        assert attn._route("flash_fwd", *bf16[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "mma"
            assert attn._route(name, *bf16) == "wgmma"
            for r in rest:
                assert attn._route(name, *r) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    with fp16_backward_on_mma(64, 128):
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_gptj6b_fp16_gradient_and_backward_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of gptj6b_fp16_gradient (4 layers:
    8/4/4) and of one gptj6b_fp16_backward call (the loss's forward and
    backward at all 28 layers under remat, no optimizer: 56/28/28), all on
    wgmma, as `_route` picks them on the model's fp16 views at head dim 256;
    both phases run after openllama3b_fp16_backward and before the card is
    freed, timed in turns against `fp16_backward_on_mma(256)`, as the loss's
    backward where a call is one, and appear in the kernels line's launches
    by path; the build expects both new kernels among 36; profile_path's
    main traces GPT-J-6B's backward on each route after the forwards."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch import profile_path
    from yoda_scheduler_tpu_torch.profile_path import gptj_6b

    cfg = gptj_6b()
    assert (cfg.n_layers, cfg.head_dim, cfg.dtype) == (28, 256, "float16")
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 56}, "flash_bwd_dq": {"wgmma": 28},
        "flash_bwd_dkv": {"wgmma": 28}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("gptj6b_fp16_gradient", "gptj6b_fp16_backward"):
        assert main.count(f'"{path}":') == 2, path
        assert f'phase="{path}"' in main, path
    assert '"backward_on_mma": functools.partial(fp16_backward_on_mma, 256)' in main
    assert "turns=fp16_d256_turns, llama=llama)" in main
    before = main.index('phase="openllama3b_fp16_backward"')
    assert before < main.index('phase="gptj6b_fp16_gradient"') < main.index(
        'phase="gptj6b_fp16_backward"') < main.index("free_memory()", before)
    assert {"flash_bwd_dq_wgmma256_f16_kernel", "flash_bwd_dkv_wgmma256_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36
    windows = inspect.getsource(profile_path.gptj6b_fp16_backward_windows)
    assert "functools.partial(fp16_backward_on_mma, 256)" in windows and "gptj_6b()" in windows
    body = inspect.getsource(profile_path.main)
    assert body.index("gptj6b_fp16_backward_windows()") > body.index(
        "neox_gptj_forward_windows()")


def test_fp16_d96_backward_on_mma_moves_the_fp16_backward_alone_and_restores():
    """`profile_path.fp16_backward_on_mma(96)`, the route set the GPT-NeoX-20B
    gradient and backward are timed against: within it fp16 dQ and dK/dV at
    head dim 96 take mma while the fp16 forward there keeps wgmma, bf16 at
    96 keeps wgmma for every kernel, fp16 dQ and dK/dV at 64, 80, 100, 128
    and 256 keep theirs; `fp16_backward_on_mma` at 64 and 128, and at 256,
    leaves 96 on wgmma; after each
    `_WGMMA_HEAD_DIMS` is exactly what it was, and the fp16 backward at 96
    takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import fp16_backward_on_mma

    half = torch.float16
    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 64, 96, half)] * 4
    bf16 = [_model_view(1, 64, 32, 96)] * 4
    rest = [[_model_view(1, 64, 4, d, half)] * 4 for d in (64, 100, 128, 256)]
    rest.append([_model_view(1, 64, 32, 80, half)] * 4)
    with fp16_backward_on_mma(96):
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        assert attn._route("flash_fwd", *bf16[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "mma"
            assert attn._route(name, *bf16) == "wgmma"
            for r in rest:
                assert attn._route(name, *r) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for other in ((64, 128), (256,)):
        with fp16_backward_on_mma(*other):
            for name in BWD_KERNELS:
                assert attn._route(name, *t) == "wgmma"
        assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_neox20b_fp16_gradient_and_backward_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of neox20b_fp16_gradient (4 layers:
    8/4/4) and of one neox20b_fp16_backward call (the loss's forward and
    backward under remat, no optimizer, at 22 of GPT-NeoX-20B's 44 layers:
    44/22/22), all on wgmma, as `_route` picks them on the model's fp16
    views at head dim 96; the cut is `profile_path.NEOX20B_BACKWARD_LAYERS`,
    whose fp16 weights and gradients fit the 80 GB card where 44 layers'
    do not, and the phase's config names it; both phases run after
    gptj6b_fp16_backward and before the card is freed, timed in turns
    against `fp16_backward_on_mma(96)`, as the loss's backward where a call
    is one, and appear in the kernels line's launches by path; the build
    expects both new kernels among 36, and the smoke's sink rows take head
    dim 96 too; profile_path's main traces the cut backward on each route
    after GPT-J-6B's."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch import profile_path
    from yoda_scheduler_tpu_torch.profile_path import NEOX20B_BACKWARD_LAYERS, gpt_neox_20b

    assert NEOX20B_BACKWARD_LAYERS == 22
    full, cut = gpt_neox_20b(), gpt_neox_20b(NEOX20B_BACKWARD_LAYERS)
    assert dataclasses.replace(cut, n_layers=44) == full
    assert (cut.n_layers, cut.head_dim, cut.dtype) == (22, 96, "float16")
    # fp16 weights and gradients, 4 bytes a parameter: 44 layers past the
    # card's 80 GB, 22 within it beside the activations
    assert _llama_params(full) * 4 / 1e9 > 100 and _llama_params(cut) * 4 / 1e9 < 56
    assert chip_smoke.step_routes("wgmma", cut.n_layers) == {
        "flash_fwd": {"wgmma": 44}, "flash_bwd_dq": {"wgmma": 22},
        "flash_bwd_dkv": {"wgmma": 22}}
    q, k, v, do = [_model_view(1, 64, cut.n_heads, cut.head_dim, cut.torch_dtype)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("neox20b_fp16_gradient", "neox20b_fp16_backward"):
        assert main.count(f'"{path}":') == 2, path
        assert f'phase="{path}"' in main, path
    assert '"backward_on_mma": functools.partial(fp16_backward_on_mma, 96)' in main
    assert "gpt_neox_20b(NEOX20B_BACKWARD_LAYERS)" in main
    assert "turns=fp16_d96_turns, llama=llama)" in main
    assert "{NEOX20B_BACKWARD_LAYERS} of 44 layers" in main
    before = main.index('phase="gptj6b_fp16_backward"')
    assert before < main.index('phase="neox20b_fp16_gradient"') < main.index(
        'phase="neox20b_fp16_backward"') < main.index("free_memory()", before)
    assert {"flash_bwd_dq_wgmma96_f16_kernel", "flash_bwd_dkv_wgmma96_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36
    assert chip_smoke.FP16_SINK_COTANGENT_D96 == dict(chip_smoke.FP16_SINK_COTANGENT, d=96)
    assert "FP16_SINK_COTANGENT_D96" in inspect.getsource(chip_smoke.phase_backward)
    windows = inspect.getsource(profile_path.neox20b_fp16_backward_windows)
    assert "functools.partial(fp16_backward_on_mma, 96)" in windows
    assert "gpt_neox_20b(NEOX20B_BACKWARD_LAYERS)" in windows
    body = inspect.getsource(profile_path.main)
    assert body.index("neox20b_fp16_backward_windows()") > body.index(
        "gptj6b_fp16_backward_windows()")


def test_fp16_d80_backward_on_mma_moves_the_fp16_backward_alone_and_restores():
    """`profile_path.fp16_backward_on_mma(80)`, the route set the OPT-2.7B
    gradient and backward are timed against: within it fp16 dQ and dK/dV at
    head dim 80 take mma while the fp16 forward there keeps wgmma, bf16 at
    80 keeps wgmma for every kernel, and fp16 dQ and dK/dV at 64, 96, 100,
    128 and 256 keep theirs; `fp16_backward_on_mma` at 64 and 128, at 96
    and at 256 leaves 80 on wgmma; after each `_WGMMA_HEAD_DIMS` is exactly what it was, and the
    fp16 backward at 80 takes wgmma again."""
    from yoda_scheduler_tpu_torch.profile_path import fp16_backward_on_mma

    half = torch.float16
    saved = {key: dims for key, dims in attn._WGMMA_HEAD_DIMS.items()}
    t = [_model_view(1, 64, 32, 80, half)] * 4
    bf16 = [_model_view(1, 64, 32, 80)] * 4
    rest = [[_model_view(1, 64, 4, d, half)] * 4 for d in (64, 96, 100, 128, 256)]
    with fp16_backward_on_mma(80):
        assert attn._route("flash_fwd", *t[:3]) == "wgmma"
        assert attn._route("flash_fwd", *bf16[:3]) == "wgmma"
        for name in BWD_KERNELS:
            assert attn._route(name, *t) == "mma"
            assert attn._route(name, *bf16) == "wgmma"
            for r in rest:
                assert attn._route(name, *r) == "wgmma"
    assert attn._WGMMA_HEAD_DIMS == saved
    for other in ((64, 128), (96,), (256,)):
        with fp16_backward_on_mma(*other):
            for name in BWD_KERNELS:
                assert attn._route(name, *t) == "wgmma"
        assert attn._WGMMA_HEAD_DIMS == saved
    for name in BWD_KERNELS:
        assert attn._route(name, *t) == "wgmma"


def test_opt27b_fp16_gradient_and_backward_expect_every_launch_on_wgmma():
    """chip_smoke's expected launches of opt27b_fp16_gradient (4 layers:
    8/4/4) and of one opt27b_fp16_backward call (the loss's forward and
    backward under remat, no optimizer, at all 32 of OPT-2.7B's layers,
    whose fp16 weights and gradients take under 15 GB: 64/32/32), all on
    wgmma, as `_route` picks them on the model's fp16 views at head dim 80;
    both phases run after neox20b_fp16_backward and before the card is
    freed, timed in turns against `fp16_backward_on_mma(80)`, as the loss's
    backward where a call is one, and appear in the kernels line's launches
    by path; the build expects both new kernels among 36, and the smoke's
    sink rows take head dim 80 too; profile_path's main traces the backward
    on each route last, after GPT-NeoX-20B's."""
    import inspect

    import chip_smoke
    from yoda_scheduler_tpu_torch import profile_path
    from yoda_scheduler_tpu_torch.profile_path import opt_2_7b

    cfg = opt_2_7b()
    assert (cfg.n_layers, cfg.head_dim, cfg.dtype) == (32, 80, "float16")
    # fp16 weights and gradients, 4 bytes a parameter
    assert 14 < _llama_params(cfg) * 4 / 1e9 < 15
    assert chip_smoke.step_routes("wgmma", cfg.n_layers) == {
        "flash_fwd": {"wgmma": 64}, "flash_bwd_dq": {"wgmma": 32},
        "flash_bwd_dkv": {"wgmma": 32}}
    assert chip_smoke.step_routes("wgmma", 4) == {
        "flash_fwd": {"wgmma": 8}, "flash_bwd_dq": {"wgmma": 4},
        "flash_bwd_dkv": {"wgmma": 4}}
    q, k, v, do = [_model_view(1, 64, cfg.n_heads, cfg.head_dim, cfg.torch_dtype)] * 4
    assert attn._route("flash_fwd", q, k, v) == "wgmma"
    for name in BWD_KERNELS:
        assert attn._route(name, q, k, v, do) == "wgmma"
    main = inspect.getsource(chip_smoke.main)
    for path in ("opt27b_fp16_gradient", "opt27b_fp16_backward"):
        assert main.count(f'"{path}":') == 2, path
        assert f'phase="{path}"' in main, path
    assert '"backward_on_mma": functools.partial(fp16_backward_on_mma, 80)' in main
    assert "turns=fp16_d80_turns)" in main
    assert "turns=fp16_d80_turns, llama=llama)" in main
    before = main.index('phase="neox20b_fp16_backward"')
    assert before < main.index('phase="opt27b_fp16_gradient"') < main.index(
        'phase="opt27b_fp16_backward"') < main.index("free_memory()", before)
    assert {"flash_bwd_dq_wgmma80_f16_kernel", "flash_bwd_dkv_wgmma80_f16_kernel"} <= set(
        chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == len(set(chip_smoke.WGMMA_KERNELS)) == 36
    assert chip_smoke.FP16_SINK_COTANGENT_D80 == dict(chip_smoke.FP16_SINK_COTANGENT, d=80)
    assert "FP16_SINK_COTANGENT_D80" in inspect.getsource(chip_smoke.phase_backward)
    windows = inspect.getsource(profile_path.opt27b_fp16_backward_windows)
    assert "functools.partial(fp16_backward_on_mma, 80)" in windows and "opt_2_7b()" in windows
    body = inspect.getsource(profile_path.main)
    assert body.index("opt27b_fp16_backward_windows()") > body.index(
        "neox20b_fp16_backward_windows()")
    assert body.rstrip().split("reports += ")[-1].startswith("opt27b_fp16_backward_windows()")
