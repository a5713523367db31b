"""Which forward kernel of csrc/flash_fwd.cu the port's inputs take
(`attention._fwd_route`), decided from dtype, head_dim, base alignment and
strides alone, on CPU tensors; and the refusal of a named route that cannot
take the inputs. The kernels themselves run in tests/test_torch_cuda.py."""

import pytest
import torch

from yoda_scheduler_tpu_torch.ops import attention as attn


def _bhsd(b, h, s, d, dtype=torch.bfloat16, offset=0):
    x = torch.zeros(b * h * s * d + offset, dtype=dtype)
    return x[offset:].view(b, h, s, d)


def _model_view(b, s, h, d):
    """The model's layout: [B, S, H, D] viewed as [B, H, S, D]."""
    return torch.zeros(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)


CASES = {
    "bf16_d128": (lambda: [_bhsd(1, 4, 64, 128)] * 3, "wgmma"),
    "bf16_d128_gqa": (lambda: [_bhsd(1, 4, 64, 128)] + [_bhsd(1, 2, 64, 128)] * 2,
                      "wgmma"),
    "model_bshd_view": (lambda: [_model_view(2, 64, 4, 128)] * 3, "wgmma"),
    "bf16_d64": (lambda: [_bhsd(1, 4, 64, 64)] * 3, "mma"),
    "bf16_d32": (lambda: [_bhsd(1, 4, 64, 32)] * 3, "mma"),
    "bf16_offset_by_one": (lambda: [_bhsd(1, 4, 64, 128, offset=1)] * 3, "simt"),
    "bf16_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 132)[..., :128]] * 3, "simt"),
    "fp32_d128": (lambda: [_bhsd(1, 4, 64, 128, torch.float32)] * 3, "simt"),
    "empty_kv": (lambda: [_bhsd(1, 4, 64, 128), _bhsd(1, 4, 0, 128),
                          _bhsd(1, 4, 0, 128)], "mma"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_route_follows_the_inputs(case):
    make, want = CASES[case]
    q, k, v = make()
    assert attn._fwd_route(q, k, v) == want
    assert attn._fwd_routes(q, k, v)[-1] == want
    assert "simt" in attn._fwd_routes(q, k, v)


@pytest.mark.parametrize("case,route", [
    ("fp32_d128", "wgmma"), ("fp32_d128", "mma"), ("bf16_d64", "wgmma"),
    ("bf16_offset_by_one", "mma"), ("bf16_d128", "tma")])
def test_a_route_that_cannot_take_the_inputs_raises(case, route):
    q, k, v = CASES[case][0]()
    before = attn.flash_fwd.launches
    with pytest.raises(ValueError, match=f"route '{route}' cannot take"):
        attn.flash_fwd(q, k, v, causal=False, route=route)
    assert attn.flash_fwd.launches == before


def test_a_route_that_can_take_them_still_needs_cuda():
    q, k, v = CASES["bf16_d128"][0]()
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_fwd(q, k, v, route="mma")
