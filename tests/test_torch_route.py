"""Which kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu the port's
inputs take (`attention._route`), decided from
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
    assert attn._route(q, k, v) == want
    assert attn._routes(q, k, v)[-1] == want
    assert "simt" in attn._routes(q, k, v)


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


# the backward's inputs (q, k, v, dO) -> the route `_route` must pick
BWD_CASES = {
    "bf16_d128": (lambda: [_bhsd(1, 4, 64, 128)] * 4, "wgmma"),
    "bf16_d128_gqa": (lambda: [_bhsd(1, 4, 64, 128)] + [_bhsd(1, 2, 64, 128)] * 2
                      + [_bhsd(1, 4, 64, 128)], "wgmma"),
    "model_views_contiguous_do": (lambda: [_model_view(2, 64, 4, 128)] * 3
                                  + [_bhsd(2, 4, 64, 128)], "wgmma"),
    "model_views_transposed_do": (lambda: [_model_view(2, 64, 4, 128)] * 4, "wgmma"),
    "bf16_d64": (lambda: [_bhsd(1, 4, 64, 64)] * 4, "mma"),
    "bf16_d32": (lambda: [_bhsd(1, 4, 64, 32)] * 4, "mma"),
    "do_offset_by_one": (lambda: [_bhsd(1, 4, 64, 128)] * 3
                         + [_bhsd(1, 4, 64, 128, offset=1)], "simt"),
    "do_odd_seq_stride": (lambda: [_bhsd(1, 4, 64, 128)] * 3
                          + [_bhsd(1, 4, 64, 132)[..., :128]], "simt"),
    "fp32_d128": (lambda: [_bhsd(1, 4, 64, 128, torch.float32)] * 4, "simt"),
    "empty_kv": (lambda: [_bhsd(1, 4, 64, 128), _bhsd(1, 4, 0, 128),
                          _bhsd(1, 4, 0, 128), _bhsd(1, 4, 64, 128)], "mma"),
}


def _bwd_args(q, k, v, do):
    lse = torch.zeros(q.shape[:3])
    return q, k, v, do, lse, lse


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_route_follows_the_inputs(case):
    make, want = BWD_CASES[case]
    q, k, v, do = make()
    assert attn._route(q, k, v, do) == want
    assert attn._routes(q, k, v, do)[-1] == want
    assert "simt" in attn._routes(q, k, v, do)


@pytest.mark.parametrize("fn", [attn.flash_bwd_dq, attn.flash_bwd_dkv],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("case,route", [
    ("fp32_d128", "wgmma"), ("fp32_d128", "mma"), ("bf16_d64", "wgmma"),
    ("do_offset_by_one", "mma"), ("do_odd_seq_stride", "wgmma"),
    ("empty_kv", "wgmma"), ("bf16_d128", "tma")])
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


def test_the_models_backward_lands_on_wgmma(monkeypatch):
    """The loss gradient of a bf16 layer at head_dim 128 through the
    autograd node of the kernels, with the kernels' launchers replaced by
    recorders on the CPU: the forward's inputs (the model's [B, S, H, D]
    views) take the forward's wgmma route, and the g_out that
    `_FlashFwd.backward` hands to both backward launchers, with q, k and v,
    takes the backward's."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=256, n_heads=2, n_kv_heads=1,
                              n_layers=1, dtype="bfloat16")
    assert cfg.head_dim == 128
    seen = []

    def fwd(q, k, v, causal=True, window=None):
        seen.append(("flash_fwd", attn._route(q, k, v)))
        return attn.reference_attention_with_lse(q, k, v, causal, window)

    def bwd(name, q, k, v, do, lse, delta, causal=True, window=None):
        seen.append((name, attn._route(q, k, v, do)))
        return attn.flash_backward_reference(q, k, v, q, lse, do, causal, window)

    monkeypatch.setattr(attn, "flash_fwd", fwd)
    monkeypatch.setattr(attn, "flash_bwd_dq", lambda *a, **kw: bwd("dq", *a, **kw)[0])
    monkeypatch.setattr(attn, "flash_bwd_dkv", lambda *a, **kw: (
        [t.repeat_interleave(2, dim=1) for t in bwd("dkv", *a, **kw)[1:]]))
    monkeypatch.setattr(attn, "_attention", lambda q, k, v, causal, window: (
        attn._FlashFwd.apply(q, k, v, causal, window)))
    params = init_llama(cfg, seed=0, device="cpu")
    for t in params["layers"][0].values():
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(0))
    llama_loss(params, tokens, cfg, remat=True).backward()
    assert seen == [("flash_fwd", "wgmma"), ("flash_fwd", "wgmma"),
                    ("dq", "wgmma"), ("dkv", "wgmma")]
