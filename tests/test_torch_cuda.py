"""The PyTorch port on the card: the CUDA kernel behind `flash_attention`,
its refusals and its autograd node, and the tiny model on CUDA against the
same model on the CPU. Every test needs an NVIDIA GPU and skips without one.

This file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from yoda_scheduler_tpu_torch.models import LlamaConfig, init_llama, llama_forward
from yoda_scheduler_tpu_torch.ops import attention as attn

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 4, 4, 128, 128, 64), True, None),
    ((2, 4, 2, 100, 100, 128), True, None),
    ((1, 2, 2, 64, 200, 32), True, 48),
    ((1, 2, 1, 70, 130, 64), False, None),
])
def test_flash_attention_launches_the_kernel(gpu, dtype, shape, causal, window):
    q, k, v = _qkv(gpu, dtype, *shape)
    before = attn.flash_fwd.launches
    o, lse = attn.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches == before + 1
    ro, rl = attn.reference_attention_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-4)


def test_backward_is_the_training_slice(gpu):
    q, k, v = _qkv(gpu, torch.bfloat16, 1, 2, 2, 64, 64, 64)
    q.requires_grad_(True)
    o = attn.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="training slice"):
        o.float().sum().backward()


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.bfloat16, 96)])
def test_kernel_refuses_what_it_does_not_take(gpu, dtype, d):
    q, k, v = _qkv(gpu, dtype, 1, 2, 2, 32, 32, d)
    with pytest.raises(ValueError, match="flash_fwd takes"):
        attn.flash_attention(q, k, v)


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


def test_greedy_tokens_on_cuda_equal_cpu(gpu, tiny_f32):
    cfg, params, cpu = tiny_f32
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)))
    got = generate_mod.generate(params, prompt.to(gpu), cfg, 8)
    want = generate_mod.generate(cpu, prompt, cfg, 8)
    assert torch.equal(got.cpu(), want)
