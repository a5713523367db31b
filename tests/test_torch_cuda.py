"""The PyTorch port on the card: the CUDA kernels behind `flash_attention`
and its gradient, their refusals, and the tiny model and train step on CUDA
against the same on the CPU. Every test needs an NVIDIA GPU and skips
without one.

This file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from yoda_scheduler_tpu_torch.models import (LlamaConfig, init_llama, llama_forward,
                                             llama_loss)
from yoda_scheduler_tpu_torch.ops import attention as attn
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
