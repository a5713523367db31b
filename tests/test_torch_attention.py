"""The PyTorch port's attention (yoda_scheduler_tpu_torch/ops/attention.py)
against the JAX package's flash attention on the same inputs, forward and
backward.

On the CPU the port's wrappers take the plain versions and the JAX side runs
its Pallas kernels in interpret mode (or its own plain path for shapes it
cannot tile). The CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.ops import attention as jattn
from yoda_scheduler_tpu_torch.ops import attention as tattn

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

# (b, h, kvh, sq, sk, d, causal, window)
CASES = {
    "causal": (1, 2, 2, 128, 128, 32, True, None),
    "non_causal": (1, 2, 2, 128, 128, 32, False, None),
    "gqa": (2, 4, 2, 64, 64, 32, True, None),
    "cross_length": (1, 2, 2, 64, 192, 32, True, None),
    "window": (1, 2, 2, 128, 128, 32, True, 48),
    "ragged": (1, 2, 1, 200, 200, 64, True, None),
}
# fp32: both sides compute in fp32 and differ only in summation order.
# bf16: O is rounded to bf16 at different points (the plain version rounds
# the probabilities before P.V, the kernel only the output), so O may differ
# by about one bf16 ulp at |O| < 4; the LSE is fp32 on both sides.
TOL = {"float32": dict(o=1e-5, lse=1e-5), "bfloat16": dict(o=2e-2, lse=1e-4)}


def _inputs(case, dtype, seed=0):
    b, h, kvh, sq, sk, d, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_with_lse_matches_jax(case, dtype):
    *_, causal, window = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    jo, jl = jattn.flash_attention_with_lse(jq, jk, jv, causal=causal,
                                            window=window)
    to, tl = tattn.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                            window=window)
    assert to.dtype == getattr(torch, dtype) and tl.dtype == torch.float32
    assert to.shape == jo.shape and tl.shape == jl.shape
    np.testing.assert_allclose(_np(to), _np(jo), atol=TOL[dtype]["o"],
                               rtol=TOL[dtype]["o"])
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL[dtype]["lse"],
                               rtol=TOL[dtype]["lse"])
    # flash_attention is the O half of the same computation
    np.testing.assert_array_equal(
        _np(tattn.flash_attention(tq, tk, tv, causal=causal, window=window)),
        _np(to))


@pytest.mark.parametrize("case", ["window"])
def test_reference_matches_jax_reference(case):
    *_, causal, window = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "float32", seed=1)
    jo, jl = jattn.reference_attention_with_lse(jq, jk, jv, causal, window)
    to, tl = tattn.reference_attention_with_lse(tq, tk, tv, causal, window)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)


# (q shape, k shape, kwargs): each raises ValueError on both sides
BAD = {
    "causal_sq_gt_sk": ((1, 2, 64, 32), (1, 2, 32, 32), {}),
    "heads_not_multiple": ((1, 3, 32, 32), (1, 2, 32, 32), {}),
    "window_non_causal": ((1, 2, 32, 32), (1, 2, 32, 32),
                          dict(causal=False, window=8)),
    "window_zero": ((1, 2, 32, 32), (1, 2, 32, 32), dict(window=0)),
    "bwd_blocks_untileable": ((1, 2, 128, 32), (1, 2, 128, 32),
                              dict(block_q_bwd=48)),
}


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_with_lse"])
@pytest.mark.parametrize("bad", list(BAD))
def test_same_value_errors(bad, fn):
    qs, ks, kw = BAD[bad]
    with pytest.raises(ValueError) as jerr:
        q = jnp.zeros(qs, jnp.float32)
        k = jnp.zeros(ks, jnp.float32)
        getattr(jattn, fn)(q, k, k, **kw)
    with pytest.raises(ValueError) as terr:
        q = torch.zeros(qs)
        k = torch.zeros(ks)
        getattr(tattn, fn)(q, k, k, **kw)
    assert str(terr.value) == str(jerr.value)


def test_reference_window_needs_causal():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="requires causal"):
        tattn.reference_attention(q, q, q, causal=False, window=4)


def test_handles_gqa_flags_mirror_jax():
    for name in ("flash_attention", "flash_attention_with_lse",
                 "reference_attention", "reference_attention_with_lse"):
        assert getattr(tattn, name).handles_gqa is True
        assert getattr(jattn, name).handles_gqa is True


def test_cpu_tensors_take_the_plain_version():
    (_, _, _), (tq, tk, tv) = _inputs("gqa", "float32")
    before = tattn.flash_fwd.launches
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv)
    ro, rl = tattn.reference_attention_with_lse(tq, tk, tv)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert tattn.flash_fwd.launches == before


def test_kernel_launcher_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_fwd(q, q, q)


# backward: a loss of both outputs, sum(O * dO) + sum(LSE * g), as
# tests/test_ops.py's gradient test does. fp32: the JAX suite's own 5e-5.
# bf16: 0.08 abs, the JAX suite's bf16 backward bound (tests/test_ops.py):
# the JAX kernels compute in fp32 and round their outputs, the port's plain
# versions round P and dS (and autograd its probabilities) to bf16 as well.
BWD_TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=0.08, rtol=0)}


@functools.lru_cache(maxsize=None)
def _jax_backward(case, dtype):
    """(inputs as numpy, cotangents as numpy, JAX's dq, dk, dv as numpy)."""
    *_, causal, window = CASES[case]
    (jq, jk, jv), _ = _inputs(case, dtype)
    rng = np.random.default_rng(7)
    do = rng.standard_normal(jq.shape, dtype=np.float32)
    g = rng.standard_normal(jq.shape[:3], dtype=np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_with_lse(
        q, k, v, causal=causal, window=window), jq, jk, jv)
    grads = vjp((jnp.asarray(do).astype(dtype), jnp.asarray(g)))
    return do, g, tuple(_np(x) for x in grads)


@pytest.mark.parametrize("path", ["plain_backward", "autograd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax(case, dtype, path):
    """`flash_backward_reference` (the kernels' plain twin) and CPU autograd
    through `flash_attention_with_lse`, against jax.vjp of the JAX
    package's flash_attention_with_lse (its Pallas dQ and dK/dV kernels)."""
    *_, causal, window = CASES[case]
    do_np, g_np, want = _jax_backward(case, dtype)
    _, (tq, tk, tv) = _inputs(case, dtype)
    do = torch.from_numpy(do_np).to(getattr(torch, dtype))
    g_lse = torch.from_numpy(g_np)
    if path == "plain_backward":
        o, lse = tattn.reference_attention_with_lse(tq, tk, tv, causal, window)
        got = tattn.flash_backward_reference(tq, tk, tv, o, lse, do, causal,
                                             window, g_lse)
    else:
        for t in (tq, tk, tv):
            t.requires_grad_(True)
        o, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                                window=window)
        torch.autograd.backward([o, lse], [do, g_lse])
        got = (tq.grad, tk.grad, tv.grad)
    for g_t, g_j, t in zip(got, want, (tq, tk, tv)):
        assert g_t.dtype == t.dtype and tuple(g_t.shape) == g_j.shape
        np.testing.assert_allclose(_np(g_t), g_j, **BWD_TOL[dtype])


def test_plain_backward_without_lse_cotangent_is_autograd_of_o():
    """g_lse=None is a zero LSE cotangent: the classic backward of O."""
    (_, _, _), (tq, tk, tv) = _inputs("gqa", "float32")
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    o, lse = tattn.reference_attention_with_lse(q, k, v)
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(
        o.shape, dtype=np.float32))
    o.backward(do)
    got = tattn.flash_backward_reference(tq, tk, tv, o.detach(), lse.detach(), do)
    for g_t, g_a in zip(got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(g_t, g_a, atol=1e-5, rtol=1e-5)


def test_group_sum_sums_each_group_of_heads():
    x = torch.arange(2 * 4 * 3 * 2, dtype=torch.float32).view(2, 4, 3, 2)
    got = tattn.group_sum(x, 2)
    # q heads 0, 1 share kv head 0 and heads 2, 3 kv head 1 (repeat_interleave)
    assert torch.equal(got[:, 0], x[:, 0] + x[:, 1])
    assert torch.equal(got[:, 1], x[:, 2] + x[:, 3])
    assert tattn.group_sum(x, 4) is x


def test_backward_launchers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    lse = torch.zeros(1, 2, 8)
    for fn in (tattn.flash_bwd_dq, tattn.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, lse)
