"""The port's attention at the head dims and dtypes past the kernels' first
widths (head dims 40, 80, 96, 100, 256 and 320; fp16 beside fp32 and bf16,
at 128 too), the fp16 backward's cotangent scale under small and large
cotangents, and tiny Llamas whose head dims are 48, 64 (fp16), 80, 100 and
256 (one KV head), against the JAX package on the same inputs.

The JAX kernels take `d` from the array and compute in any float dtype, so
every such model runs in the JAX package; the port's kernels run these head
dims at a padded width on the card (`ops/csrc/flash_common.cuh`,
`padded_dim`; past 256 on the simt kernels alone, at 512). Here on the CPU the port's wrappers take the plain versions
and the JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests do. The kernels are held against the plain versions on
the card by chip_smoke.py and tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.ops import attention as jattn
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.models import params_from_jax
from yoda_scheduler_tpu_torch.ops import attention as tattn
from yoda_scheduler_tpu_torch.parallel import param_leaves

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

# (b, h, kvh, s, d, window), causal: each head dim alone, then GQA and a
# window at Phi-3-mini's 96; 100 with a ragged sequence (no block of the
# JAX kernel's but the whole sequence); 320, past the mma kernels' 256; and
# 128, alone and with GQA and a window, the width of the fp16 wgmma forward
# (Llama-2-7B's attention in its published weights' dtype)
CASES = {
    "d40": (1, 2, 2, 64, 40, None),
    "d80": (1, 2, 2, 64, 80, None),
    "d96": (1, 2, 2, 64, 96, None),
    "d100_ragged": (1, 2, 2, 100, 100, None),
    "d256": (1, 2, 2, 64, 256, None),
    "d320": (1, 2, 2, 64, 320, None),
    "d96_gqa_window": (1, 4, 2, 64, 96, 24),
    "d128": (1, 2, 2, 64, 128, None),
    "d128_gqa_window": (1, 4, 2, 64, 128, 24),
}
DTYPES = ("float32", "bfloat16", "float16")
# |port - JAX| <= atol + rtol * |JAX|. fp32: summation order only (measured
# <= 2.1e-6 on the CPU, seed 0). bf16: the JAX kernel rounds only its output, the
# port's plain version rounds the probabilities (and the backward P and dS)
# too, about one bf16 ulp at |O| < 4 (measured <= 1.56e-2 forward, 3.1e-2
# backward at |dV| ~ 6): the bounds of tests/test_torch_attention.py. fp16:
# the same rounding one fp16 ulp deep, 8x finer than bf16's, so the bf16
# bounds over 8 (measured <= 1.95e-3 forward, 3.9e-3 backward). The LSE is
# fp32 on both sides in every dtype.
FWD_TOL = {"float32": dict(o=1e-5, lse=1e-5), "bfloat16": dict(o=2e-2, lse=1e-4),
           "float16": dict(o=2.5e-3, lse=1e-4)}
BWD_TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=0.08, rtol=0),
           "float16": dict(atol=1e-2, rtol=0)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(case, dtype, seed=0):
    """(numpy q, k, v, dO, g_lse) from a seed, in fp32."""
    b, h, kvh, s, d, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d),
                          (b, h, s))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_backward_match_jax(case, dtype):
    """flash_attention_with_lse's O and LSE, and the gradients of a loss of
    both outputs (dQ, dK, dV), against the JAX package's
    flash_attention_with_lse and its jax.vjp on the same values; also the
    plain twin of the backward kernels (`flash_backward_reference`)."""
    window = CASES[case][-1]
    q, k, v, do, g = _inputs(case, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    (jo, jl), vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_with_lse(
        q, k, v, causal=True, window=window), jq, jk, jv)
    want = vjp((jnp.asarray(do).astype(dtype), jnp.asarray(g)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    tdo, tg = torch.from_numpy(do).to(tdt), torch.from_numpy(g)
    to, tl = tattn.flash_attention_with_lse(tq, tk, tv, causal=True, window=window)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert to.shape == jo.shape and tl.shape == jl.shape
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_np(to), _np(jo), atol=tol["o"], rtol=tol["o"])
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol["lse"], rtol=tol["lse"])
    torch.autograd.backward([to, tl], [tdo, tg])
    plain = tattn.flash_backward_reference(tq.detach(), tk.detach(), tv.detach(),
                                           to.detach(), tl.detach(), tdo, True, window, tg)
    for name, got, ref, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), plain,
                                 want):
        for path, g_t in (("autograd", got), ("plain_backward", ref)):
            assert g_t.dtype == tdt and tuple(g_t.shape) == w.shape
            np.testing.assert_allclose(_np(g_t), _np(w), **BWD_TOL[dtype],
                                       err_msg=f"{name} ({path})")


# a Llama whose head dim is none of the kernels' first widths: dim 96 over 2
# query heads of 48 and one KV head
def _head_dim_48(dtype):
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dim=96, n_heads=2,
                               n_kv_heads=1, ffn_dim=192, dtype=dtype)


def _twin(jcfg):
    return tllama.LlamaConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def llama48():
    jcfg = _head_dim_48("float32")
    assert jcfg.head_dim == 48 and _twin(jcfg).head_dim == 48
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(5))
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 40))
    return jcfg, jparams, tokens


def _port_params(jcfg, jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg), device="cpu")


def test_head_dim_48_llama_logits_match_jax(llama48):
    """fp32 logits: summation order only, two layers of it (the bound of
    tests/test_torch_llama.py)."""
    jcfg, jparams, tokens = llama48
    want = jllama.llama_forward(jparams, jnp.asarray(tokens), jcfg)
    got = tllama.llama_forward(_port_params(jcfg, jparams), torch.from_numpy(tokens),
                               _twin(jcfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_head_dim_48_llama_gradients_match_jax(llama48):
    """jax.value_and_grad of llama_loss (remat) against the port's backward
    through its checkpointed layers, every leaf, in fp32 (the bound of
    tests/test_torch_train.py's gradient parity)."""
    jcfg, jparams, tokens = llama48
    want_loss, want = jax.value_and_grad(jllama.llama_loss)(
        jparams, jnp.asarray(tokens), jcfg, remat=True)
    tparams = _port_params(jcfg, jparams)
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    loss = tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg), remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    want = jax.tree.map(np.asarray, want)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(_np(tparams[name].grad), want[name], atol=1e-6,
                                   err_msg=name)
    for i, layer in enumerate(tparams["layers"]):
        for name, t in layer.items():
            np.testing.assert_allclose(_np(t.grad), want["layers"][name][i], atol=1e-6,
                                       err_msg=f"layers.{i}.{name}")


# fp16: every matmul output is rounded to fp16 in both, at places that
# differ by an ulp, so the logits are held by their relative L2 error, as
# tests/test_torch_llama.py holds bf16's at 2e-2, over 8 for fp16's finer
# ulp (measured 8.7e-4 at head dim 32, 8.2e-4 at 48, 8.2e-4 at 80 and 8.3e-4
# at 100 on the CPU, seed 7)
FP16_LOGITS_REL_L2 = 2.5e-3


# the fp16 Llamas: the tiny preset (head dim 32), dim 96 over 2 heads (48),
# dim 128 over 2 heads (64, the width of OPT-1.3B, whose forward takes the
# fp16 wgmma kernel at 64 on the card), dim 160 over 2 (80, OPT-2.7B's) and
# dim 200 over 2 (100, OpenLLaMA-3B's), whose forwards take the fp16 wgmma
# kernels at 80 and 100
FP16_CONFIGS = {32: dict(), 48: dict(dim=96, n_heads=2, n_kv_heads=1, ffn_dim=192),
                64: dict(n_heads=2, n_kv_heads=2),
                80: dict(dim=160, n_heads=2, n_kv_heads=2),
                100: dict(dim=200, n_heads=2, n_kv_heads=2),
                96: dict(dim=192, n_heads=2, n_kv_heads=2),
                256: dict(dim=512, n_heads=2, n_kv_heads=2)}


@pytest.mark.parametrize("head_dim", [32, 48, 64, 80, 100, 96, 256])
def test_fp16_llama_logits_match_jax(head_dim):
    """A tiny fp16 Llama (the dtype of Llama-2's, OPT's, OpenLLaMA's,
    GPT-NeoX-20B's and GPT-J-6B's published weights) at the tiny preset's
    head dim 32, at 48, 64, 80, 100, 96 (GPT-NeoX-20B's) and 256
    (GPT-J-6B's)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float16",
                               **FP16_CONFIGS[head_dim])
    assert jcfg.head_dim == head_dim
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(7))
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 40))
    tparams = _port_params(jcfg, jparams)
    assert tparams["layers"][0]["wq"].dtype == torch.float16
    want = _np(jllama.llama_forward(jparams, jnp.asarray(tokens), jcfg))
    got = _np(tllama.llama_forward(tparams, torch.from_numpy(tokens), _twin(jcfg)))
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FP16_LOGITS_REL_L2, rel


# fp16 cotangents of a model's size: at Llama-2-7B width dO is ~1e-5, and
# dS = P (dP - delta) / sqrt(d) ~1e-8 falls below fp16's smallest subnormal
# where the kernels round dS to fp16 for their products; the kernels'
# autograd node scales the cotangents by a power of two first
# (`attention._fp16_cotangent_scale`). Relative L2 of each gradient against
# the JAX kernels' (dS in fp32): the scaled path reads 1.8e-3-2.5e-3 on the
# CPU (seed 12), the unscaled twin 0.105 for dQ and dK.
SMALL_COTANGENT = 1e-5
SMALL_COTANGENT_REL_L2 = 1e-2


def _kernel_twins(monkeypatch):
    """The backward kernels' plain twin (`flash_backward_reference`, which
    rounds P and dS where the kernels do) behind the kernels' wrappers, and
    the wrappers' autograd node on CPU tensors. The twin's dK/dV come
    group-summed, each q head's rounded to k's dtype first as the kernels
    write them, so `_FlashFwd.backward`'s `group_sum` passes them through:
    the same values as the kernels' per-head outputs summed there, at GQA
    as at MHA."""
    def dq(q, k, v, do, lse, delta, causal=True, window=None, out_scale=None):
        return tattn.flash_backward_reference(q, k, v, torch.zeros_like(q), lse, do, causal,
                                              window, -delta, out_scale)[0]

    def dkv(q, k, v, do, lse, delta, causal=True, window=None, out_scale=None):
        return tattn.flash_backward_reference(q, k, v, torch.zeros_like(q), lse, do, causal,
                                              window, -delta, out_scale)[1:]

    monkeypatch.setattr(tattn, "flash_fwd", lambda q, k, v, causal=True, window=None: (
        tattn.reference_attention_with_lse(q, k, v, causal, window)))
    monkeypatch.setattr(tattn, "flash_bwd_dq", dq)
    monkeypatch.setattr(tattn, "flash_bwd_dkv", dkv)
    monkeypatch.setattr(tattn, "_attention", lambda q, k, v, causal, window: (
        tattn._FlashFwd.apply(q, k, v, causal, window)))


def _fp16_vjp(lse_scale, sink=False):
    """The fp16 gradients of flash_attention_with_lse (B=1, H=2, S=256, d=96,
    causal, seed 12) for dO of a model's size (SMALL_COTANGENT) and an LSE
    cotangent of `lse_scale`: (the port's autograd node's dQ, dK, dV, the
    backward twin's without the cotangent scale, the JAX VJP's, the port's
    cotangent scale). `sink`: key 0 is an attention sink (every component
    2, q's components of mean 1, so that each row puts nearly all of its
    weight on it) and the LSE cotangent is `lse_scale` everywhere, of one
    sign (as a z-loss's 2 c lse is)."""
    rng = np.random.default_rng(12)
    b, h, s, d = 1, 2, 256, 96
    q, k, v, do = (rng.standard_normal((b, h, s, d), dtype=np.float32) for _ in range(4))
    do = do * SMALL_COTANGENT
    g = rng.standard_normal((b, h, s), dtype=np.float32) * lse_scale
    if sink:
        q = q + 1.0
        k[:, :, 0] = 2.0
        g = np.full_like(g, lse_scale)
    jx = [jnp.asarray(a).astype("float16") for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_with_lse(q, k, v), *jx)
    want = [_np(x) for x in vjp((jnp.asarray(do).astype("float16"), jnp.asarray(g)))]
    tq, tk, tv = (torch.from_numpy(a).half().requires_grad_(True) for a in (q, k, v))
    tdo, tg = torch.from_numpy(do).half(), torch.from_numpy(g)
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv)
    torch.autograd.backward([o, lse], [tdo, tg])
    unscaled = tattn.flash_backward_reference(tq.detach(), tk.detach(), tv.detach(),
                                              o.detach(), lse.detach(), tdo, g_lse=tg)
    scale = tattn._fp16_cotangent_scale(tdo, tattn.backward_delta(o.detach(), tdo, tg))
    return (tq.grad, tk.grad, tv.grad), unscaled, want, float(scale)


def _rel(got, w):
    return float(np.linalg.norm(_np(got) - w) / np.linalg.norm(w))


def test_fp16_backward_keeps_small_cotangents(monkeypatch):
    _kernel_twins(monkeypatch)
    grads, unscaled, want, _ = _fp16_vjp(SMALL_COTANGENT)
    for name, got, raw, w in zip(("dq", "dk", "dv"), grads, unscaled, want):
        assert got.dtype == torch.float16
        assert _rel(got, w) <= SMALL_COTANGENT_REL_L2, name
        if name != "dv":  # dV = P^T dO rounds no dS
            assert _rel(raw, w) > SMALL_COTANGENT_REL_L2, name


def _assert_finite_and_close(grads, want):
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == torch.float16 and bool(torch.isfinite(got).all()), name
        assert _rel(got, w) <= SMALL_COTANGENT_REL_L2, name


# a large LSE cotangent beside dO of a model's size (a z-loss on the LSE):
# delta = rowsum(dO * O) - g_lse then outweighs dO by up to 1e8, and a scale
# taken from dO alone would push the scaled delta, and dS with it, past
# fp16's largest value (the kernels round dS to fp16). The scale also bounds
# delta (`attention._FP16_DELTA_LOG2`). With an attention sink under an LSE
# cotangent of one sign (`sink`), the sink's dK sums dS over every q row,
# ~3.1e4 in the JAX VJP, so that its value times the cotangent scale lies
# past fp16's largest value: the kernels multiply their sums by the inverse
# scale before rounding them to fp16 (`flash_bwd_dq`'s out_scale), so dK is
# finite. Relative L2 against the JAX VJP on the CPU (seed 12), dQ / dK /
# dV: 3.2e-4 / 3.4e-4 / 1.8e-3 at x8, 3.1e-4 / 3.3e-4 / 1.8e-3 at x1e3,
# 2.0e-5 / 6.2e-5 / 1.3e-4 with the sink at x1e3
@pytest.mark.parametrize("lse_scale, sink", [(8.0, False), (1e3, False), (1e3, True)],
                         ids=["8.0", "1000.0", "sink-1000.0"])
def test_fp16_backward_keeps_a_large_lse_cotangent(monkeypatch, lse_scale, sink):
    _kernel_twins(monkeypatch)
    grads, _, want, scale = _fp16_vjp(lse_scale, sink)
    if sink:
        assert np.abs(want[1]).max() * scale > float(torch.finfo(torch.float16).max)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == torch.float16 and bool(torch.isfinite(got).all()), name
        assert _rel(got, w) <= SMALL_COTANGENT_REL_L2, name


def test_a_scale_from_do_alone_overflows_ds(monkeypatch):
    """The case the bound on delta is for: at an LSE cotangent of x1e3, the
    scale from max |dO| alone (no bound on delta) rounds dS past fp16's
    largest value, and dQ and dK come out inf."""
    _kernel_twins(monkeypatch)
    monkeypatch.setattr(tattn, "_FP16_DELTA_LOG2", 10_000)
    grads, _, _, _ = _fp16_vjp(1e3)
    for name, got in zip(("dq", "dk"), grads):
        assert not bool(torch.isfinite(got).all()), name


def _rounded_once(q, k, v, o, lse, do, causal, window, g_lse=None, out_scale=None):
    """(dQ, dK, dV) as the plain backward gave them before it rounded each q
    head's dK and dV: the same formula, each group summed in fp32 and
    rounded once."""
    h, sq, d = q.shape[1:]
    kvh, sk = k.shape[1:3]
    kf, vf = (t.float().repeat_interleave(h // kvh, dim=1) for t in (k, v))
    qf, dof = q.float(), do.float()
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        qi = torch.arange(sq)[:, None] + (sk - sq)
        ki = torch.arange(sk)[None, :]
        mask = (ki <= qi) & (ki > qi - window) if window else ki <= qi
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = tattn.backward_delta(o, do, g_lse)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    p = p.to(q.dtype).float()
    grads = (torch.einsum("bhqk,bhkd->bhqd", ds, kf),
             tattn.group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, qf), kvh),
             tattn.group_sum(torch.einsum("bhqk,bhqd->bhkd", p, dof), kvh))
    if out_scale is not None:
        grads = [g * out_scale for g in grads]
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _cancelling_group():
    """Inputs on which a GQA group's dK and dV cancel (bf16; B=1, 4 q heads
    over 1, S=64, d=16, causal, window 2), all on integers so that every
    sum is exact in fp32: q (the same in every head) lives in the first
    half of the head dims and k in the second, so every score is 0 and P is
    1 or 1/2; v and dO are small integers, and dO's even rows are +-1024
    times one integer vector, of opposite signs in heads 0 and 1 and in 2
    and 3. Each head's dK and dV (~500 on those rows) lose their small part
    to bf16's rounding (ulp 4), and the group sum keeps only the small
    parts: (q, k, v, o, lse, dO) as torch tensors, o and lse the plain
    forward's (exact here too)."""
    b, h, kvh, s, d, window = 1, 4, 1, 64, 16, 2
    rng = np.random.default_rng(26)
    q = np.zeros((b, h, s, d), np.float32)
    q[..., :d // 2] = rng.integers(-2, 3, (b, 1, s, d // 2))
    k = np.zeros((b, kvh, s, d), np.float32)
    k[..., d // 2:] = rng.integers(-2, 3, (b, kvh, s, d // 2))
    v = rng.integers(-1, 2, (b, kvh, s, d)).astype(np.float32)
    do = rng.integers(-3, 4, (b, h, s, d)).astype(np.float32)
    signs = np.array([1, -1, 1, -1], np.float32)[None, :, None, None]
    do[:, :, 0::2] = signs * 1024.0 * rng.integers(-1, 2, (d,))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o, lse = tattn.reference_attention_with_lse(tq, tk, tv, True, window)
    return tq, tk, tv, o, lse, tdo, window


# F11: the plain backward rounds each q head's dK and dV to k's dtype before
# the group sum, as the JAX package's dK/dV kernel writes them and
# `_flash_backward` sums them (and as every kernel route does). On
# `_cancelling_group`'s exact arithmetic the JAX package's backward and the
# plain one agree to the bit (tolerance 0); summing each group in fp32 and
# rounding once (`_rounded_once`) misses by up to 4.5 (dV) and 5.75 (dK) at
# |dK|, |dV| <= 6 (measured on the CPU).
def test_the_plain_backward_rounds_each_q_head_at_gqa_as_jax():
    q, k, v, o, lse, do, window = _cancelling_group()
    b, h, s, _ = q.shape
    jq, jk, jv, jo, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                           for t in (q, k, v, o, do))
    want = jattn._flash_backward(jq, jk, jv, jo, jnp.asarray(lse.numpy()).reshape(b * h, s, 1),
                                 jdo, True, s, s, True, window=window)
    got = tattn.flash_backward_reference(q, k, v, o, lse, do, True, window)
    once = _rounded_once(q, k, v, o, lse, do, True, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    for name, g, w in zip(("dk", "dv"), once[1:], want[1:]):
        assert np.abs(_np(g) - _np(w)).max() >= 4.0, name


@pytest.mark.parametrize("dtype,out_scale", [("bfloat16", None), ("float16", 2.0 ** -6),
                                             ("float32", None)])
def test_the_plain_backward_at_mha_rounds_once_as_before(dtype, out_scale):
    """With as many kv heads as q heads the plain backward's dQ, dK and dV
    are bit for bit what they were before the per-head rounding
    (`_rounded_once`): the change acts at GQA alone. Causal, window 24, an
    LSE cotangent; in fp16 with an `out_scale`."""
    q, k, v, do, g = _inputs("d96", dtype, seed=3)
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, do))
    g = torch.from_numpy(g)
    assert k.shape[1] == q.shape[1]
    o, lse = tattn.reference_attention_with_lse(q, k, v, True, 24)
    scale = None if out_scale is None else torch.tensor(out_scale)
    got = tattn.flash_backward_reference(q, k, v, o, lse, do, True, 24, g, scale)
    for name, gt, w in zip(("dq", "dk", "dv"), got,
                           _rounded_once(q, k, v, o, lse, do, True, 24, g, scale)):
        assert gt.dtype == q.dtype and torch.equal(gt, w), name


# OPT-1.3B's attention (fp16, MHA, head dim 64), OpenLLaMA-3B's in its
# published dtype (fp16, head dim 100), GPT-J-6B's (fp16, head dim 256),
# GPT-NeoX-20B's (fp16, head dim 96) and OPT-2.7B's (fp16, head dim 80) on
# tiny Llamas of 2 layers of 2 heads, whose backward takes dQ's and dK/dV's
# fp16 wgmma kernels at 64, 100, 256, 96 and 80 on the card: the loss and
# every gradient leaf of jax.value_and_grad of the JAX package's llama_loss
# (remat) against the port's, with the kernels' plain twins behind the
# wrappers (`_kernel_twins`), so that the fp16 cotangent scale and
# `out_scale` run as on the card. fp16 rounds every matmul output at places
# an ulp apart in the two frameworks, as for FP16_LOGITS_REL_L2: the loss
# within 1e-4 relative (measured 1.0e-5 at 64) and each leaf within rel. L2
# 5e-3 (measured <= 1.6e-3 at 64, 100 and 256, 1.4e-3 at 96, 1.5e-3 at 80,
# on the CPU), every gradient finite.
FP16_GRAD_REL_L2 = 5e-3


@pytest.mark.parametrize("head_dim", [64, 100, 256, 96, 80])
def test_fp16_llama_gradients_match_jax(monkeypatch, head_dim):
    _kernel_twins(monkeypatch)
    scales = []
    twin_dq = tattn.flash_bwd_dq

    def dq(*args, out_scale=None, **kwargs):
        scales.append(out_scale)
        return twin_dq(*args, out_scale=out_scale, **kwargs)

    monkeypatch.setattr(tattn, "flash_bwd_dq", dq)
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float16",
                               **FP16_CONFIGS[head_dim])
    assert jcfg.head_dim == head_dim and jcfg.n_kv_heads == jcfg.n_heads == 2
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(15))
    tokens = np.random.default_rng(16).integers(0, jcfg.vocab_size, (2, 40))
    want_loss, want = jax.value_and_grad(jllama.llama_loss)(
        jparams, jnp.asarray(tokens), jcfg, remat=True)
    tparams = _port_params(jcfg, jparams)
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    loss = tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg), remat=True)
    loss.backward()
    assert len(scales) == jcfg.n_layers and all(s is not None for s in scales)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-4)
    want = jax.tree.map(_np, want)
    pairs = [(n, tparams[n], want[n]) for n in ("embed", "final_norm", "lm_head")]
    pairs += [(f"layers.{i}.{n}", t, want["layers"][n][i])
              for i, layer in enumerate(tparams["layers"]) for n, t in layer.items()]
    for name, t, w in pairs:
        assert t.grad.dtype == t.dtype and bool(torch.isfinite(t.grad).all()), name
        assert _rel(t.grad, w) <= FP16_GRAD_REL_L2, name


# Llamas at OpenLLaMA-3B's, StableLM-3B's and Gemma-2B's head dims (100, 80
# and 256; at 256 with Gemma's one KV head), cut to 2 layers of 2 heads, whose
# forwards take the wgmma forward kernels at those widths on the card: fp32
# logits against the JAX package's, summation order only (the bound of
# tests/test_torch_llama.py)
def _new_width(head_dim):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dim=2 * head_dim, n_heads=2,
                               n_kv_heads=1 if head_dim == 256 else 2, ffn_dim=256,
                               dtype="float32")
    assert jcfg.head_dim == _twin(jcfg).head_dim == head_dim and jcfg.n_layers == 2
    return jcfg


@pytest.mark.parametrize("head_dim", [80, 100, 256])
def test_new_width_llama_logits_match_jax(head_dim):
    jcfg = _new_width(head_dim)
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(9))
    tokens = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 40))
    want = jllama.llama_forward(jparams, jnp.asarray(tokens), jcfg)
    got = tllama.llama_forward(_port_params(jcfg, jparams), torch.from_numpy(tokens),
                               _twin(jcfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


# the same Llamas' gradients, whose backward takes dQ and dK/dV's wgmma
# kernels at 80, 100 and 256 on the card: jax.value_and_grad of llama_loss
# (remat) against the port's backward, every leaf, in fp32 (the bound of
# test_head_dim_48_llama_gradients_match_jax)
@pytest.mark.parametrize("head_dim", [80, 100, 256])
def test_new_width_llama_gradients_match_jax(head_dim):
    jcfg = _new_width(head_dim)
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(11))
    tokens = np.random.default_rng(12).integers(0, jcfg.vocab_size, (2, 40))
    want_loss, want = jax.value_and_grad(jllama.llama_loss)(
        jparams, jnp.asarray(tokens), jcfg, remat=True)
    tparams = _port_params(jcfg, jparams)
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    loss = tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg), remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    want = jax.tree.map(np.asarray, want)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(_np(tparams[name].grad), want[name], atol=1e-6,
                                   err_msg=name)
    for i, layer in enumerate(tparams["layers"]):
        for name, t in layer.items():
            np.testing.assert_allclose(_np(t.grad), want["layers"][name][i], atol=1e-6,
                                       err_msg=f"layers.{i}.{name}")


# StableLM-3B's head dim (80, MHA) and Gemma-2B's (256 over one KV head) on
# tiny Llamas of 2 layers of 2 heads: two AdamW steps of the port's
# `build_llama_train_step` against the JAX package's on a one-device mesh,
# from the same weights (`params_from_jax`) and one numpy-seeded batch, in
# fp32; on the card both backward kernels of each step take their
# head-dim-80 (head-dim-256) wgmma kernels. Losses within
# tests/test_torch_train.py's fp32 bound (summation order only); each leaf
# as tests/test_torch_moe.py's fp32 steps hold it, by rel. L2 and each entry
# within 2 lr: AdamW's first step moves an entry by lr g / (|g| + eps), so
# an entry whose gradient is at rounding level moves by up to lr either way
# in either framework (at 80 the worst leaf's rel. L2 is 5.2e-6, and one
# w_up entry of 40960 differs by 8.3e-5, every other by <= 1e-5).
TRAIN_STEPS = 2
TRAIN_LR = 3e-4
TRAIN_TOL = dict(loss=dict(rtol=1e-5, atol=0), leaf_rel_l2=2e-5, entry=2 * TRAIN_LR)


def _trained(head_dim):
    """(JAX losses, port losses, JAX final params as numpy, port params)
    after TRAIN_STEPS steps of `_new_width(head_dim)`."""
    from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
    from yoda_scheduler_tpu.parallel import make_mesh
    from yoda_scheduler_tpu_torch.parallel import build_llama_train_step, init_opt_state

    jcfg = _new_width(head_dim)
    init_fn, step_fn, _ = jax_build(jcfg, make_mesh({}, devices=jax.devices()[:1]))
    jparams, jopt = init_fn(jax.random.PRNGKey(13))
    tparams = _port_params(jcfg, jparams)
    _, tstep, _ = build_llama_train_step(_twin(jcfg), device="cpu")
    topt = init_opt_state(tparams, TRAIN_LR)
    tokens = np.random.default_rng(14).integers(0, jcfg.vocab_size, (2, 40))
    jlosses, tlosses = [], []
    for _ in range(TRAIN_STEPS):
        jparams, jopt, jloss = step_fn(jparams, jopt, jnp.asarray(tokens, jnp.int32))
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(tokens))
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    return jlosses, tlosses, jax.tree.map(np.asarray, jparams), tparams


@pytest.fixture(scope="module")
def trained_d80():
    jcfg = _new_width(80)
    assert jcfg.n_kv_heads == jcfg.n_heads
    return _trained(80)


@pytest.fixture(scope="module")
def trained_d256():
    assert _new_width(256).n_kv_heads == 1
    return _trained(256)


def _assert_losses_match(trained):
    jlosses, tlosses, _, _ = trained
    np.testing.assert_allclose(tlosses, jlosses, **TRAIN_TOL["loss"])
    assert tlosses[1] < tlosses[0]


def test_d80_train_losses_match_jax(trained_d80):
    _assert_losses_match(trained_d80)


def test_d256_train_losses_match_jax(trained_d256):
    _assert_losses_match(trained_d256)


def _assert_weights_match(trained, qkv_shapes):
    """Every leaf's dtype, rel. L2 and largest entry error (TRAIN_TOL), and
    the attention projections' shapes."""
    _, _, jparams, tparams = trained
    pairs = [(f"layers.{i}.{n}", t, jparams["layers"][n][i])
             for i, layer in enumerate(tparams["layers"]) for n, t in layer.items()]
    pairs += [(n, tparams[n], jparams[n]) for n in ("embed", "final_norm", "lm_head")]
    assert {tuple(t.shape) for n, t, _ in pairs
            if n.endswith((".wq", ".wk", ".wv"))} == qkv_shapes
    for name, t, want in pairs:
        assert t.dtype == getattr(torch, str(want.dtype)), name
        err = _np(t) - want
        assert np.linalg.norm(err) / np.linalg.norm(want) < TRAIN_TOL["leaf_rel_l2"], name
        assert np.abs(err).max() <= TRAIN_TOL["entry"], name


def test_d80_trained_weights_match_jax(trained_d80):
    _assert_weights_match(trained_d80, {(160, 160)})


def test_d256_trained_weights_match_jax(trained_d256):
    """At 256 over one KV head wq is [512, 512] and wk, wv [512, 256]."""
    _assert_weights_match(trained_d256, {(512, 512), (512, 256)})


# An fp16 train step gives NaN weights after its first AdamW update in the
# JAX package, and the port keeps that behaviour: AdamW's eps of 1e-8 rounds
# to 0 in fp16, and each gradient entry that is exactly 0 gives 0/0. That is
# why OPT-1.3B's path (fp16) ends at the gradient in chip_smoke.py. A 2-layer
# Llama of 2 heads of 64 in fp16 (seed 13, tokens from default_rng(14)):
# step 1's loss 5.82613 (JAX) and 5.82604 (port) on the CPU, then NaN in
# both.
def test_fp16_train_steps_turn_nan_after_one_update_as_in_jax():
    from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
    from yoda_scheduler_tpu.parallel import make_mesh
    from yoda_scheduler_tpu_torch.parallel import build_llama_train_step, init_opt_state

    assert np.float16(1e-8) == 0
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float16", **FP16_CONFIGS[64])
    assert jcfg.head_dim == 64 and jcfg.n_layers == 2
    init_fn, step_fn, _ = jax_build(jcfg, make_mesh({}, devices=jax.devices()[:1]))
    jparams, jopt = init_fn(jax.random.PRNGKey(13))
    tparams = _port_params(jcfg, jparams)
    _, tstep, _ = build_llama_train_step(_twin(jcfg), device="cpu")
    topt = init_opt_state(tparams, TRAIN_LR)
    tokens = np.random.default_rng(14).integers(0, jcfg.vocab_size, (2, 40))
    losses = []
    for _ in range(TRAIN_STEPS):
        jparams, jopt, jloss = step_fn(jparams, jopt, jnp.asarray(tokens, jnp.int32))
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(tokens))
        losses.append((float(jloss), float(tloss)))
    (j1, t1), (j2, t2) = losses
    assert np.isfinite([j1, t1]).all() and t1 == pytest.approx(j1, rel=1e-4)
    assert np.isnan(j2) and np.isnan(t2)
    assert np.isnan(_np(jparams["layers"]["wq"])).any()
    assert bool(torch.isnan(tparams["layers"][0]["wq"].detach()).any())
