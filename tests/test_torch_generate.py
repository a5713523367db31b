"""The PyTorch port's KV-cache serving (yoda_scheduler_tpu_torch/models/
generate.py) against the JAX package's on the same weights and prompts.

The models are fp32 so that bf16 near-ties cannot flip a greedy argmax
between the two frameworks; greedy tokens must then be equal."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.models import params_from_jax

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

# the packages export a function named `generate` over the module's name
jgen = importlib.import_module("yoda_scheduler_tpu.models.generate")
tgen = importlib.import_module("yoda_scheduler_tpu_torch.models.generate")

F32 = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
# linear cache: prompt 16 + 10 new; rolling: window 8 < 16 + 10, so
# generate() folds the prefill into a ring of 8 slots
MODELS = {"linear": F32, "rolling": dataclasses.replace(F32, sliding_window=8)}
NEW = 10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.cache
def _model(name):
    """(name, jax config, jax params, port config, port params, prompt)."""
    jcfg = MODELS[name]
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    return name, jcfg, jparams, tcfg, tparams, prompt


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def jax_tokens(model):
    _, jcfg, jparams, _, _, prompt = model
    return np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg, NEW,
                                    eager=True))


@pytest.mark.parametrize("eager", [False, True])
def test_greedy_tokens_equal_jax(model, jax_tokens, eager):
    _, _, _, tcfg, tparams, prompt = model
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, NEW,
                        eager=eager)
    assert got.shape == (2, NEW)
    np.testing.assert_array_equal(got.numpy(), jax_tokens)


def test_prefill_then_stepwise_decode_matches_jax():
    _, jcfg, jparams, tcfg, tparams, prompt = _model("linear")
    jcache = jgen.KVCache.zeros(jcfg, 2, 24)
    tcache = tgen.KVCache.zeros(tcfg, 2, 24, device="cpu")
    jl, jcache = jgen.prefill(jparams, jnp.asarray(prompt), jcache, jcfg)
    tl, tcache = tgen.prefill(tparams, torch.from_numpy(prompt), tcache, tcfg)
    for _ in range(3):
        # fp32 on both sides: logits agree to summation order
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
        tok = np.array(jnp.argmax(jl, axis=-1))
        jl, jcache = jgen.decode_step(jparams, jnp.asarray(tok), jcache, jcfg)
        tl, tcache = tgen.decode_step(tparams, torch.from_numpy(tok), tcache,
                                      tcfg)
    assert tcache.length == int(jcache.length) == prompt.shape[1] + 3
    np.testing.assert_allclose(_np(tcache.k), _np(jcache.k), atol=1e-4,
                               rtol=1e-4)


def test_rolling_decode_step_matches_jax():
    _, jcfg, jparams, tcfg, tparams, prompt = _model("rolling")
    w = jcfg.sliding_window
    jpre = jgen.KVCache.zeros(jcfg, 2, 16)
    tpre = tgen.KVCache.zeros(tcfg, 2, 16, device="cpu")
    jl, jpre = jgen.prefill(jparams, jnp.asarray(prompt), jpre, jcfg)
    tl, tpre = tgen.prefill(tparams, torch.from_numpy(prompt), tpre, tcfg)
    jring = jgen.RollingKVCache.from_prefill(jpre, w)
    tring = tgen.RollingKVCache.from_prefill(tpre, w)
    tok = np.array(jnp.argmax(jl, axis=-1))
    jl, jring = jgen.decode_step_rolling(jparams, jnp.asarray(tok), jring, jcfg)
    tl, tring = tgen.decode_step_rolling(tparams, torch.from_numpy(tok), tring,
                                         tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tring.slot_pos.numpy(),
                                  np.asarray(jring.slot_pos))
    assert tring.next_pos == int(jring.next_pos)


@pytest.mark.parametrize("length", [3, 8, 13])
def test_from_prefill_matches_jax(length):
    """Short prompts (never-written slots), exactly one window, and a
    prompt longer than the window."""
    rng = np.random.default_rng(length)
    k = rng.standard_normal((2, 1, 16, 2, 4), dtype=np.float32)
    v = rng.standard_normal((2, 1, 16, 2, 4), dtype=np.float32)
    jring = jgen.RollingKVCache.from_prefill(
        jgen.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                     length=jnp.int32(length)), 8)
    tring = tgen.RollingKVCache.from_prefill(
        tgen.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                     length=length), 8)
    np.testing.assert_array_equal(tring.slot_pos.numpy(),
                                  np.asarray(jring.slot_pos))
    np.testing.assert_array_equal(tring.k.numpy(), np.asarray(jring.k))
    np.testing.assert_array_equal(tring.v.numpy(), np.asarray(jring.v))
    assert tring.next_pos == int(jring.next_pos)


def test_cache_is_gqa_sized():
    cfg = tllama.LlamaConfig.tiny()
    cache = tgen.KVCache.zeros(cfg, 2, 32, device="cpu")
    assert tuple(cache.k.shape) == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                                    cfg.head_dim)
    assert cache.k.dtype == torch.bfloat16 and cache.length == 0


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    return cfg, tllama.init_llama(cfg, seed=0, device="cpu")


def test_cache_full_raises(small):
    cfg, params = small
    cache = tgen.KVCache.zeros(cfg, 1, 5, device="cpu")
    _, cache = tgen.prefill(params, torch.zeros(1, 5, dtype=torch.int64),
                            cache, cfg)
    with pytest.raises(ValueError, match="KV cache full"):
        tgen.decode_step(params, torch.zeros(1, dtype=torch.int64), cache, cfg)


def test_max_len_too_small_raises(small):
    cfg, params = small
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate(params, torch.zeros(1, 16, dtype=torch.int64), cfg, 8,
                      max_len=16)


def test_rolling_window_mismatch_raises(small):
    cfg, params = small
    ring = tgen.RollingKVCache.from_prefill(
        tgen.KVCache.zeros(cfg, 1, 4, device="cpu"), 4)
    with pytest.raises(ValueError, match="rolling cache window"):
        tgen.decode_step_rolling(params, torch.zeros(1, dtype=torch.int64),
                                 ring, cfg)


def test_sampling_without_generator_raises(small):
    cfg, params = small
    with pytest.raises(ValueError, match="requires"):
        tgen.generate(params, torch.zeros(1, 4, dtype=torch.int64), cfg, 2,
                      temperature=0.5)


def test_sampling_is_deterministic_per_seed(small):
    cfg, params = small
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8)))
    f = tgen.make_generate_fn(cfg, 6, temperature=0.8)

    def run(seed):
        return f(params, prompt, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    assert a.shape == (2, 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_zero_new_tokens(small):
    cfg, params = small
    out = tgen.generate(params, torch.zeros(2, 4, dtype=torch.int64), cfg, 0)
    assert out.shape == (2, 0)
