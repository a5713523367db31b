"""The port's serving bench (yoda_scheduler_tpu_torch/bench_generate.py)
against the JAX package's bench_generate.py.

From `params_from_jax` weights of an fp32 tiny model (so that no bf16
near-tie flips a greedy argmax between the frameworks), the twin's fused
step (greedy argmax of the last logits, one decode step) driven from its
seeded cache gives the JAX package's tokens, driven the same way, for the
linear and the rolling cache; the no-cache step gives the JAX loop's.
Then the reference's slope plan and bandwidth guard, the rolling check,
the entry point on the CPU and the departure: only a spent budget skips a
cell, any other error propagates."""

import dataclasses
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu_torch import bench_generate as bg
from yoda_scheduler_tpu_torch.bench_util import make_checkpoint
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.models import params_from_jax

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

# the packages export a function named `generate` over the module's name
jgen = importlib.import_module("yoda_scheduler_tpu.models.generate")
tgen = importlib.import_module("yoda_scheduler_tpu_torch.models.generate")

F32 = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
PROMPT, NEW, WINDOW, STEPS = 16, 10, 8, 8


@functools.cache
def _model(window=None):
    """(jax config, jax params, port config, port params, prompt [2, PROMPT])."""
    jcfg = dataclasses.replace(F32, sliding_window=window)
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, PROMPT))
    return jcfg, jparams, tcfg, tparams, prompt


def _jax_fused_tokens(jcfg, jparams, prompt, rolling):
    """The reference's measure_decode driven for STEPS fused steps
    (bench_generate.py:131, 145-148, 172-183): prefill into the cache the cell
    sizes, fold it into the ring when rolling, then argmax + step; the
    token each step consumed."""
    b, s = prompt.shape
    cache = jgen.KVCache.zeros(jcfg, b, s if rolling else s + NEW)
    logits, cache = jgen.prefill(jparams, jnp.asarray(prompt), cache, jcfg)
    if rolling:
        cache = jgen.RollingKVCache.from_prefill(cache, jcfg.sliding_window)
    step_fn = jgen.decode_step_rolling if rolling else jgen.decode_step
    toks = []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, axis=-1)
        toks.append(np.asarray(tok))
        logits, cache = step_fn(jparams, tok, cache, jcfg)
    return np.stack(toks, axis=1)


@pytest.mark.parametrize("window", [None, WINDOW])
def test_fused_step_tokens_match_jax(window):
    jcfg, jparams, tcfg, tparams, prompt = _model(window)
    rolling = window is not None and window < PROMPT + NEW
    want = _jax_fused_tokens(jcfg, jparams, prompt, rolling)
    logits, cache = bg.seed_cache(tparams, tcfg, torch.from_numpy(prompt), NEW, rolling)
    assert isinstance(cache, tgen.RollingKVCache if rolling else tgen.KVCache)
    step_fn = tgen.decode_step_rolling if rolling else tgen.decode_step
    toks = []
    with torch.no_grad():
        for _ in range(STEPS):
            toks.append(torch.argmax(logits, dim=-1))
            logits, cache = bg.fused_step(tparams, logits, cache, tcfg, step_fn)
    np.testing.assert_array_equal(torch.stack(toks, dim=1).numpy(), want)


def test_no_cache_step_tokens_match_jax():
    """The reference's nc_step (bench_generate.py:237-241), four times."""
    jcfg, jparams, tcfg, tparams, prompt = _model()

    def jax_step(toks):
        logits = jllama.llama_forward(jparams, toks, jcfg)
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        return jnp.concatenate([toks[:, 1:], nxt[:, None]], axis=1)

    jt, tt = jnp.asarray(prompt), torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(4):
            jt, tt = jax_step(jt), bg.no_cache_step(tparams, tt, tcfg)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _reference_plan(new_tokens):
    """bench_generate.py:162-164."""
    warm = max(2, new_tokens // 32)
    n1 = max(4, new_tokens // 10)
    n2 = new_tokens - warm - n1 - 1
    return warm, n1, n2


def test_slope_plan_is_the_references():
    for n in range(14, 601):
        assert bg.slope_plan(n) == _reference_plan(n)
        warm, n1, n2 = bg.slope_plan(n)
        assert 1 + warm + n1 + n2 == n and n2 > n1  # the cache fills exactly
    with pytest.raises(ValueError, match="too small"):
        bg.slope_plan(8)


@pytest.mark.parametrize("batch,implied,bw,suspect", [
    (1, 5000.0, 3350.0, True), (8, 5000.0, 3350.0, False), (1, 4000.0, 3350.0, False),
    (1, 4020.1, 3350.0, True), (1, 5000.0, None, False)])
def test_bandwidth_guard_binds_at_b1_only(batch, implied, bw, suspect):
    assert bg.bandwidth_suspect(batch, implied, bw) is suspect


@pytest.mark.parametrize("batch", [1, 8])
def test_bandwidth_guard_nulls_a_b1_cell_only(batch):
    """With an absurdly low memory rate every B=1 sample is above it: the
    cell is measured twice and then nulled; a B=8 cell keeps its number."""
    _, _, tcfg, tparams, _ = _model()
    cell = bg._bench_one(tparams, tcfg, batch, PROMPT, 16, None, 1e-12, 10**6, repeats=1)
    if batch == 1:
        assert cell["decode_tokens_per_sec"] is None and "nulled" in cell["error"]
    else:
        assert cell["decode_tokens_per_sec"] > 0 and "error" not in cell


@pytest.mark.parametrize("name,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0),
                                       ("NVIDIA A100-SXM4-80GB", 2039.0),
                                       ("NVIDIA L4", None), (None, None)])
def test_memory_rate_table(name, gbps):
    assert bg.hbm_gbps(name) == gbps


def test_serving_shape_is_the_references():
    """bench_generate.py:104-106, about 950M parameters."""
    cfg = bg.serving_config(True)
    assert (cfg.vocab_size, cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim,
            cfg.max_seq_len) == (32000, 2048, 16, 16, 16, 5632, 4096)
    from yoda_scheduler_tpu_torch.bench_mfu import param_count
    assert 0.9e9 < param_count(cfg) < 1.0e9
    assert bg.run_shape(True) == (2048, 512, 1024) and bg.run_shape(False) == (64, 16, 32)


@pytest.mark.parametrize("fault", ["prompt_lost", "oldest_window", "slot_shifted",
                                   "window_one_short"])
def test_rolling_check_rejects_the_planted_rings(fault):
    """chip_smoke's planted folds, which the card's check must reject too:
    the prompt lost, the oldest window kept, and two rings one key short."""
    import chip_smoke

    _, _, tcfg, tparams, prompt = _model(WINDOW)
    fold = chip_smoke.planted_rings(tgen)[fault]
    bad = bg.rolling_check(tparams, tcfg, torch.from_numpy(prompt), fold=fold)
    assert not bad["ok"] and bad["max_rel_l2"] > bg.ROLLING_REL_L2


def test_rolling_check_passes_and_catches_a_broken_ring(monkeypatch):
    _, _, tcfg, tparams, prompt = _model(WINDOW)
    prompt = torch.from_numpy(prompt)
    good = bg.rolling_check(tparams, tcfg, prompt)
    assert good["ok"] and len(good["rel_l2"]) == STEPS and good["max_rel_l2"] < 1e-5

    class DroppedPrompt(tgen.RollingKVCache):
        """A ring that loses the prompt's keys and values when it folds."""
        @classmethod
        def from_prefill(cls, cache, window):
            ring = tgen.RollingKVCache.from_prefill(cache, window)
            ring.k.zero_()
            ring.v.zero_()
            return ring

    monkeypatch.setattr(bg, "RollingKVCache", DroppedPrompt)
    bad = bg.rolling_check(tparams, tcfg, prompt)
    assert not bad["ok"] and bad["max_rel_l2"] > bg.ROLLING_REL_L2
    with pytest.raises(bg.RollingMismatch):
        bg._bench_one(tparams, tcfg, 1, PROMPT, 16, WINDOW, None, 1, repeats=1)


def test_rolling_check_runs_a_bf16_model_in_fp32():
    """The cells' bf16 weights are cast to fp32 for the check (the norms
    already are), and the sound ring reads at fp32's rounding."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), sliding_window=WINDOW)
    params = tllama.init_llama(cfg, seed=0, device="cpu")
    cast, cast_cfg = bg.cast_params(params, cfg, "float32")
    assert cast_cfg.dtype == "float32" and cast["layers"][0]["wq"].dtype == torch.float32
    assert cast["layers"][0]["attn_norm"] is params["layers"][0]["attn_norm"]
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, PROMPT)))
    good = bg.rolling_check(params, cfg, prompt)
    assert good["dtype"] == "float32" and good["ok"] and good["max_rel_l2"] < 1e-5


# -------------------------------------------------------------- departures
def _off_ckpt():
    return make_checkpoint("BENCH_GEN_TEST_CKPT_UNSET", "off", lambda msg: None)


def test_a_spent_budget_skips_cells_and_nothing_else_does(monkeypatch):
    calls = []

    def fake_one(params, config, b, prompt_len, new_tokens, w, bw, param_bytes, repeats):
        calls.append((b, w))
        return {"batch": b, "window": w, "decode_tokens_per_sec": 1.0}

    monkeypatch.setattr(bg, "_bench_one", fake_one)
    cells = bg.run_cells(None, None, False, _off_ckpt(), None, 1, remaining=lambda: 0.0)
    assert calls == [(1, None)]
    assert cells[1:] == [{"batch": 1, "window": 32, "skipped": "budget"},
                         {"batch": 8, "window": None, "skipped": "budget"},
                         {"batch": 8, "window": 32, "skipped": "budget"}]

    def broken(*args):
        raise RuntimeError("an illegal memory access was encountered")

    monkeypatch.setattr(bg, "_bench_one", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        bg.run_cells(None, None, False, _off_ckpt(), None, 1)


REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "cells", "no_cache_baseline",
                  "backend", "model_params", "device_kind"}


def test_main_on_the_cpu_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_GEN_CKPT", "off")
    assert bg.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert REFERENCE_KEYS <= set(out)
    assert out["metric"] == "llama_decode_tokens_per_sec" and out["backend"] == "cpu"
    assert [(c["batch"], c["window"]) for c in out["cells"]] == [(1, None), (1, 32),
                                                                (8, None), (8, 32)]
    assert all(c["decode_tokens_per_sec"] > 0 for c in out["cells"])
    assert [c["rolling_check"]["ok"] for c in out["cells"] if c["window"]] == [True, True]
    assert out["no_cache_baseline"]["batch"] == 8
    assert out["vs_baseline"] == pytest.approx(
        out["cells"][2]["decode_tokens_per_sec"] / out["no_cache_baseline"]["tokens_per_sec"])


def test_main_without_cuda_exits_non_zero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bg.main([]) == 2
    assert capsys.readouterr().out == ""
