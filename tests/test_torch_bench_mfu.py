"""The port's train/attention bench (yoda_scheduler_tpu_torch/bench_mfu.py)
against the JAX package's bench_mfu.py.

The timed functions: each q-chained loop, fed the same inputs from a numpy
seed, against the same loop over the JAX package's `flash_attention` (its
Pallas kernels in interpret mode on the CPU) at fp32, as the reference
builds it (bench_mfu.py:205-207, 284-299, 355-362, 393-396). The
accounting: parameter counts against `jax.eval_shape(init_llama)`, and
the MFU formula against the reference's expression. The entry point on
the CPU, and the departures: only an OOM stops the escalation or nulls a
sample."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.ops import attention as jattn
from yoda_scheduler_tpu_torch import bench_mfu
from yoda_scheduler_tpu_torch.bench_util import make_checkpoint
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.ops import attention as tattn
from yoda_scheduler_tpu_torch.tools import tune_attention as tune_mod

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

# fp32 on both sides, differing only in summation order: the tolerances of
# tests/test_torch_attention.py (O: 1e-5; the backward: 5e-5), held by the
# output of a chain of CHAIN calls
FWD_TOL, BWD_TOL = 1e-5, 5e-5
CHAIN = 3
B, H, KVH, S, D, WINDOW = 1, 4, 1, 128, 32, 48


def _inputs(kvh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, H, S, D), (B, kvh, S, D), (B, kvh, S, D))]


def _jax_chain(fn, q, k, v, n):
    """The reference's loop body, `fn(x, k, v).astype(q.dtype)` carried
    into the next q (bench_mfu.py:206-207), n times."""
    x = q
    for _ in range(n):
        x = fn(x, k, v).astype(q.dtype)
    return np.asarray(x)


def _jax_grad(fn):
    """The reference's mk_grad (bench_mfu.py:284-286)."""
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32)))


# name -> (kv heads, port fn, JAX fn, tolerance a call)
CASES = {
    "fwd": (H, bench_mfu.flash_fwd_fn,
            lambda q, k, v: jattn.flash_attention(q, k, v, causal=True), FWD_TOL),
    "plain_fwd": (H, bench_mfu.plain_fwd_fn,
                  lambda q, k, v: jattn.reference_attention(q, k, v, causal=True), FWD_TOL),
    "grad_q": (H, bench_mfu.grad_q(bench_mfu.flash_fwd_fn),
               _jax_grad(lambda q, k, v: jattn.flash_attention(q, k, v, causal=True)),
               BWD_TOL),
    "plain_grad_q": (H, bench_mfu.grad_q(bench_mfu.plain_fwd_fn),
                     _jax_grad(lambda q, k, v: jattn.reference_attention(q, k, v,
                                                                         causal=True)),
                     BWD_TOL),
    "gqa_grouped": (KVH, bench_mfu.flash_fwd_fn,
                    lambda q, k, v: jattn.flash_attention(q, k, v, causal=True), FWD_TOL),
    # jnp.repeat(k, 4, axis=1) repeats each head in place: head h reads kv
    # head h // 4, which repeat_interleave does (and torch's repeat does not)
    "gqa_repeated": (KVH, bench_mfu.gqa_repeated_fn,
                     lambda q, k, v: jattn.flash_attention(
                         q, jnp.repeat(k, H // KVH, axis=1), jnp.repeat(v, H // KVH, axis=1),
                         causal=True), FWD_TOL),
    "window": (H, lambda q, k, v: bench_mfu.flash_fwd_fn(q, k, v, window=WINDOW),
               lambda q, k, v: jattn.flash_attention(q, k, v, causal=True, window=WINDOW),
               FWD_TOL),
}


@pytest.mark.parametrize("case", list(CASES))
def test_timed_chain_matches_jax(case):
    kvh, port_fn, jax_fn, tol = CASES[case]
    arrs = _inputs(kvh)
    want = _jax_chain(jax_fn, *(jnp.asarray(a) for a in arrs), CHAIN)
    got = bench_mfu.chain(port_fn, *(torch.from_numpy(a) for a in arrs), CHAIN)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, S, D)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_repeat_is_not_the_twin_of_jnp_repeat():
    """The trap the GQA row avoids: torch's `repeat` tiles the heads (head h
    reads kv head h % kvh) and gives another function at kvh > 1."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 64, 32), dtype=np.float32))
               for _ in range(3))
    k2, v2 = k[:, :2], v[:, :2]
    grouped = tattn.flash_attention(q, k2, v2)
    assert torch.allclose(bench_mfu.gqa_repeated_fn(q, k2, v2), grouped, atol=1e-6)
    tiled = tattn.flash_attention(q, k2.repeat(1, 2, 1, 1), v2.repeat(1, 2, 1, 1))
    assert not torch.allclose(tiled, grouped, atol=1e-3)


# SDPA's flash backend takes no mask, so the window row has no flash call
@pytest.mark.parametrize("kvh,window,flash", [(H, None, False), (H, None, True),
                                              (KVH, None, False), (KVH, None, True),
                                              (H, WINDOW, False)])
def test_library_call_computes_the_rows_function(kvh, window, flash):
    """SDPA beside each row computes the row's function: against the plain
    attention at fp32 (grouped KV through enable_gqa, the window through
    a boolean mask)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(kvh, seed=1))
    mask = bench_mfu.window_mask(S, window, q.device)
    want = tattn.reference_attention(q, k, v, causal=True, window=window)
    got = bench_mfu.sdpa_fn(q, k, v, flash=flash, mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL, rtol=FWD_TOL)
    assert bench_mfu.sdpa_default_backend(q, k, v, mask) in (
        "MATH", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


# ------------------------------------------------------------- accounting
def _jax_config(cfg):
    return jllama.LlamaConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("index", range(4))
def test_candidate_param_count_matches_jax_eval_shape(index):
    cfg, _, _ = bench_mfu.train_candidates(True)[index]
    shapes = jax.eval_shape(lambda: jllama.init_llama(_jax_config(cfg),
                                                      jax.random.PRNGKey(0)))
    assert bench_mfu.param_count(cfg) == sum(x.size for x in jax.tree.leaves(shapes))


def test_param_count_is_the_ports_init():
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_llama(cfg, device="cpu")
    n = sum(t.numel() for t in [params["embed"], params["final_norm"], params["lm_head"]]
            + [t for layer in params["layers"] for t in layer.values()])
    assert bench_mfu.param_count(cfg) == n
    with pytest.raises(ValueError, match="dense"):
        bench_mfu.param_count(tllama.LlamaConfig.tiny_moe())


def test_candidates_are_the_references_then_7b():
    got = [(c.dim, c.n_layers, c.n_heads, c.n_kv_heads, c.ffn_dim, b, s)
           for c, b, s in bench_mfu.train_candidates(True)]
    assert got == [(1024, 8, 16, 16, 4096, 8, 2048), (1024, 16, 16, 16, 4096, 8, 2048),
                   (2048, 16, 16, 16, 5632, 4, 2048), (4096, 32, 32, 32, 11008, 1, 2048)]
    counts = [bench_mfu.param_count(c) for c, _, _ in bench_mfu.train_candidates(True)]
    assert counts == sorted(counts)  # ascending: the smallest gives a number first
    assert [(c.dim, b, s) for c, b, s in bench_mfu.train_candidates(False)] == [(128, 2, 256)]


@pytest.mark.parametrize("index", range(4))
def test_mfu_is_the_references_formula(index):
    """bench_mfu.py:152-170 on the same inputs."""
    config, batch, seq = bench_mfu.train_candidates(True)[index]
    n_params, dt, peak = bench_mfu.param_count(config), 0.3371, 989e12
    tokens_per_step = batch * seq
    flops_per_token = 6 * n_params + 6 * config.n_layers * config.dim * seq
    flops_per_sec = flops_per_token * tokens_per_step / dt
    got = bench_mfu.train_metrics(n_params, config, batch, seq, dt, peak)
    assert got["tokens_per_sec"] == pytest.approx(tokens_per_step / dt, rel=1e-12)
    assert got["model_tflops_per_sec"] == pytest.approx(flops_per_sec / 1e12, rel=1e-12)
    assert got["mfu_pct"] == pytest.approx(100 * flops_per_sec / peak, rel=1e-12)
    assert bench_mfu.train_metrics(n_params, config, batch, seq, dt, None)["mfu_pct"] is None


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA A100-SXM4-80GB", 312e12),
                                       ("NVIDIA L4", None), (None, None)])
def test_peak_is_the_cards_catalog_row(name, peak):
    assert bench_mfu.peak_flops(name) == peak


def test_attention_plan_is_the_references():
    assert bench_mfu.attention_plan(True) == ([2048, 4096, 8192], 8192, 4, 24)
    assert bench_mfu.attention_plan(False) == ([256], 512, 1, 3)


# -------------------------------------------------------------- departures
def _off_ckpt():
    return make_checkpoint("BENCH_MFU_TEST_CKPT_UNSET", "off", lambda msg: None)


def test_only_oom_stops_the_escalation(monkeypatch):
    calls = []

    def fake_train(config, batch, seq, device, peak, steps):
        calls.append(config.dim)
        if len(calls) == 3:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return {"model_params": 1, "batch": batch, "seq": seq, "step_time_s": 1.0,
                "tokens_per_sec": 1.0, "model_tflops_per_sec": 1.0, "peak_tflops": None,
                "mfu_pct": float(len(calls)), "final_loss": 1.0}

    monkeypatch.setattr(bench_mfu, "_train_one", fake_train)
    out = bench_mfu.llama_train_bench(True, _off_ckpt(), "cpu")
    assert calls == [1024, 1024, 2048]  # the 7B candidate is never tried
    assert out["mfu_pct"] == 2.0
    assert out["attempts"][-1] == {"dim": 2048, "layers": 16, "error": "OutOfMemoryError"}


def test_any_other_train_error_propagates(monkeypatch):
    def broken(*args):
        raise RuntimeError("flash_fwd (wgmma) launch failed with CUDA error 700")

    monkeypatch.setattr(bench_mfu, "_train_one", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        bench_mfu.llama_train_bench(True, _off_ckpt(), "cpu")


def test_kernel_time_is_none_on_oom_only():
    q = torch.zeros(1, 1, 8, 32)

    def oom(q, k, v):
        raise torch.OutOfMemoryError("CUDA out of memory")

    def broken(q, k, v):
        raise RuntimeError("an illegal memory access was encountered")

    assert bench_mfu._kernel_time_s(oom, q, q, q, 1, 3) is None
    with pytest.raises(RuntimeError, match="illegal memory access"):
        bench_mfu._kernel_time_s(broken, q, q, q, 1, 3)
    assert bench_mfu._kernel_time_s(lambda q, k, v: q + 1, q, q, q, 1, 3) > 0


def test_above_peak_sample_is_measured_again_then_nulled():
    again = []

    def remeasure(t):
        def go():
            again.append(t)
            return t
        return go

    # 1e15 FLOPs in 1 ms is 1e18 FLOP/s, above a 1e15 peak
    assert bench_mfu.plausible_or_none(1e-3, 1e15, 1e15, "x", remeasure(1e-3)) is None
    assert bench_mfu.plausible_or_none(1e-3, 1e15, 1e15, "x", remeasure(2.0)) == 2.0
    assert bench_mfu.plausible_or_none(2.0, 1e15, 1e15, "x", remeasure(9.0)) == 2.0
    assert bench_mfu.plausible_or_none(1e-3, 1e15, None, "x", remeasure(9.0)) == 1e-3
    assert again == [1e-3, 2.0]


# -------------------------------------------------------------- entry point
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "train", "attention"}


def test_main_on_the_cpu_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_MFU_CKPT", "off")
    assert bench_mfu.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert REFERENCE_KEYS <= set(out)
    assert out["metric"] == "llama_train_mfu" and out["backend"] == "cpu"
    assert out["unit"] == "TFLOP/s" and out["train"]["mfu_pct"] is None  # no card, no peak
    row = out["attention"]["S256"]
    for key in ("flash_fwd_ms", "plain_fwd_ms", "flash_fwdbwd_ms", "plain_fwdbwd_ms",
                "sdpa_default_fwd_ms", "sdpa_flash_fwd_ms"):
        assert isinstance(row[key], float) and row[key] > 0
    assert out["vs_baseline"] == row["fwd_speedup"]


def test_main_without_cuda_exits_non_zero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_mfu.main([]) == 2
    assert capsys.readouterr().out == ""


# ------------------------------------------------- checked before timing
@pytest.fixture
def plain_kernels(monkeypatch):
    """The three wrappers replaced by their plain versions on CPU tensors;
    the check's rows at S = 64 and 128 (B S = 256), window 32."""
    ref = tattn.reference_attention_with_lse

    def bwd(q, k, v, do, lse, delta, causal=True, window=None):
        return tattn.flash_backward_reference(q, k, v, ref(q, k, v, causal, window)[0], lse,
                                              do, causal, window)

    monkeypatch.setattr(tattn, "flash_fwd", lambda q, k, v, causal=True, window=None:
                        ref(q, k, v, causal, window))
    monkeypatch.setattr(tattn, "flash_bwd_dq", lambda *a: bwd(*a)[0])
    monkeypatch.setattr(tattn, "flash_bwd_dkv", lambda *a: bwd(*a)[1:])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(bench_mfu, "attention_plan", lambda on_card: ([64, 128], 256, 1, 3))
    monkeypatch.setattr(bench_mfu, "WINDOW", 32)


def test_every_row_is_checked_before_timing(plain_kernels):
    checks = bench_mfu.check_attention("cpu")
    assert sorted(checks) == ["S128", "S64", "gqa_16q_4kv", "window_1024"]
    assert all(c["ok"] for c in checks.values())
    assert "worst_tile" in checks["S64"] and "max_abs_err_grouped_vs_repeated" in \
        checks["gqa_16q_4kv"]


def test_a_spent_budget_reports_each_row_it_drops(plain_kernels):
    """The first S is always timed; every row after it that the budget
    leaves out is reported as skipped, none dropped silently."""
    rows = bench_mfu.time_attention(True, _off_ckpt(), None, "cpu", remaining=lambda: 0.0)
    assert sorted(rows) == ["S128", "S64", "gqa_16q_4kv", "window_1024"]
    assert isinstance(rows["S64"]["flash_fwd_ms"], float)
    assert [rows[k] for k in ("S128", "gqa_16q_4kv", "window_1024")] == [
        {"skipped": "budget"}] * 3


@pytest.mark.parametrize("fault", ["non_causal", "no_window", "tiled_gqa"])
def test_a_wrong_kernel_fails_its_rows_check(plain_kernels, monkeypatch, fault):
    """A forward that drops the causal mask, ignores the window, or reads
    the wrong KV head (torch's repeat) is refused before any timing."""
    ref = tattn.reference_attention_with_lse

    def wrong(q, k, v, causal=True, window=None):
        if fault == "non_causal":
            return ref(q, k, v, False, None)
        if fault == "no_window":
            return ref(q, k, v, causal, None)
        group = q.shape[1] // k.shape[1]
        return ref(q, k.repeat(1, group, 1, 1), v.repeat(1, group, 1, 1), causal, window)

    monkeypatch.setattr(tattn, "flash_fwd", wrong)
    with pytest.raises(tune_mod.CheckFailed):
        bench_mfu.check_attention("cpu")
