"""Inference bench on one NVIDIA GPU: Llama prefill latency and KV-cache
decode throughput. The port's twin of the JAX package's bench_generate.py.

    python3 -m yoda_scheduler_tpu_torch.bench_generate [--device cuda|cpu]

For the ~950M-parameter shape bench_mfu trains at width 2048 (16 layers,
16 heads, ffn 5632, vocab 32000; 1.9 GB of bf16 weights), at B in {1, 8}
with a 2048-token prompt and 512 new tokens, it measures:

- prefill ms: the prompt into a fresh KV cache, one forward; the median
  of `repeats`.
- steady-state decode tokens/s: an eager loop of the "fused step", the
  greedy argmax of the last logits and one decode step (the reference
  jits the pair as one dispatch; here it is the port's eager step, about
  1,400 launches). Timed as the slope between a short and a long run of
  steps sized from the new tokens (warm = max(2, N/32), n1 = max(4, N/10),
  n2 = N - warm - n1 - 1, the reference's plan), each from a freshly
  seeded cache; the median of `repeats` slopes. Beside it, the least time
  a step could take, the weights read once at the card's memory rate.
- the same under sliding-window attention (window=1024): the prefill cache
  folds into the ring (`RollingKVCache.from_prefill`) and decode runs
  `decode_step_rolling`. Before timing, the rolling decode is held against
  the linear-cache decode of the same windowed model from one prefill
  over 8 steps (the same tokens), logits by rel. L2 <= ROLLING_REL_L2,
  with the weights cast to fp32 (see ROLLING_REL_L2).

vs_baseline: cached decode against generation with no KV cache, the full
`llama_forward` (one flash_fwd a layer) re-run per token at B=8 with the
window of tokens shifted, timed as the slope between 2 and 4 tokens.

Sanity guard: at B=1 decode streams the weights once a step; a sample
whose implied rate exceeds 1.2x the card's memory rate (`hbm_gbps`) is
measured again and then nulled.

Departures from the reference, each a failure it hid: without CUDA it
exits 2 unless `--device cpu` is given (the reference's tiny CPU shapes);
a cell is reported as skipped only when the budget ran out, and any other
error ends the run non-zero (the reference records it and exits 0); the
watchdog exits non-zero.

Output: the card's name and power limit (nvidia-smi), then ONE JSON line
with the reference's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace

import torch

from .bench_util import (detect_card, free_memory, make_budget, make_checkpoint,
                         make_progress, make_sync, start_watchdog, unbounded)
from .models.generate import (KVCache, RollingKVCache, decode_step, decode_step_rolling,
                              prefill)
from .models.llama import LlamaConfig, init_llama, llama_forward
from .parallel.train import param_leaves
from .tools import tune_attention as tune
from .topology.gpus import model_of_nvml_name

METRIC, UNIT = "llama_decode_tokens_per_sec", "tok/s"
BUDGET_ENV, BUDGET_DEFAULT_S = "BENCH_GEN_BUDGET_S", 480.0
CKPT_ENV, CKPT_DEFAULT = "BENCH_GEN_CKPT", "BENCH_GENERATE_TORCH.ckpt.json"
PACKAGE = "yoda_scheduler_tpu_torch"
# memory rate of each catalog model, GB/s (NVIDIA's data sheets): the
# decode sanity ceiling and the weights' roofline
HBM_GBPS = {"h100-sxm5": 3350.0, "h100-pcie": 2000.0, "a100-sxm4-80gb": 2039.0}
# rolling against linear decode from one prefill: the two caches hold the
# same keys, and the paths differ only in the order each step's attention
# sums them (over the ring's slots, or over the whole linear cache). In
# bf16 that order flips an output ulp now and then and 16 layers carry it
# on: at width 2048 on an H100 the sound ring read 1.7e-2 in bf16 and the
# two rings one key short (chip_smoke.planted_rings) 2.2e-2 and 2.8e-2. So
# the check casts the weights to fp32, where the same card read 1.2e-6 for
# the sound ring and 7.5e-3 and 1.8e-2 for those two.
ROLLING_REL_L2 = 1e-4
ROLLING_CHECK_DTYPE = "float32"
ROLLING_CHECK_STEPS = 8
BANDWIDTH_SLACK = 1.2

_progress = make_progress("bench_generate")
_sync = make_sync()


def hbm_gbps(nvml_name: str | None) -> float | None:
    """The card's memory rate, GB/s; None for a card not in the table."""
    return HBM_GBPS.get(model_of_nvml_name(nvml_name)) if nvml_name else None


def serving_config(on_card: bool) -> LlamaConfig:
    """The shape bench_mfu trains at width 2048 (bench_generate.py:98-108);
    the tiny shape on the CPU."""
    if on_card:
        return LlamaConfig(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
                           n_kv_heads=16, ffn_dim=5632, max_seq_len=4096)
    return LlamaConfig.tiny()


def run_shape(on_card: bool) -> tuple[int, int, int]:
    """(prompt_len, new_tokens, window)."""
    return (2048, 512, 1024) if on_card else (64, 16, 32)


def slope_plan(new_tokens: int) -> tuple[int, int, int]:
    """(warm, n1, n2): the reference's segments; with the one step that
    precedes them they fill exactly `new_tokens` cache slots."""
    warm = max(2, new_tokens // 32)
    n1 = max(4, new_tokens // 10)
    n2 = new_tokens - warm - n1 - 1
    if n2 <= n1:
        raise ValueError(f"new_tokens={new_tokens} too small for the slope plan")
    return warm, n1, n2


def bandwidth_suspect(batch: int, implied_gbps: float, bw_peak_gbps: float | None) -> bool:
    """Only B=1 is bound by the weights' reads (a batch shares them), so only
    there does a rate above the card's memory rate expose a bad sample."""
    return (bw_peak_gbps is not None and batch == 1
            and implied_gbps > BANDWIDTH_SLACK * bw_peak_gbps)


def make_prompt(seed: int, batch: int, prompt_len: int, vocab: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, (batch, prompt_len), generator=gen, device=device)


def seed_cache(params, cfg: LlamaConfig, prompt, new_tokens: int, rolling: bool):
    """Prefill a fresh cache: prompt + new_tokens slots, or the prompt's,
    folded into the ring of cfg.sliding_window slots when `rolling`.
    Returns (last logits [B, vocab], cache)."""
    b, s = prompt.shape
    cache = KVCache.zeros(cfg, b, s if rolling else s + new_tokens, device=prompt.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    if rolling:
        cache = RollingKVCache.from_prefill(cache, cfg.sliding_window)
    return logits, cache


def fused_step(params, logits, cache, cfg: LlamaConfig, step_fn):
    """The greedy token of the last logits, then one decode step."""
    return step_fn(params, torch.argmax(logits, dim=-1), cache, cfg)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def cast_params(params, cfg: LlamaConfig, dtype: str):
    """(params, cfg) in `dtype`: every leaf in cfg's dtype cast to it (the
    fp32 norms stay as they are)."""
    if dtype == cfg.dtype:
        return params, cfg
    old, new = cfg.torch_dtype, getattr(torch, dtype)

    def cast(t):
        return t.to(new) if t.dtype == old else t

    return ({**{n: cast(t) for n, t in params.items() if n != "layers"},
             "layers": [{n: cast(t) for n, t in layer.items()}
                        for layer in params["layers"]]},
            replace(cfg, dtype=dtype))


@torch.no_grad()
def rolling_check(params, cfg: LlamaConfig, prompt, fold=None,
                  dtype: str = ROLLING_CHECK_DTYPE) -> dict:
    """The ring decode against the linear-cache decode of the same windowed
    model in `dtype`, from one prefill (`fold`, RollingKVCache.from_prefill
    by default, copies its window into the ring): the logits of
    ROLLING_CHECK_STEPS decode steps fed the linear run's greedy tokens, by
    rel. L2."""
    params, cfg = cast_params(params, cfg, dtype)
    fold = fold or RollingKVCache.from_prefill
    steps = ROLLING_CHECK_STEPS
    lin_logits, lin = seed_cache(params, cfg, prompt, steps, rolling=False)
    rol, rol_logits = fold(lin, cfg.sliding_window), lin_logits
    errs = []
    for _ in range(steps):
        tok = torch.argmax(lin_logits, dim=-1)
        lin_logits, lin = decode_step(params, tok, lin, cfg)
        rol_logits, rol = decode_step_rolling(params, tok, rol, cfg)
        errs.append(_rel_l2(rol_logits, lin_logits))
    return {"steps": steps, "dtype": dtype, "rel_l2": errs, "max_rel_l2": max(errs),
            "bound": ROLLING_REL_L2, "ok": max(errs) <= ROLLING_REL_L2}


class RollingMismatch(RuntimeError):
    """The ring decode disagrees with the linear decode: a fault of the
    port, not of the bench."""


@torch.no_grad()
def _bench_one(params, config: LlamaConfig, batch: int, prompt_len: int, new_tokens: int,
               window: int | None, bw_peak_gbps: float | None, param_bytes: int,
               repeats: int = 3) -> dict:
    """One (batch, window) cell: prefill ms and steady-state decode tokens/s.
    Windowed cells decode against the ring cache (O(window) memory), full
    attention ones against the prompt + new sized cache."""
    cfg = replace(config, sliding_window=window)
    rolling = window is not None and window < prompt_len + new_tokens
    device = params["embed"].device
    prompt = make_prompt(1, batch, prompt_len, cfg.vocab_size, device)

    def run_prefill():
        cache = KVCache.zeros(cfg, batch, prompt_len if rolling else prompt_len + new_tokens,
                              device=device)
        return prefill(params, prompt, cache, cfg)[0]

    _sync(run_prefill())  # warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(run_prefill())
        ts.append(time.perf_counter() - t0)
    t_prefill = sorted(ts)[len(ts) // 2]
    _progress(f"B={batch} window={window}: prefill timed")

    check = None
    if rolling:
        check = rolling_check(params, cfg, prompt)
        if not check["ok"]:
            raise RollingMismatch(f"B={batch} window={window}: rolling decode against "
                                  f"linear: {check}")

    step_fn = decode_step_rolling if rolling else decode_step
    warm, n1, n2 = slope_plan(new_tokens)
    n = n2 - n1

    def run_steps(k, logits, cache):
        t0 = time.perf_counter()
        for _ in range(k):
            logits, cache = fused_step(params, logits, cache, cfg, step_fn)
        _sync(logits)
        return time.perf_counter() - t0, logits, cache

    def measure_decode():
        """Seed a fresh cache, one step, warm, then the slope."""
        logits, cache = seed_cache(params, cfg, prompt, new_tokens, rolling)
        logits, cache = fused_step(params, logits, cache, cfg, step_fn)
        _sync(logits)
        _, logits, cache = run_steps(warm, logits, cache)
        t1, logits, cache = run_steps(n1, logits, cache)
        t2, logits, cache = run_steps(n2, logits, cache)
        return max(t2 - t1, 1e-9)

    def median_slope():
        slopes = sorted(measure_decode() for _ in range(repeats))
        return slopes[len(slopes) // 2]

    t_decode = median_slope()
    _progress(f"B={batch} window={window}: decode timed")
    implied_gbps = param_bytes * (n / t_decode) / 1e9
    if bandwidth_suspect(batch, implied_gbps, bw_peak_gbps):
        _progress(f"B={batch}: implies {implied_gbps:.0f} GB/s > spec {bw_peak_gbps:.0f}; "
                  "re-measuring")
        t_decode = median_slope()
        implied_gbps = param_bytes * (n / t_decode) / 1e9
        if bandwidth_suspect(batch, implied_gbps, bw_peak_gbps):
            return {"batch": batch, "window": window, "prefill_ms": t_prefill * 1e3,
                    "decode_tokens_per_sec": None, "rolling_check": check,
                    "error": "implied memory rate above spec; sample nulled"}
    return {
        "batch": batch,
        "window": window,
        "rolling": rolling,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "steps_timed": n,
        "prefill_ms": t_prefill * 1e3,
        "decode_step_ms": t_decode * 1e3 / n,
        "weights_roofline_ms": (param_bytes / (bw_peak_gbps * 1e9) * 1e3
                                if bw_peak_gbps else None),
        "decode_tokens_per_sec": batch * n / t_decode,
        "implied_weights_gbps_lower_bound": implied_gbps,
        "rolling_check": check,
    }


def no_cache_step(params, toks, config: LlamaConfig):
    """Generation with no KV cache: the full forward over the window of
    tokens, its last position's greedy token appended and the oldest
    dropped."""
    logits = llama_forward(params, toks, config)
    nxt = torch.argmax(logits[:, -1], dim=-1)
    return torch.cat([toks[:, 1:], nxt[:, None]], dim=1)


@torch.no_grad()
def no_cache_baseline(params, config: LlamaConfig, batch: int, prompt_len: int,
                      repeats: int = 3) -> dict:
    """Tokens/s of generation with no KV cache, the slope between 2 and 4
    tokens (each the median of `repeats`) after one warm token."""
    prompt = make_prompt(2, batch, prompt_len, config.vocab_size, params["embed"].device)

    def gen_time(n):
        toks = prompt.clone()
        t0 = time.perf_counter()
        for _ in range(n):
            toks = no_cache_step(params, toks, config)
        _sync(toks)
        return time.perf_counter() - t0

    gen_time(1)
    t2 = sorted(gen_time(2) for _ in range(repeats))[repeats // 2]
    t4 = sorted(gen_time(4) for _ in range(repeats))[repeats // 2]
    per_tok = max(t4 - t2, 1e-9) / 2
    return {"batch": batch, "prompt_len": prompt_len, "tokens_per_sec": batch / per_tok,
            "per_token_ms": per_tok * 1e3}


def weight_bytes(params) -> tuple[int, int]:
    """(bytes, count) of every parameter."""
    leaves = param_leaves(params)
    return (sum(t.numel() * t.element_size() for t in leaves),
            sum(t.numel() for t in leaves))


def run_cells(params, config: LlamaConfig, on_card: bool, ckpt, bw: float | None,
              param_bytes: int, remaining=unbounded, repeats: int = 3) -> list:
    """B in {1, 8} x window in {None, the run's}: a cell checkpointed, or
    skipped once the budget is spent, or measured; an error propagates."""
    prompt_len, new_tokens, window = run_shape(on_card)
    cells = []
    for b in (1, 8):
        for w in (None, window):
            saved = ckpt.get(f"cell.b{b}.w{w}")
            if saved is not None:
                _progress(f"cell B={b} window={w}: reusing checkpointed section")
                cells.append(saved)
                continue
            if cells and remaining() < 90:
                cells.append({"batch": b, "window": w, "skipped": "budget"})
                continue
            cell = _bench_one(params, config, b, prompt_len, new_tokens, w, bw,
                              param_bytes, repeats)
            cells.append(cell)
            if "error" not in cell:  # a nulled sample is measured again next run
                ckpt.put(f"cell.b{b}.w{w}", cell)
            free_memory()
    return cells


def result(cells: list, baseline, n_params: int, card, smi: str | None,
           backend: str) -> dict:
    """The one JSON line, with the reference's keys. vs_baseline: cached
    decode against no-cache generation at B=8."""
    headline = next((c for c in cells if c.get("batch") == 8 and c.get("window") is None
                     and c.get("decode_tokens_per_sec")), None)
    vs = None
    if headline and isinstance(baseline, dict) and baseline.get("tokens_per_sec"):
        vs = headline["decode_tokens_per_sec"] / baseline["tokens_per_sec"]
    return {
        "metric": METRIC,
        "value": headline["decode_tokens_per_sec"] if headline else None,
        "unit": UNIT,
        "vs_baseline": vs,
        "backend": backend,
        "model_params": n_params,
        "device_kind": card.name if card else "cpu",
        "catalog_model": card.model.name if card and card.model else None,
        "nvidia_smi": smi,
        "cells": cells,
        "no_cache_baseline": baseline,
    }


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m yoda_scheduler_tpu_torch.bench_generate",
        description="Llama prefill and KV-cache decode bench on one NVIDIA GPU.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the reference's tiny shapes on the plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_generate: CUDA is not available; pass --device cpu for the tiny "
              "CPU run", file=sys.stderr)
        return 2
    budget, remaining = make_budget(BUDGET_ENV, BUDGET_DEFAULT_S)
    watchdog = start_watchdog(METRIC, UNIT, budget)
    try:
        card = detect_card(args.device)
        on_card = card is not None
        smi = tune.card() if on_card else None
        if smi:
            print(smi, flush=True)
        config = serving_config(on_card)
        params = init_llama(config, seed=0, device=args.device)
        param_bytes, n_params = weight_bytes(params)
        _progress(f"params: {n_params / 1e6:.0f}M ({param_bytes / 1e9:.2f} GB)")
        prompt_len, new_tokens, _ = run_shape(on_card)
        bw = hbm_gbps(card.name) if card else None
        ckpt = make_checkpoint(CKPT_ENV, CKPT_DEFAULT, _progress)
        ckpt.bind_context(card=card.name if card else "cpu", package=PACKAGE,
                          n_params=n_params, prompt_len=prompt_len, new_tokens=new_tokens)
        cells = run_cells(params, config, on_card, ckpt, bw, param_bytes, remaining)
        baseline = ckpt.get("baseline")
        if baseline is not None:
            _progress("no-cache baseline: reusing checkpointed section")
        elif remaining() > 60:
            # B=8, as the headline cell: a cache-vs-no-cache comparison
            baseline = no_cache_baseline(params, config, 8, prompt_len)
            ckpt.put("baseline", baseline)
        else:
            baseline = {"skipped": "budget"}
    finally:
        watchdog.cancel()
    if not any("error" in c for c in cells):
        ckpt.clear()  # clean run: the printed line now owns the numbers
    print(json.dumps(result(cells, baseline, n_params, card, smi, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
