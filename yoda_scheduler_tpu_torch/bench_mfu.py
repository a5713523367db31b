"""Workload bench on one NVIDIA GPU: the Llama train step's MFU and the
flash-attention micro-bench. The port's twin of the JAX package's
bench_mfu.py.

    python3 -m yoda_scheduler_tpu_torch.bench_mfu [--device cuda|cpu]

It runs the training step the scheduler places (models/llama.py and
parallel/train.py: bf16, remat, AdamW) and reports:

- tokens/s and MFU for the reference's three candidate widths (d1024 L8
  B8, d1024 L16 B8, d2048 L16 B4, all S=2048) and then Llama-2-7B at B=1,
  S=2048, the largest that fits the 80 GB card (54 GB): one warm step,
  then 10 steps timed with one fence. MFU = (6N + 6 L d S) tokens/s over
  the card's bf16 dense peak from its catalog row (`topology/gpus.py`),
  the reference's convention (remat not counted); None on a card the
  catalog lacks.
- causal attention, H=16, D=128, bf16, B = 8192/S at S = 2048, 4096 and
  8192: the flash kernels (`flash_attention`) against the plain
  `reference_attention`, forward and "fwd+bwd". "fwd+bwd" is the gradient
  of sum(O) with respect to q alone, as `jax.grad`'s default argnums=0;
  the port's backward (`_FlashFwd.backward`) launches the dK/dV kernel
  beside the dQ kernel all the same, and that is what is timed here.
  Then GQA 16q/4kv at the longest S, grouped against K and V repeated to
  16 heads (`repeat_interleave`, the twin of `jnp.repeat`), and
  window=1024 against full causal at the longest S. Beside each row:
  SDPA under its default backend (whose choice is named) and under its
  flash backend forced (`tools/tune_attention._sdpa`; it takes no mask,
  so the window row has none).

Each time is the slope of a q-chained loop (the output cast to q's dtype
is the next call's q) between 4 and 24 calls, host clock around the calls
and one fence, the median of READINGS readings at each length. A sample
implying more than the card's peak is measured once more, then nulled.
A row the budget leaves out is reported as {"skipped": "budget"}.

Departures from the reference, each a failure it hid:

- No fallback: without CUDA it exits 2 unless `--device cpu` is given,
  which runs the reference's tiny CPU shapes on the plain versions.
- Only `torch.OutOfMemoryError` stops the train escalation or nulls an
  attention sample; any other error ends the run non-zero.
- On the card every attention row is checked against the plain version at
  its shape before any is timed (tools/tune_attention's forward and
  dQ/dK/dV checks; GQA grouped against repeated within bf16 tolerance),
  and a failed check ends the run with exit 1.
- The watchdog exits non-zero.

Output: the card's name and power limit (nvidia-smi), then ONE JSON line
with the reference's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

import torch

from .bench_util import (detect_card, free_memory, make_budget, make_checkpoint,
                         make_progress, make_sync, start_watchdog, unbounded)
from .models.llama import LlamaConfig
from .ops import attention as attn
from .ops import bounds
from .parallel.train import build_llama_train_step, param_leaves
from .tools import tune_attention as tune
from .topology.gpus import GPUS, model_of_nvml_name

METRIC, UNIT = "llama_train_mfu", "%"
BUDGET_ENV, BUDGET_DEFAULT_S = "BENCH_MFU_BUDGET_S", 480.0
CKPT_ENV, CKPT_DEFAULT = "BENCH_MFU_CKPT", "BENCH_MFU_TORCH.ckpt.json"
PACKAGE = "yoda_scheduler_tpu_torch"
H, D = 16, 128
GQA_KV_HEADS, WINDOW = 4, 1024
# GQA grouped against repeated: the same kernel reads the same K/V rows, so
# the outputs agree to bf16's rounding (tools/tune_attention's O tolerance)
GQA_TOL = tune.FWD_TOL["o"]
CARD_TRAIN_STEPS = 10  # timed after one warm step (3 on the CPU)
# host-clock readings a chain length: on an H100 one reading read an S=2048
# fwd+bwd at 0.4355 ms, below its own backward kernels' 0.59
READINGS = 3

_progress = make_progress("bench_mfu")
_sync = make_sync()


def peak_flops(nvml_name: str | None) -> float | None:
    """The card's bf16 dense peak, FLOP/s, from its catalog row; None for a
    card the catalog lacks (or no card)."""
    model = model_of_nvml_name(nvml_name) if nvml_name else None
    return GPUS[model].bf16_dense_tflops * 1e12 if model else None


# --------------------------------------------------------------- train MFU
def _reference_shape(dim: int, layers: int, ffn: int) -> LlamaConfig:
    return LlamaConfig(vocab_size=32000, dim=dim, n_layers=layers, n_heads=16,
                       n_kv_heads=16, ffn_dim=ffn, max_seq_len=2048)


def train_candidates(on_card: bool) -> list[tuple[LlamaConfig, int, int]]:
    """(config, batch, seq) in ascending size: the reference's three
    (bench_mfu.py:98-105), then Llama-2-7B at B=1, S=2048; the tiny shape
    on the CPU."""
    if not on_card:
        return [(LlamaConfig.tiny(), 2, 256)]
    return [(_reference_shape(1024, 8, 4096), 8, 2048),
            (_reference_shape(1024, 16, 4096), 8, 2048),
            (_reference_shape(2048, 16, 5632), 4, 2048),
            (LlamaConfig.llama2_7b(), 1, 2048)]


def param_count(config: LlamaConfig) -> int:
    """The dense model's parameters, reckoned from its shapes: embedding,
    per layer two norms, wq/wk/wv/wo and the SwiGLU FFN, final norm, head."""
    if config.is_moe:
        raise ValueError("param_count reckons the dense model")
    d, f, hd = config.dim, config.ffn_dim, config.head_dim
    h, kvh = config.n_heads, config.n_kv_heads
    layer = 2 * d + d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f
    return 2 * config.vocab_size * d + config.n_layers * layer + d


def model_flops_per_token(n_params: int, config: LlamaConfig, seq: int) -> int:
    """6N for the matmuls plus the causal attention term 6 L d S (PaLM's
    appendix B convention, as the reference); remat's recompute is not
    counted."""
    return 6 * n_params + 6 * config.n_layers * config.dim * seq


def train_metrics(n_params: int, config: LlamaConfig, batch: int, seq: int,
                  step_s: float, peak: float | None) -> dict:
    tokens_per_s = batch * seq / step_s
    flops_per_s = model_flops_per_token(n_params, config, seq) * tokens_per_s
    return {"step_time_s": step_s, "tokens_per_sec": tokens_per_s,
            "model_tflops_per_sec": flops_per_s / 1e12,
            "peak_tflops": peak / 1e12 if peak else None,
            "mfu_pct": 100 * flops_per_s / peak if peak else None}


def _train_one(config: LlamaConfig, batch: int, seq: int, device, peak, steps: int) -> dict:
    init_fn, step_fn, batch_fn = build_llama_train_step(config, remat=True, device=device)
    params, opt_state = init_fn(0)
    n_params = sum(t.numel() for t in param_leaves(params))
    if n_params != param_count(config):
        raise RuntimeError(f"{n_params} parameters, {param_count(config)} reckoned")
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = batch_fn(torch.randint(0, config.vocab_size, (batch, seq), generator=gen,
                                    device=dev))
    params, opt_state, loss = step_fn(params, opt_state, tokens)  # warm
    _sync(loss)
    _progress("train step warm; timing")
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, tokens)
    _sync(loss)
    step_s = (time.perf_counter() - t0) / steps
    return {"model_params": n_params, "batch": batch, "seq": seq,
            **train_metrics(n_params, config, batch, seq, step_s, peak),
            "final_loss": float(loss)}


def llama_train_bench(on_card: bool, ckpt, device="cuda", peak: float | None = None,
                      remaining=unbounded) -> dict:
    """Escalate through `train_candidates`: each success is kept (and
    checkpointed) and the next size tried; an OOM or a spent budget stops
    the escalation. Returns the largest success with every attempt."""
    best, attempts = None, []
    for config, batch, seq in train_candidates(on_card):
        key = f"train.d{config.dim}L{config.n_layers}B{batch}S{seq}"
        saved = ckpt.get(key)
        if saved is not None:
            _progress(f"train candidate {key}: reusing checkpointed section")
            attempts.append(saved["attempt"])
            best = saved["result"]
            continue
        if best is not None and remaining() < 120:
            attempts.append({"dim": config.dim, "layers": config.n_layers,
                             "skipped": "budget"})
            break
        _progress(f"train candidate dim={config.dim} L={config.n_layers} B={batch} "
                  f"S={seq} ({param_count(config) / 1e9:.2f}B parameters)")
        result = None
        try:
            result = _train_one(config, batch, seq, device, peak,
                                CARD_TRAIN_STEPS if on_card else 3)
        except torch.OutOfMemoryError as e:
            # not checkpointed: the next run measures it again
            _progress(f"candidate out of memory: {str(e)[:200]}")
            attempts.append({"dim": config.dim, "layers": config.n_layers,
                             "error": "OutOfMemoryError"})
        free_memory()
        if result is None:
            break
        best = {**result, "device": str(device)}
        attempt = {"dim": config.dim, "layers": config.n_layers, "batch": batch,
                   "model_params": result["model_params"], "mfu_pct": result["mfu_pct"],
                   "tokens_per_sec": result["tokens_per_sec"],
                   "step_time_s": result["step_time_s"]}
        attempts.append(attempt)
        ckpt.put(key, {"result": best, "attempt": attempt})
        _progress(f"candidate ok: mfu={best['mfu_pct']}% tok/s={best['tokens_per_sec']:.1f}")
    if best is None:
        raise RuntimeError(f"no train config completed: {attempts}")
    return {**best, "attempts": attempts}


# --------------------------------------------------- flash attention bench
def flash_fwd_fn(q, k, v, window=None):
    return attn.flash_attention(q, k, v, causal=True, window=window)


def plain_fwd_fn(q, k, v, window=None):
    return attn.reference_attention(q, k, v, causal=True, window=window)


def gqa_repeated_fn(q, k, v):
    """Flash attention after K and V are repeated to q's heads in place
    (head h reads kv head h // group), the pre-GQA path."""
    group = q.shape[1] // k.shape[1]
    return attn.flash_attention(q, k.repeat_interleave(group, dim=1),
                                v.repeat_interleave(group, dim=1), causal=True)


def window_mask(s: int, window: int | None, device) -> torch.Tensor | None:
    """The causal mask within `window` as SDPA's boolean mask (True = attend)."""
    if window is None:
        return None
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    return (ki <= qi) & (ki > qi - window)


def sdpa_fn(q, k, v, flash: bool = False, mask=None):
    """The library's call for the row's function: causal, grouped KV through
    enable_gqa, a window through a boolean `mask`; `flash` forces the flash
    backend (the route sweep's `_sdpa`), which takes no mask and raises on
    what it does not take rather than timing another backend."""
    gqa = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
    if flash:
        if mask is not None:
            raise ValueError("SDPA's flash backend takes no mask")
        return tune._sdpa(q, k, v, **gqa)
    if mask is None:
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                **gqa)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, **gqa)


def sdpa_default_backend(q, k, v, mask=None) -> str:
    """The backend SDPA's default dispatch picks for these inputs."""
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q, k, v, attn_mask=mask, dropout_p=0.0,
                                     is_causal=mask is None,
                                     enable_gqa=k.shape[1] != q.shape[1])
    names = {int(getattr(SDPBackend, n)): n for n in (
        "ERROR", "MATH", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
        "OVERRIDEABLE") if hasattr(SDPBackend, n)}
    return names.get(int(choice), str(choice))


def grad_q(fn):
    """q -> the gradient of sum(O.float()) with respect to q alone (q-shaped,
    so it chains like the forward)."""
    def g(q, k, v):
        with torch.enable_grad():
            leaf = q.detach().requires_grad_(True)
            return torch.autograd.grad(fn(leaf, k, v).float().sum(), leaf)[0]
    return g


def chain(fn, q, k, v, n: int):
    """n calls of fn, the output cast to q's dtype feeding the next q."""
    x = q
    for _ in range(n):
        x = fn(x, k, v).to(q.dtype)
    return x


def _kernel_time_s(fn, q, k, v, n1: int, n2: int) -> float | None:
    """Seconds a call of `fn(q, k, v) -> q-shaped`: the slope (T(n2) -
    T(n1)) / (n2 - n1) of the q-chained loop, which cancels the fixed cost
    of the fence; each length is warmed once, then read READINGS times on
    the host clock around the calls and one fence, and the median feeds
    the slope. None on OOM only."""
    def measure(n):
        _sync(chain(fn, q, k, v, n))
        ts = []
        for _ in range(READINGS):
            t0 = time.perf_counter()
            _sync(chain(fn, q, k, v, n))
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    try:
        t1 = measure(n1)
        t2 = measure(n2)
    except torch.OutOfMemoryError:
        return None
    return max(t2 - t1, 1e-9) / (n2 - n1)


def make_inputs(seed: int, b: int, h: int, kvh: int, s: int, device, n: int = 3):
    """q [b, h, s, D], then k, v (and a cotangent when n=4) with kvh heads,
    bf16, from a generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = [(b, h, s, D), (b, kvh, s, D), (b, kvh, s, D), (b, h, s, D)][:n]
    return [torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
            for shape in shapes]


def attention_plan(on_card: bool):
    """(seqs, tokens, n1, n2): the reference's S list, B S, chain lengths."""
    return ([2048, 4096, 8192], 8192, 4, 24) if on_card else ([256], 512, 1, 3)


def _check_fwd(q, k, v, window=None) -> dict:
    ref = attn.reference_attention_with_lse(q, k, v, True, window)
    return tune._fwd_check(*attn.flash_fwd(q, k, v, True, window), ref)


def _check_fwd_bwd(q, k, v, do) -> dict:
    fwd = _check_fwd(q, k, v)
    o, lse = attn.flash_fwd(q, k, v)
    delta = attn.backward_delta(o, do).contiguous()
    args = (q, k, v, do, lse, delta, True, None)
    dk, dv = attn.flash_bwd_dkv(*args)
    kvh = k.shape[1]
    bwd = tune._bwd_check((attn.flash_bwd_dq(*args), attn.group_sum(dk, kvh),
                           attn.group_sum(dv, kvh)),
                          attn.flash_backward_reference(q, k, v, o, lse, do, True))
    return {**fwd, **bwd, "ok": fwd["ok"] and bwd["ok"]}


def check_attention(device="cuda") -> dict:
    """Every row the card times, checked against the plain version at its
    shape before any time is taken: each S's forward and dQ/dK/dV
    (tools/tune_attention's checks), the GQA forward and grouped against
    repeated, the windowed forward. Raises tune.CheckFailed on the first
    that disagrees; returns the readings by row."""
    seqs, tokens, _, _ = attention_plan(True)
    out = {}

    def keep(name, readings):
        torch.cuda.synchronize()
        out[name] = readings
        if not readings["ok"]:
            raise tune.CheckFailed(f"{name}: disagrees with the plain version: {readings}")

    for s in seqs:
        keep(f"S{s}", _check_fwd_bwd(*make_inputs(s, max(1, tokens // s), H, H, s,
                                                  device, n=4)))
        free_memory()
    s = max(seqs)
    b = max(1, tokens // s)
    q, k, v = make_inputs(7, b, H, GQA_KV_HEADS, s, device)
    grouped, repeated = flash_fwd_fn(q, k, v), gqa_repeated_fn(q, k, v)
    gqa = _check_fwd(q, k, v)
    gqa["max_abs_err_grouped_vs_repeated"] = float((grouped.float() - repeated.float())
                                                   .abs().max())
    gqa["ok"] = gqa["ok"] and torch.allclose(grouped.float(), repeated.float(),
                                             atol=GQA_TOL, rtol=GQA_TOL)
    keep("gqa_16q_4kv", gqa)
    del q, k, v, grouped, repeated
    keep("window_1024", _check_fwd(*make_inputs(11, b, H, H, s, device), WINDOW))
    free_memory()
    return out


def _ms(t):
    """ms, or "unmeasured" for an OOM or a nulled sample."""
    return t * 1e3 if t is not None else "unmeasured"


def _ratio(ref, x, ref_label: str, x_label: str):
    """ref / x, or a sentinel naming exactly which side failed."""
    if ref and x:
        return ref / x
    return f"{x_label}_unmeasured" if ref else f"{ref_label}_unmeasured"


def plausible_or_none(t, useful_flops, peak, label, remeasure):
    """A sample whose implied throughput exceeds the card's peak is a
    measurement artifact: measure once more, then null it."""
    def ok(t):
        return t is None or peak is None or useful_flops / t <= peak
    if not ok(t):
        _progress(f"{label} {t * 1e3:.3f}ms implies >peak; re-measuring")
        t = remeasure()
        if not ok(t):
            t = None
    return t


SKIPPED = {"skipped": "budget"}


def time_attention(on_card: bool, ckpt, peak: float | None = None, device="cuda",
                   remaining=unbounded) -> dict:
    """The timed rows (`check_attention` holds them first on the card); a
    row the budget leaves out is reported as SKIPPED."""
    seqs, tokens, n1, n2 = attention_plan(on_card)

    def timed_at(q, k, v):
        return partial(_kernel_time_s, q=q, k=k, v=v, n1=n1, n2=n2)

    out = {}
    for s in seqs:
        saved = ckpt.get(f"attn.S{s}")
        if saved is not None:
            _progress(f"attention S={s}: reusing checkpointed section")
            out[f"S{s}"] = saved
            continue
        if out and remaining() < 90:
            _progress(f"budget spent; skipping S={s}")
            out[f"S{s}"] = dict(SKIPPED)
            continue
        b = max(1, tokens // s)
        _progress(f"attention S={s} B={b}")
        q, k, v = make_inputs(s, b, H, H, s, device)
        timed = timed_at(q, k, v)
        t_flash = timed(flash_fwd_fn)
        useful_flops = tune.causal_flops(b, H, s, D)
        t_flash = plausible_or_none(t_flash, useful_flops, peak, f"S={s} flash fwd",
                                    lambda: timed(flash_fwd_fn))
        t_plain = timed(plain_fwd_fn)
        t_flash_g = timed(grad_q(flash_fwd_fn))
        t_plain_g = timed(grad_q(plain_fwd_fn))
        sdpa_flash = partial(sdpa_fn, flash=True)
        bound_ms, bound_by = bounds.attention_bound(b, H, H, s, s, D, True, None,
                                                    torch.bfloat16)
        out[f"S{s}"] = {
            "batch": b,
            "flash_fwd_tflops": useful_flops / t_flash / 1e12 if t_flash else None,
            "flash_fwd_ms": _ms(t_flash),
            "plain_fwd_ms": _ms(t_plain),
            "fwd_speedup": _ratio(t_plain, t_flash, "plain", "flash"),
            "fwd_bound_ms": bound_ms, "fwd_bound_by": bound_by,
            "flash_fwdbwd_ms": _ms(t_flash_g),
            "plain_fwdbwd_ms": _ms(t_plain_g),
            "fwdbwd_speedup": _ratio(t_plain_g, t_flash_g, "plain", "flash"),
            "fwdbwd": "grad of sum(O) wrt q; the port's backward launches dQ and dK/dV",
            "sdpa_default_backend": sdpa_default_backend(q, k, v),
            "sdpa_default_fwd_ms": _ms(timed(sdpa_fn)),
            "sdpa_flash_fwd_ms": _ms(timed(sdpa_flash)),
            "sdpa_default_fwdbwd_ms": _ms(timed(grad_q(sdpa_fn))),
            "sdpa_flash_fwdbwd_ms": _ms(timed(grad_q(sdpa_flash))),
        }
        ckpt.put(f"attn.S{s}", out[f"S{s}"])
        del q, k, v, timed
        free_memory()
    if not on_card:
        return out
    top_s = max(int(key[1:]) for key, row in out.items() if "skipped" not in row)
    b = max(1, tokens // top_s)
    saved = ckpt.get("attn.gqa")
    if saved is not None:
        _progress("gqa: reusing checkpointed section")
        out["gqa_16q_4kv"] = saved
    elif remaining() <= 60:
        out["gqa_16q_4kv"] = dict(SKIPPED)
    else:
        q, k, v = make_inputs(7, b, H, GQA_KV_HEADS, top_s, device)
        _progress(f"gqa S={top_s} B={b} heads {H}:{GQA_KV_HEADS}")
        timed = timed_at(q, k, v)
        t_grouped, t_repeat = timed(flash_fwd_fn), timed(gqa_repeated_fn)
        out["gqa_16q_4kv"] = {
            "seq": top_s, "batch": b,
            "grouped_fwd_ms": _ms(t_grouped),
            "repeated_fwd_ms": _ms(t_repeat),
            "grouped_speedup": _ratio(t_repeat, t_grouped, "repeated", "grouped"),
            "fwd_bound_ms": bounds.attention_bound(b, H, GQA_KV_HEADS, top_s, top_s, D,
                                                   True, None, torch.bfloat16)[0],
            "sdpa_default_backend": sdpa_default_backend(q, k, v),
            "sdpa_default_fwd_ms": _ms(timed(sdpa_fn)),
            "sdpa_flash_fwd_ms": _ms(timed(partial(sdpa_fn, flash=True))),
        }
        ckpt.put("attn.gqa", out["gqa_16q_4kv"])
        del q, k, v, timed
        free_memory()
    saved = ckpt.get("attn.window")
    if saved is not None:
        _progress("window: reusing checkpointed section")
        out["window_1024"] = saved
        return out
    if remaining() <= 60:
        out["window_1024"] = dict(SKIPPED)
        return out
    q, k, v = make_inputs(11, b, H, H, top_s, device)
    _progress(f"window S={top_s} B={b} window={WINDOW}")
    timed = timed_at(q, k, v)
    windowed = partial(flash_fwd_fn, window=WINDOW)
    # useful FLOPs: each query attends ~window keys, against the causal
    # half-square
    t_win = plausible_or_none(timed(windowed), 4 * top_s * WINDOW * b * H * D, peak,
                              "window", lambda: timed(windowed))
    t_full = plausible_or_none(timed(flash_fwd_fn), tune.causal_flops(b, H, top_s, D),
                               peak, "full-causal", lambda: timed(flash_fwd_fn))
    mask = window_mask(top_s, WINDOW, q.device)
    out["window_1024"] = {
        "seq": top_s, "batch": b, "window": WINDOW,
        "windowed_fwd_ms": _ms(t_win),
        "full_causal_fwd_ms": _ms(t_full),
        # ~S / (2 window) for S >> window when the kernel skips the blocks
        # outside the window; ~1.0 would mean it does not
        "window_speedup": _ratio(t_full, t_win, "full_causal", "windowed"),
        "fwd_bound_ms": bounds.attention_bound(b, H, H, top_s, top_s, D, True, WINDOW,
                                               torch.bfloat16)[0],
        "sdpa_default_backend": sdpa_default_backend(q, k, v, mask),
        "sdpa_default_fwd_ms": _ms(timed(partial(sdpa_fn, mask=mask))),
        "sdpa_flash_fwd_ms": None,
        "sdpa_flash_note": "SDPA's flash backend takes no mask, so no window",
    }
    ckpt.put("attn.window", out["window_1024"])
    return out


def attention_bench(on_card: bool, ckpt, peak: float | None = None, device="cuda",
                    remaining=unbounded) -> dict:
    """On the card, every row checked (`check_attention`), then timed."""
    if on_card:
        check_attention(device)
    return time_attention(on_card, ckpt, peak, device, remaining)


def result(train: dict, attention: dict, card, smi: str | None, backend: str) -> dict:
    """The one JSON line, with the reference's keys. vs_baseline: the flash
    kernel against the plain attention at the longest S where both ran."""
    numeric = {key: row for key, row in attention.items()
               if isinstance(row.get("fwd_speedup"), (int, float))}
    seq_keys = [key for key in (numeric or attention) if key[1:].isdigit()]
    top_s = max(seq_keys, key=lambda key: int(key[1:])) if seq_keys else None
    speedup = attention[top_s].get("fwd_speedup") if top_s else None
    return {
        "metric": METRIC,
        "value": train["mfu_pct"] if train["mfu_pct"] is not None
        else train["model_tflops_per_sec"],
        "unit": UNIT if train["mfu_pct"] is not None else "TFLOP/s",
        "vs_baseline": speedup if isinstance(speedup, (int, float)) else None,
        "backend": backend,
        "device_kind": card.name if card else "cpu",
        "catalog_model": card.model.name if card and card.model else None,
        "nvidia_smi": smi,
        "train": train,
        "attention": attention,
    }


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m yoda_scheduler_tpu_torch.bench_mfu",
        description="Llama train MFU and flash-attention bench on one NVIDIA GPU.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the reference's tiny shapes on the plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_mfu: CUDA is not available; pass --device cpu for the tiny CPU run",
              file=sys.stderr)
        return 2
    budget, remaining = make_budget(BUDGET_ENV, BUDGET_DEFAULT_S)
    watchdog = start_watchdog(METRIC, UNIT, budget)
    try:
        card = detect_card(args.device)
        on_card = card is not None
        smi = tune.card() if on_card else None
        if smi:
            print(smi, flush=True)
        _progress(f"device={args.device} card={card} budget={budget}s")
        ckpt = make_checkpoint(CKPT_ENV, CKPT_DEFAULT, _progress)
        seqs = attention_plan(on_card)[0]
        ckpt.bind_context(card=card.name if card else "cpu", package=PACKAGE,
                          train=[f"d{c.dim}L{c.n_layers}B{b}S{s}"
                                 for c, b, s in train_candidates(on_card)],
                          seqs=seqs)
        peak = peak_flops(card.name) if card else None
        train = llama_train_bench(on_card, ckpt, args.device, peak, remaining)
        try:
            attention = attention_bench(on_card, ckpt, peak, args.device, remaining)
        except tune.CheckFailed as e:
            print(f"bench_mfu: {e}", file=sys.stderr)
            return 1
    finally:
        watchdog.cancel()
    ckpt.clear()  # the printed line now owns the numbers
    print(json.dumps(result(train, attention, card, smi, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
