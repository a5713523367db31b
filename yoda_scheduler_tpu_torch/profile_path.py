"""Where the time goes on the port's path, at Phi-3-mini, Llama-2-7B,
Mixtral-8x7B, OpenLLaMA-3B (bf16 and fp16), StableLM-3B-4E1T, Gemma-2B,
OPT-1.3B, OPT-2.7B, GPT-NeoX-20B and GPT-J-6B widths on one GPU.

    python3 -m yoda_scheduler_tpu_torch.profile_path

First, before any trace (a process that has run torch.profiler launches
slower afterwards), it reads the host's side of the StableLM-3B-4E1T step
(`stablelm3b_host_turns`: dQ's and dK/dV's host ms a launch on wgmma and on
mma, idle and behind a busy device, and steps in alternated turns with the
backward on each, the host's enqueue ms beside each step's ms); then it
times training steps at Phi-3-mini width (32 layers,
head dim 96, B=1, S=2048) on the host's clock, 8 steps at a turn in turns
(wgmma, mma, mma, wgmma): on the routes `_route` picks, and with the
head-dim-96 forward, dQ and dK/dV on the mma route, as before their wgmma
kernels; then it traces one such step on each.

Then it traces with torch.profiler, after a warm-up, at Llama-2-7B width one
`llama_forward` (B=1, S=2048), one `prefill` (4 requests x 512 tokens), 16
`decode_step`s of those requests (their prefill outside the trace), one
training step (B=1, S=2048, remat, AdamW; all 32 layers) and one pipelined
training step (pp=4 stages in one process, 4 microbatches, B=4); then at
Mixtral-8x7B width one `llama_forward` (16 layers) and one training step
(4 layers), both B=1, S=2048; then one ResNet-50 training pass (bf16,
B=256, 224 x 224, the forward and backward of a softmax cross-entropy); then
one `llama_forward` at OpenLLaMA-3B's widths (head dim 100) and one at
StableLM-3B-4E1T's (80), B=1, S=2048, each with flash_fwd on its wgmma
kernel and on the route it took before (simt at 100, mma at 80), and one
OpenLLaMA-3B training step (all 26 layers, B=1, S=2048, remat, AdamW) with
dQ and dK/dV on their head-dim-100 wgmma kernels and one on simt
(`d100_backward_on_simt`; `openllama3b_train_windows()` traces those two
steps alone); then one `llama_forward` at Gemma-2B's widths (head dim 256,
bf16) and one at OPT-1.3B's (64, fp16), B=1, S=2048, each with flash_fwd on
its wgmma kernel and on mma, as before it (`gemma_opt_forward_windows()`
traces those four alone); then one StableLM-3B-4E1T training step (all 32
layers, B=1, S=2048, remat, AdamW) with dQ and dK/dV on their head-dim-80
wgmma kernels and one on mma (`d80_backward_on_mma`;
`stablelm3b_train_windows()` traces those two alone); then one Gemma-2B
training step (all 18 layers, B=1, S=2048, remat, AdamW) with dQ and dK/dV
on their head-dim-256 wgmma kernels and one on mma (`d256_backward_on_mma`;
`gemma2b_train_windows()` traces those two alone); then OPT-1.3B's loss
(all 24 layers, fp16, B=1, S=2048, remat) through its forward and backward,
no optimizer step, with dQ and dK/dV on their fp16 head-dim-64 wgmma kernels
and on mma (`fp16_backward_on_mma(64)`; `opt13b_backward_windows()` traces those
two alone); then one `llama_forward` at OPT-2.7B's widths (head dim 80,
fp16) and one at OpenLLaMA-3B's in fp16 (100), B=1, S=2048, each with
flash_fwd on its fp16 wgmma kernel and on the route it took before (mma at
80, simt at 100; `fp16_new_width_forward_windows()` traces those four
alone); then OpenLLaMA-3B's loss in fp16 (all 26 layers) as OPT-1.3B's, with
dQ and dK/dV on their fp16 head-dim-100 wgmma kernels and on simt
(`fp16_d100_backward_on_simt`; `openllama3b_fp16_backward_windows()` traces
those alone), each route traced twice in turns; then one `llama_forward` at
GPT-NeoX-20B's widths (head dim 96, fp16, all 44 layers) and one at
GPT-J-6B's (256, fp16, 28 layers), B=1, S=2048, each with flash_fwd on its
fp16 wgmma kernel and on mma, as before it (`neox_gptj_forward_windows()`
traces those four alone); then GPT-J-6B's loss (all 28 layers, fp16) as
OPT-1.3B's, with dQ and dK/dV on their fp16 head-dim-256 wgmma kernels and
on mma (`fp16_backward_on_mma(256)`; `gptj6b_fp16_backward_windows()`
traces those alone), each route traced twice in turns; then GPT-NeoX-20B's
loss (fp16, 22 of its 44 layers: `NEOX20B_BACKWARD_LAYERS`) so, with dQ and
dK/dV on their fp16 head-dim-96 wgmma kernels and on mma
(`fp16_backward_on_mma(96)`; `neox20b_fp16_backward_windows()`); last
OPT-2.7B's loss (fp16, all 32 layers) so, with dQ and dK/dV on their fp16
head-dim-80 wgmma kernels and on mma (`fp16_backward_on_mma(80)`;
`opt27b_fp16_backward_windows()`). For each traced
window it prints one JSON line: the host wall time, the device's busy time
(the union of kernel intervals) and idle share, the kernel launches, the
device time grouped into conv / matmul / flash_fwd / flash_bwd_dq /
flash_bwd_dkv / optimizer / moe_route / batch_norm / other, and the kernels
with the most device time. moe_route is every kernel that starts inside a
`moe_route` span on the device's timeline (models/moe.py: the router's
product, top-k, queue positions, dispatch and combine, and the backward of
dispatch and combine); the router softmax's and top-k's backward count as
other. batch_norm is every kernel inside a `batch_norm` span
(models/resnet.py: each BatchNorm and its ReLU, forward and the backward's
recomputation and gradient); conv is cuDNN's convolution kernels by name.
The full report goes to chiprun_out/profile_path.json.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.nn.functional as F

from .models import (KVCache, LlamaConfig, decode_step, init_llama, llama_forward,
                     llama_loss, prefill, resnet_forward_fn)
from .models.moe import ROUTE_SPAN
from .models.resnet import BN_SPAN
from .ops import attention
from .parallel import (build_llama_train_step, build_pipelined_llama_train_step,
                       param_leaves)


def mixtral_8x7b(n_layers: int) -> LlamaConfig:
    """Mixtral-8x7B's published widths in the JAX package's LlamaConfig
    fields, from mistralai/Mixtral-8x7B-v0.1's config.json: hidden_size
    4096, 32 layers, 32 heads, 8 key-value heads, intermediate_size 14336,
    8 local experts, 2 per token, vocab 32000, rope_theta 1e6, rms_norm_eps
    1e-5, max_position_embeddings 32768, no sliding window,
    router_aux_loss_coef 0.02. Depth cut to `n_layers`; the capacity factor
    is the JAX package's 1.25 (Mixtral drops no token)."""
    return LlamaConfig(vocab_size=32000, dim=4096, n_layers=n_layers, n_heads=32,
                       n_kv_heads=8, ffn_dim=14336, rope_theta=1e6, norm_eps=1e-5,
                       max_seq_len=32768, num_experts=8, experts_per_token=2,
                       moe_aux_weight=0.02)


def phi3_mini() -> LlamaConfig:
    """Phi-3-mini's widths as the port's Llama config, from the published
    microsoft/Phi-3-mini-4k-instruct config.json: hidden 3072, 32 layers, 32
    query and 32 KV heads of 96, intermediate 8192, vocab 32064, rope_theta
    10000, rms_norm_eps 1e-5, 4096 positions, bf16. Its fused qkv and
    gate_up projections are the same products as the Llama's separate ones;
    the weights are random, from a seed."""
    return LlamaConfig(vocab_size=32064, dim=3072, n_layers=32, n_heads=32,
                       n_kv_heads=32, ffn_dim=8192, rope_theta=10000.0,
                       norm_eps=1e-5, max_seq_len=4096, dtype="bfloat16")


def openllama_3b() -> LlamaConfig:
    """OpenLLaMA-3B's widths, from the published openlm-research/open_llama_3b
    config.json: hidden 3200, 26 layers, 32 query and 32 KV heads of 100,
    intermediate 8640, vocab 32000, rope_theta 10000, rms_norm_eps 1e-6, 2048
    positions: a Llama architecture the config takes as it is; bf16, the
    weights random from a seed."""
    return LlamaConfig(vocab_size=32000, dim=3200, n_layers=26, n_heads=32,
                       n_kv_heads=32, ffn_dim=8640, rope_theta=10000.0,
                       norm_eps=1e-6, max_seq_len=2048, dtype="bfloat16")


def stablelm_3b_4e1t() -> LlamaConfig:
    """StableLM-3B-4E1T's widths, from the published
    stabilityai/stablelm-3b-4e1t config.json: hidden 2560, 32 layers, 32
    query and 32 KV heads of 80, intermediate 6912, vocab 50304, rope_theta
    10000, norm eps 1e-5, 4096 positions; bf16, the weights random from a
    seed. Its LayerNorm and 25% partial rotary are not modelled: these are
    its widths on the Llama block, as `phi3_mini` is Phi-3's."""
    return LlamaConfig(vocab_size=50304, dim=2560, n_layers=32, n_heads=32,
                       n_kv_heads=32, ffn_dim=6912, rope_theta=10000.0,
                       norm_eps=1e-5, max_seq_len=4096, dtype="bfloat16")


def gemma_2b() -> LlamaConfig:
    """Gemma-2B's widths, from the published google/gemma-2b config.json:
    hidden 2048, 18 layers, 8 query heads and 1 KV head of 256 (2048 / 8,
    so no head-dim field is needed), intermediate 16384, vocab 256000,
    rms_norm_eps 1e-6, rope_theta 10000, 8192 positions; bf16, the weights
    random from a seed: about 3.0 B parameters, 6.1 GB. These are its widths
    on the Llama block, as `phi3_mini` is Phi-3's: its GeGLU (a GELU gate
    where the block has SiLU), the sqrt(hidden) scale of the embeddings,
    the tied embedding and output weights (two matrices here) and its
    (1 + w) RMSNorm weights are not modelled."""
    return LlamaConfig(vocab_size=256000, dim=2048, n_layers=18, n_heads=8,
                       n_kv_heads=1, ffn_dim=16384, rope_theta=10000.0,
                       norm_eps=1e-6, max_seq_len=8192, dtype="bfloat16")


def opt_1_3b() -> LlamaConfig:
    """OPT-1.3B's widths, from the published facebook/opt-1.3b config.json:
    hidden 2048, 24 layers, 32 heads of 64 (query and KV alike), FFN 8192,
    vocab 50272, 2048 positions, in its published torch_dtype, fp16; the
    weights random from a seed: about 1.8 B parameters, 3.6 GB. Its
    LayerNorm, learned positions (rotary here), two-matrix ReLU FFN (three
    matrices and SiLU here) and biases are not modelled."""
    return LlamaConfig(vocab_size=50272, dim=2048, n_layers=24, n_heads=32,
                       n_kv_heads=32, ffn_dim=8192, rope_theta=10000.0,
                       norm_eps=1e-5, max_seq_len=2048, dtype="float16")


def opt_2_7b() -> LlamaConfig:
    """OPT-2.7B's widths, from the published facebook/opt-2.7b config.json:
    hidden 2560, 32 layers, 32 heads of 80 (query and KV alike), FFN 10240,
    vocab 50272, 2048 positions, in its published torch_dtype, fp16; the
    weights random from a seed: about 3.6 B parameters, 7.2 GB. As in
    `opt_1_3b`, its LayerNorm, learned positions, two-matrix ReLU FFN and
    biases are not modelled."""
    return LlamaConfig(vocab_size=50272, dim=2560, n_layers=32, n_heads=32,
                       n_kv_heads=32, ffn_dim=10240, rope_theta=10000.0,
                       norm_eps=1e-5, max_seq_len=2048, dtype="float16")


def gpt_neox_20b(n_layers: int = 44) -> LlamaConfig:
    """GPT-NeoX-20B's widths, from the published EleutherAI/gpt-neox-20b
    config.json: hidden 6144, 44 layers, 64 heads of 96 (query and KV
    alike), FFN 24576, vocab 50432, 2048 positions, in its published
    torch_dtype, fp16; the weights random from a seed: about 27.2 B
    parameters on this Llama block, 54.4 GB. Its LayerNorm, rotary on 25% of
    each head (all of it here), parallel residual, two-matrix GELU FFN
    (three matrices and SiLU here) and biases are not modelled. Depth cut
    to `n_layers` where the whole model does not fit
    (`NEOX20B_BACKWARD_LAYERS`)."""
    return LlamaConfig(vocab_size=50432, dim=6144, n_layers=n_layers, n_heads=64,
                       n_kv_heads=64, ffn_dim=24576, rope_theta=10000.0,
                       norm_eps=1e-5, max_seq_len=2048, dtype="float16")


# GPT-NeoX-20B's depth for its fp16 backward on one 80 GB card: a layer is
# 4 x 6144^2 + 3 x 6144 x 24576 = 604.0 M parameters beside 619.8 M of
# embedding and head, so 44 layers' fp16 weights and gradients take 108.8 GB
# and 22 layers' 55.6 GB (13.91 B parameters), with room for the remat
# activations and the 50432-wide logits
NEOX20B_BACKWARD_LAYERS = 22


def gptj_6b() -> LlamaConfig:
    """GPT-J-6B's widths, from the published EleutherAI/gpt-j-6b config.json:
    hidden 4096, 28 layers, 16 heads of 256 (query and KV alike), FFN 16384
    (n_inner null: 4 x 4096), vocab 50400, 2048 positions, in fp16, the
    dtype of the repo's float16 revision; the weights random from a seed:
    about 7.9 B parameters on this Llama block, 15.9 GB. Its LayerNorm,
    rotary on 64 of each head's 256 dims (all of them here), parallel
    attention and FFN, gelu_new FFN of two matrices and biases are not
    modelled."""
    return LlamaConfig(vocab_size=50400, dim=4096, n_layers=28, n_heads=16,
                       n_kv_heads=16, ffn_dim=16384, rope_theta=10000.0,
                       norm_eps=1e-5, max_seq_len=2048, dtype="float16")


def openllama_3b_fp16() -> LlamaConfig:
    """`openllama_3b` in the published open_llama_3b checkpoint's
    torch_dtype, fp16: about 3.4 B parameters, 6.9 GB."""
    return dataclasses.replace(openllama_3b(), dtype="float16")


def _group(name: str) -> str:
    low = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kernel in low:
            return kernel
    if "adam" in low:
        return "optimizer"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "implicit")):
        return "conv"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def trace(label: str, fn, setup=lambda: None) -> dict:
    """Profile `fn(setup())` after one warm-up call on its own setup."""
    fn(setup())
    state = setup()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the ranges that record_function (the optimizer's
    # step, moe_route) draws on the device's timeline over the kernels it
    # launches
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise SystemExit(f"{label}: the profiler recorded no device kernels")
    spans = {name: sorted((e.time_range.start, e.time_range.end) for e in device
                          if getattr(e, "is_user_annotation", False) and e.name == name)
             for name in (ROUTE_SPAN, BN_SPAN)}

    def group(e) -> str:
        for name, ranges in spans.items():
            i = bisect.bisect_right(ranges, (e.time_range.start, float("inf"))) - 1
            if i >= 0 and e.time_range.start < ranges[i][1]:
                return name
        return _group(e.name)

    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name, by_group = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        by_group[group(e)] += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    report = {
        "window": label, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches": len(kernels), "moe_route_spans": len(spans[ROUTE_SPAN]),
        "batch_norm_spans": len(spans[BN_SPAN]),
        "device_ms_by_group": {k: v / 1e3 for k, v in by_group.items()},
        "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": c}
                        for n, (t, c) in top],
    }
    print(json.dumps(report), flush=True)
    return report


def inference_windows(cfg) -> list[dict]:
    params = init_llama(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen, device="cuda")
    steps = 16

    def prefilled():
        return prefill(params, prompts, KVCache.zeros(cfg, 4, 512 + steps), cfg)

    def decode(state):
        logits, cache = state
        for _ in range(steps):
            logits, cache = decode_step(params, logits.argmax(-1), cache, cfg)

    with torch.no_grad():
        return [
            trace("forward_b1_s2048", lambda _: llama_forward(params, tokens, cfg)),
            trace("prefill_4x512", lambda _: prefilled()),
            trace(f"decode_4x{steps}_steps", decode, setup=prefilled),
        ]


def train_window(cfg, label: str, build=build_llama_train_step, batch: int = 1,
                 **kwargs) -> dict:
    init_fn, step_fn, batch_fn = build(cfg, device="cuda", **kwargs)
    params, opt_state = init_fn(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = batch_fn(torch.randint(0, cfg.vocab_size, (batch, 2048), generator=gen,
                                    device="cuda"))
    return trace(label, lambda _: step_fn(params, opt_state, tokens))


@contextlib.contextmanager
def _off_wgmma(drop):
    """Within it, the wgmma route refuses each (kernel, dtype) key's head
    dims d for which drop(key, d) holds, so that they take mma; after it
    `attention._WGMMA_HEAD_DIMS` is what it was."""
    saved = dict(attention._WGMMA_HEAD_DIMS)
    attention._WGMMA_HEAD_DIMS.update(
        {k: tuple(d for d in dims if not drop(k, d)) for k, dims in saved.items()})
    try:
        yield
    finally:
        attention._WGMMA_HEAD_DIMS.clear()
        attention._WGMMA_HEAD_DIMS.update(saved)


def d96_on_mma():
    """Within it, head dim 96 takes the mma route for all three kernels, as
    before their wgmma kernels."""
    return _off_wgmma(lambda key, d: d == 96)


def fp16_backward_on_mma(*dims):
    """Within it, fp16 dQ and dK/dV at the head dims `dims` take the mma
    route, as before their fp16 wgmma kernels there; fp16 dQ and dK/dV at
    every other head dim keep theirs (`fp16_d100_backward_on_simt` moves
    100, which no mma kernel takes), the fp16 forward keeps its wgmma
    kernels, and bf16 all of its."""
    return _off_wgmma(lambda key, d: (key[1] == torch.float16 and key[0] != "flash_fwd"
                                      and d in dims))


def d80_forward_on_mma():
    """Within it, the forward at head dim 80 takes the mma route, as before
    its wgmma kernel; dQ and dK/dV keep theirs."""
    return _off_wgmma(lambda key, d: key[0] == "flash_fwd" and d == 80)


def d80_backward_on_mma():
    """Within it, dQ and dK/dV at head dim 80 take the mma route, as before
    their wgmma kernels; the forward keeps its wgmma kernel."""
    return _off_wgmma(lambda key, d: key[0] != "flash_fwd" and d == 80)


def d256_forward_on_mma():
    """Within it, the forward at head dim 256 takes the mma route, as before
    its wgmma kernel; dQ and dK/dV keep theirs."""
    return _off_wgmma(lambda key, d: key[0] == "flash_fwd" and d == 256)


def d256_backward_on_mma():
    """Within it, dQ and dK/dV at head dim 256 take the mma route, as before
    their wgmma kernels; the forward keeps its wgmma kernel."""
    return _off_wgmma(lambda key, d: key[0] != "flash_fwd" and d == 256)


def fp16_d64_forward_on_mma():
    """Within it, the fp16 forward at head dim 64 takes the mma route, as
    before its wgmma kernel; dQ and dK/dV keep their fp16 wgmma kernels
    there, and bf16 at 64 keeps its wgmma kernels."""
    return _off_wgmma(lambda key, d: key == ("flash_fwd", torch.float16) and d == 64)


def fp16_d80_forward_on_mma():
    """Within it, the fp16 forward at head dim 80 takes the mma route, as
    before its wgmma kernel; fp16 dQ and dK/dV keep their wgmma kernels
    there, and bf16 at 80 keeps its."""
    return _off_wgmma(lambda key, d: key == ("flash_fwd", torch.float16) and d == 80)


def fp16_d96_forward_on_mma():
    """Within it, the fp16 forward at head dim 96 takes the mma route, as
    before its wgmma kernel; fp16 dQ and dK/dV keep their wgmma kernels
    there, and bf16 at 96 keeps its."""
    return _off_wgmma(lambda key, d: key == ("flash_fwd", torch.float16) and d == 96)


def fp16_d256_forward_on_mma():
    """Within it, the fp16 forward at head dim 256 takes the mma route, as
    before its wgmma kernel; fp16 dQ and dK/dV keep their wgmma kernels
    there, and bf16 at 256 keeps its."""
    return _off_wgmma(lambda key, d: key == ("flash_fwd", torch.float16) and d == 256)


def fp16_d100_forward_on_simt():
    """Within it, the fp16 forward at head dim 100 takes the simt route, as
    before its wgmma kernel (no mma kernel takes 200-byte rows); fp16 dQ and
    dK/dV keep their wgmma kernels there, and bf16 at 100 keeps its."""
    return _off_wgmma(lambda key, d: key == ("flash_fwd", torch.float16) and d == 100)


def fp16_d100_backward_on_simt():
    """Within it, fp16 dQ and dK/dV at head dim 100 take the simt route, as
    before their wgmma kernels; the fp16 forward keeps its wgmma kernel
    there, and bf16 at 100 keeps all of its."""
    return _off_wgmma(lambda key, d: (key[1] == torch.float16 and key[0] != "flash_fwd"
                                      and d == 100))


def d100_forward_on_simt():
    """Within it, the forward at head dim 100 takes the simt route, as before
    its wgmma kernel (no mma kernel takes 200-byte rows)."""
    return _off_wgmma(lambda key, d: key[0] == "flash_fwd" and d == 100)


def d100_backward_on_simt():
    """Within it, dQ and dK/dV at head dim 100 take the simt route, as before
    their wgmma kernels (no mma kernel takes 200-byte rows); the forward
    keeps its wgmma kernel."""
    return _off_wgmma(lambda key, d: key[0] != "flash_fwd" and d == 100)


def _launch_host_ms(fn, n: int = 50) -> dict:
    """The host's ms a call of `fn` takes to enqueue, over `n` calls: with
    the device idle, and behind ~1 s of device work (`torch.cuda._sleep`),
    where a launch that waits on the device would show it."""
    fn()
    out = {}
    for name, cycles in (("idle", 0), ("behind_busy_device", 2_000_000_000)):
        torch.cuda.synchronize()
        if cycles:
            torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
    return out


def stablelm3b_host_turns(rounds: int = 5, steps: int = 3) -> dict:
    """Where the StableLM-3B-4E1T step's host clock goes, before any trace:
    dQ's and dK/dV's host ms a launch at its attention's shape (B=1, S=2048,
    32 heads of 80, the model's views) on wgmma and on mma, idle and behind
    a busy device (`_launch_host_ms`); then `rounds` rounds of `steps` steps
    (all 32 layers, remat, AdamW) on each route set, the backward on wgmma
    and on mma (`d80_backward_on_mma`), the order flipped each round, with
    the host's ms to enqueue each step and to finish it, and their
    medians."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn((1, 2048, 32, 80), generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    o, lse = attention.flash_fwd(q, k, v)
    args = (q, k, v, do, lse, attention.backward_delta(o, do).contiguous())
    launch = {f"{fn.__name__}_{route}": _launch_host_ms(lambda: fn(*args, route=route))
              for fn in (attention.flash_bwd_dq, attention.flash_bwd_dkv)
              for route in ("wgmma", "mma")}
    del q, k, v, do, o, lse, args
    cfg = stablelm_3b_4e1t()
    init_fn, step_fn, batch_fn = build_llama_train_step(cfg, device="cuda")
    params, opt_state = init_fn(0)
    tokens = batch_fn(torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                                    device="cuda"))
    sets = {"wgmma": contextlib.nullcontext, "backward_on_mma": d80_backward_on_mma}
    for routes in sets.values():
        with routes():
            step_fn(params, opt_state, tokens)
    times = {name: {"enqueue_ms": [], "step_ms": []} for name in sets}
    for i in range(rounds):
        for name in (list(sets) if i % 2 else list(sets)[::-1]):
            with sets[name]():
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step_fn(params, opt_state, tokens)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    times[name]["enqueue_ms"].append((t1 - t0) * 1e3)
                    times[name]["step_ms"].append((time.perf_counter() - t0) * 1e3)
    report = {"window": "stablelm3b_host_turns", "launch_host_ms": launch, "steps": times,
              "median_ms": {name: {key: statistics.median(v) for key, v in t.items()}
                            for name, t in times.items()}}
    print(json.dumps(report), flush=True)
    return report


def phi3_train_windows(steps: int = 8) -> list[dict]:
    """Phi-3-mini training steps (32 layers, B=1, S=2048, remat, AdamW) on
    each route set: `steps` steps of each on the host's clock in turns
    ({route set: step ms}, and each set's median; after a warm-up step on
    each),
    then one step of each traced. Run it before any other trace."""
    cfg = phi3_mini()
    init_fn, step_fn, batch_fn = build_llama_train_step(cfg, device="cuda")
    params, opt_state = init_fn(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = batch_fn(torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                                    device="cuda"))

    def step(_):
        step_fn(params, opt_state, tokens)

    sets = {"wgmma96": contextlib.nullcontext, "mma96": d96_on_mma}
    for routes in sets.values():
        with routes():
            step(None)
    times = {name: [] for name in sets}
    for name in ("wgmma96", "mma96", "mma96", "wgmma96"):
        with sets[name]():
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(None)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    report = {"window": "phi3_train_step_ms_in_turns", "step_ms": times,
              "step_ms_median": {k: statistics.median(v) for k, v in times.items()}}
    print(json.dumps(report), flush=True)
    reports = [report]
    for name, routes in sets.items():
        with routes():
            reports.append(trace(f"phi3_train_step_b1_s2048_{name}", step))
    return reports


def _forward_windows(cases) -> list[dict]:
    """For each (config, old route's name, its route set): one traced
    `llama_forward` (B=1, S=2048) with flash_fwd on its wgmma kernel and one
    on the old route, the weights freed after each config."""
    reports = []
    for cfg, old_name, old in cases:
        params = init_llama(cfg, seed=0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
        dtype = "" if cfg.dtype == "bfloat16" else "_fp16"
        with torch.no_grad():
            for name, routes in (("wgmma", contextlib.nullcontext), (old_name, old)):
                with routes():
                    reports.append(trace(
                        f"forward_d{cfg.head_dim}{dtype}_{cfg.n_layers}_layers_b1_s2048_{name}",
                        lambda _: llama_forward(params, tokens, cfg)))
        del params
        _free()
    return reports


def new_width_forward_windows() -> list[dict]:
    """At OpenLLaMA-3B's widths (head dim 100) and StableLM-3B-4E1T's (80),
    B=1, S=2048: one traced `llama_forward` with flash_fwd on its wgmma
    kernel and one on the route it took before (simt at 100, mma at 80)."""
    return _forward_windows(((openllama_3b(), "simt", d100_forward_on_simt),
                             (stablelm_3b_4e1t(), "mma", d80_forward_on_mma)))


def gemma_opt_forward_windows() -> list[dict]:
    """At Gemma-2B's widths (head dim 256, bf16) and OPT-1.3B's (64, fp16),
    B=1, S=2048: one traced `llama_forward` with flash_fwd on its wgmma
    kernel and one on mma, the route it took before."""
    return _forward_windows(((gemma_2b(), "mma", d256_forward_on_mma),
                             (opt_1_3b(), "mma", fp16_d64_forward_on_mma)))


def fp16_new_width_forward_windows() -> list[dict]:
    """At OPT-2.7B's widths (head dim 80, fp16) and OpenLLaMA-3B's in fp16
    (100), B=1, S=2048: one traced `llama_forward` with flash_fwd on its
    fp16 wgmma kernel and one on the route it took before (mma at 80, simt
    at 100)."""
    return _forward_windows(((opt_2_7b(), "mma", fp16_d80_forward_on_mma),
                             (openllama_3b_fp16(), "simt", fp16_d100_forward_on_simt)))


def neox_gptj_forward_windows() -> list[dict]:
    """At GPT-NeoX-20B's widths (head dim 96, fp16, 44 layers) and
    GPT-J-6B's (256, fp16, 28 layers), B=1, S=2048: one traced
    `llama_forward` with flash_fwd on its fp16 wgmma kernel and one on mma,
    the route it took before."""
    return _forward_windows(((gpt_neox_20b(), "mma", fp16_d96_forward_on_mma),
                             (gptj_6b(), "mma", fp16_d256_forward_on_mma)))


def _backward_train_windows(cfg, label: str, old_name: str, old) -> list[dict]:
    """One traced training step of `cfg` (all its layers, B=1, S=2048,
    remat, AdamW) with dQ and dK/dV on their wgmma kernels, and one with
    both on their old route (`old`); the forward on wgmma in both."""
    init_fn, step_fn, batch_fn = build_llama_train_step(cfg, device="cuda")
    params, opt_state = init_fn(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = batch_fn(torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                                    device="cuda"))
    reports = []
    for name, routes in (("wgmma", contextlib.nullcontext), (old_name, old)):
        with routes():
            reports.append(trace(f"{label}_train_step_b1_s2048_{name}",
                                 lambda _: step_fn(params, opt_state, tokens)))
    return reports


def openllama3b_train_windows() -> list[dict]:
    """OpenLLaMA-3B's step (26 layers) traced with dQ and dK/dV on their
    head-dim-100 wgmma kernels and on simt (`d100_backward_on_simt`)."""
    return _backward_train_windows(openllama_3b(), "openllama3b", "backward_on_simt",
                                   d100_backward_on_simt)


def stablelm3b_train_windows() -> list[dict]:
    """StableLM-3B-4E1T's step (32 layers) traced with dQ and dK/dV on their
    head-dim-80 wgmma kernels and on mma (`d80_backward_on_mma`)."""
    return _backward_train_windows(stablelm_3b_4e1t(), "stablelm3b", "backward_on_mma",
                                   d80_backward_on_mma)


def gemma2b_train_windows() -> list[dict]:
    """Gemma-2B's step (18 layers) traced with dQ and dK/dV on their
    head-dim-256 wgmma kernels and on mma (`d256_backward_on_mma`)."""
    return _backward_train_windows(gemma_2b(), "gemma2b", "backward_on_mma",
                                   d256_backward_on_mma)


def _fp16_backward_windows(cfg, label: str, old_name: str, old) -> list[dict]:
    """`cfg`'s loss (all its layers, fp16, B=1, S=2048, remat) traced through
    its forward and backward, with no optimizer step (AdamW's eps is 0 in
    fp16), with dQ and dK/dV on their fp16 wgmma kernels and on their old
    route (`old`), each traced twice, in turns."""
    params = init_llama(cfg, seed=0, device="cuda")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")

    def fwd_bwd(_):
        for t in leaves:
            t.grad = None
        llama_loss(params, tokens, cfg, remat=True).backward()

    # in turns A, B, B, A, so that neither set is only the first traced
    sets = (("wgmma", contextlib.nullcontext), (old_name, old))
    reports = []
    for name, routes in sets + sets[::-1]:
        with routes():
            reports.append(trace(f"{label}_fp16_fwd_bwd_b1_s2048_{name}", fwd_bwd))
    return reports


def opt13b_backward_windows() -> list[dict]:
    """OPT-1.3B's loss (24 layers) traced as `_fp16_backward_windows`, dQ
    and dK/dV on their fp16 head-dim-64 wgmma kernels and on mma
    (`fp16_backward_on_mma(64)`)."""
    return _fp16_backward_windows(opt_1_3b(), "opt13b", "backward_on_mma",
                                  functools.partial(fp16_backward_on_mma, 64))


def openllama3b_fp16_backward_windows() -> list[dict]:
    """OpenLLaMA-3B's loss in fp16 (26 layers) traced as
    `_fp16_backward_windows`, dQ and dK/dV on their fp16 head-dim-100 wgmma
    kernels and on simt (`fp16_d100_backward_on_simt`)."""
    return _fp16_backward_windows(openllama_3b_fp16(), "openllama3b", "backward_on_simt",
                                  fp16_d100_backward_on_simt)


def gptj6b_fp16_backward_windows() -> list[dict]:
    """GPT-J-6B's loss (28 layers, fp16) traced as `_fp16_backward_windows`,
    dQ and dK/dV on their fp16 head-dim-256 wgmma kernels and on mma
    (`fp16_backward_on_mma(256)`)."""
    return _fp16_backward_windows(gptj_6b(), "gptj6b", "backward_on_mma",
                                  functools.partial(fp16_backward_on_mma, 256))


def neox20b_fp16_backward_windows() -> list[dict]:
    """GPT-NeoX-20B's loss (fp16, cut to `NEOX20B_BACKWARD_LAYERS` of its 44
    layers) traced as `_fp16_backward_windows`, dQ and dK/dV on their fp16
    head-dim-96 wgmma kernels and on mma (`fp16_backward_on_mma(96)`)."""
    return _fp16_backward_windows(gpt_neox_20b(NEOX20B_BACKWARD_LAYERS),
                                  f"neox20b_{NEOX20B_BACKWARD_LAYERS}_layers",
                                  "backward_on_mma", functools.partial(fp16_backward_on_mma, 96))


def opt27b_fp16_backward_windows() -> list[dict]:
    """OPT-2.7B's loss (all 32 layers, fp16) traced as
    `_fp16_backward_windows`, dQ and dK/dV on their fp16 head-dim-80 wgmma
    kernels and on mma (`fp16_backward_on_mma(80)`)."""
    return _fp16_backward_windows(opt_2_7b(), "opt27b", "backward_on_mma",
                                  functools.partial(fp16_backward_on_mma, 80))


def moe_forward_window(cfg) -> dict:
    params = init_llama(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    with torch.no_grad():
        return trace(f"moe_forward_{cfg.n_layers}_layers_b1_s2048",
                     lambda _: llama_forward(params, tokens, cfg))


def resnet_window(batch: int = 256, image: int = 224) -> dict:
    """One ResNet-50 training pass: the train-mode forward (batch_stats
    updated), a softmax cross-entropy on random labels, its backward."""
    init_fn, apply_fn = resnet_forward_fn(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(batch, image, image, 3, generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    variables = init_fn(0, x)
    params = list(variables["params"].values())
    for t in params:
        t.requires_grad_(True)

    def step(_):
        logits, _ = apply_fn(variables, x, train=True)
        F.cross_entropy(logits, labels).backward()
        for t in params:
            t.grad = None

    return trace(f"resnet50_train_b{batch}_{image}px", step)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()  # each window's weights need the room


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_path: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    reports = [stablelm3b_host_turns()]
    _free()
    reports += phi3_train_windows()
    _free()
    cfg = LlamaConfig.llama2_7b()
    reports += inference_windows(cfg)
    _free()
    reports.append(train_window(cfg, "train_step_b1_s2048"))
    _free()
    reports.append(train_window(cfg, "pipeline_train_step_pp4_m4_b4_s2048",
                                build_pipelined_llama_train_step, batch=4, pp=4,
                                num_microbatches=4))
    _free()
    reports.append(moe_forward_window(mixtral_8x7b(16)))
    _free()
    reports.append(train_window(mixtral_8x7b(4), "moe_train_step_4_layers_b1_s2048"))
    _free()
    reports.append(resnet_window())
    _free()
    reports += new_width_forward_windows()
    _free()
    reports += openllama3b_train_windows()
    _free()
    reports += gemma_opt_forward_windows()
    _free()
    reports += stablelm3b_train_windows()
    _free()
    reports += gemma2b_train_windows()
    _free()
    reports += opt13b_backward_windows()
    _free()
    reports += fp16_new_width_forward_windows()
    _free()
    reports += openllama3b_fp16_backward_windows()
    _free()
    reports += neox_gptj_forward_windows()
    _free()
    reports += gptj6b_fp16_backward_windows()
    _free()
    reports += neox20b_fp16_backward_windows()
    _free()
    reports += opt27b_fp16_backward_windows()
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_path.json").write_text(json.dumps(
        {"nvidia_smi": smi, "reports": reports}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
