"""Where the time goes on the port's path, at Llama-2-7B and Mixtral-8x7B
widths on one GPU.

    python3 -m yoda_scheduler_tpu_torch.profile_path

Traces with torch.profiler, after a warm-up, at Llama-2-7B width one
`llama_forward` (B=1, S=2048), one `prefill` (4 requests x 512 tokens), 16
`decode_step`s of those requests (their prefill outside the trace), one
training step (B=1, S=2048, remat, AdamW; all 32 layers) and one pipelined
training step (pp=4 stages in one process, 4 microbatches, B=4); then at
Mixtral-8x7B width one `llama_forward` (16 layers) and one training step
(4 layers), both B=1, S=2048; last one ResNet-50 training pass (bf16,
B=256, 224 x 224, the forward and backward of a softmax cross-entropy). For
each window it prints one JSON line: the host wall time, the device's busy
time (the union of kernel intervals) and idle share, the kernel launches,
the device time grouped into conv / matmul / flash_fwd / flash_bwd_dq /
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
import gc
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.nn.functional as F

from .models import (KVCache, LlamaConfig, decode_step, init_llama, llama_forward,
                     prefill, resnet_forward_fn)
from .models.moe import ROUTE_SPAN
from .models.resnet import BN_SPAN
from .parallel import build_llama_train_step, build_pipelined_llama_train_step


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
    cfg = LlamaConfig.llama2_7b()
    reports = inference_windows(cfg)
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
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_path.json").write_text(json.dumps(
        {"nvidia_smi": smi, "reports": reports}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
