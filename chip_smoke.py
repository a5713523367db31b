#!/usr/bin/env python3
"""Drive the PyTorch port (yoda_scheduler_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. build: the card's name and power limit, and the CUDA kernels compiled
   from the sources in this checkout (nvcc, sm_90a, one process per source).
2. kernel: the flash forward kernel against its plain version on the card
   at the main path's shape (also as the model's transposed [B, S, H, D]
   views), at Mixtral's GQA 32/8 (contiguous and as the model's views) and
   at cross-length, window, non-causal, fp32, ragged and unaligned shapes, each on the route `_route` picks, with the
   kernel's, the plain version's and one library call's times, TF/s and the
   card's bound for the same work; at the main shape the wgmma and mma
   routes are timed in turns (mma, wgmma, wgmma, mma).
3. backward: the dQ and dK/dV kernels against the plain backward at the
   same shapes (a non-zero LSE cotangent at some), elementwise and by each
   output's worst tile, each on the route `_route` picks, twice with equal
   bits, with their times, TF/s, the
   plain backward's time, the bound of each, and at the main shape the
   library's backward (timed alone) and the wgmma and mma routes of each
   kernel timed in turns (mma, wgmma, wgmma, mma).
4. forward: Llama-2-7B width, all 32 layers, bf16, random weights from a
   seed, B=1, S=2048: one `llama_forward` must launch the kernel once per
   layer, and its logits must agree with the forward through the plain
   attention.
5. serving: the same weights answer 4 requests (512-token prompts, 64 new
   tokens, greedy) twice with equal tokens, prefill's logits agree with the
   forward's at every prompt position, and one sampled request is
   deterministic per seed.
6. gradient: at 7B width with 4 layers, the loss's gradient through the
   kernels against the gradient through the plain attention, every leaf.
7. train: the 7B-width, 32-layer, bf16 train step (remat, AdamW), B=1,
   S=2048, 4 steps on one batch: launches per step, every one on the wgmma
   route, a falling loss, step time, tokens/s, MFU and peak memory.

The MoE phases run Mixtral-8x7B's published widths (8 experts, top-2, GQA
32/8) with random bf16 weights from a seed, depth cut to fit the card:
moe_forward and moe_serving (16 layers) after serving, moe_train (4 layers)
after train.

- moe_forward: B=1, S=2048: 16 flash_fwd launches, all on the wgmma route;
  logits and routing against the forward through the plain attention, end
  to end and layer by layer from the same input; each of these four
  bounds must reject each planted wrong attention (`planted_faults`);
  dropped share, forward ms, peak memory, parameters.
- moe_serving: as serving, with its own bound, which each planted wrong
  attention in the forward must exceed; beside the decode step's memory
  bound (every expert weight read once a step).
- moe_train: as train, with aux weight 0.02; MFU by active parameters
  beside the capacity-padded expert work.

The sharded training step (parallel/), after train:

- sharded_train: a world-1 NCCL process group on an in-process store, the
  mesh with every axis 1, and `build_llama_train_step(llama2_7b, mesh)` for
  train's steps, seed and tokens: the losses against train's, launches per
  step by route, step time and peak memory (within train's + 2 GB: the
  fsdp gather is per layer at use).
- ring: ring attention over sp=4 through the one-process rotation at
  S=8192 in chunks of 2048, MHA 32/32 and GQA 32/8: output and dQ/dK/dV
  against the plain attention over the whole sequence (rel. L2 and worst
  64-row tile), a bit-repeatable backward, 10/10/10 launches on the wgmma
  route (6 future chunks skipped), the ring's forward and forward+backward
  times beside one 8192-token causal flash_fwd and its bound.
- ulysses: Ulysses over sp=4 through the one-process exchange on the
  ring's shapes (GQA 32/8 on the grouped-KV branch): each rank's 8 query
  heads over the whole 8192 tokens, 4/4/4 launches on the wgmma route, the
  same comparisons, its times beside the ring's of the same call.

The pipelined step (parallel/pipeline.py), 4 stages in one process (no
bubble and no point-to-point transfer is measured there), 4 microbatches:

- pipeline_gradient: 7B width, 4 layers, B=4, S=2048, remat: the loss and
  every leaf's gradient against the one-device llama_loss's; planted wrong
  pipelines (stage blocks reversed, microbatches retired to wrong slots)
  must each break the gradient bound and one of them the loss bound too.
- pipeline_train: all 32 layers, B=4: the first loss against the
  one-device loss, a falling loss, 256/128/128 wgmma launches a step, step
  time, tokens/s, MFU and peak memory beside the peak reckoned before it.

The workload runtime's last modules, after pipeline_train:

- checkpoint (parallel/checkpoint.py): 7B width cut to 4 layers (1.07 B
  parameters, ~6.4 GB of bf16 state with AdamW's moments), B=1, S=2048,
  the one-device step: 4 steps on one batch, saved after steps 1 and 2
  with max_to_keep=1 into a temporary directory (free space checked
  first); restored into a fresh init_fn(3) for 2 more steps, whose last
  loss must equal the uninterrupted run's to the bit; restored again onto
  the world-1 NCCL mesh's template for one step, equal to the bit too; GB
  written, save and restore seconds and GB/s.
- multihost (parallel/multihost.py): initialize_multihost over a TCP
  rendezvous on 127.0.0.1 (world-1 NCCL), global_batch against batch_fn,
  one 4-layer 7B-width step through it equal to the one-device step's loss
  to the bit; then the YODA_* env path with no arguments.
- resnet (models/resnet.py): ResNet-50, 1000 classes, B=256, 224 x 224 x
  3, bf16, channels_last: train-mode and eval forwards and the
  forward+backward of a softmax cross-entropy, images/s, TF/s and MFU
  (from the conv and Dense shapes), peak memory; the bf16 logits and
  running statistics against the fp32 model on the same weights and
  batch, and the running statistics of two BatchNorms against the fp32
  biased-variance formula (in fp64).

Every flash launch of the checkpoint and multihost steps is on the wgmma
route.

The scheduling system, on the host, fed by the card's telemetry:

- telemetry (telemetry/sniffer.py, duty.py, nvml.py): the NVML sniffer's
  node against nvidia-smi (memory total equal, free within a slack, max SM
  clock, power limit, one chip a card) and CUDA's memory view; free memory
  again while 16 GiB are held; NVML's utilization through DutySamplerPool
  (>= 80 under ~2 s of the ring phase's causal 8192-token flash_fwd, <= 20
  two seconds after) and the probe sampler above its idle reading; `python
  -m yoda_scheduler_tpu_torch.cli sniff`'s CR (accelerator gpu, a chip for
  each card `nvidia-smi -L` lists); the snapshot's ms.
- scheduler (the engine copy): bench.py's huge_5000 cluster (5,000 fake
  nodes through the port's telemetry.fake) plus the live card as sniffed;
  a 60,000 MB one-card GPU pod binds on the live card and nowhere else,
  and with 40 GiB of the card held (re-sniffed, re-put) the same pod is
  refused; then bench.py's burst of 25,000 pods (5 a node, its four
  kinds, in an order from a seed): no chip held twice, no chip's memory
  overcommitted, two runs of the whole trace placing alike; bound pods,
  cycle p50 and p99, wall seconds and the data planes that ran.

Then a line listing every kernel of the path, and last the device
line. Full results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_HBM_BYTES = 3.35e12   # bytes/s
PEAK_FLOPS = {torch.bfloat16: H100_BF16_FLOPS, torch.float32: H100_FP32_FLOPS}

# phase 2 tolerances, |kernel - plain| <= atol + rtol * |plain|:
# bf16 O: the plain version rounds the probabilities to bf16 before P.V and
#   the kernel rounds only its output, about one bf16 ulp at |O| < 4;
# fp32 O: summation order only (the plain products run in full fp32);
# LSE is fp32 on both sides; the kernel scales q before Q.K^T and the plain
#   version scales the scores after it.
TOL = {torch.bfloat16: dict(o=2e-2, lse=1e-3), torch.float32: dict(o=1e-4, lse=1e-4)}
# phases 3-4: relative L2 error of the logits against the plain path. Each
# of 32 bf16 layers rounds its attention differently in the two paths and
# the residual stream carries the differences on; two plain bf16 paths of 32
# layers at width 128 already differ by 2.4e-2 on the CPU. A wrong mask or
# index gives an error of order 1.
LOGITS_REL_L2 = 1e-1
# phase 3 tolerance, as phase 2's: the plain backward rounds P and dS to the
# input dtype where the kernels round them, so bf16 results differ by the
# order of fp32 sums, which moves a rounding by one bf16 ulp now and then;
# fp32 results differ by summation order only.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# phase 3 also bounds each of dQ, dK and dV by its worst 64-row tile of one
# (batch, head), `tile_rel_l2`: dK and dV of late keys are about as small as
# BWD_TOL's atol, so a tile that is a fifth wrong can pass the bound above;
# this one holds every tile to its own size (bf16: the variant tool's bound,
# `variants.BWD_TILE_REL_L2`; fp32: summation order).
BWD_TILE_REL_L2_FP32 = 1e-4
BWD_G_LSE = {"gqa", "gqa_bshd", "cross_length", "ragged_300"}  # shapes with a non-zero LSE cotangent
# phase 6: relative L2 error of each leaf's gradient against the gradient
# through the plain attention. The two round at different places in bf16:
# autograd of the plain attention rounds the probabilities and their
# gradient dP to bf16 and keeps dS in fp32, the kernels keep dP in fp32 and
# round P and dS; every matmul of the backward then rounds its bf16 output,
# and 4 layers carry the differences on. A wrong mask or index moves the
# attention gradients by tens of percent.
GRAD_REL_L2 = 5e-2
TRAIN_STEPS = 4   # one warm-up step, then three timed
# MoE phases, against the same model through the plain attention. Set before
# the first card run from a CPU emulation (a kernel-like bf16 attention
# against the plain one, 16 MoE layers of 8 experts, top-2, widths 512 and
# 1024), not from a card run:
# - end to end, routing flips near ties reroute tokens, which reroutes
#   others through attention and capacity, so the two paths drift apart
#   layer by layer: logits rel. L2 0.12-0.16 and routing agreement
#   0.94-0.96 (layer 0 0.998, layer 15 0.87-0.91) for sound kernels; 1.04
#   and 0.44 for a non-causal kernel. Bounds 0.5 and 0.75.
# - layer by layer, both paths given the same input (the kernel path's):
#   a sound kernel moves a choice only near a tie, agreement >= 0.9956 and
#   layer output rel. L2 <= 0.013 in the emulation; a non-causal kernel
#   0.91 and 0.157. Bounds 0.98 and 0.05 for every layer.
# Each of the four bounds must also reject every planted wrong attention
# (`planted_faults`), read on the card in every run.
# moe_serving: prefill's logits at every prompt position (4 x 512, the plain
# cached attention) against llama_forward's (the kernel), as moe_forward's
# end-to-end comparison at a quarter of the tokens a row. With sound kernels
# the card read 0.130 (moe_forward, every position) and 0.1487 (prefill's
# last position). Bound 0.3, about twice those, chosen before any planted
# fault was read; the planted faults must exceed it.
MOE_SERVING_REL_L2 = 0.3
MOE_LOGITS_REL_L2 = 0.5
MOE_ROUTING_AGREE = 0.75
MOE_LAYER_ROUTING_AGREE = 0.98
MOE_LAYER_REL_L2 = 5e-2
MOE_FORWARD_LAYERS, MOE_TRAIN_LAYERS = 16, 4
# sharded_train: at world 1 every collective is skipped and each rank's
# hooks are the one-device ones, so the sharded step runs the one-device
# step's operations on the same inputs: its losses are expected equal to
# train's to the bit. The bound is relative and allows a sum's order to
# differ (a bf16 step's loss moves by ~1e-3 for a one-ulp change of its
# weights); the reading is reported as it is.
SHARDED_LOSS_REL = 1e-3
SHARDED_PEAK_SLACK_GB = 2.0
# ring: S=8192 over sp=4 (the whole sequence's causal attention as 4
# diagonal and 6 full 2048-token chunks); output and gradients against the
# plain attention, by relative L2 over the whole tensor and by the worst
# 64-row tile (phase 3's bound, variants.BWD_TILE_REL_L2): the ring merges
# fp32 partials and rounds once, the plain version rounds its
# probabilities to bf16 before P.V.
RING_SEQ, RING_SP = 8192, 4
RING_SHAPES = {"mha": (1, 32, 32, 128), "gqa": (1, 32, 8, 128)}  # b, h, kvh, d
# pipeline phases: 4 stages in one process, 4 microbatches of one row each.
# The loss against the one-device loss within 5e-3 absolute (the JAX
# package's test_loss_matches_plain_model bound); every gradient within
# GRAD_REL_L2 (phase 6's). With random weights the loss barely sees how the
# stages are wired (a wrong pairing of rows and targets moves it by the
# noise of 8188 random predictions, ~1e-2), the gradients do (order 1):
# each planted fault must break the gradient bound, and one the loss bound.
PIPE_PP, PIPE_MICROBATCHES, PIPE_BATCH, PIPE_SEQ = 4, 4, 4, 2048
PIPE_LOSS_ABS = 5e-3
PIPE_FAULTS = ("stage_order", "retire_shift", "retire_reversed")

# checkpoint and multihost: 7B width cut to 4 layers so that the state
# (1.07 B parameters and AdamW's bf16 moments, ~6.4 GB) writes in seconds;
# a resumed or rendezvoused step runs the same operations on the same
# values as the uninterrupted one-device step, so the losses must be equal
# to the bit (sharded_train already reads equal against train).
CKPT_LAYERS, CKPT_STEPS, CKPT_SAVES = 4, 4, (1, 2)
# resnet: B=256 at 224 x 224 (the JAX package's example pod trains at
# ImageNet size). The bf16 model against the fp32 model on the same weights
# and batch, both in this port on the card: each conv rounds its output to
# bf16 and every BatchNorm carries the differences on. A CPU estimate
# (B=8..64, 64-224 px, these weights), not a card reading: train-mode
# logits 0.011-0.033, eval 0.0026-0.0035, running statistics 0.004-0.006.
# Bounds about 3x those. The running statistics after one train forward
# against the biased-variance formula in fp64: fp32 sums only.
RESNET_BATCH, RESNET_IMAGE, RESNET_ITERS = 256, 224, 3
RESNET_REL_L2 = {"train": 0.1, "eval": 0.02, "stats": 0.02}
RESNET_STATS_FORMULA_REL = 1e-4
# telemetry: NVML's memory.total and free are what nvidia-smi reads (the
# same library, MiB floored), so totals must be equal and free memory, read
# a moment apart with nothing allocated between, within TELEMETRY_FREE_SLACK_MB.
# CUDA's own view (torch.cuda.mem_get_info) leaves out the GPU driver's
# reservation: its total may be lower than NVML's by up to
# TELEMETRY_CUDA_SLACK_MB, and its free memory differs by as much.
# A 16 GiB allocation must lower the sniffed free memory by at least
# 16 GiB less the free slack. The load is the ring phase's causal
# 8192-token flash_fwd (B=1, H=32, D=128, bf16: ~1 ms a launch), enqueued
# for TELEMETRY_LOAD_S: the host keeps the launch queue full, so NVML's
# utilization reads >= TELEMETRY_BUSY_PCT during it and <= TELEMETRY_IDLE_PCT
# TELEMETRY_SETTLE_S after it.
TELEMETRY_FREE_SLACK_MB, TELEMETRY_CUDA_SLACK_MB = 256, 1024
TELEMETRY_ALLOC_GIB, TELEMETRY_LOAD_S, TELEMETRY_SETTLE_S = 16, 2.0, 2.0
TELEMETRY_BUSY_PCT, TELEMETRY_IDLE_PCT = 80, 20
# scheduler: bench.py's huge_5000 cell (BENCH_SCALE5K.json): 625 x (one
# v4-32 slice of 4 hosts, 2 v4-8 hosts, 2 GPU nodes of 8 cards at 40,000
# MB) = 5,000 nodes, 5 pods a node in bench.py's mix, plus this host's
# card as sniffed. A pod asking for LIVE_POD_MB of free memory a card fits
# only the live card (a fake GPU card has 40,000 MB); with LIVE_HOLD_GIB
# of the card held it fits nowhere.
SCHED_UNITS, SCHED_PODS_PER_NODE, SCHED_SEED = 625, 5, 13
LIVE_NODE, LIVE_POD_MB, LIVE_HOLD_GIB = "h100-live", 60_000, 40

RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of one call over `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask lets through: the work these inputs need."""
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        qp = sk - sq + i
        lo = 0 if window is None else max(0, qp - window + 1)
        total += qp - lo + 1
    return total


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(b, h, kvh, sq, sk, d, causal, window, dtype):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    (q, k, v read once, O and LSE written once) and the two products' flops
    over the peak rate of the dtype."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    flops = 4 * b * h * d * visible_pairs(sq, sk, causal, window)
    return _bound(nbytes, flops, dtype)


def backward_bounds(b, h, kvh, sq, sk, d, causal, window, dtype):
    """{"dq": (bound_ms, bound_by), "dkv": ...}. dQ: q, dO and k, v read,
    dQ written, LSE and delta read (8 bytes a row); 6 D flops a visible pair
    (S, dP, dS K). dK/dV: the same reads, dK and dV written (one per q
    head, as the kernel writes them); 8 D flops a visible pair (S, dP,
    P^T dO, dS^T Q)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(sq, sk, causal, window)
    reads = esize * d * (2 * b * h * sq + 2 * b * kvh * sk) + 8 * b * h * sq
    return {"dq": _bound(reads + esize * d * b * h * sq, 6 * b * h * d * pairs, dtype),
            "dkv": _bound(reads + 2 * esize * d * b * h * sk, 8 * b * h * d * pairs,
                          dtype)}


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording_routes(moe):
    """Collects (expert [B, S, k], dispatched [B, S, k]) of each MoE layer
    that runs inside the block, in order."""
    calls, orig = [], moe._top_k_dispatch

    def record(*args):
        out = orig(*args)
        calls.append((out[0], out[2] > 0))
        return out

    moe._top_k_dispatch = record
    try:
        yield calls
    finally:
        moe._top_k_dispatch = orig


def routing_agreement(a, b) -> float:
    """Share of (token, choice) decisions, expert and dispatched, that are
    equal in two runs of one layer."""
    (ea, da), (eb, db) = a, b
    return float(((ea == eb) & (da == db)).float().mean())


def planted_faults(attn) -> dict:
    """Wrong attentions, each a fault a kernel could have, for the MoE
    phases' comparisons to reject: the causal mask dropped, and every query
    head reading the next KV group's keys and values (a group-index fault)."""
    def kv_group_shift(q, k, v):
        return attn.flash_attention(q, k.roll(1, dims=1), v.roll(1, dims=1))

    kv_group_shift.handles_gqa = True
    return {"non_causal": functools.partial(attn.flash_attention, causal=False),
            "kv_group_shift": kv_group_shift}


def reset_launches(attn) -> None:
    for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        attn._reset_counts(fn)


def read_launches(attn) -> dict:
    return {fn.__name__: fn.launches
            for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)}


def read_routes(attn) -> dict:
    """Each wrapper's launches by route, the routes that launched."""
    return {fn.__name__: {r: n for r, n in fn.launches_by_route.items() if n}
            for fn in (attn.flash_fwd, attn.flash_bwd_dq, attn.flash_bwd_dkv)}


def ptxas_summary(log: str) -> dict:
    """{kernel (with its mangled template arguments): "N registers, S bytes
    spill stores, L bytes spill loads"} from nvcc's -Xptxas -v output;
    ptxas's performance notes (wgmma serialization, setmaxnreg) are kept
    under "notes"."""
    out, notes, kernel = {}, [], None
    for ln in log.splitlines():
        name = re.search(r"\d(flash_\w+?_kernel)(I\w*?EE)?", ln)
        if "Compiling entry" in ln and name:
            kernel = name.group(1) + (name.group(2) or "")
            out[kernel] = ""
        elif kernel and "spill stores" in ln:
            out[kernel] = ln.strip()
        elif kernel and "Used" in ln and "registers" in ln:
            used = re.search(r"Used (\d+) registers", ln).group(1)
            out[kernel] = f"{used} registers, {out[kernel]}"
        elif "Performance" in ln or "setmaxnreg" in ln:
            notes.append(ln.strip())
    return {**out, "notes": notes}


def phase_build(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    names = ("flash_fwd", "flash_bwd")
    build.load(*names)
    info = {n: build.build_info.get(n, {}) for n in names}
    ptxas = {n: ptxas_summary(i.get("log", "")) for n, i in info.items()}
    # the wgmma kernels must fit their registers: no spills, no wgmma
    # serialised for want of registers (ptxas's C7512); the build keeps
    # ptxas's output beside each library, so a cached build is checked too
    wgmma = {k: v for p in ptxas.values() for k, v in p.items() if "wgmma" in k}
    notes = [n for p in ptxas.values() for n in p["notes"]]
    spill_free = (
        len(wgmma) == 3
        and all("0 bytes spill stores, 0 bytes spill loads" in v for v in wgmma.values())
        and not any("C7512" in n or "serialized" in n for n in notes))
    emit("build", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0,
         nvcc_s={n: i.get("seconds") for n, i in info.items()}, ptxas=ptxas,
         wgmma_kernels_spill_free=spill_free)
    if not spill_free:
        raise SystemExit(f"the three wgmma kernels must build with no spills and no "
                         f"serialised wgmma: {wgmma}, notes {notes}")
    return smi


# (name, b, h, kvh, sq, sk, d, causal, window, dtype, layout, route):
# layout "bhsd" is contiguous [B, H, S, D]; "bshd" the model's transposed
# views of a contiguous [B, S, H, D]; "offset1" starts every tensor one
# element into its storage, off 16-byte alignment. route is the forward
# kernel `_route` must pick for these inputs.
SHAPES = [
    ("main", 1, 32, 32, 2048, 2048, 128, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("main_bshd", 1, 32, 32, 2048, 2048, 128, True, None, torch.bfloat16, "bshd",
     "wgmma"),
    ("gqa", 1, 32, 8, 2048, 2048, 128, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("gqa_bshd", 1, 32, 8, 2048, 2048, 128, True, None, torch.bfloat16, "bshd",
     "wgmma"),  # Mixtral-8x7B's attention as its model gives it to the kernels
    ("cross_length", 1, 32, 32, 256, 1024, 128, True, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("window_512", 1, 32, 32, 2048, 2048, 128, True, 512, torch.bfloat16, "bhsd",
     "wgmma"),
    ("non_causal", 1, 32, 32, 1024, 1024, 128, False, None, torch.bfloat16, "bhsd",
     "wgmma"),
    ("fp32_d64", 1, 16, 16, 1024, 1024, 64, True, None, torch.float32, "bhsd", "simt"),
    ("ragged_300", 2, 8, 4, 300, 300, 128, True, None, torch.bfloat16, "bhsd", "wgmma"),
    ("main_unaligned", 1, 32, 32, 2048, 2048, 128, True, None, torch.bfloat16,
     "offset1", "simt"),
]
ROUTE_TURNS = ("mma", "wgmma", "wgmma", "mma")  # timed in turns at the main shape


def rand_inputs(gen, dtype, layout, *shapes):
    """Normal tensors of `shapes` ([B, H, S, D]) on the card in `layout`."""
    out = []
    offset = 1 if layout == "offset1" else 0
    for shape in shapes:
        n = math.prod(shape)
        x = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)[offset:]
        if layout == "bshd":
            b, h, s, d = shape
            out.append(x.view(b, s, h, d).transpose(1, 2))
        else:
            out.append(x.view(shape))
    return out


def phase_kernel(attn):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err = [], 0.0
    for name, b, h, kvh, sq, sk, d, causal, window, dtype, layout, want in SHAPES:
        q, k, v = rand_inputs(gen, dtype, layout, (b, h, sq, d), (b, kvh, sk, d),
                              (b, kvh, sk, d))
        route = attn._route(q, k, v)
        if route != want:
            raise SystemExit(f"{name} takes the {route} route, expected {want}")
        o, lse = attn.flash_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        ro, rlse = attn.reference_attention_with_lse(q, k, v, causal, window)
        tol = TOL[dtype]

        def agrees(o, lse):
            return (bool(torch.isfinite(o).all())
                    and torch.allclose(o.float(), ro.float(), atol=tol["o"], rtol=tol["o"])
                    and torch.allclose(lse, rlse, atol=tol["lse"], rtol=tol["lse"]))

        err_o = float((o.float() - ro.float()).abs().max())
        err_lse = float((lse - rlse).abs().max())
        ok = agrees(o, lse)
        ms = cuda_time_ms(lambda: attn.flash_fwd(q, k, v, causal, window), 20)
        plain_ms = cuda_time_ms(
            lambda: attn.reference_attention_with_lse(q, k, v, causal, window), 5)
        library_ms, turns = None, None
        if name in ("main", "main_bshd"):
            # the yardstick, timed here and used nowhere in the port
            library_ms = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 20)
        if name == "main":
            turns = {r: [] for r in ROUTE_TURNS}
            for r in ROUTE_TURNS:
                turns[r].append(cuda_time_ms(
                    lambda: attn.flash_fwd(q, k, v, causal, window, route=r), 20))
            ok = ok and agrees(*attn.flash_fwd(q, k, v, causal, window, route="mma"))
        bound_ms, bound_by = attention_bound(b, h, kvh, sq, sk, d, causal,
                                             window, dtype)
        flops = 4 * b * h * d * visible_pairs(sq, sk, causal, window)
        row = dict(shape=name, route=route, layout=layout, b=b, h=h, kvh=kvh,
                   sq=sq, sk=sk, d=d, causal=causal, window=window,
                   dtype=str(dtype).split(".")[1],
                   max_abs_err_o=err_o, max_abs_err_lse=err_lse, atol=tol,
                   ok=ok, ms=ms, tflops=flops / ms / 1e9,
                   share_of_bound=bound_ms / ms, plain_ms=plain_ms,
                   library_ms=library_ms, route_turns_ms=turns,
                   bound_ms=bound_ms, bound_by=bound_by)
        print(json.dumps({"phase": "kernel", **row}), flush=True)
        rows.append(row)
        max_err = max(max_err, err_o)
        if not ok:
            raise SystemExit(f"flash_fwd disagrees with its plain version at {name}")
    RESULTS["kernel"] = rows
    return rows, max_err


def sdpa_backward_ms(q, k, v, do) -> float:
    """The library yardstick: SDPA's backward alone, from one graph built
    once (inputs that require grad) and differentiated again and again.
    Timed here only; the port never calls it."""
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    ms = cuda_time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                  retain_graph=True), 20)
    del out
    return ms


def phase_backward(attn, variants):
    tile_bound = {torch.bfloat16: variants.BWD_TILE_REL_L2,
                  torch.float32: BWD_TILE_REL_L2_FP32}

    def agrees(got, ref_t, dtype):
        """(tile_rel_l2, ok): within BWD_TOL elementwise and within the tile
        bound."""
        tile = variants.tile_rel_l2(got, ref_t)
        tol = BWD_TOL[dtype]
        return tile, (bool(torch.isfinite(got).all()) and tile <= tile_bound[dtype]
                      and torch.allclose(got.float(), ref_t.float(), atol=tol, rtol=tol))

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = [], {"dq": 0.0, "dkv": 0.0}
    for name, b, h, kvh, sq, sk, d, causal, window, dtype, layout, want in SHAPES:
        q, k, v, do = rand_inputs(gen, dtype, layout, (b, h, sq, d), (b, kvh, sk, d),
                                  (b, kvh, sk, d), (b, h, sq, d))
        # dO in the layout of q: the backward takes the forward's route
        route = attn._route(q, k, v, do)
        if route != want:
            raise SystemExit(f"{name}: the backward takes the {route} route, "
                             f"expected {want}")
        o, lse = attn.flash_fwd(q, k, v, causal, window)
        g_lse = (torch.randn((b, h, sq), generator=gen, device="cuda")
                 if name in BWD_G_LSE else None)
        delta = attn.backward_delta(o, do, g_lse).contiguous()
        args = (q, k, v, do, lse, delta, causal, window)
        reset_launches(attn)
        runs = []
        for _ in range(2):
            dq = attn.flash_bwd_dq(*args)
            dk, dv = attn.flash_bwd_dkv(*args)
            runs.append((dq, attn.group_sum(dk, kvh), attn.group_sum(dv, kvh)))
        torch.cuda.synchronize()
        routes = read_routes(attn)
        if any(routes[n] != {want: 2} for n in ("flash_bwd_dq", "flash_bwd_dkv")):
            raise SystemExit(f"{name}: the backward launched {routes}, expected "
                             f"2 {want} launches of each kernel")
        repeatable = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        ref = attn.flash_backward_reference(q, k, v, o, lse, do, causal, window, g_lse)
        errs, ok = {}, repeatable
        for nm, got, ref_t in zip(("dq", "dk", "dv"), runs[0], ref):
            errs[nm] = float((got.float() - ref_t.float()).abs().max())
            errs[nm + "_rel_l2"] = rel_l2(got, ref_t)
            errs[nm + "_tile_rel_l2"], agree = agrees(got, ref_t, dtype)
            ok = ok and agree
        turns, route_tile = None, None
        if name == "main":
            # each route against the plain backward too, then in turns
            route_tile = {}
            for r in ROUTE_TURNS[:2]:
                dq = attn.flash_bwd_dq(*args, route=r)
                dk, dv = attn.flash_bwd_dkv(*args, route=r)
                for nm, got, ref_t in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                    route_tile[f"{r}_{nm}"], agree = agrees(got, ref_t, dtype)
                    ok = ok and agree
            turns = {fn: {r: [] for r in ROUTE_TURNS} for fn in ("dq", "dkv")}
            for r in ROUTE_TURNS:
                turns["dq"][r].append(cuda_time_ms(
                    lambda: attn.flash_bwd_dq(*args, route=r), 20))
                turns["dkv"][r].append(cuda_time_ms(
                    lambda: attn.flash_bwd_dkv(*args, route=r), 20))
        del runs, ref
        ms_dq = cuda_time_ms(lambda: attn.flash_bwd_dq(*args), 20)
        ms_dkv = cuda_time_ms(lambda: attn.flash_bwd_dkv(*args), 20)
        plain_ms = cuda_time_ms(lambda: attn.flash_backward_reference(
            q, k, v, o, lse, do, causal, window, g_lse), 3)
        library_ms = sdpa_backward_ms(q, k, v, do) if name == "main" else None
        bounds = backward_bounds(b, h, kvh, sq, sk, d, causal, window, dtype)
        pairs = visible_pairs(sq, sk, causal, window)
        row = dict(shape=name, route=route, layout=layout, b=b, h=h,
                   kvh=kvh, sq=sq, sk=sk, d=d, causal=causal, window=window,
                   dtype=str(dtype).split(".")[1], g_lse=g_lse is not None,
                   max_abs_err=errs, atol=BWD_TOL[dtype],
                   tile_rel_l2_bound=tile_bound[dtype], route_tile_rel_l2=route_tile,
                   bit_repeatable=repeatable, ok=ok,
                   dq_ms=ms_dq, dkv_ms=ms_dkv,
                   dq_tflops=6 * b * h * d * pairs / ms_dq / 1e9,
                   dkv_tflops=8 * b * h * d * pairs / ms_dkv / 1e9,
                   dq_share_of_bound=bounds["dq"][0] / ms_dq,
                   dkv_share_of_bound=bounds["dkv"][0] / ms_dkv,
                   route_turns_ms=turns, plain_ms=plain_ms, library_ms=library_ms,
                   dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
                   dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1])
        print(json.dumps({"phase": "backward", **row}), flush=True)
        rows.append(row)
        max_err["dq"] = max(max_err["dq"], errs["dq"])
        max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])
        if not ok:
            raise SystemExit(f"flash_bwd_dq/dkv disagree with the plain backward "
                             f"or are not repeatable at {name}")
    RESULTS["backward"] = rows
    return rows, max_err


def phase_forward(attn, llama):
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    with torch.no_grad():
        reset_launches(attn)
        logits = llama.llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = attn.flash_fwd.launches
        if launches != cfg.n_layers:
            raise SystemExit(f"llama_forward launched flash_fwd {launches} "
                             f"times, expected {cfg.n_layers}")
        ref = llama.llama_forward(params, tokens, cfg,
                                  attn_impl=attn.reference_attention)
        err = rel_l2(logits, ref)
        if (tuple(logits.shape) != (1, 2048, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all()) or err > LOGITS_REL_L2):
            raise SystemExit(f"forward logits wrong: shape {tuple(logits.shape)}, "
                             f"rel L2 {err}")
        del ref
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            llama.llama_forward(params, tokens, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    emit("forward", config="llama2_7b", layers=cfg.n_layers, batch=1, seq=2048,
         dtype=cfg.dtype, init_s=init_s, flash_fwd_launches=launches,
         logits_rel_l2_vs_plain=err, bound=LOGITS_REL_L2, forward_ms=times,
         forward_ms_median=statistics.median(times),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return cfg, params, launches


def phase_moe_forward(attn, llama, train, moe, cfg):
    """Mixtral-8x7B width, 16 layers, B=1, S=2048: the kernel path against
    the plain attention path, end to end and layer by layer."""
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in train.param_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    plain = attn.reference_attention
    with torch.no_grad():
        reset_launches(attn)
        with recording_routes(moe) as routes:
            logits = llama.llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches, by_route = read_launches(attn), read_routes(attn)
        want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != want or by_route["flash_fwd"] != {"wgmma": cfg.n_layers}:
            raise SystemExit(f"moe_forward launched {by_route}, expected {want} "
                             f"with every flash_fwd on the wgmma route")
        with recording_routes(moe) as plain_routes:
            ref = llama.llama_forward(params, tokens, cfg, attn_impl=plain)
        err = rel_l2(logits, ref)
        agree = [routing_agreement(a, b) for a, b in zip(routes, plain_routes)]
        dropped = statistics.mean(float((~d).float().mean()) for _, d in routes)
        faults = planted_faults(attn)
        planted = {}
        for name, impl in faults.items():
            with recording_routes(moe) as fr:
                bad = llama.llama_forward(params, tokens, cfg, attn_impl=impl)
            planted[name] = dict(
                logits_rel_l2=rel_l2(bad, ref),
                routing_agree=statistics.mean(
                    routing_agreement(a, b) for a, b in zip(fr, plain_routes)),
                layer_routing_agree=[], layer_rel_l2=[])
        del ref, bad
        # layer by layer: every path from the kernel path's input
        x = params["embed"][tokens]
        layer_agree, layer_err = [], []
        for layer in params["layers"]:
            with recording_routes(moe) as rk:
                y, _ = llama.transformer_layer(x, layer, cfg, attn.flash_attention)
            with recording_routes(moe) as rp:
                y_plain, _ = llama.transformer_layer(x, layer, cfg, plain)
            layer_agree.append(routing_agreement(rk[0], rp[0]))
            layer_err.append(rel_l2(y, y_plain))
            for name, impl in faults.items():
                with recording_routes(moe) as rf:
                    y_bad, _ = llama.transformer_layer(x, layer, cfg, impl)
                planted[name]["layer_routing_agree"].append(routing_agreement(rf[0], rp[0]))
                planted[name]["layer_rel_l2"].append(rel_l2(y_bad, y_plain))
            x = y
        del x, y, y_plain, y_bad
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            llama.llama_forward(params, tokens, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    agree_all = statistics.mean(agree)

    def rejected_by(logits_err, routing, layer_routing, layer_rel):
        """The bounds that these readings break."""
        return [n for n, broken in (
            ("logits_rel_l2", logits_err > MOE_LOGITS_REL_L2),
            ("routing_agree", routing < MOE_ROUTING_AGREE),
            ("layer_routing_agree", min(layer_routing) < MOE_LAYER_ROUTING_AGREE),
            ("layer_rel_l2", max(layer_rel) > MOE_LAYER_REL_L2)) if broken]

    for r in planted.values():
        r["rejected_by"] = rejected_by(r["logits_rel_l2"], r["routing_agree"],
                                       r["layer_routing_agree"], r["layer_rel_l2"])
    emit("moe_forward", config="mixtral_8x7b widths", layers=cfg.n_layers, batch=1,
         seq=2048, dtype=cfg.dtype, experts=cfg.num_experts, top_k=cfg.experts_per_token,
         capacity=moe.expert_capacity(2048, cfg.num_experts, cfg.experts_per_token,
                                      cfg.expert_capacity_factor),
         params=n_params, init_s=init_s, launches=launches, launches_by_route=by_route,
         logits_rel_l2_vs_plain=err, bound=MOE_LOGITS_REL_L2,
         routing_agree=agree_all, routing_agree_bound=MOE_ROUTING_AGREE,
         routing_agree_by_layer=agree, dropped_share=dropped,
         layer_routing_agree_min=min(layer_agree),
         layer_routing_agree_bound=MOE_LAYER_ROUTING_AGREE,
         layer_rel_l2_max=max(layer_err), layer_rel_l2_bound=MOE_LAYER_REL_L2,
         layer_routing_agree=layer_agree, layer_rel_l2=layer_err, planted=planted,
         forward_ms=times, forward_ms_median=statistics.median(times),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if (tuple(logits.shape) != (1, 2048, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or rejected_by(err, agree_all, layer_agree, layer_err)):
        raise SystemExit(f"moe_forward disagrees with the plain attention path: logits "
                         f"rel L2 {err}, routing agreement {agree_all}, by layer "
                         f"{min(layer_agree)}, layer rel L2 {max(layer_err)}")
    # each bound on its own must reject each planted fault
    passed = {n: r["rejected_by"] for n, r in planted.items() if len(r["rejected_by"]) < 4}
    if passed:
        raise SystemExit(f"moe_forward: a bound lets a planted fault pass (the bounds "
                         f"that reject it): {passed}")
    return cfg, params, launches["flash_fwd"]


def phase_serving(cfg, params, llama, gen_mod, phase="serving",
                  bound=LOGITS_REL_L2, planted=None, **extra):
    """4 requests, 512-token prompts, 64 greedy tokens, twice; `extra` goes
    into the phase's line. Prefill's logits at every prompt position (the
    cache walk prefill runs, whose last row prefill returns) must agree with
    llama_forward's within `bound`; each of `planted` ({name: attn_impl}),
    put in the forward in place of the kernel, must break it."""
    b, plen, new = 4, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                            device="cuda")
    with torch.no_grad():
        cache = gen_mod.KVCache.zeros(cfg, b, plen + new, device="cuda")
        gen_mod.prefill(params, prompts, cache, cfg)  # warm-up
        prefill_ms = []
        for _ in range(3):
            cache = gen_mod.KVCache.zeros(cfg, b, plen + new, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = gen_mod.prefill(params, prompts, cache, cfg)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        cache = gen_mod.KVCache.zeros(cfg, b, plen + new, device="cuda")
        walk, cache = gen_mod._forward_with_cache(
            params, prompts, gen_mod._positions(0, b, plen, prompts.device), cache, cfg)
        del cache
        fwd = llama.llama_forward(params, prompts, cfg)
        err, err_last = rel_l2(walk, fwd), rel_l2(last, fwd[:, -1])
        first_agree = int((last.argmax(-1) == fwd[:, -1].argmax(-1)).sum())
        del fwd
        planted_err = {
            name: rel_l2(walk, llama.llama_forward(params, prompts, cfg, attn_impl=impl))
            for name, impl in (planted or {}).items()}
    if planted:
        extra["planted_rel_l2_vs_prefill"] = planted_err
    if not torch.equal(walk[:, -1], last):
        raise SystemExit(f"{phase}: prefill's last logits differ from its cache walk's")
    if err > bound:
        raise SystemExit(f"{phase}: prefill logits disagree with llama_forward: "
                         f"rel L2 {err}")
    if any(e <= bound for e in planted_err.values()):
        raise SystemExit(f"{phase}: a planted fault passes the bound {bound}: "
                         f"{planted_err}")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen_mod.generate(params, prompts, cfg, new)
        torch.cuda.synchronize()
        runs.append((toks, (time.perf_counter() - t0) * 1e3))
    (toks, gen_ms), (toks2, gen_ms2) = runs
    if tuple(toks.shape) != (b, new) or not torch.equal(toks, toks2):
        raise SystemExit(f"{phase}: greedy generation is not repeatable")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise SystemExit(f"{phase}: generated token out of the vocabulary")
    sampled = [gen_mod.generate(params, prompts[:1], cfg, new, temperature=0.8,
                                generator=torch.Generator(device="cuda").manual_seed(7))
               for _ in range(2)]
    if not torch.equal(*sampled):
        raise SystemExit(f"{phase}: sampling is not deterministic per seed")
    p_ms = statistics.median(prefill_ms)
    steps = new - 1  # the last token needs no forward
    decode_ms = statistics.median([gen_ms, gen_ms2]) - p_ms
    emit(phase, requests=b, prompt_tokens=plen, new_tokens=new,
         prefill_ms=prefill_ms, prefill_ms_median=p_ms,
         prefill_logits_rel_l2_vs_forward=err, bound=bound,
         prefill_last_logits_rel_l2_vs_forward=err_last,
         first_token_argmax_agree=f"{first_agree}/{b}",
         generate_ms=[gen_ms, gen_ms2], decode_steps=steps,
         decode_ms_per_step=decode_ms / steps,
         decode_tokens_per_s=b * steps / (decode_ms / 1e3),
         greedy_repeatable=True, sampled_deterministic=True,
         sampled_tokens=sampled[0].shape[1], **extra)


def phase_gradient(attn, llama, train):
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=4)
    params = llama.init_llama(cfg, seed=0, device="cuda")
    leaves = train.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    grads, losses = {}, {}
    for name, impl in (("kernels", None), ("plain", attn.reference_attention)):
        reset_launches(attn)
        loss = llama.llama_loss(params, tokens, cfg, attn_impl=impl, remat=True)
        loss.backward()
        torch.cuda.synchronize()
        if name == "kernels":
            launches, routes = read_launches(attn), read_routes(attn)
        losses[name] = float(loss.detach())
        grads[name] = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    if launches != want:
        raise SystemExit(f"the 4-layer gradient launched {launches}, expected {want}")
    errs = [rel_l2(a, b) for a, b in zip(grads["kernels"], grads["plain"])]
    finite = all(bool(torch.isfinite(g).all()) for g in grads["kernels"])
    names = (["embed"] + [f"layers.{i}.{n}" for i, layer in enumerate(params["layers"])
                          for n in layer] + ["final_norm", "lm_head"])
    worst = max(range(len(errs)), key=errs.__getitem__)
    emit("gradient", config="llama2_7b width, 4 layers", batch=1, seq=2048,
         dtype=cfg.dtype, launches=launches, launches_by_route=routes,
         loss_kernels=losses["kernels"],
         loss_plain=losses["plain"], grad_rel_l2_max=errs[worst],
         grad_rel_l2_worst_leaf=names[worst],
         grad_rel_l2={n: e for n, e in zip(names, errs)}, bound=GRAD_REL_L2)
    if not finite or errs[worst] > GRAD_REL_L2:
        raise SystemExit(f"gradient through the kernels disagrees with the plain "
                         f"attention: rel L2 {errs[worst]} at {names[worst]}")
    del params, leaves, grads


def phase_train(attn, train, moe, cfg, phase="train"):
    """4 train steps at B=1, S=2048 on one batch (remat, AdamW lr 3e-4).
    MFU counts each token's active parameters: all but the experts, and k/E
    of the experts (bench_mfu.py's 6N + 6 L d S convention)."""
    free_memory()
    b, s = 1, 2048
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, dev = train.build_llama_train_step(cfg, device="cuda")
    t0 = time.perf_counter()
    params, opt_state = init_fn(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        reset_launches(attn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches, routes = read_launches(attn), read_routes(attn)
        if launches != want:
            raise SystemExit(f"{phase}: a train step launched {launches}, expected {want}")
        if routes != {n: {"wgmma": c} for n, c in want.items()}:
            raise SystemExit(f"{phase}: a train step launched {routes}, expected every "
                             f"launch on the wgmma route")
        losses.append(loss)
    losses = [float(x) for x in losses]
    tensors = (train.param_leaves(params) + [loss]
               + [t for st in opt_state.state.values() for t in st.values()
                  if isinstance(t, torch.Tensor)])
    on_card = all(t.is_cuda for t in tensors)
    n_params = sum(t.numel() for t in train.param_leaves(params))
    step_ms = statistics.median(times[1:])
    tokens_per_s = b * s / (step_ms / 1e3)
    n_active, moe_fields = n_params, {}
    if cfg.is_moe:
        n_expert = sum(t.numel() for layer in params["layers"]
                       for n, t in layer.items() if n.startswith("we_"))
        n_active = n_params - n_expert + n_expert * cfg.experts_per_token // cfg.num_experts
        cap = moe.expert_capacity(s, cfg.num_experts, cfg.experts_per_token,
                                  cfg.expert_capacity_factor)
        # gate, up and down over every capacity slot: forward, recompute and
        # the backward's two products
        padded = 4 * cfg.n_layers * 3 * 2 * cfg.num_experts * b * cap * cfg.dim * cfg.ffn_dim
        moe_fields = dict(moe_aux_weight=cfg.moe_aux_weight, capacity=cap,
                          expert_params=n_expert, active_params=n_active,
                          expert_tflop_per_step_capacity_padded=padded / 1e12,
                          expert_tflops_per_s_capacity_padded=padded / 1e9 / step_ms)
    # bench_mfu.py's convention: 6N + 6 L d S flops a token, remat not counted
    flops_per_token = 6 * n_active + 6 * cfg.n_layers * cfg.dim * s
    mfu = flops_per_token * tokens_per_s / H100_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase, config="mixtral_8x7b widths" if cfg.is_moe else "llama2_7b",
         layers=cfg.n_layers, batch=b, seq=s,
         dtype=cfg.dtype, remat=True, optimizer="AdamW lr 3e-4 wd 1e-4 (fused)",
         params=n_params, init_s=init_s, launches_per_step=launches,
         launches_by_route=routes,
         losses=losses, step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens_per_s, model_tflops_per_s=flops_per_token * tokens_per_s / 1e12,
         mfu=mfu, peak_mem_gb=peak_gb, all_on_card=on_card, **moe_fields)
    # every later step's loss below the first: AdamW at 3e-4 with no
    # warm-up overshoots after its first large drop on one batch
    if not all(math.isfinite(x) and x < losses[0] for x in losses[1:]):
        raise SystemExit(f"{phase}: training loss not finite and falling: {losses}")
    if not on_card:
        raise SystemExit(f"{phase}: a parameter, optimizer state or the loss left the card")
    return launches


def phase_sharded_train(attn, train, mesh_mod, cfg, phase="sharded_train"):
    """The 7B step through a world-1 NCCL mesh: train's steps, seed and
    tokens; losses against train's, launches, step time, peak memory."""
    import torch.distributed as dist

    free_memory()
    b, s = 1, 2048
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        torch.cuda.reset_peak_memory_stats()
        mesh = mesh_mod.make_mesh({a: 1 for a in mesh_mod.AXIS_ORDER}, device="cuda")
        init_fn, step_fn, batch_fn = train.build_llama_train_step(cfg, mesh)
        params, opt_state = init_fn(0)
        gen = torch.Generator(device="cuda").manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers}
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            reset_launches(attn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step_fn(params, opt_state, batch_fn(tokens))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches, routes = read_launches(attn), read_routes(attn)
            if routes != {n: {"wgmma": c} for n, c in want.items()}:
                raise SystemExit(f"{phase}: a step launched {routes}, expected {want} "
                                 f"on the wgmma route")
            losses.append(loss)
        losses = [float(x) for x in losses]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del params, opt_state
    finally:
        dist.destroy_process_group()
    ref = RESULTS["train"]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"])]
    step_ms = statistics.median(times[1:])
    emit(phase, config="llama2_7b", mesh={a: 1 for a in mesh_mod.AXIS_ORDER},
         backend="nccl", world=1, layers=cfg.n_layers, batch=b, seq=s,
         launches_per_step=launches, launches_by_route=routes, losses=losses,
         train_losses=ref["losses"], loss_rel_vs_train=rel,
         loss_equal_to_the_bit=losses == ref["losses"], bound=SHARDED_LOSS_REL,
         step_ms=times, step_ms_median=step_ms, train_step_ms_median=ref["step_ms_median"],
         tokens_per_s=b * s / (step_ms / 1e3), peak_mem_gb=peak_gb,
         train_peak_mem_gb=ref["peak_mem_gb"], peak_bound_gb=ref["peak_mem_gb"]
         + SHARDED_PEAK_SLACK_GB)
    if max(rel) > SHARDED_LOSS_REL:
        raise SystemExit(f"{phase}: losses {losses} differ from train's {ref['losses']}")
    if peak_gb > ref["peak_mem_gb"] + SHARDED_PEAK_SLACK_GB:
        raise SystemExit(f"{phase}: peak memory {peak_gb} GB over train's "
                         f"{ref['peak_mem_gb']} + {SHARDED_PEAK_SLACK_GB}")
    return launches


def plain_by_heads(attn, q, k, v, do, heads: int = 8):
    """The plain causal attention over the whole sequence and its plain
    backward, a block of query heads (and their kv heads) at a time: (o,
    dq, dk, dv)."""
    h, kvh = q.shape[1], k.shape[1]
    outs = []
    for i in range(0, h, heads):
        j, m = i * kvh // h, (i + heads) * kvh // h
        qb, kb, vb, dob = q[:, i:i + heads], k[:, j:m], v[:, j:m], do[:, i:i + heads]
        o, lse = attn.reference_attention_with_lse(qb, kb, vb)
        outs.append((o, *attn.flash_backward_reference(qb, kb, vb, o, lse, dob)))
        del lse
    return [torch.cat(parts, 1) for parts in zip(*outs)]


def sp_attention_rows(attn, variants, phase, attend, per_rank, seed, extra):
    """The body of the `ring` and `ulysses` phases: for each of RING_SHAPES
    at S=8192, `attend(q, k, v)` (a sequence-parallel scheme over sp=4 in
    one process) and its gradient through the kernels against the plain
    attention over the whole sequence (rel. L2 and worst 64-row tile),
    `per_rank` launches of each kernel on the wgmma route, a bit-repeatable
    backward, the scheme's forward and forward+backward times beside one
    causal flash_fwd over the whole sequence and the bounds; `extra(shape)`
    adds the scheme's own fields. -> (rows, launches of the first shape)."""
    free_memory()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, launches_out = [], None
    for name, (b, h, kvh, d) in RING_SHAPES.items():
        q, k, v, do = rand_inputs(gen, torch.bfloat16, "bhsd", (b, h, RING_SEQ, d),
                                  (b, kvh, RING_SEQ, d), (b, kvh, RING_SEQ, d),
                                  (b, h, RING_SEQ, d))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def fwd_bwd():
            out = attend(*leaves)
            grads = torch.autograd.grad(out, leaves, do)
            return out.detach(), grads

        reset_launches(attn)
        out, grads = fwd_bwd()
        torch.cuda.synchronize()
        launches, routes = read_launches(attn), read_routes(attn)
        want = {n: {"wgmma": per_rank} for n in launches}
        if routes != want:
            raise SystemExit(f"{phase} {name}: launched {routes}, expected {want}")
        _, grads2 = fwd_bwd()
        repeatable = all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
        del grads2
        plain = plain_by_heads(attn, q, k, v, do)
        errs = {}
        for nm, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), plain):
            errs[nm] = dict(rel_l2=rel_l2(got, ref), tile_rel_l2=variants.tile_rel_l2(got, ref),
                            max_abs=float((got.float() - ref.float()).abs().max()),
                            finite=bool(torch.isfinite(got).all()))
        # one causal flash_fwd over the whole sequence, beside the scheme
        o1, _ = attn.flash_fwd(q, k, v, True, None)
        one_err = dict(rel_l2=rel_l2(o1, plain[0]),
                       tile_rel_l2=variants.tile_rel_l2(o1, plain[0]))
        del plain, o1, out, grads
        with torch.no_grad():
            fwd_ms = cuda_time_ms(lambda: attend(q, k, v), 5)
        fwd_bwd_ms = cuda_time_ms(fwd_bwd, 5)
        one_fwd_ms = cuda_time_ms(lambda: attn.flash_fwd(q, k, v, True, None), 10)
        bound_ms, bound_by = attention_bound(b, h, kvh, RING_SEQ, RING_SEQ, d, True,
                                             None, torch.bfloat16)
        bwd_bounds = backward_bounds(b, h, kvh, RING_SEQ, RING_SEQ, d, True, None,
                                     torch.bfloat16)
        ok = (repeatable and all(e["finite"] and e["rel_l2"] <= variants.BWD_TILE_REL_L2
                                 and e["tile_rel_l2"] <= variants.BWD_TILE_REL_L2
                                 for e in errs.values())
              and one_err["tile_rel_l2"] <= variants.BWD_TILE_REL_L2)
        row = dict(shape=name, b=b, h=h, kvh=kvh, seq=RING_SEQ, d=d, sp=RING_SP,
                   **extra(name), launches=launches,
                   launches_by_route=routes, errors_vs_plain=errs,
                   bound=variants.BWD_TILE_REL_L2, bit_repeatable=repeatable,
                   one_flash_fwd_8192_vs_plain=one_err, ok=ok,
                   **{f"{phase}_fwd_ms": fwd_ms, f"{phase}_fwd_bwd_ms": fwd_bwd_ms},
                   one_flash_fwd_8192_ms=one_fwd_ms, one_flash_fwd_8192_bound_ms=bound_ms,
                   one_flash_fwd_8192_bound_by=bound_by,
                   backward_bound_ms=bwd_bounds["dq"][0] + bwd_bounds["dkv"][0])
        print(json.dumps({"phase": phase, **row}), flush=True)
        rows.append(row)
        if launches_out is None:
            launches_out = launches
        if not ok:
            raise SystemExit(f"{phase} {name}: disagrees with the plain attention or is "
                             f"not repeatable: {errs}, {one_err}")
        del q, k, v, do, leaves
        free_memory()
    RESULTS[phase] = rows
    return rows, launches_out


def phase_ring(attn, ring, variants):
    """Ring attention over sp=4 through the one-process rotation at S=8192:
    the kernels inside the ring against the plain attention, launches and
    times."""
    chunks = RING_SP * (RING_SP + 1) // 2
    _, launches = sp_attention_rows(
        attn, variants, "ring", lambda q, k, v: ring.ring_attention_emulated(q, k, v,
                                                                             sp=RING_SP),
        chunks, 8, lambda name: dict(chunk=RING_SEQ // RING_SP, chunks_computed=chunks,
                                     chunks_skipped=RING_SP * RING_SP - chunks))
    return launches


def phase_ulysses(attn, ulysses, variants):
    """Ulysses over sp=4 through the one-process exchange at S=8192, on the
    ring's shapes: each rank attends H/4 query heads over the whole
    sequence (GQA 32/8: its 2 kv heads, the grouped-KV exchange), one
    launch of each kernel a rank; beside the ring's times of this call."""
    ring_rows = {r["shape"]: r for r in RESULTS["ring"]}

    def extra(name):
        b, h, kvh, d = RING_SHAPES[name]
        return dict(heads_per_rank=h // RING_SP, kv_heads_per_rank=kvh // RING_SP,
                    ring_fwd_ms=ring_rows[name]["ring_fwd_ms"],
                    ring_fwd_bwd_ms=ring_rows[name]["ring_fwd_bwd_ms"])

    _, launches = sp_attention_rows(
        attn, variants, "ulysses",
        lambda q, k, v: ulysses.ulysses_attention_emulated(q, k, v, sp=RING_SP),
        RING_SP, 11, extra)
    return launches


@contextlib.contextmanager
def planted_pipeline_fault(pipeline, name: str):
    """A wrong pipeline for the pipeline phases' bounds to reject:
    "stage_order" runs the stage blocks in the reverse order (stage s runs
    block P - 1 - s); "retire_shift" and "retire_reversed" retire the
    microbatches to the wrong slots (slot m + 1, slot M - 1 - m)."""
    blocks, run = pipeline._stage_blocks, pipeline._pipeline

    def reversed_blocks(layers, pp):
        return dict(zip(range(pp), reversed(list(blocks(layers, pp).values()))))

    def misretired(sched, x_mb):
        y_mb, aux = run(sched, x_mb)
        return (y_mb.roll(1, 0) if name == "retire_shift" else y_mb.flip(0)), aux

    if name == "stage_order":
        pipeline._stage_blocks = reversed_blocks
    else:
        pipeline._pipeline = misretired
    try:
        yield
    finally:
        pipeline._stage_blocks, pipeline._pipeline = blocks, run


def pipeline_launches(layers: int, microbatches: int) -> dict:
    """Kernel launches of one remat step: each layer's forward on every
    microbatch, again in the backward, and one of each backward kernel."""
    n = layers * microbatches
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def phase_pipeline_gradient(attn, llama, train, pipeline):
    """7B width, 4 layers, pp=4 stages in one process, M=4, B=4, S=2048,
    remat: the pipelined loss and every leaf's gradient against the
    one-device llama_loss's at the same weights and tokens; each planted
    fault must break the gradient bound, and one of them the loss bound too."""
    free_memory()
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=4)
    params = llama.init_llama(cfg, seed=0, device="cuda")
    leaves = train.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ), generator=gen,
                           device="cuda")

    def loss_and_grads(fn):
        loss = fn()
        loss.backward()
        torch.cuda.synchronize()
        grads = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        return float(loss.detach()), grads

    def pipelined():
        return pipeline.pipelined_llama_loss(params, tokens, cfg, pp=PIPE_PP,
                                             num_microbatches=PIPE_MICROBATCHES, remat=True)

    loss_one, grads_one = loss_and_grads(
        lambda: llama.llama_loss(params, tokens, cfg, remat=True))
    reset_launches(attn)
    loss_pp, grads_pp = loss_and_grads(pipelined)
    launches, routes = read_launches(attn), read_routes(attn)
    want = pipeline_launches(cfg.n_layers, PIPE_MICROBATCHES)
    if routes != {n: {"wgmma": c} for n, c in want.items()}:
        raise SystemExit(f"pipeline_gradient launched {routes}, expected {want} on wgmma")
    names = (["embed"] + [f"layers.{i}.{n}" for i, layer in enumerate(params["layers"])
                          for n in layer] + ["final_norm", "lm_head"])

    def readings(loss, grads):
        errs = [rel_l2(a, b) for a, b in zip(grads, grads_one)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        return dict(loss=loss, loss_abs_err=abs(loss - loss_one),
                    grad_rel_l2_max=errs[worst], grad_rel_l2_worst_leaf=names[worst],
                    finite=all(bool(torch.isfinite(g).all()) for g in grads),
                    rejected_by=[n for n, broken in (
                        ("loss", abs(loss - loss_one) > PIPE_LOSS_ABS),
                        ("gradient", errs[worst] > GRAD_REL_L2)) if broken]), errs

    sound, errs = readings(loss_pp, grads_pp)
    del grads_pp
    planted = {}
    for name in PIPE_FAULTS:
        with planted_pipeline_fault(pipeline, name):
            planted[name] = readings(*loss_and_grads(pipelined))[0]
    emit("pipeline_gradient", config="llama2_7b width, 4 layers", pp=PIPE_PP,
         microbatches=PIPE_MICROBATCHES, batch=PIPE_BATCH, seq=PIPE_SEQ, dtype=cfg.dtype,
         remat=True, one_process=True, launches=launches, launches_by_route=routes,
         loss_one_device=loss_one, **sound, loss_bound=PIPE_LOSS_ABS,
         grad_bound=GRAD_REL_L2, grad_rel_l2={n: e for n, e in zip(names, errs)},
         planted=planted)
    if sound["rejected_by"] or not sound["finite"]:
        raise SystemExit(f"pipeline_gradient: the pipelined loss or gradient disagrees "
                         f"with the one-device step: {sound}")
    if any("gradient" not in r["rejected_by"] for r in planted.values()) or not any(
            len(r["rejected_by"]) == 2 for r in planted.values()):
        raise SystemExit(f"pipeline_gradient: a planted fault passes the gradient bound, "
                         f"or none breaks both bounds: {planted}")
    del params, leaves, grads_one


def phase_pipeline_train(attn, llama, train, pipeline):
    """All 32 layers at 7B width, pp=4 stages in one process, M=4, B=4,
    S=2048, remat, AdamW: the first loss against the one-device loss at the
    same weights and tokens, a falling loss, launches, step time, tokens/s,
    MFU and peak memory beside its reckoning."""
    free_memory()
    cfg = llama.LlamaConfig.llama2_7b()
    b, s = PIPE_BATCH, PIPE_SEQ
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, batch_fn = pipeline.build_pipelined_llama_train_step(
        cfg, pp=PIPE_PP, num_microbatches=PIPE_MICROBATCHES, device="cuda")
    params, opt_state = init_fn(0)
    n_params = sum(t.numel() for t in train.param_leaves(params))
    # the peak, reckoned before the first step: parameters, gradients and
    # AdamW's two moments in bf16 (8 bytes a parameter); each layer's input
    # on every microbatch (remat's checkpoints); the logits of the whole
    # batch in fp32, their log-softmax and their gradient
    reckoned = dict(state_gb=8 * n_params / 1e9,
                    checkpoints_gb=cfg.n_layers * b * s * cfg.dim * 2 / 1e9,
                    logits_gb=3 * b * s * cfg.vocab_size * 4 / 1e9)
    reckoned["total_gb"] = sum(reckoned.values())
    print(json.dumps({"phase": "pipeline_train", "reckoned_peak": reckoned}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(10)
    tokens = batch_fn(torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device="cuda"))
    with torch.no_grad():
        loss_one = float(llama.llama_loss(params, tokens, cfg))
    want = pipeline_launches(cfg.n_layers, PIPE_MICROBATCHES)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        reset_launches(attn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches, routes = read_launches(attn), read_routes(attn)
        if routes != {n: {"wgmma": c} for n, c in want.items()}:
            raise SystemExit(f"pipeline_train: a step launched {routes}, expected {want} "
                             f"on the wgmma route")
        losses.append(loss)
    losses = [float(x) for x in losses]
    step_ms = statistics.median(times[1:])
    tokens_per_s = b * s / (step_ms / 1e3)
    flops_per_token = 6 * n_params + 6 * cfg.n_layers * cfg.dim * s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("pipeline_train", config="llama2_7b", layers=cfg.n_layers, pp=PIPE_PP,
         microbatches=PIPE_MICROBATCHES, batch=b, seq=s, dtype=cfg.dtype, remat=True,
         optimizer="AdamW lr 3e-4 wd 1e-4 (fused)", params=n_params,
         one_process=("every stage in one process: no bubble and no point-to-point "
                      "transfer is measured"),
         launches_per_step=launches, launches_by_route=routes, losses=losses,
         loss_one_device=loss_one, first_loss_abs_err=abs(losses[0] - loss_one),
         loss_bound=PIPE_LOSS_ABS, step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens_per_s, model_tflops_per_s=flops_per_token * tokens_per_s / 1e12,
         mfu=flops_per_token * tokens_per_s / H100_BF16_FLOPS, peak_mem_gb=peak_gb,
         reckoned_peak_gb=reckoned["total_gb"])
    if abs(losses[0] - loss_one) > PIPE_LOSS_ABS:
        raise SystemExit(f"pipeline_train: first loss {losses[0]} against the one-device "
                         f"{loss_one}")
    if not all(math.isfinite(x) and x < losses[0] for x in losses[1:]):
        raise SystemExit(f"pipeline_train: training loss not finite and falling: {losses}")
    del params, opt_state
    return launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _state_bytes(params, opt_state, train) -> int:
    leaves = train.param_leaves(params)
    moments = [t for p in leaves for t in opt_state.state[p].values()
               if isinstance(t, torch.Tensor) and t.dim()]
    return sum(t.numel() * t.element_size() for t in leaves + moments)


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _ckpt_step(attn, step_fn, params, opt_state, tokens, phase, want):
    """One step, the launch counts set to 0 before it; every flash launch
    must be on the wgmma route. -> (params, opt_state, loss as a float,
    launches)."""
    reset_launches(attn)
    params, opt_state, loss = step_fn(params, opt_state, tokens)
    torch.cuda.synchronize()
    routes = read_routes(attn)
    if routes != {n: {"wgmma": c} for n, c in want.items()}:
        raise SystemExit(f"{phase}: a step launched {routes}, expected {want} on the "
                         f"wgmma route")
    return params, opt_state, float(loss), read_launches(attn)


def phase_checkpoint(attn, llama, train, mesh_mod, checkpoint):
    """Save, resume and restore onto a mesh at 7B width, 4 layers: the
    resumed losses equal to the uninterrupted run's to the bit."""
    import torch.distributed as dist

    free_memory()
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=CKPT_LAYERS)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    init_fn, step_fn, _ = train.build_llama_train_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    run = functools.partial(_ckpt_step, attn, step_fn, tokens=tokens, phase="checkpoint",
                            want=want)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = checkpoint.TrainCheckpointer(tmp, max_to_keep=1)
        params, opt_state = init_fn(0)
        losses, save_s = [], []
        for i in range(CKPT_STEPS):
            if i == CKPT_SAVES[0]:
                state_gb = _state_bytes(params, opt_state, train) / 1e9
                free_gb = shutil.disk_usage(tmp).free / 1e9
                # two checkpoints exist for a moment: the new, then the old goes
                if free_gb < 2.2 * state_gb:
                    raise SystemExit(f"checkpoint: {free_gb:.1f} GB free under {tmp}; "
                                     f"the phase needs {2.2 * state_gb:.1f} GB for two "
                                     f"{state_gb:.2f} GB checkpoints")
            if i in CKPT_SAVES:
                t0 = time.perf_counter()
                ckpt.save(i, params, opt_state)
                save_s.append(time.perf_counter() - t0)
                if i == CKPT_SAVES[-1]:
                    written = _dir_bytes(Path(tmp) / str(i))
            params, opt_state, loss, _ = run(params, opt_state)
            losses.append(loss)
        kept = ckpt.all_steps()
        del params, opt_state
        free_memory()
        template = init_fn(3)
        t0 = time.perf_counter()
        step, params, opt_state = ckpt.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed = []
        for _ in range(CKPT_STEPS - step):
            params, opt_state, loss, launches = run(params, opt_state)
            resumed.append(loss)
        del params, opt_state, template
        free_memory()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = mesh_mod.make_mesh({a: 1 for a in mesh_mod.AXIS_ORDER}, device="cuda")
            init_m, step_m, batch_m = train.build_llama_train_step(cfg, mesh)
            template = init_m(3)
            t0 = time.perf_counter()
            _, params, opt_state = checkpoint.TrainCheckpointer(tmp, mesh=mesh).restore(
                template)
            torch.cuda.synchronize()
            mesh_restore_s = time.perf_counter() - t0
            mesh_loss = _ckpt_step(attn, step_m, params, opt_state, batch_m(tokens),
                                   "checkpoint", want)[2]
            del params, opt_state, template
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = written / 1e9
    emit("checkpoint", config=f"llama2_7b width, {cfg.n_layers} layers", batch=1, seq=2048,
         dtype=cfg.dtype, state_gb=state_gb, free_disk_gb=free_gb, max_to_keep=1,
         saved_steps=list(CKPT_SAVES), kept_steps=kept,
         older_step_removed=kept == [CKPT_SAVES[-1]], gb_written_per_save=gb,
         save_s=save_s, save_gb_per_s=[gb / t for t in save_s], restore_s=restore_s,
         restore_gb_per_s=gb / restore_s, mesh_restore_s=mesh_restore_s,
         restored_step=step, launches_per_step=launches, losses=losses,
         resumed_losses=resumed, resumed_equal_to_the_bit=resumed[-1] == losses[-1],
         mesh_restored_loss=mesh_loss,
         mesh_restored_equal_to_the_bit=mesh_loss == losses[step])
    if kept != [CKPT_SAVES[-1]] or step != CKPT_SAVES[-1]:
        raise SystemExit(f"checkpoint: kept steps {kept}, restored step {step}")
    if not all(math.isfinite(x) for x in losses + resumed + [mesh_loss]):
        raise SystemExit(f"checkpoint: losses not finite: {losses} {resumed} {mesh_loss}")
    if resumed != losses[step:]:
        raise SystemExit(f"checkpoint: the resumed losses {resumed} differ from the "
                         f"uninterrupted run's {losses[step:]}")
    if mesh_loss != losses[step]:
        raise SystemExit(f"checkpoint: the mesh-restored step's loss {mesh_loss} differs "
                         f"from {losses[step]}")
    return losses, launches


def phase_multihost(attn, llama, train, mesh_mod, multihost, one_device_loss):
    """initialize_multihost over a TCP rendezvous (world-1 NCCL) and its env
    path; global_batch against batch_fn; one 4-layer 7B-width step through
    the group equal to the one-device step's loss."""
    import torch.distributed as dist

    free_memory()
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=CKPT_LAYERS)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    coordinator = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    joined = multihost.initialize_multihost(coordinator=coordinator, num_processes=1,
                                            process_id=0)
    rendezvous_s = time.perf_counter() - t0
    try:
        group = dict(world=dist.get_world_size(), rank=dist.get_rank(),
                     backend=str(dist.get_backend()))
        second_call = multihost.initialize_multihost(coordinator=coordinator,
                                                     num_processes=1, process_id=0)
        mesh = mesh_mod.make_mesh({a: 1 for a in mesh_mod.AXIS_ORDER}, device="cuda")
        init_fn, step_fn, batch_fn = train.build_llama_train_step(cfg, mesh)
        piece = multihost.global_batch(tokens, batch_fn)
        batch_equal = torch.equal(piece, batch_fn(tokens))
        _, _, loss, launches = _ckpt_step(attn, step_fn, *init_fn(0), piece, "multihost",
                                          want)
    finally:
        dist.destroy_process_group()
    env = {"YODA_COORDINATOR": f"127.0.0.1:{_free_port()}", "YODA_NUM_PROCESSES": "1",
           "YODA_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        env_joined = multihost.initialize_multihost()
        env_group = dict(world=dist.get_world_size(), rank=dist.get_rank(),
                         backend=str(dist.get_backend()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit("multihost", coordinator=coordinator, joined=joined, rendezvous_s=rendezvous_s,
         group=group, second_call_returns=second_call, global_batch_equals_batch_fn=batch_equal,
         config=f"llama2_7b width, {cfg.n_layers} layers", launches_per_step=launches,
         loss=loss, one_device_loss=one_device_loss,
         loss_equal_to_the_bit=loss == one_device_loss, env_path_joined=env_joined,
         env_path_group=env_group)
    expected = dict(world=1, rank=0, backend="nccl")
    if not (joined and env_joined and group == expected and env_group == expected):
        raise SystemExit(f"multihost: the rendezvous gave {joined} {group}, the env path "
                         f"{env_joined} {env_group}")
    if second_call is not False or not batch_equal:
        raise SystemExit(f"multihost: second call {second_call}, global_batch equal to "
                         f"batch_fn {batch_equal}")
    if loss != one_device_loss:
        raise SystemExit(f"multihost: loss {loss} against the one-device {one_device_loss}")
    if dist.is_initialized():
        raise SystemExit("multihost: a process group outlived the phase")
    return launches


def resnet_macs(resnet, model, image: int) -> int:
    """Multiply-adds of one image's forward, from each conv's and the Dense
    layer's shapes (output positions x out channels x in channels x k x k;
    in x out)."""
    macs = []

    def count(mod, _inp, out):
        if isinstance(mod, resnet.Conv):
            macs.append(out[0].numel() * mod.weight[0].numel())
        else:
            macs.append(mod.weight.numel())

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (resnet.Conv, resnet.Dense))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, image, image, 3, device="cuda"), train=False)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


def phase_resnet(resnet):
    """ResNet-50 at B=256, 224 x 224, bf16, channels_last: train-mode and
    eval forwards and a softmax cross-entropy's forward+backward, timed;
    checked against the fp32 model and the biased-variance formula."""
    import torch.nn.functional as F

    free_memory()
    b, image = RESNET_BATCH, RESNET_IMAGE
    torch.cuda.reset_peak_memory_stats()
    model = resnet.ResNet50(1000, torch.bfloat16, device="cuda")
    init_fn, apply_fn = resnet.resnet_forward_fn(model=model)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(b, image, image, 3, generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    variables = init_fn(0, x)
    # BatchNorm scales and biases drawn from the seed, the last of each
    # block small (as a trained ResNet's are), so that every conv reaches
    # the logits (Flax's init starts those scales at zero)
    for name, t in variables["params"].items():
        if name.endswith(".scale"):
            u = torch.rand(t.shape, generator=gen, device="cuda")
            t.copy_(u * 0.5 if ".bn3." in name else u + 0.5)
        elif name.endswith(".bias") and not name.startswith("fc"):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.1)
    params = variables["params"]
    for t in params.values():
        t.requires_grad_(True)

    # one train forward: the stats of two BatchNorms against the formula
    captured = {}
    bns = {"bn": model.bn, "blocks.15.bn3": model.blocks[-1].bn3}
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: captured.__setitem__(name, inp[0].detach()))
        for name, m in bns.items()]
    with torch.no_grad():
        logits, mutated = apply_fn(variables, x, train=True)
    for h in hooks:
        h.remove()
    formula = {}
    for name, m in bns.items():
        v = captured.pop(name).double()
        mean, var = v.mean((0, 2, 3)), v.var((0, 2, 3), unbiased=False)
        old_m, old_v = (variables["batch_stats"][f"{name}.{k}"].double() for k in ("mean", "var"))
        for k, want in (("mean", m.momentum * old_m + (1 - m.momentum) * mean),
                        ("var", m.momentum * old_v + (1 - m.momentum) * var)):
            formula[f"{name}.{k}"] = rel_l2(mutated["batch_stats"][f"{name}.{k}"].double(),
                                            want)
    del captured

    def train_step():
        out, _ = apply_fn(variables, x, train=True)
        F.cross_entropy(out, labels).backward()
        for t in params.values():
            t.grad = None

    def eval_forward():
        with torch.no_grad():
            apply_fn(variables, x, train=False)

    out, _ = apply_fn(variables, x, train=True)
    F.cross_entropy(out, labels).backward()
    grads_ok = all(t.grad is not None and t.grad.is_cuda and bool(torch.isfinite(t.grad).all())
                   for t in params.values())
    for t in params.values():
        t.grad = None
    del out
    train_ms = cuda_time_ms(train_step, RESNET_ITERS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_ms = cuda_time_ms(eval_forward, RESNET_ITERS)
    with torch.no_grad():
        eval_logits = apply_fn(variables, x, train=False)
        # the fp32 model on the same weights and batch
        _, apply32 = resnet.resnet_forward_fn(
            model=resnet.ResNet50(1000, torch.float32, device="cuda"))
        logits32, mutated32 = apply32(variables, x, train=True)
        eval32 = apply32(variables, x, train=False)
    stats_err = max(rel_l2(mutated["batch_stats"][n], mutated32["batch_stats"][n])
                    for n in mutated32["batch_stats"])
    errs = {"train": rel_l2(logits, logits32), "eval": rel_l2(eval_logits, eval32),
            "stats": stats_err}
    tensors = [logits, eval_logits, *mutated["batch_stats"].values(), *params.values()]
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    on_card = all(t.is_cuda for t in tensors)
    macs = resnet_macs(resnet, model, image)
    train_flops = 3 * 2 * macs * b  # forward, and the backward's two products
    emit("resnet", config="ResNet-50, 1000 classes", batch=b, image=[image, image, 3],
         dtype="bfloat16", memory_format="channels_last", logits_dtype=str(logits.dtype),
         gmacs_per_image_forward=macs / 1e9,
         flops_reckoning="2 x (conv: output positions x out x in x k x k; Dense: in x "
                         "out) a forward; 3x that a training pass",
         train_ms=train_ms, train_images_per_s=b / (train_ms / 1e3),
         train_tflops_per_s=train_flops / train_ms / 1e9,
         mfu=train_flops / (train_ms / 1e3) / H100_BF16_FLOPS,
         eval_ms=eval_ms, eval_images_per_s=b / (eval_ms / 1e3),
         eval_tflops_per_s=2 * macs * b / eval_ms / 1e9, peak_mem_gb=peak_gb,
         rel_l2_vs_fp32=errs, bounds=RESNET_REL_L2,
         running_stats_vs_formula=formula, formula_bound=RESNET_STATS_FORMULA_REL,
         finite=finite, grads_finite_on_card=grads_ok, all_on_card=on_card)
    if not (finite and grads_ok and on_card and logits.dtype == torch.float32):
        raise SystemExit(f"resnet: finite {finite}, gradients {grads_ok}, on the card "
                         f"{on_card}, logits {logits.dtype}")
    if any(errs[k] > RESNET_REL_L2[k] for k in errs):
        raise SystemExit(f"resnet: bf16 against fp32 {errs}, bounds {RESNET_REL_L2}")
    if max(formula.values()) > RESNET_STATS_FORMULA_REL:
        raise SystemExit(f"resnet: running statistics against the formula {formula}")


def nvidia_smi(*fields: str) -> list[list[str]]:
    """One row a card of `nvidia-smi --query-gpu=...`, without units."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return [[f.strip() for f in ln.split(",")] for ln in out.strip().splitlines()]


def phase_telemetry(attn, smi: str):
    """The port's NVML sniffer against nvidia-smi and CUDA, its free memory
    under a 16 GiB allocation, NVML's duty and the probe sampler's under
    the flash kernel's load and after it, and `cli sniff`'s CR."""
    from yoda_scheduler_tpu_torch.telemetry import duty, nvml, sniffer

    free_memory()
    # this process's CUDA context exists before any reading is compared
    cuda_free, cuda_total = torch.cuda.mem_get_info(0)
    cards = nvidia_smi("name", "memory.total", "memory.free", "clocks.max.sm", "power.limit")
    listed = sum(ln.startswith("GPU ") for ln in subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines())
    t0 = time.perf_counter()
    node = sniffer.local_node_metrics()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    # one card visible: NVML's index 0 is CUDA's device 0
    chip = node.chips[0]
    name, smi_total, smi_free, smi_clock, smi_power = cards[0]
    read = dict(
        chips=node.chip_count, smi_cards=len(cards), smi_listed=listed,
        hbm_total_mb=chip.hbm_total_mb, smi_total_mb=int(smi_total),
        hbm_free_mb=chip.hbm_free_mb, smi_free_mb=int(smi_free),
        cuda_total_mb=cuda_total // 2**20, cuda_free_mb=cuda_free // 2**20,
        clock_mhz=chip.clock_mhz, smi_max_sm_clock_mhz=int(smi_clock),
        power_w=chip.power_w, smi_power_limit_w=float(smi_power),
        core_count=chip.core_count, ici_bandwidth_gbps=chip.ici_bandwidth_gbps,
        accelerator=node.accelerator)
    checks = {
        "one_chip_a_card": node.chip_count == len(cards) == listed,
        "gpu_node": node.accelerator == "gpu" and node.tpu_generation == "",
        "total_equals_nvidia_smi": chip.hbm_total_mb == int(smi_total),
        "free_near_nvidia_smi": abs(chip.hbm_free_mb - int(smi_free)) <= TELEMETRY_FREE_SLACK_MB,
        "cuda_total_within_reservation":
            0 <= chip.hbm_total_mb - cuda_total // 2**20 <= TELEMETRY_CUDA_SLACK_MB,
        "cuda_free_near": abs(chip.hbm_free_mb - cuda_free // 2**20) <= TELEMETRY_CUDA_SLACK_MB,
        "max_sm_clock_equals_nvidia_smi": chip.clock_mhz == int(smi_clock),
        "power_limit_equals_nvidia_smi": chip.power_w == int(float(smi_power)),
        "cores_and_link": chip.core_count > 0 and chip.ici_bandwidth_gbps > 0,
    }

    # free memory under a 16 GiB allocation
    hold = torch.empty(TELEMETRY_ALLOC_GIB << 30, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    held_free = sniffer.local_node_metrics().chips[0].hbm_free_mb
    del hold
    free_memory()
    drop_mb = chip.hbm_free_mb - held_free
    checks["free_drops_by_the_allocation"] = (
        drop_mb >= (TELEMETRY_ALLOC_GIB << 10) - TELEMETRY_FREE_SLACK_MB)

    # duty: NVML through the pool, and the probe sampler, under the load
    gen = torch.Generator(device="cuda").manual_seed(14)
    b, h, _, d = RING_SHAPES["mha"]
    q, k, v = (torch.randn(b, h, RING_SEQ, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    (card,) = [c for c in nvml.devices() if c.index == 0]
    pool = duty.DutySamplerPool()
    sampler = duty.DutyCycleSampler(0, period_s=0.1).start()
    try:
        # the probe's estimate is an EWMA of samples: its highest reading
        # over an idle second against its highest over the load
        idle_probe = []
        for _ in range(20):
            time.sleep(0.05)
            idle_probe.append(sampler.duty_pct)
        idle_nvml = pool.duty_of(card)
        reset_launches(attn)
        busy_nvml, busy_probe, launches = [], [], 0
        t0 = time.perf_counter()
        with torch.no_grad():
            while (elapsed := time.perf_counter() - t0) < TELEMETRY_LOAD_S:
                out = attn.flash_attention(q, k, v)
                launches += 1
                if launches % 50 == 0:
                    busy_probe.append(sampler.duty_pct)
                    if elapsed > TELEMETRY_LOAD_S / 2:
                        busy_nvml.append(pool.duty_of(card))
        busy_nvml.append(pool.duty_of(card))
        torch.cuda.synchronize()
        drained_s = time.perf_counter() - t0
        load_launches, load_routes = read_launches(attn), read_routes(attn)
        time.sleep(2 * sampler.period_s)  # the probe that waited on the load lands
        busy_probe.append(sampler.duty_pct)
        time.sleep(TELEMETRY_SETTLE_S)
        after_nvml = pool.duty_of(card)
    finally:
        stopped = sampler.stop() and pool.stop()
    with torch.no_grad():
        repeat_equal = torch.equal(out, attn.flash_attention(q, k, v))
    finite = bool(torch.isfinite(out.float()).all())
    del q, k, v, out
    checks.update({
        "load_on_the_wgmma_route": load_routes == {"flash_fwd": {"wgmma": launches},
                                                   "flash_bwd_dq": {}, "flash_bwd_dkv": {}},
        "nvml_busy_under_load": min(busy_nvml) >= TELEMETRY_BUSY_PCT,
        "probe_above_its_idle": max(busy_probe) > max(idle_probe),
        "nvml_idle_after": after_nvml <= TELEMETRY_IDLE_PCT,
        "sampler_joined": stopped,
        "load_output_finite_and_repeatable": finite and repeat_equal,
    })

    # the CLI's one-shot CR, as the sniffer DaemonSet's container runs it
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "yoda_scheduler_tpu_torch.cli", "sniff",
                          "--node-name", LIVE_NODE], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).resolve().parent))
    cli_s = time.perf_counter() - t0
    cr = json.loads(res.stdout) if res.returncode == 0 else {}
    status = cr.get("status", {})
    checks["cli_sniff_cr"] = (
        res.returncode == 0 and cr.get("kind") == "TpuNodeMetrics"
        and cr.get("metadata", {}).get("name") == LIVE_NODE
        and status.get("accelerator") == "gpu" and len(status.get("chips", [])) == listed
        and status["chips"][0]["hbm_total_mb"] == int(smi_total))
    emit("telemetry", nvidia_smi=smi, card=name, snapshot_ms=snapshot_ms, read=read,
         free_mb_holding_16gib=held_free, free_drop_mb=drop_mb,
         load=dict(shape=dict(b=b, h=h, seq=RING_SEQ, d=d, causal=True, dtype="bfloat16"),
                   host_s=TELEMETRY_LOAD_S, drained_s=drained_s, launches=load_launches,
                   launches_by_route=load_routes),
         duty_nvml=dict(idle=idle_nvml, busy=busy_nvml, after=after_nvml),
         duty_probe=dict(idle=idle_probe, busy=busy_probe),
         cli_sniff=dict(rc=res.returncode, s=cli_s, stderr=res.stderr[-2000:],
                        chips=len(status.get("chips", [])),
                        accelerator=status.get("accelerator")),
         checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"telemetry: failed {failed}")
    return load_launches


def scale_nodes(telemetry, units: int):
    """bench.py's build_scale_nodes through the port's telemetry.fake:
    `units` x (one 4-host v4-32 slice, 2 v4-8 hosts, 2 GPU nodes of 8 cards
    at 40,000 MB)."""
    nodes = []
    for i in range(units):
        nodes += telemetry.make_v4_slice(f"s{i}", "2x2x4")
        for j in range(2):
            nodes.append(telemetry.make_tpu_node(f"t{i}-{j}", chips=4))
            nodes.append(telemetry.make_gpu_node(f"g{i}-{j}", cards=8))
    return nodes


def burst_specs(n: int, seed: int) -> list[tuple[str, dict]]:
    """bench.py's scale burst (`_run_scale_nogc`): an equal mix of one-chip
    TPU pods, two-chip TPU pods at 4,000 MB, one-card GPU pods at 10,000 MB
    and plain pods at 1,000 MB, in an order shuffled from `seed`."""
    kinds = {"tpu-1c": {"scv/number": "1", "tpu/accelerator": "tpu"},
             "tpu-2c": {"scv/number": "2", "tpu/accelerator": "tpu", "scv/memory": "4000"},
             "gpu": {"scv/number": "1", "tpu/accelerator": "gpu", "scv/memory": "10000"},
             "plain": {"scv/memory": "1000"}}
    names = list(kinds)
    specs = [(f"p{i}", dict(kinds[names[i % 4]])) for i in range(n)]
    random.Random(seed).shuffle(specs)
    return specs


def placement_faults(pods, cluster) -> list[str]:
    """The engine's invariants over the cluster's book (tests/test_chaos.py's):
    each bound pod once, where it believes it is, on chips its node has,
    the count it asked for, no chip held twice, and each chip's free
    memory at least what its pod asked for."""
    faults, seen, owners = [], {}, {}
    for node in cluster.node_names():
        for p in cluster.pods_on(node):
            if p.key in seen:
                faults.append(f"{p.key} bound on {seen[p.key]} and {node}")
            seen[p.key] = node
    for p in pods:
        if p.phase.value != "Bound":
            continue
        if seen.get(p.key) != p.node:
            faults.append(f"{p.name} on {p.node}, the cluster says {seen.get(p.key)}")
        chips = {c.coords: c for c in cluster.telemetry.get(p.node).chips}
        held = p.assigned_chips()
        if len(held) != int(p.labels.get("scv/number", "1")):
            faults.append(f"{p.name} holds {len(held)} chips")
        for c in held:
            if c not in chips:
                faults.append(f"{p.name} holds {p.node}/{c}, which does not exist")
                continue
            if (p.node, c) in owners:
                faults.append(f"{p.node}/{c} held by {owners[(p.node, c)]} and {p.name}")
            owners[(p.node, c)] = p.name
            if int(p.labels.get("scv/memory", "0")) > chips[c].hbm_free_mb:
                faults.append(f"{p.name} overcommits {p.node}/{c}")
    return faults


def schedule_trace(live_at, units: int, seed: int) -> dict:
    """One run of the scheduler phase's trace on the port's engine (a
    HybridClock, as bench.py): the 5,000-node cluster and the live node
    `live_at(0)`; a LIVE_POD_MB pod, which must bind on the live node; it
    leaves, the live node is re-put as `live_at(1)` and the same pod must
    stay unschedulable; the node is re-put as `live_at(2)` and the burst
    runs. -> the outcomes, placements and the engine's readings."""
    import copy

    from yoda_scheduler_tpu_torch import scheduler, telemetry
    from yoda_scheduler_tpu_torch.scheduler.core import HybridClock
    from yoda_scheduler_tpu_torch.utils import Pod

    store = telemetry.TelemetryStore()
    far = time.time() + 1e8
    for m in scale_nodes(telemetry, units):
        m.heartbeat = far
        store.put(m)
    store.put(copy.deepcopy(live_at(0)))
    cluster = scheduler.FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    # bench.py's scale configuration
    config = scheduler.SchedulerConfig(max_attempts=8, telemetry_max_age_s=1e9,
                                       pod_hinted_backoff_s=30.0)
    sched = scheduler.Scheduler(cluster, config, clock=HybridClock())
    want = {"tpu/accelerator": "gpu", "scv/number": "1", "scv/memory": str(LIVE_POD_MB)}
    live_pod = Pod("live-card", labels=dict(want))
    sched.submit(live_pod)
    sched.run_until_idle(max_cycles=100)
    first = (live_pod.phase.value, live_pod.node, sorted(live_pod.assigned_chips()))
    cluster.evict(live_pod)
    sched.forget(live_pod.key)
    store.put(copy.deepcopy(live_at(1)))
    held_pod = Pod("live-card-held", labels=dict(want))
    sched.submit(held_pod)
    sched.run_until_idle(max_cycles=100)
    held = (held_pod.phase.value, held_pod.node)
    store.put(copy.deepcopy(live_at(2)))
    n_nodes = len(cluster.node_names())
    pods = [Pod(name, labels=labels)
            for name, labels in burst_specs(SCHED_PODS_PER_NODE * (n_nodes - 1), seed)]
    sched.metrics.histograms.pop("cycle_latency_ms", None)
    t0 = time.perf_counter()
    for p in pods:
        sched.submit(p)
    cycles = sched.run_until_idle(max_cycles=4 * len(pods))
    wall_s = time.perf_counter() - t0
    cyc = sched.metrics.histogram("cycle_latency_ms")
    planes = {dict(k).get("plane"): n for k, n in
              sched.metrics.labeled_counters.get("cycle_plane_total", {}).items()}
    bound = [p for p in pods if p.phase.value == "Bound"]
    return dict(
        nodes=n_nodes, pods=len(pods), live_first=first, live_held=held,
        bound=len(bound), on_live_node=sum(p.node == LIVE_NODE for p in bound),
        cycles=cycles, wall_s=wall_s, cycle_p50_ms=cyc.quantile(0.5),
        cycle_p99_ms=cyc.quantile(0.99), planes=planes,
        native_plane_active=sched.metrics.gauges.get("native_plane_active", 0.0) == 1.0,
        faults=placement_faults(pods, cluster),
        placements={p.name: (p.phase.value, p.node, sorted(p.assigned_chips())) for p in pods})


def phase_scheduler(smi: str):
    """The port's engine on this card's host at bench.py's 5,000-node scale
    with the live card as sniffed: the card decides where a 60,000 MB pod
    goes, and refuses it while 40 GiB of it is held; the burst's
    invariants, two runs of the same trace placing alike."""
    from yoda_scheduler_tpu_torch.telemetry import sniffer

    free_memory()
    live = [sniffer.local_node_metrics(LIVE_NODE)]

    def live_at(step):
        """Run 1 sniffs the card at each step (holding LIVE_HOLD_GIB for
        step 1); run 2 replays the same snapshots."""
        if step < len(live):
            return live[step]
        hold = (torch.empty(LIVE_HOLD_GIB << 30, dtype=torch.uint8, device="cuda")
                if step == 1 else None)
        torch.cuda.synchronize()
        live.append(sniffer.local_node_metrics(LIVE_NODE))
        del hold
        free_memory()
        return live[step]

    runs = [schedule_trace(live_at, SCHED_UNITS, SCHED_SEED) for _ in range(2)]
    first, second = runs
    free_mb = [m.chips[0].hbm_free_mb for m in live]
    same = first["placements"] == second["placements"]
    checks = {
        "live_pod_binds_on_the_live_card": first["live_first"][:2] == ("Bound", LIVE_NODE),
        "live_pod_refused_while_held": first["live_held"][0] != "Bound",
        "live_card_has_room_then_none": free_mb[0] >= LIVE_POD_MB > free_mb[1],
        "no_placement_fault": not first["faults"] and not second["faults"],
        "runs_place_alike": same and all(first[k] == second[k] for k in
                                         ("live_first", "live_held", "bound")),
        "burst_binds": first["bound"] > 0,
    }
    emit("scheduler", nvidia_smi=smi, config="bench.py huge_5000 (BENCH_SCALE5K.json) + "
         "the live card", seed=SCHED_SEED, live_free_mb=free_mb,
         live_pod_mb=LIVE_POD_MB, hold_gib=LIVE_HOLD_GIB,
         runs=[{k: v for k, v in r.items() if k != "placements"} for r in runs],
         placements_equal=same, checks=checks)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"scheduler: failed {failed}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from yoda_scheduler_tpu_torch.models import llama, moe, resnet
    from yoda_scheduler_tpu_torch.ops import _build, attention as attn, variants
    from yoda_scheduler_tpu_torch.parallel import mesh as mesh_mod, pipeline, ring, train
    from yoda_scheduler_tpu_torch.parallel import checkpoint, multihost, ulysses
    # Mixtral-8x7B's widths from its config.json, in the port's config fields
    from yoda_scheduler_tpu_torch.profile_path import mixtral_8x7b

    gen_mod = importlib.import_module("yoda_scheduler_tpu_torch.models.generate")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build(_build)
    rows, max_err = phase_kernel(attn)
    bwd_rows, bwd_err = phase_backward(attn, variants)
    cfg, params, fwd_launches = phase_forward(attn, llama)
    phase_serving(cfg, params, llama, gen_mod)
    del params
    mcfg, mparams, moe_fwd_launches = phase_moe_forward(
        attn, llama, train, moe, mixtral_8x7b(MOE_FORWARD_LAYERS))
    # every expert weight is read once a decode step: the step's memory bound
    expert_bytes = sum(t.numel() * t.element_size() for layer in mparams["layers"]
                       for n, t in layer.items() if n.startswith("we_"))
    phase_serving(mcfg, mparams, llama, gen_mod, phase="moe_serving",
                  bound=MOE_SERVING_REL_L2, planted=planted_faults(attn),
                  expert_weight_gb=expert_bytes / 1e9,
                  decode_step_bound_ms_expert_reads=expert_bytes / H100_HBM_BYTES * 1e3)
    del mparams
    free_memory()
    phase_gradient(attn, llama, train)
    step_launches = phase_train(attn, train, moe, llama.LlamaConfig.llama2_7b())
    sharded_launches = phase_sharded_train(attn, train, mesh_mod,
                                           llama.LlamaConfig.llama2_7b())
    moe_step_launches = phase_train(attn, train, moe, mixtral_8x7b(MOE_TRAIN_LAYERS),
                                    phase="moe_train")
    ring_launches = phase_ring(attn, ring, variants)
    ulysses_launches = phase_ulysses(attn, ulysses, variants)
    phase_pipeline_gradient(attn, llama, train, pipeline)
    pipe_launches = phase_pipeline_train(attn, llama, train, pipeline)
    ckpt_losses, resumed_launches = phase_checkpoint(attn, llama, train, mesh_mod,
                                                     checkpoint)
    multihost_launches = phase_multihost(attn, llama, train, mesh_mod, multihost,
                                         ckpt_losses[0])
    phase_resnet(resnet)
    telemetry_launches = phase_telemetry(attn, smi)
    phase_scheduler(smi)

    main_row, bwd_main = rows[0], bwd_rows[0]
    src = "yoda_scheduler_tpu_torch/ops/csrc/"
    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": "yoda_scheduler_tpu/ops/attention.py:68",
        "kernel_route": main_row["route"], "tflops": main_row["tflops"],
        "share_of_bound": main_row["share_of_bound"],
        "route_turns_ms": main_row["route_turns_ms"],
        "launches": step_launches["flash_fwd"],
        "launches_by_path": {"forward": fwd_launches,
                             "train_step": step_launches["flash_fwd"],
                             "sharded_train_step": sharded_launches["flash_fwd"],
                             "moe_forward": moe_fwd_launches,
                             "moe_train_step": moe_step_launches["flash_fwd"],
                             "ring_fwd_bwd": ring_launches["flash_fwd"],
                             "ulysses_fwd_bwd": ulysses_launches["flash_fwd"],
                             "pipeline_train_step": pipe_launches["flash_fwd"],
                             "checkpoint_resumed_step": resumed_launches["flash_fwd"],
                             "multihost_step": multihost_launches["flash_fwd"],
                             "telemetry_load": telemetry_launches["flash_fwd"]},
        "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}] + [{
        "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
        "replaces": f"yoda_scheduler_tpu/ops/attention.py:{line}",
        "kernel_route": bwd_main["route"], "tflops": bwd_main[f"{key}_tflops"],
        "share_of_bound": bwd_main[f"{key}_share_of_bound"],
        "route_turns_ms": bwd_main["route_turns_ms"][key],
        "launches": step_launches[name],
        "launches_by_path": {"train_step": step_launches[name],
                             "sharded_train_step": sharded_launches[name],
                             "moe_train_step": moe_step_launches[name],
                             "ring_fwd_bwd": ring_launches[name],
                             "ulysses_fwd_bwd": ulysses_launches[name],
                             "pipeline_train_step": pipe_launches[name],
                             "checkpoint_resumed_step": resumed_launches[name],
                             "multihost_step": multihost_launches[name]},
        "max_abs_err": bwd_err[key], "ms": bwd_main[f"{key}_ms"],
        "plain_ms": bwd_main["plain_ms"], "bound_ms": bwd_main[f"{key}_bound_ms"],
        "bound_by": bwd_main[f"{key}_bound_by"],
        "library_ms": bwd_main["library_ms"]}
        for name, key, line in (("flash_bwd_dq", "dq", 219),
                                ("flash_bwd_dkv", "dkv", 270))]}
    RESULTS["kernels"] = kernels
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
