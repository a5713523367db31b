"""The least time an NVIDIA H100 could take for the flash kernels' work.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate, and
the operations it does on these inputs over the card's peak rate for their
type. The rates are NVIDIA's data sheet for the H100 SXM part, dense, at its
700 W power limit; a card set below that limit runs slower under load, so a
share of the bound is stated beside the card's power limit. Work that the
mask leaves out is not counted: a causal or windowed attention does the
work of the (query, key) pairs it lets through (`visible_pairs`).
"""

from __future__ import annotations

import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_FP16_FLOPS = 989e12   # dense fp16 tensor-core peak, the same as bf16's
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_HBM_BYTES = 3.35e12   # bytes/s
PEAK_FLOPS = {torch.bfloat16: H100_BF16_FLOPS, torch.float16: H100_FP16_FLOPS,
              torch.float32: H100_FP32_FLOPS}


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


def bound(nbytes, flops, dtype) -> tuple[float, str]:
    """(bound_ms, bound_by): `nbytes` over the memory rate or `flops` over
    the peak rate of `dtype`, whichever takes longer."""
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _esize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def attention_work(b, h, kvh, sq, sk, d, causal, window, dtype) -> tuple[int, int]:
    """(bytes, flops) of the forward: q, k, v read once, O and LSE written
    once; the two products' flops over the visible pairs."""
    nbytes = _esize(dtype) * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    return nbytes, 4 * b * h * d * visible_pairs(sq, sk, causal, window)


def backward_work(b, h, kvh, sq, sk, d, causal, window, dtype) -> dict:
    """{"dq": (bytes, flops), "dkv": ...}. dQ: q, dO and k, v read, dQ
    written, LSE and delta read (8 bytes a row); 6 D flops a visible pair
    (S, dP, dS K). dK/dV: the same reads, dK and dV written (one per q
    head, as the kernel writes them); 8 D flops a visible pair (S, dP,
    P^T dO, dS^T Q)."""
    esize = _esize(dtype)
    pairs = visible_pairs(sq, sk, causal, window)
    reads = esize * d * (2 * b * h * sq + 2 * b * kvh * sk) + 8 * b * h * sq
    return {"dq": (reads + esize * d * b * h * sq, 6 * b * h * d * pairs),
            "dkv": (reads + 2 * esize * d * b * h * sk, 8 * b * h * d * pairs)}


def attention_bound(b, h, kvh, sq, sk, d, causal, window, dtype):
    """(bound_ms, bound_by) of the forward kernel's work."""
    return bound(*attention_work(b, h, kvh, sq, sk, d, causal, window, dtype), dtype)


def backward_bounds(b, h, kvh, sq, sk, d, causal, window, dtype) -> dict:
    """{"dq": (bound_ms, bound_by), "dkv": ...}: each backward kernel's."""
    return {name: bound(*work, dtype) for name, work in
            backward_work(b, h, kvh, sq, sk, d, causal, window, dtype).items()}


def forward_backward_bound(b, h, kvh, sq, sk, d, causal, window, dtype):
    """(bound_ms, bound_by) of attention and its gradient as one function:
    q, k, v and dO read once, dQ, dK and dV written once; 12 D flops a
    visible pair, the function's six products (S = Q K^T, P V, dP = dO V^T,
    P^T dO, dS K, dS^T Q). The kernels' split recomputes S in each backward
    kernel and dP in both: that is the design's cost, not the function's,
    and is not counted."""
    esize = _esize(dtype)
    nbytes = esize * d * (3 * b * h * sq + 4 * b * kvh * sk)
    return bound(nbytes, 12 * b * h * d * visible_pairs(sq, sk, causal, window), dtype)
