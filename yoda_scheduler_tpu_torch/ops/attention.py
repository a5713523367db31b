"""Flash attention: a hand-written CUDA kernel for Hopper and its plain version.

Layout: q, k, v are [batch, heads, seq, head_dim]; k/v may carry fewer heads
than q (GQA). `flash_attention` and `flash_attention_with_lse` launch the
kernel in `csrc/flash_fwd.cu` for CUDA tensors and use the plain version,
`reference_attention_with_lse`, for CPU tensors. The kernel masks ragged
sequence tails itself, so no shape falls back to the plain version on the
card; it takes bf16 or fp32 and head_dim 32, 64 or 128, and raises otherwise.

The backward kernels are not ported yet: on CUDA, the gradient of the
kernel's outputs raises NotImplementedError.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30


def reference_attention(q, k, v, causal: bool = True,
                        window: int | None = None):
    """Plain attention; the numerical reference for the kernel. [B, H, S, D]
    in and out; fp32 scores and softmax. `window` (requires causal): token i
    attends to keys (i-window, i]."""
    out, _ = reference_attention_with_lse(q, k, v, causal, window)
    return out


def reference_attention_with_lse(q, k, v, causal: bool = True,
                                 window: int | None = None):
    """reference_attention plus the per-row log-sum-exp of the scaled scores
    ([B, H, Sq] fp32). GQA accepted: k/v may carry fewer heads than q
    (h % kvh == 0); they are repeated. q is aligned to the end of a longer
    kv (query i sits at position i + sk - sq)."""
    _, h, sq, d = q.shape
    kvh = k.shape[1]
    if kvh != h:
        if h % kvh:
            raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    sk = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / d ** 0.5
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (ki > qi - window)
        scores = scores.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v), lse


# ------------------------------------------------------------------ kernel
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _flash_lib():
    (lib,) = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd.argtypes = _ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
    return lib


def flash_fwd(q, k, v, causal: bool = True, window: int | None = None):
    """Launch the flash forward kernel on CUDA tensors: returns (O [B, H, Sq,
    D] in q's dtype, LSE [B, H, Sq] fp32). Inputs may be strided views with
    a contiguous last dim. Raises on anything the kernel does not take.
    `flash_fwd.launches` counts the launches."""
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_fwd takes CUDA tensors")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd takes bf16 or fp32 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head_dim in {_KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != (b, kvh, sk, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_fwd needs a contiguous head_dim")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs seq_q <= seq_kv, got {sq} > {sk}")
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _flash_lib()
    strides = [s for t in tensors for s in t.stride()[:3]]
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _KERNEL_DTYPES[q.dtype], q.device.index, b, h, kvh, sq, sk, d,
        *strides, int(causal), window or 0, 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


class _FlashFwd(torch.autograd.Function):
    """The kernel as an autograd node. Its backward kernels belong to the
    training slice and are not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return flash_fwd(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(
            "flash attention backward on CUDA is not ported yet: it is the "
            "training slice in ROADMAP.md (dQ and dK/dV kernels)")


def _attention(q, k, v, causal, window):
    if q.device.type == "cpu":
        return reference_attention_with_lse(q, k, v, causal, window)
    return _FlashFwd.apply(q, k, v, causal, window)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int | None = None, block_k: int | None = None,
                    block_q_bwd: int | None = None,
                    block_k_bwd: int | None = None,
                    window: int | None = None):
    """Fused attention entry point; [B, H, S, D] -> [B, H, S, D].

    The flash kernel on CUDA tensors, the plain version on CPU tensors. The
    block_* arguments are validated as the JAX package validates them; the
    kernel picks its own tiles."""
    _resolve_blocks(q, k, causal, block_q, block_k, block_q_bwd, block_k_bwd,
                    window)
    return _attention(q, k, v, causal, window)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             block_q: int | None = None,
                             block_k: int | None = None,
                             block_q_bwd: int | None = None,
                             block_k_bwd: int | None = None,
                             window: int | None = None):
    """flash_attention plus the per-row log-sum-exp of the scaled scores
    ([B, H, S] fp32), the statistic that merges partial attentions over
    key/value chunks exactly."""
    _resolve_blocks(q, k, causal, block_q, block_k, block_q_bwd, block_k_bwd,
                    window)
    return _attention(q, k, v, causal, window)


# every entry point in this module accepts GQA-shaped inputs (k/v with
# fewer heads than q); the model layer checks this flag before deciding
# whether it must broadcast KV itself for a custom attention impl
flash_attention.handles_gqa = True
flash_attention_with_lse.handles_gqa = True
reference_attention.handles_gqa = True
reference_attention_with_lse.handles_gqa = True


def _auto_block(seq: int) -> int:
    """The JAX package's default block: the largest of {512, 256, 128} that
    tiles `seq`, or the whole sequence below 128. Kept only so that the
    block_* arguments are refused exactly where the JAX package refuses
    them; the CUDA kernel's tiles do not depend on it."""
    if seq < 128:
        return seq
    b = 512
    while b > 128 and seq % b:
        b //= 2
    return b


def _resolve_blocks(q, k, causal, block_q, block_k, block_q_bwd,
                    block_k_bwd, window=None):
    """The JAX package's argument checks, raising the same ValueErrors."""
    if window is not None and (not causal or window < 1):
        raise ValueError("sliding window requires causal=True and window >= 1")
    sq, sk = q.shape[2], k.shape[2]
    if causal and sq > sk:
        raise ValueError(f"causal attention needs seq_q <= seq_kv, got {sq} > {sk}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    bq = _auto_block(sq) if block_q is None else min(block_q, sq)
    bk = _auto_block(sk) if block_k is None else min(block_k, sk)
    if sq % bq or sk % bk:
        return  # the JAX package takes its plain path here and checks no more
    bq_b = bq if block_q_bwd is None else min(block_q_bwd, sq)
    bk_b = bk if block_k_bwd is None else min(block_k_bwd, sk)
    if sq % bq_b or sk % bk_b:
        raise ValueError(
            f"backward blocks ({bq_b},{bk_b}) do not tile seq ({sq},{sk})")
