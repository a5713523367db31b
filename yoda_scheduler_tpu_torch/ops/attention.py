"""Flash attention: hand-written CUDA kernels for Hopper and their plain versions.

Layout: q, k, v are [batch, heads, seq, head_dim]; k/v may carry fewer heads
than q (GQA). `flash_attention` and `flash_attention_with_lse` launch the
forward kernel in `csrc/flash_fwd.cu` for CUDA tensors, and their gradient
launches the two backward kernels in `csrc/flash_bwd.cu` (dQ, and dK with
dV). CPU tensors take the plain versions: `reference_attention_with_lse`,
with autograd through it, and `flash_backward_reference`, the plain twin of
the backward kernels. The kernels mask ragged sequence tails themselves, so
no shape falls back to a plain version on the card; they take fp32, bf16 or
fp16 and any head_dim from 1 to 512 (`KERNEL_MAX_HEAD_DIM`), as the JAX
kernels do, and raise otherwise.
Each kernel has three routes, which `_route` picks per kernel from the
inputs alone: "wgmma" (TMA and wgmma, 16-byte aligned rows: the model's
path; bf16 or fp16 at head_dim 64, 80, 96, 128 or 256, and at 100, whose
8-byte aligned rows the kernels' producers copy with cp.async, for every
kernel; `_WGMMA_HEAD_DIMS`), "mma" (mma.sync, other
aligned bf16 and aligned fp16: rows 16-byte aligned and head_dim a
multiple of 8, up to 256) and "simt"
(fp32, and every input the others do not take, head_dim past 256 among
them). The simt and mma kernels run at a padded width (32,
64, 128, 256, and 512 for simt) with the true head_dim at run time. A named
route that cannot take the inputs raises; nothing falls back to another
route or to the plain versions. The CPU tests hold the routing; only the
card runs the kernels.
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


def flash_backward_reference(q, k, v, o, lse, do, causal: bool = True,
                             window: int | None = None, g_lse=None, out_scale=None):
    """The plain backward of flash attention, the twin of the JAX package's
    `_flash_backward`: -> (dq, dk, dv) in the inputs' dtypes, dk/dv with
    k's head count. It computes the backward kernels' formula explicitly
    (not autograd of the forward): delta = rowsum(dO * O) - g_lse in fp32,
    P = exp(S scale - LSE) under the forward's mask, dS = P (dP - delta)
    scale, dQ = dS K, dK = dS^T Q, dV = P^T dO. P and dS are rounded to the
    input dtype before their products, where the kernels round them (as
    `reference_attention_with_lse` rounds its probabilities). `out_scale`
    (the kernels' fp16 output factor, `flash_bwd_dq`) multiplies dQ, dK and
    dV before their rounding. GQA: K/V are repeated to q's heads; each q
    head's dK and dV is rounded to k's dtype, as the JAX package's dK/dV
    kernel writes it and the kernels here do, and then group-summed back in
    fp32 and rounded once (the JAX package's `jnp.sum` of each group); with
    as many kv heads as q heads that is the one rounding."""
    _, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    kf = k.float().repeat_interleave(h // kvh, dim=1)
    vf = v.float().repeat_interleave(h // kvh, dim=1)
    qf, dof = q.float(), do.float()
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (ki > qi - window)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = backward_delta(o, do, g_lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if out_scale is not None:
        dq, dk, dv = (g * out_scale for g in (dq, dk, dv))
    dk, dv = (group_sum(g.to(t.dtype).float(), kvh).to(t.dtype)
              for g, t in ((dk, k), (dv, v)))
    return dq.to(q.dtype), dk, dv


def backward_delta(o, do, g_lse=None):
    """delta = rowsum(dO * O) in fp32, less the LSE cotangent: [B, H, Sq]."""
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def group_sum(x, kvh: int):
    """[B, H, S, D] per-q-head gradients summed over each group of H / kvh
    heads: [B, kvh, S, D]."""
    b, h, s, d = x.shape
    if h == kvh:
        return x
    return x.view(b, kvh, h // kvh, s, d).sum(2)


# ----------------------------------------------------------------- kernels
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_MAX_HEAD_DIM = 512  # the widest padded width of csrc/flash_common.cuh (simt)
_MMA_MAX_HEAD_DIM = 256  # the widest padded width of the mma kernels
_ROUTES = {"simt": 0, "mma": 1, "wgmma": 2}  # route codes of csrc/flash_{fwd,bwd}.cu
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_int64] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_BWD_TAIL = ([ctypes.c_int] * 9 + [ctypes.c_int64] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = {"flash_bwd_dq": [ctypes.c_void_p] * 8 + _BWD_TAIL,
                 "flash_bwd_dkv": [ctypes.c_void_p] * 9 + _BWD_TAIL}


def _flash_lib():
    (lib,) = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd.argtypes = _ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib():
    (lib,) = _build.load("flash_bwd")
    for name, argtypes in _BWD_ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _require_cuda(name: str, *tensors) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_qkv(name: str, q, k, v, causal: bool):
    """The checks shared by the three launchers: -> (b, h, kvh, sq, sk, d)."""
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes fp32, bf16 or fp16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if not 1 <= d <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"{name} takes head_dim 1 to {KERNEL_MAX_HEAD_DIM}, got {d}")
    if k.shape != (b, kvh, sk, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} needs a contiguous head_dim")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs seq_q <= seq_kv, got {sq} > {sk}")
    return b, h, kvh, sq, sk, d


# the head dims each kernel's wgmma route takes, by (kernel, dtype)
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu): bf16 and fp16 alike at 64, 80, 96,
# 100, 128 and 256 for every kernel (other head dims run on mma or simt)
_WGMMA_HEAD_DIMS = {("flash_fwd", torch.bfloat16): (64, 80, 96, 100, 128, 256),
                    ("flash_bwd_dq", torch.bfloat16): (64, 80, 96, 100, 128, 256),
                    ("flash_bwd_dkv", torch.bfloat16): (64, 80, 96, 100, 128, 256),
                    ("flash_fwd", torch.float16): (64, 80, 96, 100, 128, 256),
                    ("flash_bwd_dq", torch.float16): (64, 80, 96, 100, 128, 256),
                    ("flash_bwd_dkv", torch.float16): (64, 80, 96, 100, 128, 256)}


def _rows_aligned(tensors, elems: int) -> bool:
    """Every tensor's base and (batch, head, seq) strides fall on pieces of
    `elems` 2-byte elements."""
    return all(t.data_ptr() % (2 * elems) == 0
               and all(s % elems == 0 for s in t.stride()[:3]) for t in tensors)


def _routes(kernel: str, q, k, *rest) -> tuple[str, ...]:
    """The routes of `kernel` ("flash_fwd", "flash_bwd_dq" or
    "flash_bwd_dkv") that can take these inputs (q, k, v for the forward,
    q, k, v and dO for the backward), slowest first: simt takes any; mma
    needs bf16 or fp16 with a head dim that is a multiple of 8 up to 256,
    16-byte aligned bases and (batch, head, seq) strides that are multiples
    of 8 elements; wgmma needs a non-empty kv, a head dim of
    `_WGMMA_HEAD_DIMS[(kernel, dtype)]` and rows aligned as mma's, or at head
    dim 100 (200-byte rows, copied in 8-byte pieces) 8-byte aligned bases and
    strides that are multiples of 4 elements (the conditions of the csrc/
    entries)."""
    routes = ("simt",)
    d = q.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float16):
        return routes
    tensors = (q, k, *rest)
    if d % 8 == 0 and d <= _MMA_MAX_HEAD_DIM and _rows_aligned(tensors, 8):
        routes += ("mma",)
    if (d in _WGMMA_HEAD_DIMS.get((kernel, q.dtype), ()) and k.shape[2] > 0
            and _rows_aligned(tensors, 8 if d % 8 == 0 else 4)):
        routes += ("wgmma",)
    return routes


def _route(kernel: str, q, k, *rest) -> str:
    """The route `kernel` takes for these inputs: "wgmma", "mma" or "simt"."""
    return _routes(kernel, q, k, *rest)[-1]


def _pick_route(name: str, routes, route):
    """`route`, or the fastest of `routes` when it is None; a named route
    that cannot take the inputs raises."""
    if route is None:
        return routes[-1]
    if route not in routes:
        raise ValueError(f"{name} route {route!r} cannot take these inputs "
                         f"(it can take {routes})")
    return route


def _count(fn, route: str) -> None:
    fn.launches += 1
    fn.launches_by_route[route] += 1


def flash_fwd(q, k, v, causal: bool = True, window: int | None = None,
              route: str | None = None):
    """Launch the flash forward kernel on CUDA tensors: returns (O [B, H, Sq,
    D] in q's dtype, LSE [B, H, Sq] fp32). Inputs may be strided views with
    a contiguous last dim. `route` None takes `_route`'s kernel; a named
    route (to hold one kernel against another) must be able to take the
    inputs. Raises on anything the kernel does not take.
    `flash_fwd.launches` counts the launches, `.launches_by_route` each
    route's."""
    b, h, kvh, sq, sk, d = _check_qkv("flash_fwd", q, k, v, causal)
    route = _pick_route("flash_fwd", _routes("flash_fwd", q, k, v), route)
    _require_cuda("flash_fwd", q, k, v)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _flash_lib()
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _KERNEL_DTYPES[q.dtype], _ROUTES[route], q.get_device(), b, h, kvh,
        sq, sk, d, *strides, int(causal), window or 0, 1.0 / (d ** 0.5), _stream(q))
    if err:
        raise RuntimeError(f"flash_fwd ({route}) launch failed with CUDA error {err}")
    _count(flash_fwd, route)
    return o, lse


def _reset_counts(fn) -> None:
    fn.launches = 0
    fn.launches_by_route = dict.fromkeys(_ROUTES, 0)


_reset_counts(flash_fwd)


def _launch_bwd(fn, q, k, v, do, lse, delta, outs, causal, window, route,
                out_scale):
    """Checks the backward kernels' inputs and launches the kernel of
    wrapper `fn` on `route` (or `_route`'s) into the preallocated
    `outs`, counting the launch (none for empty inputs)."""
    name = fn.__name__
    b, h, kvh, sq, sk, d = _check_qkv(name, q, k, v, causal)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"{name} needs dO shaped and typed as q with a "
                         f"contiguous head_dim, got {tuple(do.shape)} {do.dtype}")
    for t in (lse, delta):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous fp32 LSE and delta of "
                             f"shape {(b, h, sq)}, got {tuple(t.shape)} {t.dtype}")
    if out_scale is not None and (q.dtype != torch.float16 or out_scale.numel() != 1
                                  or out_scale.dtype != torch.float32
                                  or out_scale.device != q.device):
        raise ValueError(f"{name} takes an out_scale in fp16 alone, one fp32 "
                         f"element on q's device, got {tuple(out_scale.shape)} "
                         f"{out_scale.dtype} on {out_scale.device} for {q.dtype}")
    route = _pick_route(name, _routes(name, q, k, v, do), route)
    _require_cuda(name, q, k, v, do, lse, delta)
    if q.numel() == 0 or k.numel() == 0:
        for t in outs:
            t.zero_()
        return
    lib = _bwd_lib()
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs),
        None if out_scale is None else out_scale.data_ptr(), _KERNEL_DTYPES[q.dtype], _ROUTES[route], q.get_device(), b, h, kvh, sq, sk,
        d, *strides, int(causal), window or 0, 1.0 / (d ** 0.5), _stream(q))
    if err:
        raise RuntimeError(f"{name} ({route}) launch failed with CUDA error {err}")
    _count(fn, route)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 window: int | None = None, route: str | None = None,
                 out_scale=None):
    """Launch the dQ kernel on CUDA tensors: -> dQ [B, H, Sq, D] in q's
    dtype. q/k/v/dO may be strided views with a contiguous last dim; lse and
    delta ([B, H, Sq] fp32, contiguous) are the forward's LSE and
    `rowsum(dO * O) - g_lse`. `route` None takes `_route`'s kernel; a
    named route must be able to take the inputs. In fp16 `out_scale`, a
    one-element fp32 tensor on the card, multiplies the kernel's fp32 sums
    before their rounding to fp16 (`_FlashFwd.backward`).
    `flash_bwd_dq.launches` counts the launches, `.launches_by_route` each
    route's."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(flash_bwd_dq, q, k, v, do, lse, delta, (dq,), causal, window, route,
                out_scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  window: int | None = None, route: str | None = None,
                  out_scale=None):
    """Launch the dK/dV kernel on CUDA tensors: -> (dK, dV), each [B, H, Sk,
    D] in k's dtype, one per q head (group-sum them for GQA, `group_sum`).
    Inputs, `route`, `out_scale` and the counts as for `flash_bwd_dq`."""
    b, h, _, d = q.shape
    shape = (b, h, k.shape[2], d)
    dk = torch.empty(shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(shape, dtype=k.dtype, device=k.device)
    _launch_bwd(flash_bwd_dkv, q, k, v, do, lse, delta, (dk, dv), causal, window,
                route, out_scale)
    return dk, dv


_reset_counts(flash_bwd_dq)
_reset_counts(flash_bwd_dkv)


# The fp16 cotangent scale keeps max |delta| scale below 2^(_FP16_DELTA_LOG2
# + 1) = 2^15, half of fp16's largest value: the kernels round dS = P (dP -
# delta) / sqrt(d) to fp16 (`_fp16_cotangent_scale`). A lower bound pushes
# the scaled dO, which the kernels also round to fp16, further below fp16's
# normal range under a large LSE cotangent; a higher one leaves dP = dO V^T
# less room beside delta.
_FP16_DELTA_LOG2 = 14


def _fp16_cotangent_scale(g_out, delta):
    """A power of two (a 0-d fp32 tensor on g_out's device, no host sync)
    for the fp16 backward's cotangents: the largest that keeps max |dO|
    below 2 and max |delta| below 2^(_FP16_DELTA_LOG2 + 1), delta =
    rowsum(dO * O) - g_lse unscaled (`backward_delta`). The backward
    kernels round P and dS to the input dtype for their tensor-core
    products, where the JAX kernels keep them in fp32; in fp16 a model's
    cotangents (~1e-5 at Llama-2-7B width) make dS ~1e-8, below fp16's
    smallest subnormal, and dQ and dK would lose most of their value. The
    backward is linear in (dO, the LSE cotangent), so it runs on both times
    this scale, and the kernels multiply their fp32 sums by its inverse
    (`out_scale`) before rounding them to fp16: exact in powers of two, dS
    then lies in fp16's normal range, and dQ, dK and dV are rounded once at
    their true size, where a sum over many rows (the dK of a key every row
    attends to) may lie far above dS. A large LSE cotangent (a z-loss on the
    LSE) makes delta, and with it dS, far larger than dO: the bound on delta
    keeps dS finite, where a scale from dO alone overflows it. bf16 has
    fp32's exponent range and needs none."""
    amax = torch.maximum(g_out.abs().amax().float(),
                         delta.abs().amax() * 2.0 ** -_FP16_DELTA_LOG2)
    return torch.where(amax > 0, torch.exp2(-torch.floor(torch.log2(amax))),
                       torch.ones_like(amax))


class _FlashFwd(torch.autograd.Function):
    """The forward kernel as an autograd node whose backward launches the
    dQ and dK/dV kernels. The LSE output is differentiable: its cotangent
    folds into delta (d LSE / d S = P per row). In fp16 the cotangents are
    scaled first (`_fp16_cotangent_scale`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        out_scale = None
        delta = backward_delta(o, g_out, g_lse)
        if q.dtype == torch.float16:
            scale = _fp16_cotangent_scale(g_out, delta)
            g_out = (g_out.float() * scale).to(torch.float16)
            delta = delta * scale
            out_scale = 1.0 / scale
        if g_out.stride(-1) != 1:
            g_out = g_out.contiguous()
        delta = delta.contiguous()
        args = (q, k, v, g_out, lse, delta, ctx.causal, ctx.window)
        dq = flash_bwd_dq(*args, out_scale=out_scale)
        dk, dv = flash_bwd_dkv(*args, out_scale=out_scale)
        kvh = k.shape[1]
        return dq, group_sum(dk, kvh), group_sum(dv, kvh), None, None


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
