"""Mixture-of-Experts FFN in PyTorch: the port of
yoda_scheduler_tpu/models/moe.py.

Top-k gating with a fixed per-expert capacity C, GShard's scheme: tokens
are queued into each expert's C slots slot-major (every first choice of a
batch row before any second choice), positions past C are dropped and the
residual carries them. The expert batch keeps the JAX package's static
[E, B, C, ·] shape, so each expert's products are one `torch.bmm` over E.

The JAX package dispatches and combines with one-hot [B, S, E, C] einsums.
Here both are gathers by index: each (expert, row, slot) cell holds at most
one token, so the values are the same. Their gradients are gathers too
(`_GatherRows`), summed over a token's k choices in a fixed order, so no
result depends on the order of atomic adds.

Numerics follow the JAX package: the router logits and the softmax in true
fp32 (TF32 is switched off around the router's product), gate and up with
an fp32 result and the SwiGLU product in fp32 before the cast to the input
dtype, down in the input dtype, the combine an fp32 weighted sum. The
load-balance loss is Switch's E * sum_e f_e p_e, f_e counting first choices
before capacity. Capacity C = int(S k cf / E) + 1, rounded up to a
multiple of 8, at least 8, from each call's own sequence length.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.profiler import record_function

# the profiler span around routing, dispatch and combine (and the backward
# of dispatch and combine); profile_path.py groups the device time under it
ROUTE_SPAN = "moe_route"


def expert_capacity(seq_len: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    cap = int(seq_len * k * capacity_factor / num_experts) + 1
    return max(8, (cap + 7) // 8 * 8)


def normal_init(shape, fan_in, dtype, generator: torch.Generator, device):
    """N(0, 1) / sqrt(fan_in), drawn in fp32 from `generator` and cast to
    `dtype`: the JAX package's weight distribution."""
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def init_moe_layer(dim: int, ffn_dim: int, num_experts: int, dtype,
                   generator: torch.Generator, device) -> dict:
    """One layer's MoE FFN leaves, with the JAX package's distributions:
    router [d, E] fp32 from N(0, 1) * 0.02 (routing is numerically
    sensitive); we_gate, we_up [E, d, f] and we_down [E, f, d] from
    `normal_init` in `dtype`."""
    d, f, e = dim, ffn_dim, num_experts

    def init(shape, fan_in, dt=dtype):
        return normal_init(shape, fan_in, dt, generator, device)

    return {"router": init((d, e), 1.0, torch.float32).mul_(0.02),
            "we_gate": init((e, d, f), d),
            "we_up": init((e, d, f), d),
            "we_down": init((e, f, d), f)}


def _top_k_dispatch(router_logits, num_experts: int, k: int, capacity: int):
    """router_logits [B, S, E] fp32 -> (expert [B, S, k] int64, position
    [B, S, k] int64, weight [B, S, k] fp32, aux scalar).

    Choice j of token (b, s) goes to expert[b, s, j] at queue position
    position[b, s, j]; weight is its renormalised gate value, 0 where the
    position is past `capacity` (dropped). A choice is dispatched where its
    weight is > 0, as the JAX package's `dispatch = combine > 0`. Its dense
    combine tensor is combine[b, s, expert, position] = weight."""
    b, s, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)                 # [B,S,E] fp32
    # top-k through a stable descending sort: equal probabilities keep the
    # lower expert index first, as jax.lax.top_k does (torch.topk does not
    # promise it)
    order = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)
    expert = order.indices[..., :k]                              # [B,S,k]
    gate = probs.gather(-1, expert)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    onehot = F.one_hot(expert, e)                                # [B,S,k,E]
    # queue positions slot-major within each batch row: all first choices
    # of row b, then all its second choices. The scan runs along the last
    # axis: along an outer axis of E columns CUDA's scan is one serial
    # thread per column
    slot_major = onehot.permute(0, 3, 2, 1).reshape(b, e, k * s)
    pos = slot_major.cumsum(-1) - slot_major                     # [B,E,k*S]
    position = pos.gather(1, expert.transpose(1, 2).reshape(b, 1, k * s))
    position = position.view(b, k, s).transpose(1, 2)            # [B,S,k]
    weight = torch.where(position < capacity, gate, 0.0)

    # Switch load-balance loss: E * sum_e (first-choice token fraction) *
    # (mean router probability); the fraction carries no gradient
    frac = onehot[:, :, 0].float().mean(dim=(0, 1))
    aux = num_experts * torch.sum(frac * probs.mean(dim=(0, 1)))
    return expert, position, weight, aux


def _pad_row(t):
    """t [N, ...] with one zero row appended: index N reads zeros."""
    return torch.cat([t, t.new_zeros((1,) + t.shape[1:])])


class _GatherRows(torch.autograd.Function):
    """out[i] = src[index[i]] (index == len(src) reads a zero row). Its
    gradient is a gather as well: grad_src[r] = sum_t grad_out[inverse[r, t]],
    where inverse [len(src), m] lists the output rows that read row r
    (len(out) where fewer than m do), summed in that order."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _pad_row(src).index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        with record_function(ROUTE_SPAN):
            g = _pad_row(grad).index_select(0, inverse.reshape(-1))
            return g.view(inverse.shape + grad.shape[1:]).sum(1), None, None


class _BmmF32(torch.autograd.Function):
    """Batched a @ b with an fp32 result, the JAX package's einsum with
    preferred_element_type=float32: bf16 inputs are multiplied with fp32
    accumulation and not rounded after. The gradients are products in the
    inputs' dtype: the fp32 cotangent is rounded to it first, where JAX on
    the CPU multiplies the fp32 cotangent and rounds the result (tensor-core
    products on the card; tests/test_torch_moe.py measures the departure)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())  # exact products, fp32 sums

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


@contextmanager
def _no_tf32():
    """fp32 products in full fp32 on CUDA, whatever the process chose."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _slot_maps(expert, position, dispatched, num_experts: int, capacity: int):
    """Index maps between the flat token-choice rows (b S + s) k + j and the
    flat expert slots (e B + b) C + c: (slot_of_choice [B S k], pad E B C
    where not dispatched; choice_of_slot [E B C], pad B S k where empty).
    Each slot is written by at most one choice; the pad entry written by
    every undispatched choice is dropped."""
    b, s, k = expert.shape
    n_slots, n_choices = num_experts * b * capacity, b * s * k
    rows = torch.arange(b, device=expert.device)[:, None, None]
    slot = (expert * b + rows) * capacity + position
    slot_of_choice = torch.where(dispatched, slot, n_slots).reshape(-1)
    choice_of_slot = torch.full((n_slots + 1,), n_choices, device=expert.device,
                                dtype=torch.int64)
    choice_of_slot[slot_of_choice] = torch.arange(n_choices, device=expert.device)
    return slot_of_choice, choice_of_slot[:-1]


def moe_ffn(x, layer: dict, num_experts: int, k: int,
            capacity_factor: float, part=None):
    """x [B, S, d] -> (y [B, S, d], aux scalar). `layer` holds one layer's
    router and we_* leaves. SwiGLU experts on the static [E, B, C, ·] expert
    batch.

    `part(tensor, role)` is the JAX package's sharding-constraint hook
    ("dispatch" [E, B, C, ·], "hidden" [E, B, C, f], "combine" [B, S, d]);
    on one device it is the identity, and None means the identity."""
    if part is None:
        part = lambda t, role: t  # noqa: E731
    b, s, d = x.shape
    e, f = num_experts, layer["we_gate"].shape[-1]
    cap = expert_capacity(s, e, k, capacity_factor)

    with record_function(ROUTE_SPAN):
        with _no_tf32():
            router_logits = x.float() @ layer["router"]
        expert, position, weight, aux = _top_k_dispatch(router_logits, e, k, cap)
        slot_of_choice, choice_of_slot = _slot_maps(expert, position, weight > 0,
                                                    e, cap)
        # dispatch: each slot reads its token; a token's gradient sums its k
        # slots
        token_of_slot = torch.div(choice_of_slot, k, rounding_mode="floor")
        expert_in = _GatherRows.apply(x.reshape(b * s, d), token_of_slot,
                                      slot_of_choice.view(b * s, k))
    expert_in = part(expert_in.view(e, b, cap, d), "dispatch")
    xe = expert_in.view(e, b * cap, d)
    gate = _BmmF32.apply(xe, layer["we_gate"])
    up = _BmmF32.apply(xe, layer["we_up"])
    h = part((F.silu(gate) * up).to(x.dtype).view(e, b, cap, f), "hidden")
    expert_out = torch.bmm(h.view(e, b * cap, f), layer["we_down"])
    expert_out = part(expert_out.view(e, b, cap, d), "dispatch")

    # combine: each choice reads its slot; fp32 weighted sum over choices
    with record_function(ROUTE_SPAN):
        picked = _GatherRows.apply(expert_out.view(e * b * cap, d), slot_of_choice,
                                   choice_of_slot[:, None])
        y = (weight.reshape(b * s, k, 1) * picked.float().view(b * s, k, d)).sum(1)
    return part(y.to(x.dtype).view(b, s, d), "combine"), aux
