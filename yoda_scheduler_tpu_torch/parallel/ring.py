"""Ring attention: causal attention over a sequence split into chunks on sp.

The port of yoda_scheduler_tpu/parallel/ring.py. Each sp rank holds a
contiguous chunk of Q/K/V; K/V chunks go round the ring while each rank
merges every chunk into its queries' attention state, never forming the
global [S, S] scores. Each chunk goes through the flash kernels
(`flash_attention_with_lse`: the LSE is what makes partial attentions
mergeable): causal on the rank's own chunk, full on a chunk from its past;
a chunk from its future contributes nothing and launches nothing. The
merge is differentiated by autograd, so each chunk's backward receives a
non-zero LSE cotangent.

The ring turns two ways, behind one rank body (`ring_body`):

- `ring_attention`: one process per sp rank; the chunks go to the next
  rank over the mesh's sp group (`batch_isend_irecv`), their gradients back;
- `ring_attention_emulated`: one process steps through a list of the sp
  chunks (the card is one, and NCCL takes one rank per GPU), with the same
  launches per rank and the same arithmetic.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.attention import flash_attention_with_lse

_NEG_INF = -1e30


def _chunk_attention(q, k, v, causal: bool):
    """One q-chunk against one k/v-chunk: (out, lse [..., 1]) in fp32."""
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    return out.float(), lse.float()[..., None]


def ring_body(q, kv_at, index: int, size: int):
    """One sp rank's ring. q [B, H, S/n, D] is the rank's chunk; `kv_at(i)`
    gives (k, v) held after i turns, the chunk of rank (index - i) % n, and
    is called for every i in order (each call may turn the ring).

    Merge state over normalised per-chunk partials (out_i, lse_i): the
    exact combination is out = sum_i softmax_i(lse_i) out_i, kept online as
    (acc, r, m) with m the running max lse: acc = sum out_i exp(lse_i - m),
    r = sum exp(lse_i - m)."""
    qf = q.float()
    m = torch.full_like(qf[..., :1], _NEG_INF)
    r = torch.zeros_like(qf[..., :1])
    acc = torch.zeros_like(qf)
    for i in range(size):
        k, v = kv_at(i)
        src = (index - i) % size
        if src > index:
            continue  # skip: a chunk entirely in the future
        # full: a chunk entirely in the past; diag: the rank's own chunk
        out_i, lse_i = _chunk_attention(q, k, v, causal=src == index)
        m_new = torch.maximum(m, lse_i)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(lse_i - m_new)
        acc = acc * alpha + out_i * beta
        r = r * alpha + beta
        m = m_new
    return (acc / r.clamp_min(1e-30)).to(q.dtype)


class _RingKV(torch.autograd.Function):
    """(k, v) -> the n pairs the ring brings: pair i is rank (index - i)'s
    chunk, pair 0 the rank's own. The backward sends each pair's gradient
    back the way it came, adding the gradients of the chunks it passes on
    the way. Every rank reads pair 0 (its diagonal chunk), so every rank
    runs the backward, whichever chunks it skipped, and runs it after its
    recomputation under remat (which reads pair 0's saved tensors)."""

    @staticmethod
    def forward(ctx, k, v, axis):
        ctx.axis = axis
        cur = (k.view_as(k), v.view_as(v))
        out = list(cur)
        for _ in range(axis.size - 1):
            cur = _shift(cur, axis, +1)
            out.extend(cur)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        axis = ctx.axis
        pairs = [grads[2 * i:2 * i + 2] for i in range(axis.size)]
        acc = pairs[-1]
        for i in range(axis.size - 2, -1, -1):
            acc = _shift(acc, axis, -1)
            acc = tuple(a + g for a, g in zip(acc, pairs[i]))
        return acc[0], acc[1], None


def _shift(tensors, axis, step: int):
    """Send `tensors` to the rank `step` places on along the axis and
    receive the same shapes from the rank as far back."""
    to = axis.ranks[(axis.index + step) % axis.size]
    frm = axis.ranks[(axis.index - step) % axis.size]
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, to, axis.group) for t in sends]
           + [dist.P2POp(dist.irecv, t, frm, axis.group) for t in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(recvs)


def ring_attention(q, k, v, mesh, axis_name: str = "sp"):
    """Causal attention of this rank's chunks q [B, H, S/n, D], k, v [B, KvH,
    S/n, D] of a sequence split over the mesh axis `axis_name` (n ranks, in
    order), the ring turning over its process group. GQA: k/v may carry
    fewer heads than q."""
    axis = mesh.axis(axis_name)
    if axis.size == 1:
        return ring_body(q, lambda i: (k, v), 0, 1)
    turned = _RingKV.apply(k, v, axis)
    return ring_body(q, lambda i: turned[2 * i:2 * i + 2], axis.index, axis.size)


ring_attention.handles_gqa = True  # per-chunk compute is GQA-aware


def ring_attention_emulated(q, k, v, sp: int, tp: int = 1):
    """Causal attention over whole q [B, H, S, D], k, v [B, KvH, S, D]
    computed as the ring over `sp` ranks computes it, in one process: rank
    r's body reads chunk (r - i) % sp of the list at turn i. `tp` only
    decides the GQA broadcast: kv heads that do not split over tp are
    repeated to full heads, as the JAX package's ring does."""
    seq = q.shape[2]
    if seq % sp:
        raise ValueError(f"seq {seq} not divisible by sp={sp}")
    h, kvh = q.shape[1], k.shape[1]
    if kvh != h and kvh % tp:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    qs, ks, vs = q.chunk(sp, 2), k.chunk(sp, 2), v.chunk(sp, 2)
    return torch.cat([
        ring_body(qs[rank], lambda i, rank=rank: (ks[(rank - i) % sp], vs[(rank - i) % sp]),
                  rank, sp)
        for rank in range(sp)], 2)


ring_attention_emulated.handles_gqa = True


def make_ring_attn(mesh, axis_name: str = "sp"):
    """attn_impl adapter for models.llama.llama_forward on a rank's chunk."""
    def attn(q, k, v):
        return ring_attention(q, k, v, mesh, axis_name)
    attn.handles_gqa = True
    return attn
