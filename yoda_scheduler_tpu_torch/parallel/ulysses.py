"""Ulysses sequence parallelism: causal attention over a sequence split on sp
by re-sharding heads instead of turning a ring.

The port of yoda_scheduler_tpu/parallel/ulysses.py. Each sp rank holds a
contiguous chunk of the sequence for all of its heads. One all-to-all per
tensor splits the heads over the sp group and gathers the sequence, so each
rank holds a subset of the heads over the whole sequence; the local causal
attention runs once through the flash kernels (no per-chunk merge); a last
all-to-all splits the sequence again and gathers the heads. It needs the
rank's heads to split over sp, which the ring does not.

Two spellings, one body (`_attend` between the exchanges):

- `ulysses_attention`: one process per sp rank, the exchanges over the
  mesh's sp group (`collectives.all_to_all`, whose backward is the inverse
  exchange);
- `ulysses_attention_emulated`: one process holds the list of the sp
  chunks and exchanges them in place (the card is one, and NCCL takes one
  rank per GPU), with the same launches per rank and the same arithmetic.
"""

from __future__ import annotations

import torch

from ..ops.attention import flash_attention
from . import collectives as C


def _broadcast_kv(seq: int, heads: int, kvh: int, n: int, tp: int,
                  axis_name: str = "sp") -> bool:
    """The JAX package's checks on the whole q [B, heads, seq, D] and k/v
    with kvh heads over sp = n and tp; -> whether k and v must be repeated
    to full heads before the exchange (their heads do not survive the same
    tp and sp splits as q's)."""
    if seq % n:
        raise ValueError(f"seq {seq} not divisible by {axis_name}={n}")
    if heads % tp:
        raise ValueError(f"heads {heads} not divisible by tp={tp}")
    local_heads = heads // tp
    if local_heads % n:
        raise ValueError(
            f"local head count {local_heads} (H={heads}, tp={tp}) not "
            f"divisible by {axis_name}={n} — use ring attention for this "
            "shape")
    if heads % kvh:
        raise ValueError(
            f"q heads {heads} not a multiple of kv heads {kvh}")
    return kvh != heads and bool(kvh % tp or (kvh // tp) % n)


def _repeat_kv(k, v, heads: int):
    rep = heads // k.shape[1]
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


def _attend(q, k, v):
    """The local attention: a head subset over the whole sequence."""
    return flash_attention(q, k, v, causal=True)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp"):
    """Causal attention of this rank's chunks q [B, H', S/n, D] and k, v
    [B, KvH', S/n, D] (the model's heads on this tp rank, n = the sp axis's
    size, chunks in sp order). The checks and the GQA choice are the JAX
    package's on the whole sequence and the global heads: H = H' tp, and
    KvH = KvH' tp, or H where the plan already repeated kv heads that do not
    split over tp (parallel/sharding.py:ShardPlan.kv_heads). On an axis of
    size 1 the exchanges are skipped: `flash_attention`."""
    axis = mesh.axis(axis_name)
    n, tp = axis.size, mesh.shape.get("tp", 1)
    h = q.shape[1]
    if _broadcast_kv(q.shape[2] * n, h * tp, k.shape[1] * tp, n, tp, axis_name):
        k, v = _repeat_kv(k, v, h)
    # scatter heads, gather sequence; the exchange sends contiguous chunks,
    # so the model's transposed views need no copy of their own
    q, k, v = (C.all_to_all(t, 1, 2, axis) for t in (q, k, v))
    # scatter sequence, gather heads back
    return C.all_to_all(_attend(q, k, v), 2, 1, axis)


ulysses_attention.handles_gqa = True  # grouped KV rides the all-to-alls


def _exchange(parts: list, split_dim: int, cat_dim: int) -> list:
    """The all-to-all over the list of every rank's tensor, in one process:
    rank j gets chunk j of each rank's tensor along `split_dim`,
    concatenated in rank order along `cat_dim`."""
    n = len(parts)
    chunks = [p.chunk(n, split_dim) for p in parts]
    return [torch.cat([chunks[r][j] for r in range(n)], cat_dim) for j in range(n)]


def ulysses_attention_emulated(q, k, v, sp: int, tp: int = 1):
    """Causal attention over whole q [B, H, S, D], k, v [B, KvH, S, D]
    computed as Ulysses over `sp` ranks computes it, in one process: the
    sequence cut into sp chunks, the exchanges over the list, one local
    attention per rank. `tp` only enters the checks and the GQA choice (the
    heads of every tp rank go through the list together; attention is per
    head)."""
    h = q.shape[1]
    if _broadcast_kv(q.shape[2], h, k.shape[1], sp, tp):
        k, v = _repeat_kv(k, v, h)
    ranks = [_exchange(list(t.chunk(sp, 2)), 1, 2) for t in (q, k, v)]
    outs = [_attend(*qkv) for qkv in zip(*ranks)]
    return torch.cat(_exchange(outs, 2, 1), 2)


ulysses_attention_emulated.handles_gqa = True


def make_ulysses_attn(mesh, axis_name: str = "sp"):
    """attn_impl adapter for models.llama.llama_forward on a rank's chunk."""
    def attn(q, k, v):
        return ulysses_attention(q, k, v, mesh, axis_name)
    attn.handles_gqa = True
    return attn
