"""The collectives of the sharded training step, as autograd Functions.

GSPMD inserts these for the JAX package from its sharding annotations; the
port writes them out, Megatron-style, over the process groups of a mesh
axis (`mesh.Axis`), on local shards of plain tensors. Each Function's
backward is its forward's adjoint:

- `all_gather` (fsdp weights at use, the sequence over sp): its adjoint is
  the reduce-scatter of the gradient;
- `fan_out` (the input of a column-parallel product on tp): identity
  forward, all-reduce of the gradient;
- `sum_partials` (the output of a row-parallel product on tp, and any sum
  of partial results that every rank then uses alike): all-reduce
  forward, identity backward;
- `all_to_all` (the expert dispatch over ep): its adjoint is the inverse
  all-to-all.

On an axis of size 1 each returns its input: the world-1 step computes
what the one-device step computes, with the same operations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _ordered(chunks: list, axis) -> list:
    """Chunks in index order of `axis` -> in group-rank order."""
    out = [None] * axis.size
    for i, c in enumerate(chunks):
        out[axis.perm[i]] = c
    return out


def _gather(x, dim: int, axis):
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat([parts[p] for p in axis.perm], dim)


def _reduce_scatter(x, dim: int, axis):
    chunks = [c.contiguous() for c in x.chunk(axis.size, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, _ordered(chunks, axis), group=axis.group)
    return out


def _all_reduce(x, axis, op=dist.ReduceOp.SUM):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=axis.group)
    return x


def _all_to_all(x, split_dim: int, cat_dim: int, axis):
    sends = _ordered([c.contiguous() for c in x.chunk(axis.size, split_dim)], axis)
    recvs = [torch.empty_like(c) for c in sends]
    dist.all_to_all(recvs, sends, group=axis.group)
    return torch.cat([recvs[p] for p in axis.perm], cat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.axis), None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, axis):
        ctx.dims, ctx.axis = (split_dim, cat_dim), axis
        return _all_to_all(x, split_dim, cat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, cat_dim, split_dim, ctx.axis), None, None, None


def all_gather(x, dim: int, axis):
    """The shards of `axis` concatenated along `dim` in index order; the
    gradient is reduce-scattered (each rank gets the sum over the axis of
    its shard's gradient)."""
    return x if axis.size == 1 else _AllGather.apply(x, dim, axis)


def fan_out(x, axis):
    """Identity forward; the gradient is summed over `axis` (each rank's
    column-parallel product gives the input a partial gradient)."""
    return x if axis.size == 1 else _FanOut.apply(x, axis)


def sum_partials(x, axis):
    """The sum over `axis` (of row-parallel partial products); the gradient
    passes through, since every rank goes on with the same sum."""
    return x if axis.size == 1 else _SumPartials.apply(x, axis)


def all_to_all(x, split_dim: int, cat_dim: int, axis):
    """Cut `x` along `split_dim` into `axis.size` chunks, send chunk i to
    the axis's rank i, and concatenate what arrives along `cat_dim` in
    index order; the gradient takes the inverse exchange."""
    return x if axis.size == 1 else _AllToAll.apply(x, split_dim, cat_dim, axis)


def all_reduce_max(x, axis):
    """The elementwise maximum over `axis`, outside autograd."""
    return x if axis.size == 1 else _all_reduce(x.detach(), axis, dist.ReduceOp.MAX)


def gather_values(x, dim: int, axis):
    """`all_gather` outside autograd (index tensors, counts, shards being
    collected)."""
    return x if axis.size == 1 else _gather(x.detach(), dim, axis)
