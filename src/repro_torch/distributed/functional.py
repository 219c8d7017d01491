"""Differentiable collectives for the expert-parallel block.

Each is an autograd Function over ``torch.distributed`` with the
gradient that a model replicated along the group needs: ranks along the
group hold the same activations and compute the same downstream loss, so
a block that splits work over the group must hand each rank the whole
gradient again.

- :func:`all_to_all`: ``all_to_all_single`` along dim 0 (chunk j to rank
  j, the received chunks in rank order); its gradient is the same
  exchange of the gradient.  :attr:`all_to_all.calls` counts the
  exchanges made (the counterpart of a kernel's launch count); over a
  group of one rank the exchange is the identity and is skipped, and
  :attr:`all_to_all.skipped` counts those.
- :func:`split`: this rank's chunk of dim 0; the gradient is gathered.
- :func:`gather`: every rank's chunk, concatenated on dim 0; the gradient
  is this rank's chunk of it (each rank holds the whole, identical
  downstream gradient).
- :func:`all_reduce_sum`: a sum over the groups; the gradient is summed
  too (a rank's loss reads the sum of every rank's input).
- :func:`reduce_grad`: the identity whose gradient is summed over the
  groups and scaled, for a replicated weight of which each rank uses a
  part.
- :func:`sum_replicated`: a sum over the groups whose result every rank
  holds as one replicated value (a ``DTensor``'s ``Replicate``, as a
  sharded step's vocab-parallel loss is): each rank's gradient is its
  own, passed through.

:class:`BatchShard` names this rank's block of a batch split evenly over
the batch axes' groups; the loss and the MoE block read it to compute
the whole batch's terms (``models/transformer.py``, ``models/moe.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's block of a batch split evenly over process groups:
    the groups (one per batch axis), the number of blocks and this
    block's place in the batch order (``Plan.local_batch``)."""
    groups: tuple
    size: int
    index: int


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x, group):
    if dist.get_world_size(group) == 1:
        all_to_all.skipped += 1
        return x
    all_to_all.calls += 1
    return _AllToAll.apply(x, group)


all_to_all.calls = 0
all_to_all.skipped = 0


def _gather_dim0(x, group):
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _chunk_dim0(x, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0] // n
    return x[r * m:(r + 1) * m]


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim0(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk_dim0(g, ctx.group).contiguous(), None


def split(x, group):
    return _Split.apply(x, group)


def gather(x, group):
    return _Gather.apply(x, group)


def _sum(x, groups):
    x = x.clone()
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.groups), None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, scale):
        ctx.groups, ctx.scale = groups, scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = _sum(g, ctx.groups)
        if ctx.scale != 1.0:
            out = out * ctx.scale
        return out, None, None


def all_reduce_sum(x, groups):
    return _AllReduceSum.apply(x, tuple(groups))


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_replicated(x, groups):
    return _SumReplicated.apply(x, tuple(groups))


def gather_blocks(x, shard: BatchShard):
    """Every block's ``x`` stacked in batch order, ``[shard.size, *x.shape]``
    (no gradient): a sum over the groups of each rank's ``x`` at its
    place."""
    out = x.new_zeros((shard.size,) + tuple(x.shape))
    out[shard.index] = x
    return _sum(out, shard.groups)


def reduce_grad(x, groups, scale: float = 1.0):
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReduceGrad.apply(x, tuple(groups), float(scale))
