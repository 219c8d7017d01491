"""Raptor's flight collectives on ``torch.distributed``.

The port of ``repro/core/jaxops.py``: the state-sharing stream and the
pre-emption rule as collectives over a *flight* group, one member per
rank.  On a fleet each member is an executor group (a pod or a
data-parallel slice) with its own latency and failures; every rank of
the group calls the same function, as the reference's combinators run
inside ``shard_map`` over a named axis.

- :func:`first_finisher`: every member contributes (value, latency); all
  adopt the value of the member with the smallest latency (the lowest
  rank on a tie, as ``jnp.argmin``) -- the state-sharing broadcast and
  the pre-emption of the others.
- :func:`k_of_n_mean`: the mean over the k earliest members (drop
  stragglers; ties to the lower rank, a stable sort).
- :func:`masked_mean`: the mean over the healthy members, a reduced
  flight (paper §3.3.2); it fails only when every member fails (p^N).

``group`` is a process group (``None``: the default group), or a
``DeviceMesh`` and one of its dim names as ``(mesh, name)``.  A value is
a tensor or a dict of tensors (the reference's pytree); latency and
health are scalars (Python numbers or 0-dim tensors) on the value's
device.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _group(group):
    if isinstance(group, tuple):
        mesh, name = group
        return mesh.get_group(name)
    return group


def _tree_map(fn: Callable, value):
    if isinstance(value, dict):
        return {k: _tree_map(fn, v) for k, v in value.items()}
    return fn(value)


def _first_leaf(value) -> torch.Tensor:
    if isinstance(value, dict):
        return _first_leaf(next(iter(value.values())))
    return value


def _gather_scalar(x, group, device) -> torch.Tensor:
    """[F] float32: every member's scalar, in rank order."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device).reshape(1)
    out = torch.empty(dist.get_world_size(group), dtype=torch.float32,
                      device=device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _psum_f32(v: torch.Tensor, weight: torch.Tensor, group):
    contrib = v.float() * weight
    dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
    return contrib


def first_finisher(value, latency, group=None):
    """Adopt the value of the member with the smallest latency.

    Returns (winner's value, winner's rank in the group, an int64 0-dim
    tensor).  Cost: one all-gather of the scalar latencies and one
    all-reduce of the value's bytes (in float32, cast back)."""
    g = _group(group)
    dev = _first_leaf(value).device
    lats = _gather_scalar(latency, g, dev)
    winner = torch.argmin(lats)                 # first minimum on a tie
    me = dist.get_rank(g)
    is_winner = (winner == me).float()

    def pick(v):
        return _psum_f32(v, is_winner, g).to(v.dtype)

    return _tree_map(pick, value), winner


def masked_mean(value, healthy, group=None):
    """Mean over the healthy members; returns (mean, n_healthy).

    ``healthy``: scalar {0, 1}.  With no healthy member the mean is 0 and
    ``n_healthy`` 0 -- callers treat that as a failed job (prob p^N)."""
    g = _group(group)
    dev = _first_leaf(value).device
    h = torch.as_tensor(healthy, dtype=torch.float32, device=dev)
    n = h.clone().reshape(1)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=g)
    n = n[0]
    denom = torch.clamp(n, min=1.0)

    def agg(v):
        return (_psum_f32(v, h, g) / denom).to(v.dtype)

    return _tree_map(agg, value), n


def k_of_n_mean(value, latency, k: int, group=None):
    """Mean over the k members with the smallest latency (stragglers
    dropped); ties go to the lower rank."""
    g = _group(group)
    dev = _first_leaf(value).device
    lats = _gather_scalar(latency, g, dev)
    order = torch.argsort(lats, stable=True)
    me = dist.get_rank(g)
    my_place = int(torch.nonzero(order == me)[0, 0])
    keep = torch.tensor(float(my_place < k), device=dev)

    def agg(v):
        return (_psum_f32(v, keep, g) / float(k)).to(v.dtype)

    return _tree_map(agg, value)


def speculative_apply(fn, mesh, flight_axis: str, value_spec=None):
    """``fn(member_index, *args) -> (value, latency)`` run by every member
    of ``mesh``'s ``flight_axis``, the first finisher's value adopted by
    all.  Returns ``wrapped(*args) -> (value, winner)``.

    ``value_spec``: the value's spec inside a member (the reference's
    ``out_specs`` without the flight axis).  Every rank holds its own
    block of the value and the flight group joins the ranks that hold the
    same block, so the spec only has to leave the flight axis out."""
    if value_spec is not None:
        for entry in value_spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            if flight_axis in names:
                raise ValueError(f"value_spec {value_spec} shards over the "
                                 f"flight axis {flight_axis!r}")

    def wrapped(*args):
        idx = mesh.get_local_rank(flight_axis)
        value, latency = fn(idx, *args)
        return first_finisher(value, latency, (mesh, flight_axis))

    return wrapped
