"""AdamW with a cosine schedule and gradient clipping.

The port of ``repro/training/optimizer.py``: the update math is float32,
the moments are kept in ``OptConfig.state_dtype`` (bf16 for the 400B
llama4 config), decoupled weight decay applies to matrices only (leaves
with ``ndim >= 2``) and every new parameter is cast back to its own dtype.

Parameters are the model's :class:`~repro_torch.models.transformer
.ParamTree` (or any module); gradients and moments are dicts keyed by the
parameter's name in ``named_parameters()`` (``layers.0.attn.wq``).
Unlike the reference's functional update, :func:`adamw_update` writes
the parameters and the moments IN PLACE, under ``torch.no_grad()``: a
step would otherwise hold a second copy of the model and its moments.

A sharded state (``Plan.shard_state``: parameters, moments and gradients
as ``DTensor``s, each gradient in its parameter's placements) is updated
on each rank's shards, and :func:`global_norm` is the norm over every
shard of every rank: each rank's sum of squares (a leaf replicated over
some mesh dims counted once over them) summed by one all-reduce, so that
every rank clips by the same factor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.distributed.local import is_dtensor

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def lr_at(step, oc: OptConfig):
    """The learning rate at ``step`` (an int tensor), in float32: linear
    warmup, then a cosine decay to a tenth of ``oc.lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = oc.lr * (step + 1) / max(oc.warmup_steps, 1)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 * oc.lr + 0.9 * oc.lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state(params, oc: OptConfig) -> Dict[str, object]:
    """Zero moments in ``oc.state_dtype`` beside every parameter, and the
    step count (int32, on the parameters' device)."""
    dt = STATE_DTYPES[oc.state_dtype]
    named = list(params.named_parameters())

    def zeros():
        return {name: torch.zeros(p.shape, dtype=dt, device=p.device)
                for name, p in named}
    dev = named[0][1].device if named else None
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of every leaf of ``tree`` (a dict of tensors or
    a sequence of them) together."""
    leaves = list(tree.values() if isinstance(tree, dict) else tree)
    if leaves and is_dtensor(leaves[0]):
        return _sharded_norm(leaves)
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(t.float())) for t in leaves])))


def _sharded_norm(leaves) -> torch.Tensor:
    """The 2-norm of DTensor leaves over every rank's shards: one
    all-reduce over the group of the summed local squares, each leaf's
    divided by the number of its replicas."""
    parts = []
    for t in leaves:
        sq = torch.sum(torch.square(t.to_local().float()))
        reps = 1
        for i, p in enumerate(t.placements):
            if not p.is_shard():
                reps *= t.device_mesh.size(i)
        parts.append(sq / reps if reps > 1 else sq)
    total = funcol.all_reduce(torch.sum(torch.stack(parts)), "sum",
                              dist.group.WORLD)
    return torch.sqrt(total)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt_state, params,
                 oc: OptConfig):
    """One AdamW step, in place.  ``grads``: {parameter name: gradient}.
    Returns (params, opt_state, {"grad_norm", "lr"}), the first two the
    objects passed in, updated."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(step, oc)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - oc.b1 ** t
    bc2 = 1 - oc.b2 ** t
    mu, nu = opt_state["mu"], opt_state["nu"]
    for name, param in params.named_parameters():
        p, m_, v_ = _local(param), _local(mu[name]), _local(nu[name])
        g = _local(grads[name]).float() * scale
        m32 = oc.b1 * m_.float() + (1 - oc.b1) * g
        v32 = oc.b2 * v_.float() + (1 - oc.b2) * torch.square(g)
        del g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps)
        if p.dim() >= 2:           # decoupled weight decay on matrices only
            delta = delta + oc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m_.copy_(m32)
        v_.copy_(v32)
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
