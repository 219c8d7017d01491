"""Train-step builder: loss -> grad -> (optional compression / straggler
transform) -> AdamW.

The port of ``repro/training/step.py``.  PyTorch runs eagerly, so the
builders return plain functions: ``train_step(state, batch)`` takes the
gradient of :func:`repro_torch.models.transformer.loss_fn` with
``torch.autograd.grad`` (through the kernels' autograd Functions) and
updates the state in place (:func:`~repro_torch.training.optimizer
.adamw_update`).  ``state = {"params": ParamTree, "opt": {"mu", "nu":
{name: tensor}, "step": int32 tensor}}``.

A plan selects one of two data-parallel steps, each by its own
argument:

- ``plan=`` (the path kept): the sharded step.  The state comes from
  ``plan.shard_state`` (parameters and moments as ``DTensor``s, ZeRO-3
  over the data axes and tensor parallel over ``model``, the reference's
  ``in_shardings``); the batch is placed by the plan, the loss runs on
  DTensors (each weight gathered over the data axes where a layer reads
  it, the kernels on each rank's shards, the MoE layers through the EP
  block), each gradient comes back in its parameter's placements
  (reduce-scattered over the data axes) and AdamW updates each rank's
  shards; the metrics are the whole batch's.  A plain state raises.
- ``batch_blocks=``: replicated weights, each rank its block of the
  global batch over the plan's batch axes (``Plan.local_batch``; a batch
  that does not divide stays whole on every rank), for an MoE config
  without ``ep`` only: its layers then dispatch as over the whole batch
  (``loss_fn(..., shard=)``: capacity and each slot's place in its
  expert's queue from every block's counts, the aux loss and the
  ``loss_weight`` renormalisation over the whole batch), which the
  sharded step's EP block does not reproduce.  The step averages the
  gradients (and the loss metrics) over the batch axes before
  ``grad_transform`` -- the gradient of the reference's step on the
  whole batch.  A dense config raises, naming ``plan=``.

``constrain`` alone (the reference's ``constrain=plan.constrain``) is a
layout hint: the step then runs the whole batch on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.functional import BatchShard
from repro_torch.distributed.local import is_dtensor
from repro_torch.distributed.sharding import Plan
from repro_torch.launch.mesh import is_abstract
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state)


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """The reference's step options.  ``grad_compression`` and
    ``raptor_k_of_n`` are the reference's fields, which its
    ``make_train_step`` never reads; :func:`make_train_step` refuses
    them set, since compression is ``grad_transform=compress_grads(...)``
    (``distributed/collectives.py``) and the k fastest pods are
    ``loss_weight`` from ``training.raptor_dp.signals_to_weights``."""
    remat: bool = True
    remat_policy: Optional[str] = None       # None (full) | "dots"
    grad_compression: Optional[str] = None   # refused: see above
    raptor_k_of_n: Optional[tuple] = None    # refused: see above


def make_loss_fn(cfg: ModelConfig, constrain=None, remat: bool = True,
                 ep=None, remat_policy: Optional[str] = None):
    constrain = constrain or tfm._ID

    def loss(params, batch, shard: Optional[BatchShard] = None):
        return tfm.loss_fn(params, cfg, batch, remat=remat,
                           remat_policy=remat_policy, constrain=constrain,
                           ep=ep, shard=shard)
    return loss


def _mean_over(tensors, shard: BatchShard) -> None:
    """Average each tensor in place over the blocks of the batch."""
    for t in tensors:
        for group in shard.groups:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(shard.size)


def batch_to(cfg: ModelConfig, batch, device) -> Dict[str, torch.Tensor]:
    """A batch (numpy arrays or tensors) on ``device``; the float inputs
    (``embeddings``, ``enc_emb``) in the model dtype, as the model's
    matmuls take them."""
    dt = tfm.DTYPES[cfg.dtype]
    out = {}
    for name, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v, device=device)
        if t.is_floating_point() and name != "loss_weight":
            t = t.to(dt)
        out[name] = t
    return out


def make_train_step(cfg: ModelConfig, oc: OptConfig, *,
                    plan: Optional[Plan] = None,
                    batch_blocks: Optional[Plan] = None, constrain=None,
                    options: StepOptions = StepOptions(),
                    grad_transform: Optional[Callable] = None, ep=None,
                    device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-dim
    float32 tensors).  The batch goes to ``device`` (the card unless
    given: without one this raises) by :func:`batch_to`; the state is
    updated in place.  ``grad_transform(grads)`` ({name: gradient} ->
    the same) is the injection point for compression and straggler
    weights (``repro_torch.distributed.collectives``).  ``plan`` (the
    sharded step, on a ``plan.shard_state`` state) or ``batch_blocks``
    (an MoE config's batch blocks with replicated weights), each a plan
    over a ``DeviceMesh``, makes the step data-parallel; ``constrain``
    then defaults to the plan's (module docstring)."""
    for name in ("grad_compression", "raptor_k_of_n"):
        if getattr(options, name) is not None:
            raise ValueError(
                f"StepOptions.{name} is the reference's unread field; pass "
                f"grad_transform=compress_grads(...) for compression, and "
                f"loss_weight from signals_to_weights(..., k=) for k-of-n")
    if plan is not None and batch_blocks is not None:
        raise ValueError("pass plan= (the sharded step) or batch_blocks=, "
                         "not both")
    if batch_blocks is not None and (cfg.moe is None or ep is not None):
        raise ValueError("batch_blocks= is for an MoE config's dispatch "
                         "over the whole batch, without ep; pass plan= and "
                         "a state from plan.shard_state")
    dp = plan if plan is not None else batch_blocks
    if dp is not None:
        if is_abstract(dp.mesh):
            raise ValueError("a data-parallel step needs a plan over a "
                             "DeviceMesh; this plan's mesh is abstract")
        constrain = constrain or dp.constrain
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg, constrain, options.remat, ep=ep,
                           remat_policy=options.remat_policy)

    def sharded_step(state, batch):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        batch = plan.shard_batch(batch_to(cfg, batch, dev))
        with implicit_replication(), torch.enable_grad():
            loss, metrics = loss_fn(plan.gathered(params), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = {n: g.redistribute(p.device_mesh, p.placements)
                 for n, g, p in zip(names, grads, leaves)}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, opt_metrics = adamw_update(grads, state["opt"], params,
                                                oc)
        del grads
        m = {"loss": _whole(loss), **{k: _whole(v) for k, v in
                                      metrics.items()}, **opt_metrics}
        return {"params": params, "opt": opt}, m

    def train_step(state, batch):
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        if is_dtensor(leaves[0]) != (plan is not None):
            raise ValueError("a state from plan.shard_state runs through "
                             "make_train_step(plan=), and only such a state")
        if plan is not None:
            return sharded_step(state, batch)
        batch = batch_to(cfg, batch, dev)
        shard = None
        if batch_blocks is not None:
            shard = batch_blocks.batch_shard(batch["labels"].shape[0])
        if shard is not None:
            batch = batch_blocks.local_batch(batch)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, shard)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if shard is not None:
            loss, metrics = loss.detach().clone(), {
                k: v.detach().clone() for k, v in metrics.items()}
            _mean_over([*grads, loss, *metrics.values()], shard)
        grads = dict(zip(names, grads))
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, opt_metrics = adamw_update(grads, state["opt"], params,
                                                oc)
        del grads
        m = {"loss": loss.detach(),
             **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return {"params": params, "opt": opt}, m

    return train_step


def _whole(t):
    """A metric as a plain tensor (a DTensor's whole value)."""
    t = t.detach()
    return t.full_tensor() if is_dtensor(t) else t


def init_train_state(cfg: ModelConfig, oc: OptConfig, seed: int = 0, *,
                     device=None):
    """Random parameters (``init_params`` from ``seed``) with gradients
    on, and zero AdamW moments, on ``device`` (the card unless given)."""
    params = tfm.init_params(cfg, seed, device=device)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, oc)}


def train_state_shape(cfg: ModelConfig, oc: OptConfig):
    """The train state's tensors on the ``meta`` device: shapes and
    dtypes, no allocation."""
    return init_train_state(cfg, oc, device="meta")
