"""Train-step builder: loss -> grad -> (optional compression / straggler
transform) -> AdamW.

The port of ``repro/training/step.py``.  PyTorch runs eagerly, so the
builders return plain functions: ``train_step(state, batch)`` takes the
gradient of :func:`repro_torch.models.transformer.loss_fn` with
``torch.autograd.grad`` (through the kernels' autograd Functions) and
updates the state in place (:func:`~repro_torch.training.optimizer
.adamw_update`).  ``state = {"params": ParamTree, "opt": {"mu", "nu":
{name: tensor}, "step": int32 tensor}}``.

Data parallelism: with ``plan=`` a sharding plan over a ``DeviceMesh``,
every rank takes its block of the global batch over the plan's batch
axes (``Plan.local_batch``; a batch that does not divide stays whole on
every rank), the loss is the block's share of the whole batch's
(``loss_fn(..., shard=)``: the ``loss_weight`` renormalisation over the
whole batch, the MoE layers' dispatch and aux loss as over the whole
batch), and the step averages the gradients (and the loss metrics) over
those axes before ``grad_transform`` -- the gradient of the reference's
step on the whole batch.  Parameters and moments stay replicated on
every rank.  ``constrain`` alone (the reference's
``constrain=plan.constrain``) is a layout hint: the step then runs the
whole batch on every rank.
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
                    plan: Optional[Plan] = None, constrain=None,
                    options: StepOptions = StepOptions(),
                    grad_transform: Optional[Callable] = None, ep=None,
                    device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-dim
    float32 tensors).  The batch goes to ``device`` (the card unless
    given: without one this raises) by :func:`batch_to`; the state is
    updated in place.  ``grad_transform(grads)`` ({name: gradient} ->
    the same) is the injection point for compression and straggler
    weights (``repro_torch.distributed.collectives``).  With ``plan`` (a
    plan over a ``DeviceMesh``) the step is data-parallel, and
    ``constrain`` defaults to ``plan.constrain`` (module docstring)."""
    for name in ("grad_compression", "raptor_k_of_n"):
        if getattr(options, name) is not None:
            raise ValueError(
                f"StepOptions.{name} is the reference's unread field; pass "
                f"grad_transform=compress_grads(...) for compression, and "
                f"loss_weight from signals_to_weights(..., k=) for k-of-n")
    if plan is not None:
        if is_abstract(plan.mesh):
            raise ValueError("a data-parallel step needs a plan over a "
                             "DeviceMesh; this plan's mesh is abstract")
        constrain = constrain or plan.constrain
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg, constrain, options.remat, ep=ep,
                           remat_policy=options.remat_policy)

    def train_step(state, batch):
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        batch = batch_to(cfg, batch, dev)
        shard = None
        if plan is not None:
            shard = plan.batch_shard(batch["labels"].shape[0])
        if shard is not None:
            batch = plan.local_batch(batch)
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
