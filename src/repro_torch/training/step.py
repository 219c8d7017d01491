"""Train-step builder: loss -> grad -> (optional compression / straggler
transform) -> AdamW.

The port of ``repro/training/step.py``.  PyTorch runs eagerly, so the
builders return plain functions: ``train_step(state, batch)`` takes the
gradient of :func:`repro_torch.models.transformer.loss_fn` with
``torch.autograd.grad`` (through the kernels' autograd Functions) and
updates the state in place (:func:`~repro_torch.training.optimizer
.adamw_update`).  ``state = {"params": ParamTree, "opt": {"mu", "nu":
{name: tensor}, "step": int32 tensor}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state)


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """The reference's step options that act on one device: compression
    and straggler weights enter through ``grad_transform`` instead."""
    remat: bool = True
    remat_policy: Optional[str] = None       # None (full) | "dots"


def make_loss_fn(cfg: ModelConfig, constrain=None, remat: bool = True,
                 ep=None, remat_policy: Optional[str] = None):
    tfm.refuse_sharding(constrain, ep)

    def loss(params, batch):
        return tfm.loss_fn(params, cfg, batch, remat=remat,
                           remat_policy=remat_policy)
    return loss


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


def make_train_step(cfg: ModelConfig, oc: OptConfig, *, constrain=None,
                    options: StepOptions = StepOptions(),
                    grad_transform: Optional[Callable] = None, ep=None,
                    device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-dim
    float32 tensors).  The batch goes to ``device`` (the card unless
    given: without one this raises) by :func:`batch_to`; the state is
    updated in place.  ``grad_transform(grads)`` ({name: gradient} ->
    the same) is the injection point for compression and straggler
    weights (``repro_torch.distributed.collectives``)."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg, constrain, options.remat, ep=ep,
                           remat_policy=options.remat_policy)

    def train_step(state, batch):
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch_to(cfg, batch, dev))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
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
