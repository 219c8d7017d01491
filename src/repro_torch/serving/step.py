"""Serving step builders: prefill and decode as plain functions.

The port of ``repro/serving/step.py``.  PyTorch runs eagerly, so there is
nothing to jit: each builder closes over the config and returns the step.
Each step runs under ``torch.inference_mode()``, entered by the step
itself: the mode is thread-local, and a Raptor flight calls the steps
from its members' threads.  So serving weights that require grad (a
trained model's) records no autograd graph.

With ``plan=`` the steps run sharded, on parameters from
``plan.shard_params`` (DTensors; plain parameters raise): the batch and
the tokens placed by the plan, the cache allocated by
``plan.init_cache`` (each rank its block), each
weight gathered over the data axes where a layer reads it, the kernels
on each rank's shards; the logits come back as a DTensor (vocab-sharded
where the vocabulary divides the model axis: ``full_tensor()`` gathers
them) and the cache as DTensors.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.local import is_dtensor
from repro_torch.models import transformer as tfm


@contextlib.contextmanager
def _sharded_mode():
    """A sharded step's mode: no gradient, but not inference mode (a view
    of a DTensor made there cannot be taken: PyTorch 2.13), and plain
    tensors mixed with DTensors read as replicated."""
    with torch.inference_mode(False), torch.no_grad(), \
            implicit_replication():
        yield


def _sharded(plan, params) -> bool:
    """Whether the step runs sharded: with ``plan``, on parameters from
    ``plan.shard_params`` only."""
    if plan is None:
        return False
    if not is_dtensor(next(iter(params.parameters()))):
        raise ValueError("a step built with plan= runs sharded on the "
                         "parameters from plan.shard_params")
    return True


def make_prefill_step(cfg: ModelConfig, max_len: int, constrain=None,
                      ep=None, *, plan=None):
    """``constrain``: the sharding plan's hook (``Plan.constrain``);
    ``ep``: an ``EPSpec`` for expert parallelism (models/moe.py);
    ``plan``: a plan over a ``DeviceMesh`` for the sharded step (module
    docstring)."""
    if plan is not None:
        constrain = constrain or plan.constrain
    constrain = constrain or tfm._ID

    @torch.inference_mode()
    def prefill_step(params, batch):
        if _sharded(plan, params):
            with _sharded_mode():
                return tfm.prefill(plan.gathered(params), cfg,
                                   plan.shard_batch(batch), max_len,
                                   constrain=constrain, ep=ep,
                                   cache_fn=plan.init_cache)
        return tfm.prefill(params, cfg, batch, max_len, constrain=constrain,
                           ep=ep)
    return prefill_step


def make_decode_step(cfg: ModelConfig, constrain=None, ep=None, *,
                     plan=None):
    if plan is not None:
        constrain = constrain or plan.constrain
    constrain = constrain or tfm._ID

    @torch.inference_mode()
    def decode_step(params, caches, tokens):
        if _sharded(plan, params):
            if not is_dtensor(tokens):
                tokens = plan.shard_batch(tokens)
            with _sharded_mode():
                return tfm.decode_step(plan.gathered(params), cfg, caches,
                                       tokens, constrain=constrain, ep=ep)
        return tfm.decode_step(params, cfg, caches, tokens,
                               constrain=constrain, ep=ep)
    return decode_step


def cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                enc_len: int = 0):
    """The decode cache's tensors on the ``meta`` device: shapes and
    dtypes, no allocation (``enc_len``: an encoder-decoder's encoder
    length)."""
    return tfm.init_cache(cfg, batch, max_len, enc_len, device="meta")


def greedy_sample(logits):
    """argmax over the vocabulary, the lowest index on a tie (as
    ``jnp.argmax``); int32 [B]."""
    top = logits.max(dim=-1, keepdim=True).values
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == top, idx, logits.shape[-1]).min(
        dim=-1).values.to(torch.int32)
