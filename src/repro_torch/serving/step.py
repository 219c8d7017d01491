"""Serving step builders: prefill and decode as plain functions.

The port of ``repro/serving/step.py``.  PyTorch runs eagerly, so there is
nothing to jit: each builder closes over the config and returns the step.
Each step runs under ``torch.inference_mode()``, entered by the step
itself: the mode is thread-local, and a Raptor flight calls the steps
from its members' threads.  So serving weights that require grad (a
trained model's) records no autograd graph.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg: ModelConfig, max_len: int, constrain=None,
                      ep=None):
    """``constrain``: the sharding plan's hook (``Plan.constrain``);
    ``ep``: an ``EPSpec`` for expert parallelism (models/moe.py)."""
    constrain = constrain or tfm._ID

    @torch.inference_mode()
    def prefill_step(params, batch):
        return tfm.prefill(params, cfg, batch, max_len, constrain=constrain,
                           ep=ep)
    return prefill_step


def make_decode_step(cfg: ModelConfig, constrain=None, ep=None):
    constrain = constrain or tfm._ID

    @torch.inference_mode()
    def decode_step(params, caches, tokens):
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
