"""Gradient compression and straggler-tolerant aggregation transforms.

The port of ``repro/distributed/collectives.py``.  Each returns a
``grad_transform`` for ``training.step.make_train_step``, acting on
``{parameter name: gradient}``:

- ``"bf16"``: every gradient rounded to bf16 and back (what a bf16
  all-reduce would carry); the update math stays float32.
- ``"int8"``: per-tensor symmetric int8 quantisation with stochastic
  rounding, from an explicit ``torch.Generator`` seeded by ``seed`` and
  advanced by every call, so the rounding is unbiased over steps.

A step with a sharding plan (``training/step.py``) averages the
gradients over the plan's batch axes first and hands the mean to the
transform, as the reference's sharded step does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def _stochastic_round_int8(x, scale, generator):
    y = x / scale * 127.0
    noise = torch.rand(y.shape, generator=generator, device=y.device) - 0.5
    return torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)


def compress_grads(mode: Optional[str], seed: int = 0) -> Optional[Callable]:
    if mode is None:
        return None
    if mode == "bf16":
        def t(grads: Dict[str, torch.Tensor]):
            return {k: g.to(torch.bfloat16).to(g.dtype)
                    for k, g in grads.items()}
        return t
    if mode == "int8":
        gens: Dict[torch.device, torch.Generator] = {}

        def t(grads: Dict[str, torch.Tensor]):
            out = {}
            for k, g in grads.items():
                if g.device not in gens:
                    gens[g.device] = torch.Generator(
                        device=g.device).manual_seed(seed)
                scale = torch.clamp(g.abs().max().float(), min=1e-8)
                q = _stochastic_round_int8(g.float(), scale, gens[g.device])
                out[k] = (q.float() * scale / 127.0).to(g.dtype)
            return out
        return t
    raise ValueError(f"unknown compression mode {mode!r}")


def drop_straggler_transform(weights) -> Callable:
    """Scale the gradients by the inverse of the weights' mean (the share
    of samples kept): with per-sample loss weights that zero a dropped
    shard, the mean renormalises over the survivors."""
    def t(grads: Dict[str, torch.Tensor]):
        w = torch.as_tensor(weights, dtype=torch.float32)
        norm = torch.clamp(w.sum() / w.numel(), min=1e-6)
        return {k: g / norm.to(g.device) for k, g in grads.items()}
    return t
