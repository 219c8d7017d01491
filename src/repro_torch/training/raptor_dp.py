"""Raptor-style redundant data parallelism and straggler-robust aggregation.

The port of ``repro/training/raptor_dp.py`` (numpy): the paper's
flight/preemption idea applied to the training step.

- **flight-masked gradients**: the pod axis (size F) is the flight axis.
  Dropping a dead or straggling pod's gradient contribution is a
  per-sample loss weight, constant within each pod's batch shard — the
  same as a masked mean over per-pod gradients.  The step succeeds while
  one pod survives, and renormalising over the surviving pods keeps the
  gradient unbiased.
- **redundant microbatches**: at flight factor r, each microbatch goes to
  r pods in cyclically shifted order; the host adopts the first arrival
  of each microbatch and zeroes the weights of the late copies.
- **k-of-n**: keep the k fastest pods of a step, drop the rest.

``signals_to_weights`` turns per-pod health and latency into the [B]
weight vector ``loss_fn`` reads (``batch["loss_weight"]``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import StepOptions, make_train_step


def signals_to_weights(global_batch: int, num_pods: int, *,
                       health: Optional[np.ndarray] = None,
                       latency: Optional[np.ndarray] = None,
                       k: Optional[int] = None) -> np.ndarray:
    """Per-sample weights [B] from per-pod signals [F].

    health: {0,1} per pod -> drop dead pods.
    latency + k: keep only the k fastest pods (straggler drop).
    """
    keep = np.ones(num_pods, dtype=np.float32)
    if health is not None:
        keep = keep * np.asarray(health, dtype=np.float32)
    if latency is not None and k is not None:
        order = np.argsort(np.asarray(latency))
        mask = np.zeros(num_pods, np.float32)
        mask[order[:k]] = 1.0
        keep = keep * mask
    if keep.sum() == 0:
        raise RuntimeError(
            "all flight members failed — job failure (p^N event); "
            "restart from checkpoint")
    per_pod = global_batch // num_pods
    return np.repeat(keep, per_pod)


def redundant_assignment(num_micro: int, flight: int) -> list:
    """Microbatch -> pods computing it, with a cyclic shift: with
    flight=r each microbatch lands on r pods at different positions of
    their local order (decorrelated stragglers).  Returns [(micro, pod,
    position)]."""
    out = []
    for pod in range(flight):
        order = list(range(num_micro))
        s = pod % max(num_micro, 1)
        order = order[s:] + order[:s]
        for pos, m in enumerate(order):
            out.append((m, pod, pos))
    return out


def first_arrival_weights(num_micro: int, flight: int,
                          arrival_times: np.ndarray) -> np.ndarray:
    """arrival_times: [flight, num_micro] host-observed completion times
    of each redundant copy.  Weight 1 for the first copy of each
    microbatch, 0 for the pre-empted duplicates."""
    w = np.zeros((flight, num_micro), np.float32)
    winners = np.argmin(arrival_times, axis=0)
    w[winners, np.arange(num_micro)] = 1.0
    return w


def make_raptor_train_step(cfg: ModelConfig, oc: OptConfig, *,
                           plan=None, batch_blocks=None, constrain=None,
                           ep=None, remat: bool = True, device=None):
    """The plain step: flight behaviour enters only through
    ``batch["loss_weight"]``, built by :func:`signals_to_weights`; with
    ``plan`` (the sharded step) or ``batch_blocks`` (``make_train_step``)
    each pod's rank takes its shard, and the loss renormalises over the
    surviving pods' samples of the whole batch."""
    return make_train_step(cfg, oc, plan=plan, batch_blocks=batch_blocks,
                           constrain=constrain, ep=ep,
                           options=StepOptions(remat=remat), device=device)
