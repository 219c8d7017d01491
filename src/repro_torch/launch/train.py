"""Training launcher: real steps on the card, with checkpoint/resume,
Raptor redundant-DP weights and checkpointing on a preemption signal.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 6 --batch 2 --seq 2048 --simulate-failure-at 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 50 --reduced --device cpu --ckpt /tmp/ckpt --resume

The port of ``repro/launch/train.py``, with the same flags and
``--device`` (the card unless ``--device cpu``; without a card it
raises).  It runs eagerly: the forward's attention, expert products and
Mamba2 scans launch the hand-written kernels, their gradients go through
the kernels' autograd Functions.  ``--simulate-failure-at N`` zeroes the
last pod's health weight at step N (the step proceeds on the surviving
pods' samples); ``--resume`` restarts from the latest checkpoint under
``--ckpt``; SIGTERM saves a checkpoint after the current step and exits.
Every fifth step and the last print the loss, gradient norm, learning
rate, wall time (after ``torch.cuda.synchronize()`` on the card) and
tokens/s.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.synthetic import make_batch
from repro_torch.distributed.collectives import compress_grads
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.raptor_dp import signals_to_weights
from repro_torch.training.step import (StepOptions, init_train_state,
                                       make_train_step)

#: the kernels a training step launches, by name
KERNELS = {"flash_attention": mha, "expert_matmul": gmm, "ssd_scan": ssd}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--simulate-failure-at", type=int, default=-1,
                    help="kill a flight member's contribution at this step")
    ap.add_argument("--num-pods", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    return ap


def main(argv=None, *, result: dict | None = None) -> int:
    """Train; with ``result`` (a dict) it also receives the final
    ``state`` and one record per step (``history``: loss, ce, aux,
    grad_norm, lr, wall ms, tokens/s and the kernels' launches)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeConfig("host", args.seq, args.batch, "train")
    oc = OptConfig(warmup_steps=5, total_steps=args.steps,
                   state_dtype=cfg.optimizer_state_dtype)
    step_fn = make_train_step(
        cfg, oc, options=StepOptions(remat=False),
        grad_transform=compress_grads(args.grad_compression), device=dev)

    state = init_train_state(cfg, oc, 0, device=dev)
    start = 0
    if args.resume and args.ckpt:
        try:
            state, start = ckpt_io.restore(args.ckpt, state)
            start += 1
            print(f"resumed from step {start - 1}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *a: stop.update(now=True))
    history = []
    t0 = time.perf_counter()
    try:
        for step in range(start, args.steps):
            batch = make_batch(cfg, shape, step)
            # Raptor redundant-DP: per-pod health -> per-sample weights
            health = np.ones(args.num_pods)
            if step == args.simulate_failure_at:
                health[-1] = 0.0
                print(f"step {step}: simulating pod failure "
                      f"(flight degrades, step proceeds)")
            batch["loss_weight"] = signals_to_weights(
                args.batch, args.num_pods, health=health)
            before = {k: fn.launches for k, fn in KERNELS.items()}
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s = time.perf_counter() - ts
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, ms=step_s * 1e3,
                       tokens_per_s=args.batch * args.seq / step_s,
                       launches={k: fn.launches - before[k]
                                 for k, fn in KERNELS.items()})
            history.append(rec)
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step}: loss={rec['loss']:.4f} "
                      f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e} "
                      f"{rec['ms']:.1f} ms {rec['tokens_per_s']:.0f} "
                      f"tokens/s", flush=True)
            if args.ckpt and (step % args.ckpt_every == 0 or stop["now"]
                              or step == args.steps - 1):
                ckpt_io.save(args.ckpt, step, state)
            if stop["now"]:
                print("SIGTERM: checkpointed and exiting for restart")
                break
    finally:
        signal.signal(signal.SIGTERM, previous)
    if not stop["now"]:
        print(f"done: {args.steps - start} steps in "
              f"{time.perf_counter() - t0:.1f}s")
    if result is not None:
        result.update(state=state, history=history, cfg=cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
