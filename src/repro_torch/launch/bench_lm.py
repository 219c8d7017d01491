"""Where the time of the LM serving path goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_lm --arch gemma2-9b \
        --batch 2 --prompt-len 4608 --decode-steps 8 \
        --out bench_lm.json
    PYTHONPATH=src python -m repro_torch.launch.bench_lm \
        --arch granite-moe-3b-a800m --prompt-len 4096
    PYTHONPATH=src python -m repro_torch.launch.bench_lm \
        --arch zamba2-1.2b --prompt-len 4096
    PYTHONPATH=src python -m repro_torch.launch.bench_lm \
        --arch qwen2-vl-2b --prompt-len 4096
    PYTHONPATH=src python -m repro_torch.launch.bench_lm \
        --arch seamless-m4t-medium --prompt-len 4096
    PYTHONPATH=src python -m repro_torch.launch.bench_lm --mode train \
        --arch gemma-2b --batch 2 --prompt-len 2048

Every family runs (dense, MoE, SSM, hybrid, the VLM and the
encoder-decoder) on ``demo_requests`` traffic (embedding prompts, and
for seamless-m4t-medium encoder frames as many as the prompt); a Mamba2
model's prompt must be a multiple of its SSD chunk (256) or shorter than
it.

Draws the model's weights (seed 0) on the card, warms up one prefill and
one decode step, then times ``--reps`` prefills and ``--decode-steps``
decode steps (host clock around work that ends in
``torch.cuda.synchronize()``) and traces one prefill and the decode steps
under ``torch.profiler``: the device's kernel time against the wall time
(the idle share), the number of kernels launched, and the kernels that
take most of the device time, each with the card's name and power limit.

``--mode train`` does the same for the training step
(``training.step.make_train_step``, AdamW, no remat, as
``launch/train.py`` runs it) on
``make_batch``'s synthetic data of ``--batch`` sequences of
``--prompt-len`` tokens: one step to warm up, ``--reps`` steps timed,
then two steps traced (idle share, kernels per step, top device ops),
with the training kernels' launches per step.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.bench_config import card, trace
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import demo_requests
from repro_torch.serving.step import greedy_sample


def train_main(args, name: str) -> int:
    """``--mode train``: time and trace the training step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.train import KERNELS
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import (StepOptions, init_train_state,
                                           make_train_step)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    oc = OptConfig(state_dtype=cfg.optimizer_state_dtype)
    state = init_train_state(cfg, oc, 0, device=dev)
    step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                           device=dev)
    shape = ShapeConfig("bench", args.prompt_len, args.batch, "train")
    batches = [make_batch(cfg, shape, i) for i in range(args.reps + 3)]
    state, _ = step(state, batches[0])                      # warm
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for b in batches[1:args.reps + 1]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.reps
    per_step = {k: fn.launches // args.reps for k, fn in KERNELS.items()}
    n_par = sum(p.numel() for p in state["params"].parameters())
    tokens = args.batch * args.prompt_len
    print(f"{cfg.name} train B={args.batch} S={args.prompt_len}: "
          f"{step_s * 1e3:.1f} ms/step, "
          f"{tokens / step_s:.0f} tokens/s, 6 x {n_par:,} x {tokens} / "
          f"step = {6 * n_par * tokens / step_s / 1e12:.1f} TFLOP/s; loss "
          f"{float(m['loss']):.4f}; launches per step {per_step}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{name}]", flush=True)
    rest = batches[args.reps + 1:]

    def two_steps():
        nonlocal state
        for b in rest:
            state, _ = step(state, b)
    traces = [trace(two_steps, name, f"2 training steps (B={args.batch}, "
                                     f"S={args.prompt_len})", top=12)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": name, "arch": cfg.name, "mode": "train",
                       "batch": args.batch, "seq": args.prompt_len,
                       "step_s": step_s,
                       "params": n_par, "launches_per_step": per_step,
                       "traces": traces}, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("serve", "train"), default="serve")
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4608)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = card()
    if args.mode == "train":
        return train_main(args, name)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    params = tfm.init_params(cfg, 0, device=dev)
    batch = demo_requests(cfg, args.batch, args.prompt_len, device=dev)
    max_len = args.prompt_len + args.decode_steps + 8

    def prefill():
        return tfm.prefill(params, cfg, batch, max_len)

    def decode(cache, tok, steps):
        for _ in range(steps):
            logits, cache = tfm.decode_step(params, cfg, cache, tok)
            tok = greedy_sample(logits)[:, None]
        return cache, tok

    logits, cache = prefill()                               # warm
    tok = greedy_sample(logits)[:, None]
    decode(cache, tok, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        logits, cache = prefill()
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / args.reps
    tok = greedy_sample(logits)[:, None]
    t0 = time.perf_counter()
    decode(cache, tok, args.decode_steps)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.decode_steps
    print(f"{cfg.name} B={args.batch} prompt {args.prompt_len}: prefill "
          f"{prefill_s * 1e3:.1f} ms, decode {step_s * 1e3:.3f} ms/step "
          f"({args.batch / step_s:.1f} tokens/s) [{name}]", flush=True)
    traces = [trace(prefill, name, "prefill")]
    logits, cache = prefill()
    tok = greedy_sample(logits)[:, None]
    traces.append(trace(lambda: decode(cache, tok, args.decode_steps), name,
                        f"{args.decode_steps} decode steps"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": name, "arch": cfg.name, "batch": args.batch,
                       "prompt_len": args.prompt_len,
                       "prefill_s": prefill_s, "decode_step_s": step_s,
                       "traces": traces}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
