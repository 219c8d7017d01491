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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4608)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = card()
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
