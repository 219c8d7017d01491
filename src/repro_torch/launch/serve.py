"""Serving launcher: batched LM generation with optional Raptor flights,
or the live streaming Raptor scheduler service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --requests 4 --prompt-len 512 --decode-steps 32 --flight 2

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --prompt-len 4096 --decode-steps 32

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --prompt-len 4096 --decode-steps 32

    PYTHONPATH=src python -m repro_torch.launch.serve --mode scheduler \
        --workload keygen --load high --jobs 4096 --arrival mmpp

Runs on the CUDA card unless ``--device cpu`` is given (with
``--reduced`` for a model small enough for the CPU).  Generation runs
every family (``--arch`` gemma-2b, gemma2-9b, gemma3-27b, phi3-mini-3.8b,
granite-moe-3b-a800m, llama4-maverick-400b-a17b, mamba2-1.3b,
zamba2-1.2b, the VLM qwen2-vl-2b and the encoder-decoder
seamless-m4t-medium) on ``demo_requests`` traffic: token prompts, or for
the two embedding-input models random prompt embeddings (and
seamless-m4t-medium's encoder frames, as many as the prompt; qwen2-vl's
M-RoPE ids equal in its three streams).  Prefill attention runs through
the ``flash_attention`` kernel (the encoder's and the cross attention
non-causal), decode attention through ``decode_attention``, expert MLPs
through ``expert_matmul``, prefill Mamba2 scans through ``ssd_scan`` (a
Mamba2 model's prompt must be a multiple of its SSD chunk, 256, or
shorter).  In scheduler mode
``--scan logdepth --summary-backend kernel`` books through the
``maxplus_scan`` kernel.
"""
from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("generate", "scheduler"),
                    default="generate",
                    help="generate: batched model serving; scheduler: the "
                         "open-arrival Raptor scheduling service")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    # -- generate mode -------------------------------------------------
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None,
                    help="KV-cache budget; default prompt+decode+8")
    ap.add_argument("--flight", type=int, default=1)
    ap.add_argument("--jitter-ms", type=float, default=0.0)
    # -- scheduler mode ------------------------------------------------
    ap.add_argument("--workload", default="keygen",
                    choices=("keygen", "wordcount", "thumbnail",
                             "heavytail"))
    ap.add_argument("--load", default="medium")
    ap.add_argument("--workers", type=int, default=15)
    ap.add_argument("--azs", type=int, default=3)
    ap.add_argument("--jobs", type=int, default=4096)
    ap.add_argument("--microbatch", type=int, default=64)
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "mmpp", "diurnal"))
    ap.add_argument("--scan", default="auto",
                    choices=("auto", "seq", "logdepth"))
    ap.add_argument("--summary-backend", default="torch",
                    choices=("torch", "kernel"))
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _validate(args: argparse.Namespace) -> None:
    if args.jitter_ms < 0.0:
        raise ValueError(
            f"--jitter-ms must be >= 0, got {args.jitter_ms}")
    if args.prompt_len < 1:
        raise ValueError(f"--prompt-len must be >= 1, got {args.prompt_len}")
    if args.decode_steps < 1:
        raise ValueError(
            f"--decode-steps must be >= 1, got {args.decode_steps}")
    max_len = (args.max_len if args.max_len is not None
               else args.prompt_len + args.decode_steps + 8)
    if args.prompt_len + args.decode_steps > max_len:
        raise ValueError(
            f"--prompt-len {args.prompt_len} + --decode-steps "
            f"{args.decode_steps} overflows --max-len {max_len}")
    args.max_len = max_len
    if args.jobs < 1:
        raise ValueError(f"--jobs must be >= 1, got {args.jobs}")
    if args.microbatch < 1:
        raise ValueError(f"--microbatch must be >= 1, got {args.microbatch}")


def _run_generate(args) -> int:
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                            demo_requests)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    params = init_params(cfg, args.seed, device=args.device)
    eng = ServingEngine(cfg, params, ServeConfig(
        max_len=args.max_len,
        decode_steps=args.decode_steps, flight_size=args.flight,
        mean_jitter_s=args.jitter_ms / 1e3), device=args.device)
    batches = [demo_requests(cfg, args.batch, args.prompt_len, seed=i,
                             device=args.device)
               for i in range(args.requests)]
    stats = eng.serve(batches, raptor=args.flight > 1)
    s = stats.summary()
    print(f"{cfg.name} on {eng.device}: first call {s['cold_s']*1e3:.0f} "
          f"ms (kernel build and load), warm ref {s['warm_s']*1e3:.0f} ms "
          f"(excluded from latencies)")
    print(f"{s['requests']} requests: mean {s['mean_s']*1e3:.0f} ms  "
          f"p50 {s['p50_s']*1e3:.0f} ms  p99 {s['p99_s']*1e3:.0f} ms")
    if "prefill_s" in s:
        print(f"  prefill {s['prefill_s']*1e3:.1f} ms, decode "
              f"{s['decode_step_s']*1e3:.2f} ms/step, "
              f"{args.batch / s['decode_step_s']:,.1f} tokens/s")
    return 0


def _run_scheduler(args) -> int:
    from repro_torch.serving.engine import SchedulerService
    from repro_torch.sim.events import (DiurnalArrivals, MMPPArrivals,
                                        PoissonArrivals)
    from repro_torch.sim.vector_queue import (QueueFlightSim,
                                              heavytail_queue, keygen_queue,
                                              thumbnail_queue,
                                              wordcount_queue)
    wl = {"keygen": keygen_queue, "wordcount": wordcount_queue,
          "thumbnail": thumbnail_queue, "heavytail": heavytail_queue}[
              args.workload]()
    sim = QueueFlightSim(wl, num_workers=args.workers, num_azs=args.azs,
                         load=args.load, seed=args.seed, scan=args.scan,
                         summary_backend=args.summary_backend,
                         device=args.device)
    proc = {"poisson": PoissonArrivals, "mmpp": MMPPArrivals,
            "diurnal": DiurnalArrivals}[args.arrival](sim.rate_hz,
                                                      seed=args.seed)
    svc = SchedulerService(sim, microbatch=args.microbatch, seed=args.seed)
    rep = svc.run_open_load(jobs=args.jobs, microbatch=args.microbatch,
                            slo_ms=args.slo_ms, process=proc,
                            seed=args.seed)
    print(f"{args.workload} @ {args.load} ({args.arrival} arrivals, "
          f"{sim.W} workers/{sim.A} AZs, {sim.device}):")
    print(f"  sustained {rep.jobs_per_s:,.0f} jobs/s "
          f"({rep.jobs} jobs in {rep.wall_s*1e3:.0f} ms wall)")
    print(f"  sojourn mean {rep.mean_ms:.0f} ms  p50 {rep.p50_ms:.0f} ms  "
          f"p99 {rep.p99_ms:.0f} ms")
    print(f"  SLO {rep.slo_ms:.0f} ms violated "
          f"{rep.slo_violation_frac*100:.1f}% (ok {rep.ok_frac*100:.1f}%)")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    _validate(args)
    if args.mode == "scheduler":
        return _run_scheduler(args)
    return _run_generate(args)


if __name__ == "__main__":
    sys.exit(main())
