"""Time the closed-loop engine's substrate configurations on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_config \
        --jobs 10658 --trials 32 --out chiprun_out/bench_config.json

For each engine (raptor, stock) and each substrate configuration in the
grid (block, resolver, scan, backends), runs ``QueueFlightSim.run`` once to warm up and ``--reps`` times
timed (host clock around work that ends in ``torch.cuda.synchronize()``),
checks that every configuration returns bitwise the responses of the
first, and prints jobs/s per configuration with the card's name and power
limit.  This is the measurement behind ``auto_config``'s CUDA default.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue

GRID = {
    "raptor": [dict(block=8, resolver="unrolled", scan="seq"),
               dict(block=32, resolver="fixpoint", scan="seq"),
               dict(block=64, resolver="fixpoint", scan="seq"),
               dict(block=128, resolver="fixpoint", scan="seq"),
               dict(block=64, resolver="unrolled", scan="seq"),
               dict(block=64, resolver="fixpoint", scan="logdepth"),
               dict(block=256, resolver="fixpoint", scan="logdepth"),
               dict(block=666, resolver="fixpoint", scan="logdepth"),
               dict(block=666, resolver="fixpoint", scan="logdepth",
                    summary_backend="kernel"),
               dict(block=2048, resolver="fixpoint", scan="logdepth")],
    "stock": [dict(block=1, resolver="fixpoint", scan="seq"),
              dict(block=64, resolver="fixpoint", scan="seq"),
              dict(block=256, resolver="fixpoint", scan="seq"),
              dict(block=1024, resolver="fixpoint", scan="seq"),
              dict(block=64, resolver="fixpoint", scan="seq",
                   booking_backend="kernel")],
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def trace(fn, name: str, label: str, top: int = 8) -> dict:
    """``fn`` once under ``torch.profiler``: wall time, device busy time,
    idle share, kernels launched and the top kernels by device time."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in cuda)
    out = dict(label=label, wall_s=wall, device_busy_s=busy_us / 1e6,
               idle_share=1.0 - busy_us / 1e6 / wall,
               kernels=sum(e.count for e in cuda),
               top=[(e.key, e.self_device_time_total / 1e6, e.count)
                    for e in sorted(cuda, key=lambda e:
                                    -e.self_device_time_total)[:top]])
    print(f"trace {label}: wall {wall:.4f} s, device busy "
          f"{out['device_busy_s']:.4f} s, idle share "
          f"{out['idle_share']:.4f}, {out['kernels']} kernels [{name}]",
          flush=True)
    for key, sec, count in out["top"]:
        print(f"    {sec:9.5f} s {count:7d}x {key[:100]}", flush=True)
    return out


def profile(engine: str, jobs: int, trials: int, load: str,
            name: str) -> dict:
    """One engine run under :func:`trace`, after one to warm up."""
    sim = QueueFlightSim(keygen_queue(), load=load, seed=0, device="cuda")
    raptor = engine == "raptor"
    sim.run(jobs, trials, raptor=raptor)                     # warm
    config = sim.engine_config(engine)
    out = trace(lambda: sim.run(jobs, trials, raptor=raptor), name,
                f"{engine} {config} jobs={jobs}", top=5)
    return dict(out, engine=engine, config=config, jobs=jobs, trials=trials)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=10658)
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--load", default="high")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--engines", default="raptor,stock")
    ap.add_argument("--profile-jobs", type=int, default=0,
                    help="also trace one run per engine at this many jobs "
                         "(auto config) and report the device's busy "
                         "share of the wall time")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = card()
    rows = []
    for engine in args.engines.split(","):
        base = None
        for cfg in GRID[engine]:
            sim = QueueFlightSim(keygen_queue(), load=args.load, seed=0,
                                 device="cuda", **cfg)
            raptor = engine == "raptor"
            res = sim.run(args.jobs, args.trials, raptor=raptor)   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                res = sim.run(args.jobs, args.trials, raptor=raptor)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.reps
            if base is None:
                base = res.response_ms
            elif not torch.equal(base, res.response_ms):
                raise AssertionError(f"{engine} {cfg} is not bitwise the "
                                     "first config")
            row = dict(engine=engine, **cfg, wall_s=wall,
                       jobs_per_s=args.jobs * args.trials / wall)
            rows.append(row)
            print(f"{engine:6s} {cfg} {wall:9.3f} s  "
                  f"{row['jobs_per_s']:12.1f} jobs/s [{name}]", flush=True)
    traces = []
    if args.profile_jobs:
        for engine in args.engines.split(","):
            traces.append(profile(engine, args.profile_jobs, args.trials,
                                  args.load, name))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": name, "jobs": args.jobs,
                       "trials": args.trials, "load": args.load,
                       "rows": rows, "traces": traces}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
