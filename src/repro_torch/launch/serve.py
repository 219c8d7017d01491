"""Serving launcher: the live streaming Raptor scheduler service.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --workload keygen --load high --jobs 4096 --arrival mmpp

Runs on the CUDA card unless ``--device cpu`` is given.  ``--scan
logdepth --summary-backend kernel`` books through the ``maxplus_scan``
kernel.
"""
from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("scheduler",), default="scheduler",
                    help="scheduler: the open-arrival Raptor scheduling "
                         "service")
    ap.add_argument("--device", default="cuda",
                    help="torch device to book on (cuda or cpu)")
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
    if args.jobs < 1:
        raise ValueError(f"--jobs must be >= 1, got {args.jobs}")
    if args.microbatch < 1:
        raise ValueError(f"--microbatch must be >= 1, got {args.microbatch}")


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
    return _run_scheduler(args)


if __name__ == "__main__":
    sys.exit(main())
