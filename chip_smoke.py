#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``src/repro_torch``) once at full width —
the paper's HA deployment (15 workers over 3 AZs), keygen at load
``high``, fig6's 1,800 s stream (10,658 jobs per trial) and 32 trials —
after building its two hand-written CUDA kernels from the sources in the
checkout:

1. device: name and power limit (nvidia-smi), torch and CUDA versions;
2. build both kernels (one nvcc per source, in parallel), timed;
3. ``queue_booking`` against its plain PyTorch version, bitwise, at the
   engine's stock shape and the reference tests' shapes, timed;
4. ``maxplus_scan`` against its plain version, bitwise, on integer tapes
   with d != 0 and with d = 0, timed beside ``torch.cummax``;
5. engine: ``QueueFlightSim`` on cuda — stock through the kernel equals
   the scan substrate, raptor through the log-depth kernel route and the
   default route equal the sequential chain, all bitwise; both kernels'
   launch counts must rise; the ``run_pair`` summary;
6. service: ``SchedulerService`` on the kernel route under MMPP arrivals,
   with the streaming ``oracle_check`` bitwise;
7. one JSON line per run listing each kernel (launches on the engine
   path, error against the plain version, times, bound);
8. the last line: ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.  A copy
of the results goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the main path's size: HA deployment, keygen @ high, fig6's stream
WORKERS, AZS, LOAD = 15, 3, "high"
TRIALS = 32
JOBS = 10658                 # 1,800 s at 5.92 Hz
LOGDEPTH_NB = 16             # log-depth route: 16 blocks of the stream
SERVICE_JOBS, SERVICE_MB = 4096, 128
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_sm_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0].split()[0])


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want) -> float:
    """Raise unless ``got`` and ``want`` are bitwise equal (inf and nan
    in the same places); return the largest finite absolute error."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)
                           if g.is_floating_point() else g == w)
        fin = torch.isfinite(g) & torch.isfinite(w) if \
            g.is_floating_point() else torch.ones_like(same)
        if bool(fin.any()):
            err = max(err, float((g[fin].double() - w[fin].double())
                                 .abs().max()))
        if not bool(same.all()):
            raise AssertionError(
                f"kernel disagrees with its plain version at "
                f"{int((~same).sum())} places (max abs err {err})")
    return err


def booking_stream(T, N, W, util, dead_tail, seed, dev):
    """Ready-sorted booking streams like the stock engine's: Poisson-ish
    ready times at utilisation ``util``, exponential service."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ready = np.sort(rng.uniform(0, N * 100 / (W * util), (T, N)),
                    axis=1).astype(np.float32)
    if dead_tail:
        ready[:, N - dead_tail:] = np.inf
    service = rng.exponential(100.0, (T, N)).astype(np.float32)
    wf0 = rng.uniform(0, 300.0, (T, W)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (ready, service,
                                                         wf0))


def operator_tape(T, nb, W, diag_free, seed, dev):
    """Integer-valued operator tapes (exact composes); ``diag_free=False``
    is the engines' d = 0 shape."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    diag = (rng.integers(-20, 20, (T, nb, W)) if diag_free
            else np.zeros((T, nb, W))).astype(np.float32)
    off = rng.integers(0, 1000, (T, nb, W)).astype(np.float32)
    off = np.where(rng.uniform(size=off.shape) < 0.25, -np.inf,
                   off).astype(np.float32)
    wf0 = rng.integers(0, 500, (T, W)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (diag, off, wf0))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.maxplus_scan.ops import (
        maxplus_entries, maxplus_entries_plain)
    from repro_torch.kernels.queue_booking.ops import (book_stream,
                                                       book_stream_plain)
    from repro_torch.serving.engine import SchedulerService
    from repro_torch.sim.events import MMPPArrivals
    from repro_torch.sim.streaming import oracle_check
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 device: {card} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    results = {"card": card, "kind": kind}

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    for stem in sorted(paths):
        regs = [ln.strip() for ln in _build.build_log.get(stem, "")
                .splitlines() if "registers" in ln]
        say(f"phase 2 build {stem}: {paths[stem].name} "
            f"({_build.build_seconds.get(stem, 0.0):.1f} s) "
            f"{' | '.join(regs)}")
    say(f"phase 2 build: both kernels in {build_s:.1f} s wall [{card}]")
    results["build_s"] = build_s

    # ---- 3. queue_booking vs plain -------------------------------------
    W = WORKERS
    N = 2 * JOBS                       # keygen's stock stream: K=2 tasks
    for T, n, w, block, dead in [(2, 128, 15, 64, 0), (4, 200, 15, 64, 30),
                                 (1, 96, 4, 16, 0), (3, 256, 31, 128, 10)]:
        args = booking_stream(T, n, w, 0.8, dead, 0, dev)
        compare(book_stream(*args, block=block), book_stream_plain(*args))
    say("phase 3 queue_booking: bitwise equal to plain at the reference "
        "test shapes")
    args = booking_stream(TRIALS, N, W, 0.75, 0, 1, dev)
    got = book_stream(*args, block=64)
    want = book_stream_plain(*args)
    k1_err = compare(got, want)
    k1_ms = time_ms(lambda: book_stream(*args, block=64), reps=20)
    k1_plain_ms = time_ms(lambda: book_stream_plain(*args), reps=1,
                          warmup=0)
    k1_bytes = 4 * (TRIALS * N * 5 + TRIALS * W * 2)
    k1_ops = TRIALS * N * (3 * W + 3)
    k1_bound = 1e3 * max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S)
    # the chain model: each event's booking depends on the previous one
    # through ~21 dependent instructions (compare and select the key, five
    # shuffle-compare-select levels, max, add, compare and select the
    # worker), each at least 4 cycles, at the card's maximum SM clock
    k1_chain = 1e3 * N * 21 * 4 / (max_sm_mhz() * 1e6)
    say(f"phase 3 queue_booking (T={TRIALS}, N={N}, W={W}): bitwise, "
        f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms, bound "
        f"{k1_bound:.6f} ms (bytes), chain model {k1_chain:.4f} ms "
        f"[{card}]")
    results["queue_booking_chain_model_ms"] = k1_chain

    # ---- 4. maxplus_scan vs plain --------------------------------------
    nb = LOGDEPTH_NB
    for T, b, w in [(2, 1, 15), (2, 8, 15), (3, 5, 15), (4, 13, 7),
                    (1, 32, 1), (2, 48, 31)]:
        for diag_free in (True, False):
            tape = operator_tape(T, b, w, diag_free, 0, dev)
            compare(maxplus_entries(*tape), maxplus_entries_plain(*tape))
    k2_err = 0.0
    for diag_free in (True, False):
        tape = operator_tape(TRIALS, nb, W, diag_free, 2, dev)
        k2_err = max(k2_err, compare(maxplus_entries(*tape),
                                     maxplus_entries_plain(*tape)))
    tape0 = operator_tape(TRIALS, nb, W, False, 3, dev)
    k2_ms = time_ms(lambda: maxplus_entries(*tape0), reps=200)
    k2_plain_ms = time_ms(lambda: maxplus_entries_plain(*tape0), reps=50)
    cummax_ms = time_ms(lambda: torch.cummax(tape0[1], dim=1), reps=200)
    k2_bytes = 4 * (3 * TRIALS * nb * W + 2 * TRIALS * W)
    k2_ops = TRIALS * W * (3 * nb * math.ceil(math.log2(nb)) + 2 * nb)
    k2_bound = 1e3 * max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_OPS_PER_S)
    say(f"phase 4 maxplus_scan (T={TRIALS}, nb={nb}, W={W}): bitwise on "
        f"d!=0 and d=0 tapes, kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, torch.cummax {cummax_ms:.4f} ms, bound "
        f"{k2_bound:.6f} ms (bytes) [{card}]")

    # ---- 5. engine -------------------------------------------------------
    wl = keygen_queue()
    block = JOBS // nb
    sims = {
        "auto": QueueFlightSim(wl, num_workers=W, num_azs=AZS, load=LOAD,
                               seed=0, device=dev),
        "stock_kernel": QueueFlightSim(wl, num_workers=W, num_azs=AZS,
                                       load=LOAD, seed=0, device=dev,
                                       booking_backend="kernel"),
        "raptor_kernel": QueueFlightSim(wl, num_workers=W, num_azs=AZS,
                                        load=LOAD, seed=0, device=dev,
                                        scan="logdepth", block=block,
                                        summary_backend="kernel"),
        "raptor_seq": QueueFlightSim(wl, num_workers=W, num_azs=AZS,
                                     load=LOAD, seed=0, device=dev,
                                     scan="seq"),
    }
    say(f"phase 5 engine: keygen @ {LOAD}, {W} workers / {AZS} AZs, "
        f"{JOBS} jobs x {TRIALS} trials; auto config "
        f"raptor={sims['auto'].engine_config('raptor')} "
        f"stock={sims['auto'].engine_config('stock')}; seq config "
        f"{sims['raptor_seq'].engine_config('raptor')}; log-depth block "
        f"{block} (nb={JOBS // block}, tail {JOBS % block})")
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    book_stream.launches = 0
    maxplus_entries.launches = 0
    stock_k = timed("stock_kernel", lambda: sims["stock_kernel"].run(
        JOBS, TRIALS, raptor=False))
    rap_k = timed("raptor_logdepth_kernel", lambda: sims["raptor_kernel"].run(
        JOBS, TRIALS, raptor=True))
    launches = {"queue_booking": book_stream.launches,
                "maxplus_scan": maxplus_entries.launches}
    say(f"phase 5 engine launches on the kernel routes: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    stock_a = timed("stock_auto", lambda: sims["auto"].run(
        JOBS, TRIALS, raptor=False))
    rap_a = timed("raptor_auto", lambda: sims["auto"].run(
        JOBS, TRIALS, raptor=True))
    rap_s = timed("raptor_seq", lambda: sims["raptor_seq"].run(
        JOBS, TRIALS, raptor=True))
    for name, a, b in (("stock", stock_k, stock_a), ("raptor", rap_k, rap_s),
                       ("raptor auto", rap_a, rap_s)):
        compare((a.response_ms, a.ok), (b.response_ms, b.ok))
        if a.response_ms.shape != (TRIALS, JOBS) or not bool(
                torch.isfinite(a.response_ms).all()):
            raise AssertionError(f"{name}: bad responses")
    pair = {"stock": stock_a.summary(), "raptor": rap_a.summary()}
    pair["mean_ratio"] = pair["raptor"]["mean"] / pair["stock"]["mean"]
    if not 0.3 < pair["mean_ratio"] < 1.0:
        raise AssertionError(f"raptor/stock mean ratio {pair['mean_ratio']}")
    say("phase 5 engine: stock kernel == substrate, raptor log-depth "
        "kernel == seq, raptor auto == seq, bitwise")
    for eng in ("stock", "raptor"):
        s = pair[eng]
        say(f"phase 5 run_pair {eng}: mean {s['mean']:.1f} ms, p99 "
            f"{s['p99']:.1f} ms, n {s['n']}")
    say(f"phase 5 run_pair mean_ratio {pair['mean_ratio']:.4f}; wall s "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" [{card}]")
    results.update(engine_walls_s=walls, run_pair=pair, launches=launches)

    # ---- 6. service ------------------------------------------------------
    svc_sim = QueueFlightSim(wl, num_workers=W, num_azs=AZS, load="medium",
                             seed=0, device=dev, scan="logdepth", block=64,
                             summary_backend="kernel")
    maxplus_entries.launches = 0
    svc = SchedulerService(svc_sim, microbatch=SERVICE_MB, seed=0)
    rep = svc.run_open_load(
        jobs=SERVICE_JOBS, microbatch=SERVICE_MB,
        process=MMPPArrivals(svc_sim.rate_hz, burst_factor=5.0,
                             dwell_s=(20.0, 4.0), seed=0), seed=0)
    svc_launches = maxplus_entries.launches
    if svc_launches < 1 or rep.jobs != SERVICE_JOBS:
        raise AssertionError(f"service: {svc_launches} maxplus_scan "
                             f"launches, {rep.jobs} jobs")
    check = oracle_check(svc_sim, n_steps=6, microbatch=SERVICE_MB)
    if not check["bitwise"]:
        raise AssertionError(f"streaming oracle_check failed: {check}")
    say(f"phase 6 service: {rep.jobs} jobs (MMPP, microbatch "
        f"{SERVICE_MB}, config {svc_sim.engine_config('raptor')}), "
        f"{rep.jobs_per_s:.1f} jobs/s, p50 {rep.p50_ms:.1f} ms, p99 "
        f"{rep.p99_ms:.1f} ms, SLO {rep.slo_ms:.0f} ms violated "
        f"{rep.slo_violation_frac:.4f}; oracle_check bitwise "
        f"{check['bitwise']}; maxplus_scan launches {svc_launches} "
        f"[{card}]")
    results["service"] = rep.summary()

    # ---- 7. kernels line ---------------------------------------------------
    kernels = [
        {"name": "queue_booking", "route": "cuda",
         "source": "src/repro_torch/csrc/queue_booking.cu",
         "replaces": "src/repro/kernels/queue_booking/kernel.py:80",
         "launches": launches["queue_booking"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "maxplus_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/maxplus_scan.cu",
         "replaces": "src/repro/kernels/maxplus_scan/kernel.py:57",
         "launches": launches["maxplus_scan"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": cummax_ms},
    ]
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    say(f"total {results['total_s']:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
