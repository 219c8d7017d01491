"""Streaming Raptor scheduler: open arrivals on a persistent W-state.

The port of ``repro/sim/streaming.py``.  Jobs arrive from an open
:class:`repro_torch.sim.events.ArrivalProcess`; the host microbatches
them, draws their event tensors, and books each microbatch against a
**persistent per-worker free-at vector on the device** — the only state
that survives between steps, updated in place.  Booking is queued on the
device without a host wait; the host synchronises only when it harvests
a microbatch's outputs, at most ``pipeline_depth`` microbatches behind.

Exactness: each microbatch is replayed by the SAME booking body the
whole-trace engine uses (:func:`repro_torch.sim.vector_queue
._raptor_stream_fns`).  A job observes earlier jobs only through the
carried W-vector, so N consecutive steps over slices of a stream compose
to exactly one replay of the concatenated stream; :func:`oracle_check`
replays the concatenated event tensors through the ``block=1``
sequential oracle and compares runs and traces bitwise.

Fault mode: the brownout and crash tables are exogenous wall-clock
interval processes, drawn ONCE per stream (from a generator of their
own) and handed to every step, as the whole-trace replay draws them once
per trial; :func:`oracle_check` replays with the same tables.

Padding: the final partial microbatch is padded with ``inf`` arrivals —
the dead-event convention (releases gated to ``-inf``) books nothing for
them, leaving the W-state bitwise untouched; padded outputs are masked
out at harvest.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.sim.events import ArrivalProcess, PoissonArrivals
from repro_torch.sim.vector_queue import QueueFlightSim, _raptor_stream_fns


@dataclasses.dataclass
class StreamingReport:
    """Sustained-load summary of one open-arrival run."""
    jobs: int                    # live (non-padded) jobs booked
    ok_frac: float               # fraction that completed successfully
    wall_s: float                # host wall-clock of the submit+drain loop
    jobs_per_s: float            # sustained throughput (jobs / wall_s)
    mean_ms: float               # mean sojourn (arrival -> response), ok only
    p50_ms: float
    p99_ms: float
    slo_ms: float
    slo_violation_frac: float    # P(sojourn > slo_ms or failed)
    horizon_ms: float            # sim-time of the last arrival
    offered_rate_hz: float       # jobs / horizon (the realized arrival rate)

    def summary(self) -> dict:
        return dataclasses.asdict(self)


class StreamingScheduler:
    """Continuously running Raptor scheduling engine on ``sim.device``.

    ``sim`` supplies the deployment (workers/AZs/flight), workload, and
    blocked-substrate config exactly as for whole-trace runs; the
    scheduler only changes *when* events are booked, never how.

    Lifecycle::

        eng = StreamingScheduler(sim, microbatch=64)
        for batch_ms in ...:          # host arrival ingest
            eng.submit(batch_ms)      # device books, host returns
        resp_ms, ok = eng.drain()     # wait + harvest everything

    ``pipeline_depth`` bounds how many microbatches may sit unharvested
    before ``submit`` harvests the oldest (which waits for the device).
    ``keep_events=True`` records the drawn event tensors so
    :func:`oracle_check` can replay the identical stream whole-trace
    (with the one-shot fault tables, ``env``).
    """

    def __init__(self, sim: QueueFlightSim, *, microbatch: int = 64,
                 pipeline_depth: int = 2, trace: bool = False,
                 keep_events: bool = False, seed: Optional[int] = None):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.sim = sim
        self.device = sim.device
        self.microbatch = int(microbatch)
        self.pipeline_depth = int(pipeline_depth)
        self.trace = bool(trace)
        self.keep_events = bool(keep_events)
        blk, res, sc = sim.engine_config("raptor")
        self.config = (blk, res, sc)
        draw_env, self._draw, self._step = _raptor_stream_fns(
            sim.W, sim.A, sim.flight, sim.wl.graph, sim.wl.dist,
            sim.wl.fail_prob, sim._fp, sim._policy, blk, res, sc,
            sim.summary_backend, trace, self.device)
        base = sim.seed if seed is None else int(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(base)
        # fault tables are drawn ONCE per stream, from their own generator
        # (None outside fault mode)
        env_gen = torch.Generator(device=self.device)
        env_gen.manual_seed(base + 2 ** 31)
        self.env = draw_env(env_gen, 1)
        self.wf = torch.zeros((1, sim.W), device=self.device)
        self._pending = collections.deque()   # (outs, live, arrivals_ms)
        self._done = []
        self._events = [] if keep_events else None
        self.jobs_submitted = 0

    # -- ingest --------------------------------------------------------
    def submit(self, arrivals_ms) -> None:
        """Book one microbatch of absolute arrival times (ms, sorted).

        Returns once the booking is queued on the device; harvests the
        oldest microbatch when the pipeline is ``pipeline_depth`` deep.
        Arrivals must not precede the previous microbatch (the W-state
        carries the past; booking cannot rewind it).
        """
        arr = np.asarray(arrivals_ms, dtype=np.float64)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("submit wants a non-empty 1-D array of "
                             f"arrival times, got shape {arr.shape}")
        if arr.size > self.microbatch:
            raise ValueError(f"microbatch holds {self.microbatch} jobs, "
                             f"got {arr.size}")
        if np.any(np.diff(arr) < 0.0):
            raise ValueError("arrivals within a microbatch must be sorted")
        live = np.zeros(self.microbatch, dtype=bool)
        live[:arr.size] = True
        padded = np.full(self.microbatch, np.inf)
        padded[:arr.size] = arr
        sim, wl = self.sim, self.sim.wl
        arrivals = torch.as_tensor(padded, dtype=torch.float32).to(
            self.device)[None, None]
        events = self._draw(self._gen, arrivals, sim.rho, wl.task_means,
                            wl.offset_ms, wl.cv, wl.raptor_stage_ms,
                            [sim.oh_mu], [sim.oh_sigma])
        if self._events is not None:
            self._events.append(events)
        wf, outs = self._step(self.wf, events, self.env, sim.slat)
        self.wf.copy_(wf)          # the persistent state, updated in place
        self._pending.append((outs, live, padded))
        self.jobs_submitted += int(arr.size)
        while len(self._pending) > self.pipeline_depth:
            self._harvest_one()

    def _harvest_one(self) -> None:
        outs, live, arr = self._pending.popleft()
        self._done.append((tuple(o[0].cpu().numpy() for o in outs), live,
                           arr))

    # -- harvest -------------------------------------------------------
    def drain(self):
        """Wait for everything in flight; return ``(resp_ms, ok)`` host
        arrays over all live jobs submitted so far (padding dropped)."""
        while self._pending:
            self._harvest_one()
        if not self._done:
            return np.empty(0, np.float32), np.empty(0, bool)
        resp = np.concatenate([o[0][live] for o, live, _ in self._done])
        ok = np.concatenate([o[1][live] for o, live, _ in self._done])
        return resp, ok

    def drain_trace(self):
        """Like :meth:`drain` but with the per-member booking trace:
        ``(resp, ok, arrival, dispatch, worker, release)`` (live jobs)."""
        if not self.trace:
            raise ValueError("construct with trace=True to record traces")
        while self._pending:
            self._harvest_one()
        cols = [np.concatenate([o[i][live] for o, live, _ in self._done])
                for i in range(5)]
        arr = np.concatenate([a[live] for _, live, a in self._done])
        resp, ok, disp, widx, rel = cols
        return resp, ok, arr, disp, widx, rel

    def concatenated_events(self):
        """The full drawn event stream (requires ``keep_events=True``) —
        the exact ``(1, n)`` tensors every microbatch booked, padding
        included."""
        if self._events is None:
            raise ValueError("construct with keep_events=True")
        return tuple(torch.cat(xs, dim=1) for xs in zip(*self._events))


def oracle_check(sim: QueueFlightSim, *, n_steps: int = 6,
                 microbatch: int = 32, process: ArrivalProcess = None,
                 ragged_tail: bool = True, trace: bool = False,
                 seed: Optional[int] = None) -> dict:
    """Replay the streaming engine's event stream whole-trace and compare.

    Runs ``n_steps`` microbatches through :class:`StreamingScheduler`
    (recording the drawn event tensors), then books the concatenated
    stream in ONE replay through the ``block=1`` sequential oracle from a
    zero W-state, with the stream's fault tables.  Returns bitwise
    equality per output column (runs, and traces when ``trace=True``) and
    their conjunction under "bitwise".
    """
    if process is None:
        process = PoissonArrivals(sim.rate_hz, seed=sim.seed + 17)
    eng = StreamingScheduler(sim, microbatch=microbatch, trace=trace,
                             keep_events=True, seed=seed)
    for i in range(n_steps):
        n = microbatch
        if ragged_tail and i == n_steps - 1:
            n = max(1, microbatch // 3)     # exercise the padded tail
        eng.submit(process.take(n))
    streamed = (eng.drain_trace() if trace else eng.drain())
    events = eng.concatenated_events()
    _, _, oracle_step = _raptor_stream_fns(
        sim.W, sim.A, sim.flight, sim.wl.graph, sim.wl.dist,
        sim.wl.fail_prob, sim._fp, sim._policy, 1, "fixpoint", "seq",
        sim.summary_backend, trace, sim.device)
    _, outs = oracle_step(torch.zeros((1, sim.W), device=sim.device),
                          events, eng.env, sim.slat)
    live = np.isfinite(events[0][0].cpu().numpy())
    names = (("resp", "ok", "arrival", "dispatch", "worker", "release")
             if trace else ("resp", "ok"))
    oracle_cols = list(outs)
    if trace:
        oracle_cols = [outs[0], outs[1], events[0], outs[2], outs[3],
                       outs[4]]
    result = {}
    for name, got, want in zip(names, streamed, oracle_cols):
        want = want[0].cpu().numpy()[live]
        got = np.asarray(got).astype(want.dtype, copy=False)
        result[name] = bool(np.array_equal(got, want, equal_nan=True))
    result["bitwise"] = all(result.values())
    return result


def run_open_load(sim: QueueFlightSim, *, jobs: int = 4096,
                  microbatch: int = 64, slo_ms: float = None,
                  process: ArrivalProcess = None, warmup: bool = True,
                  pipeline_depth: int = 2,
                  seed: Optional[int] = None) -> StreamingReport:
    """Sustained-load run: feed ``jobs`` open arrivals, measure.

    ``warmup=True`` books one throwaway microbatch on a scratch engine
    first (the kernels build and load at first use, which must not count
    as sustained time).  Default ``slo_ms`` is 4x the workload's serial
    work estimate over the flight.
    """
    if jobs < 1:
        raise ValueError(f"jobs must be >= 1, got {jobs}")
    if process is None:
        process = PoissonArrivals(sim.rate_hz, seed=sim.seed + 29)
    if slo_ms is None:
        slo_ms = 4.0 * sim.wl.work_est_ws * 1000.0 / max(sim.flight, 1)
    if warmup:
        w = StreamingScheduler(sim, microbatch=microbatch,
                               pipeline_depth=pipeline_depth, seed=seed)
        w.submit(np.linspace(1.0, 2.0, microbatch))
        w.drain()
    eng = StreamingScheduler(sim, microbatch=microbatch,
                             pipeline_depth=pipeline_depth, seed=seed)
    t0 = time.perf_counter()
    left = jobs
    last_ms = 0.0
    while left > 0:
        batch = process.take(min(microbatch, left))
        last_ms = float(batch[-1])
        eng.submit(batch)
        left -= batch.size
    resp, ok = eng.drain()
    wall = time.perf_counter() - t0
    good = resp[ok]
    viol = float(np.mean(~ok | (resp > slo_ms)))
    return StreamingReport(
        jobs=int(resp.size), ok_frac=float(np.mean(ok)), wall_s=wall,
        jobs_per_s=resp.size / wall,
        mean_ms=float(good.mean()) if good.size else float("nan"),
        p50_ms=float(np.percentile(good, 50)) if good.size else float("nan"),
        p99_ms=float(np.percentile(good, 99)) if good.size else float("nan"),
        slo_ms=float(slo_ms), slo_violation_frac=viol,
        horizon_ms=last_ms,
        offered_rate_hz=1000.0 * resp.size / last_ms if last_ms else 0.0)


def stock_open_sojourns(sim: QueueFlightSim, arrivals_ms,
                        seed: int = 0) -> np.ndarray:
    """Idealized stock (task-FCFS, no racing) sojourns on an external
    arrival stream — the reference column of the streaming SLO table.

    A host discrete-event M/G/c: each arriving job expands to its stock
    graph's tasks (dep-free graphs only), every task is served FCFS on
    the earliest-free worker with a fresh service draw (the workload's
    dist/cv + offset) plus a Table-6 lognormal control-plane overhead;
    the job's sojourn is its last task finish minus arrival.  This is the
    law of the stock engine for dep-free manifests, not its draw stream.
    """
    wl = sim.wl
    sg = wl.stock_graph()
    if sg.has_deps:
        raise ValueError(
            "stock_open_sojourns handles dep-free stock graphs only; "
            f"{wl.name!r} has staged dependencies — use the whole-trace "
            "stock engine")
    arr = np.asarray(arrivals_ms, dtype=np.float64)
    rng = np.random.default_rng(seed)
    K = sg.K
    means = np.asarray(sg.means, dtype=np.float64)
    extras = np.asarray(wl.stock_extras(), dtype=np.float64)

    def unit(n):
        if wl.dist == "exp":
            return rng.exponential(size=n)
        if wl.dist == "pareto":
            alpha = 1.0 + np.sqrt(1.0 + 1.0 / (wl.cv * wl.cv))
            xm = (alpha - 1.0) / alpha
            return xm * rng.uniform(size=n) ** (-1.0 / alpha)
        sigma2 = np.log1p(wl.cv * wl.cv)
        return np.exp(-sigma2 / 2 + np.sqrt(sigma2) * rng.normal(size=n))

    svc = means[None, :] * unit((arr.size, K)) + wl.offset_ms
    svc += extras[None, :] * unit((arr.size, K))
    oh = np.exp(sim.oh_mu + sim.oh_sigma * rng.normal(size=(arr.size, K)))
    free = np.zeros(sim.W)
    resp = np.empty(arr.size)
    for j in range(arr.size):
        fin_max = 0.0
        for k in range(K):
            w = int(np.argmin(free))
            start = max(arr[j], free[w]) + oh[j, k]
            fin = start + svc[j, k]
            free[w] = fin
            fin_max = max(fin_max, fin)
        resp[j] = fin_max - arr[j]
    return resp
