"""The paper's experiments: one function per table/figure.

The port of ``repro/sim/experiments.py``.  The scalar paths (Table 6,
Table 7, Figure 8, and ``engine="scalar"`` of Figures 6-7 and the
workflow bank) run the numpy oracle :class:`repro_torch.sim.flights
.FlightSim` and return the reference's output exactly at the same seeds.
The vector paths run the port's engines — the closed-loop grids through
:mod:`repro_torch.sim.sweeps`, so ``queue_booking`` books and
``maxplus_scan`` scans every configuration of a grid in one batch — on
the CUDA card unless ``device`` says otherwise; without a card and
without ``device`` they raise.  ``engine="vector"`` never falls back to
the scalar oracle: the oracle runs only when the caller asks for it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.analytics import (forkjoin_failure, raptor_failure,
                                        raptor_failure_exact,
                                        response_ratio_paper, summarize)
from repro_torch.sim.cluster import Cluster
from repro_torch.sim.flights import FlightSim
from repro_torch.sim.workloads import (arrival_rate_hz, etl_workload,
                                       keygen_workload, mapreduce_workload,
                                       reliability_workload,
                                       thumbnail_workload,
                                       wordcount_workload)

HA = dict(num_workers=15, num_azs=3)
LOW_AVAIL = dict(num_workers=5, num_azs=1)
ENGINES = ("vector", "scalar")


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


def rate_for(wl, deployment: Dict, load: str) -> float:
    return arrival_rate_hz(wl.work_est_ws, deployment["num_workers"], load)


def summarize_jobs(jobs) -> dict:
    """Delay summary conditioned on SUCCESS, failure accounting alongside.

    A failed job's "response" is the failure-*detection* time (when the
    last member gave up), not a delay a client would see.  ``n`` counts
    the successful jobs summarized; ``fail_rate`` is over ALL jobs and
    ``n_failed`` is reported so nothing is silently dropped.  The vector
    engines' ``summary()`` follows the same convention.
    """
    ok = [j.response for j in jobs if j.ok]
    if ok:
        s = summarize(ok)
    else:
        nan = float("nan")
        s = dict(mean=nan, median=nan, p90=nan, p99=nan, scv=nan, n=0)
    s["fail_rate"] = float(np.mean([not j.ok for j in jobs])) if jobs else 0.0
    s["n_failed"] = int(sum(not j.ok for j in jobs))
    return s


def run_pair(wl_fn, deployment: Dict, *, load: str = "medium",
             duration_s: float = 1800.0, seed: int = 0,
             rho: float = 0.95, rotate: bool = True) -> Dict[str, dict]:
    """Simulate a workload with and without Raptor on the scalar oracle;
    returns summary stats (delay stats success-conditioned, see
    :func:`summarize_jobs`)."""
    out = {}
    for raptor in (False, True):
        cl = Cluster(rho=rho, seed=seed, **deployment)
        wl = wl_fn()
        sim = FlightSim(cl, wl, raptor=raptor,
                        arrival_rate_hz=rate_for(wl, deployment, load),
                        duration_s=duration_s, load=load, seed=seed,
                        rotate=rotate)
        jobs = sim.run()
        s = summarize_jobs(jobs)
        s["work_mean"] = float(np.mean([j.work_ms for j in jobs]))
        out["raptor" if raptor else "stock"] = s
    out["mean_ratio"] = out["raptor"]["mean"] / out["stock"]["mean"]
    return out


def table6_overhead(n: int = 20000, seed: int = 0) -> Dict:
    """Control-plane overhead medians/p90s per (availability, load)."""
    rows = {}
    for ha, label in ((True, "three_az"), (False, "one_az")):
        cl = Cluster(seed=seed, **(HA if ha else LOW_AVAIL))
        for load in ("low", "medium", "high"):
            s = cl.sample_overhead(load, n)
            rows[f"{label}/{load}"] = {
                "median": float(np.median(s)),
                "p90": float(np.percentile(s, 90)),
            }
    return rows


def table7_keygen(seed: int = 0, duration_s: float = 1800.0) -> Dict:
    """SSH keygen on the HA deployment at moderate load (+ theory check)."""
    res = run_pair(keygen_workload, HA, load="medium", seed=seed,
                   duration_s=duration_s)
    res["theory_ratio"] = response_ratio_paper()
    return res


def fig6_scale_effect(seed: int = 0, duration_s: float = 1800.0,
                      engine: str = "vector", jobs: int = None,
                      trials: int = 32, device=None) -> Dict:
    """Raptor benefit vs deployment scale and load (the paper's headline).

    Low-availability 1-AZ/5-worker: replicas co-located -> correlated ->
    ~no benefit.  HA 3-AZ/15-worker: independent -> ~2/3 ratio.

    ``engine="vector"`` (default) replays the closed-loop batched queue
    engine: per deployment, the three loads in one batch
    (:func:`repro_torch.sim.vector_queue.load_sweep`).  One vector *trial*
    is one ``duration_s``-long arrival stream (``jobs`` overrides the
    derived per-trial stream length).  ``engine="scalar"`` runs the
    event-driven oracle.
    """
    _check_engine(engine)
    out = {}
    if engine == "vector":
        from repro_torch.sim.vector_queue import keygen_queue, load_sweep
        device = resolve_device(device)
        for name, dep in (("one_az_5w", LOW_AVAIL), ("three_az_15w", HA)):
            n = jobs if jobs is not None else fig6_jobs(dep, duration_s)
            res = load_sweep(keygen_queue(), num_workers=dep["num_workers"],
                             num_azs=dep["num_azs"], jobs=n,
                             trials=trials, seed=seed, device=device)
            for load, pair in res.items():
                out[f"{name}/{load}"] = pair
        return out
    for name, dep in (("one_az_5w", LOW_AVAIL), ("three_az_15w", HA)):
        for load in ("low", "medium", "high"):
            wl0 = keygen_workload()
            hz = rate_for(wl0, dep, load)
            res = {}
            for raptor in (False, True):
                cl = Cluster(rho=0.95, seed=seed, **dep)
                sim = FlightSim(cl, keygen_workload(), raptor=raptor,
                                arrival_rate_hz=hz, duration_s=duration_s,
                                load=load, seed=seed)
                res["raptor" if raptor else "stock"] = summarize_jobs(
                    sim.run())
            res["mean_ratio"] = res["raptor"]["mean"] / res["stock"]["mean"]
            out[f"{name}/{load}"] = res
    return out


def fig6_jobs(deployment: Dict, duration_s: float = 1800.0) -> int:
    """Jobs in one vector trial of :func:`fig6_scale_effect`: one
    ``duration_s``-long keygen stream at medium load, at least 256."""
    return max(256, int(rate_for(keygen_workload(), deployment, "medium")
                        * duration_s))


def fig7_other_workloads(seed: int = 0, duration_s: float = 1800.0,
                         engine: str = "vector", jobs: int = None,
                         trials: int = 16, load: str = "medium",
                         device=None) -> Dict:
    """Wordcount + thumbnail DAG manifests (paper fig 7), HA deployment.

    The vector engine replays the DAG dependency masks on the device (one
    trial = one ``duration_s``-long arrival stream unless ``jobs`` is
    given); the scalar path is the agreement oracle.  ``load`` selects
    the utilisation/overhead regime.
    """
    _check_engine(engine)
    if engine == "vector":
        from repro_torch.sim.vector_queue import (QueueFlightSim,
                                                  thumbnail_queue,
                                                  wordcount_queue)
        device = resolve_device(device)
        out = {}
        for name, qwl in (("wordcount", wordcount_queue()),
                          ("thumbnail", thumbnail_queue())):
            sim = QueueFlightSim(qwl, load=load, seed=seed, device=device,
                                 **HA)
            n = jobs if jobs is not None else max(
                256, int(sim.rate_hz * duration_s))
            out[name] = sim.run_pair(n, trials)
        return out
    return {
        "wordcount": run_pair(wordcount_workload, HA, seed=seed,
                              duration_s=duration_s, load=load),
        "thumbnail": run_pair(thumbnail_workload, HA, seed=seed,
                              duration_s=duration_s, load=load),
    }


def workflow_bank(seed: int = 0, duration_s: float = 600.0,
                  engine: str = "vector", jobs: int = None,
                  trials: int = 8, load: str = "medium",
                  streaming: bool = True, device=None) -> Dict:
    """The spec-compiled workload bank end to end: the multi-stage ETL
    pipeline (conditional poison-job quarantine behind the ``validate``
    guard) and the ranked map-reduce with a sync barrier, each compiled by
    :mod:`repro_torch.core.workflow` and replayed through every engine.

    ``engine="vector"`` (default) runs the closed-loop batched queue
    engine and — when ``streaming=True`` — the open-arrival streaming
    scheduler with its block=1 oracle identity check; ``"scalar"`` runs
    the event-driven oracle.  Each row carries the graph's
    ``manifest_hash``.
    """
    _check_engine(engine)
    banks = (("etl", etl_workload), ("mapreduce", mapreduce_workload))
    if engine == "scalar":
        out = {}
        for name, wl_fn in banks:
            res = run_pair(wl_fn, HA, seed=seed, duration_s=duration_s,
                           load=load)
            res["manifest_hash"] = wl_fn().graph.manifest_hash
            out[name] = res
        return out
    from repro_torch.sim.streaming import oracle_check, run_open_load
    from repro_torch.sim.vector_queue import (QueueFlightSim, etl_queue,
                                              mapreduce_queue)
    device = resolve_device(device)
    out = {}
    for name, _ in banks:
        qwl = etl_queue() if name == "etl" else mapreduce_queue()
        sim = QueueFlightSim(qwl, load=load, seed=seed, device=device, **HA)
        n = jobs if jobs is not None else max(
            256, int(sim.rate_hz * duration_s))
        res = sim.run_pair(n, trials)
        res["manifest_hash"] = qwl.graph.manifest_hash
        if streaming:
            rep = run_open_load(sim, jobs=min(n, 1024), microbatch=64,
                                seed=seed)
            res["streaming"] = {
                "jobs_per_s": rep.jobs_per_s, "mean_ms": rep.mean_ms,
                "p99_ms": rep.p99_ms, "ok_frac": rep.ok_frac,
            }
            res["streaming_bitwise_oracle"] = oracle_check(
                sim, n_steps=3, microbatch=32)["bitwise"]
        out[name] = res
    return out


def load_sweep_util(utils=(0.15, 0.3, 0.45, 0.6, 0.75, 0.9), seed: int = 0,
                    jobs: int = 1024, trials: int = 16,
                    devices=None, device=None) -> Dict:
    """Closed-loop keygen ratio across a *continuous* utilisation grid.

    A thin plan over :mod:`repro_torch.sim.sweeps`: the arrival rate is a
    per-configuration knob of the queue engine, so the whole grid of one
    deployment is one batch per engine.  Overheads use the Table-6 regime
    nearest each utilisation.  At 0.9 the 1-AZ/5-worker deployment is
    saturated by the flights (raptor util > 1): its numbers there are
    only comparable as backlog growth rates, not as steady-state means.
    """
    from repro_torch.sim.vector_queue import keygen_queue, rate_sweep
    device = resolve_device(device)
    out: Dict[str, dict] = {}
    for name, dep in (("one_az_5w", LOW_AVAIL), ("three_az_15w", HA)):
        wl = keygen_queue()
        rates = [u * dep["num_workers"] / wl.work_est_ws for u in utils]
        loads = ["low" if u < 0.3 else ("medium" if u < 0.6 else "high")
                 for u in utils]
        res = rate_sweep(wl, rates, loads=loads,
                         num_workers=dep["num_workers"],
                         num_azs=dep["num_azs"], jobs=jobs, trials=trials,
                         seed=seed, devices=devices, device=device)
        for u, pair in zip(utils, res):
            out[f"{name}/util{u:.2f}"] = pair
    return out


def sweep_scale(trials: int = 20000, seed: int = 0, devices=None,
                device=None) -> Dict:
    """Vectorized Monte-Carlo sweep across cluster scale.

    Covers the scalar runs' Table 7/8 territory and extends it with the
    curves the scalar sim is too slow to produce: Raptor's mean-delay
    ratio as the deployment grows 1→8 AZs and flights grow 2→16 members.
    All trials and order-statistics reductions run on the device
    (:mod:`repro_torch.sim.vector`); the AZ/flight grid goes through
    :func:`repro_torch.sim.vector.sweep_pairs`.
    """
    from repro_torch.core.analytics import (raptor_plateau_prediction,
                                            raptor_speedup_prediction)
    from repro_torch.sim.vector import (VectorFlightSim, exponential_vector,
                                        keygen_vector, reliability_vector,
                                        sweep_pairs)
    device = resolve_device(device)
    out: Dict[str, dict] = {}

    # Table 7: keygen on the HA deployment (open-loop limit) + theory
    sim = VectorFlightSim(keygen_vector(), num_azs=3, flight=2, seed=seed,
                          device=device)
    out["table7_keygen"] = sim.run_pair(trials)
    out["table7_keygen"]["theory_ratio"] = response_ratio_paper()

    # Table 8: the keygen ratio across the three Table-6 overhead regimes
    for load in ("low", "medium", "high"):
        s = VectorFlightSim(keygen_vector(), num_azs=3, flight=2, load=load,
                            seed=seed, device=device)
        out[f"table8/{load}"] = s.run_pair(trials)

    # AZ sweep 1→8 (flight of 4) and flight sweep 2→16 (8 AZs): the whole
    # grid runs pad-and-masked through sweep_pairs
    az_points = [dict(flight=4, num_azs=a) for a in (1, 2, 3, 4, 6, 8)]
    fl_points = [dict(flight=f, num_azs=8) for f in (2, 4, 8, 16)]
    wl = exponential_vector(2, 1000.0)
    res = sweep_pairs(wl, az_points + fl_points, trials=trials, seed=seed,
                      devices=devices, device=device)
    az_res, fl_res = res[:len(az_points)], res[len(az_points):]
    out["az_sweep"] = {
        "ratio_by_azs": {c["num_azs"]: r["mean_ratio"]
                         for c, r in zip(az_points, az_res)},
        "theory_independent": raptor_speedup_prediction(num_tasks=2,
                                                        flight=4),
    }
    out["flight_sweep"] = {
        c["flight"]: {
            "mean_ratio": r["mean_ratio"],
            "theory": raptor_speedup_prediction(num_tasks=2,
                                                flight=c["flight"]),
            "theory_corrected": raptor_plateau_prediction(
                num_tasks=2, flight=c["flight"]),
        } for c, r in zip(fl_points, fl_res)}

    # paper-gap probe: at F >> K the measured ratio plateaus far above the
    # K*E[min_F]/E[max_K] prediction and onto the corrected
    # K*E[min_{F/K}]/E[max_K] form (effective race width F/K)
    rnd = VectorFlightSim(exponential_vector(2, 1000.0), num_azs=8,
                          flight=16, rho=0.95, seed=seed,
                          sequences="random", device=device)
    out["flight_sweep_random"] = {
        "flight": 16,
        "mean_ratio": rnd.run_pair(trials)["mean_ratio"],
        "cyclic_ratio": out["flight_sweep"][16]["mean_ratio"],
        "theory": raptor_speedup_prediction(num_tasks=2, flight=16),
        "theory_corrected": raptor_plateau_prediction(num_tasks=2,
                                                      flight=16),
    }

    # Figure 8 at vector scale: empirical flight failure vs the exact form
    rel = {}
    for n_tasks in (2, 4, 8):
        for p in (0.1, 0.2, 0.3):
            s = VectorFlightSim(reliability_vector(n_tasks, p), num_azs=3,
                                flight=n_tasks, seed=seed, device=device)
            r = s.run(trials, raptor=True)
            rel[f"n{n_tasks}/p{p}"] = {
                "raptor_fail": r.fail_rate(),
                "theory_exact": raptor_failure_exact(p, n_tasks),
            }
    out["reliability"] = rel
    return out


def fig8_reliability(seed: int = 0, n_jobs_s: float = 600.0) -> Dict:
    """Job vs task failure probability, N parallel tasks (scalar oracle)."""
    out = {}
    for n_tasks in (2, 4, 8):
        for p in (0.05, 0.1, 0.2, 0.3):
            wl = lambda: reliability_workload(n_tasks, p)  # noqa: E731
            res = run_pair(wl, HA, load="low", duration_s=n_jobs_s,
                           seed=seed)
            out[f"n{n_tasks}/p{p}"] = {
                "stock_fail": res["stock"]["fail_rate"],
                "raptor_fail": res["raptor"]["fail_rate"],
                "theory_stock": forkjoin_failure(p, n_tasks),
                "theory_raptor": raptor_failure(p, n_tasks),
                "theory_raptor_exact": raptor_failure_exact(p, n_tasks),
            }
    return out


def fault_sweep(seed: int = 0, trials: int = 40_000,
                mc_samples: int = 20_000, jobs: int = 1024,
                queue_trials: int = 16, device=None, **sim_kw) -> Dict:
    """Independence-prediction hold vs break under AZ brownouts.

    The §4.2.1 speedup predictions assume mutually independent member
    executions.  This sweep injects the same stationary brownout mixture
    twice — per-AZ i.i.d. processes vs ONE shared (correlated) process —
    and holds the independence-assuming mixture prediction
    (:func:`repro_torch.core.analytics.mixture_speedup_prediction`)
    against the measured open-loop mean ratio: under i.i.d. brownouts it
    tracks the measurement; under correlated ones the whole flight
    inflates together and the measured ratio pulls away.

    A closed-loop row repeats the comparison with queueing (keygen on the
    HA deployment, ``jobs`` x ``queue_trials``; the reference fixes
    1,024 x 16) where correlation also feeds back through the backlog,
    and a recovery-policy row shows timeout+retry clawing back part of
    the correlated-tail damage.  ``sim_kw`` (``summary_backend``, ...) go
    to those rows' :class:`QueueFlightSim`.
    """
    from repro_torch.core.analytics import mixture_speedup_prediction
    from repro_torch.sim.faults import FaultProfile
    from repro_torch.sim.policies import RecoveryPolicy
    from repro_torch.sim.vector import VectorFlightSim, exponential_vector
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue
    device = resolve_device(device)

    mean_ms, K, F = 1000.0, 2, 2
    base = dict(az_mtbf_ms=24_000.0, az_mttr_ms=6_000.0,
                degraded_inflation=3.0)
    pi = FaultProfile(**base).stationary_degraded
    out: Dict[str, dict] = {"profile": dict(base, stationary_degraded=pi)}

    # open-loop: prediction vs measured, both brownout regimes
    pred = mixture_speedup_prediction(
        K, F, p_deg=pi, inflation=base["degraded_inflation"],
        n_samples=mc_samples, seed=seed)
    for tag, corr in (("iid", False), ("correlated", True)):
        fp = FaultProfile(correlated=corr, **base)
        wl = exponential_vector(K, mean_ms, faults=fp)
        pair = VectorFlightSim(wl, num_azs=3, flight=F, load="low",
                               seed=seed, device=device).run_pair(trials)
        out[f"open_loop/{tag}"] = {
            "measured_ratio": pair["mean_ratio"],
            "predicted_ratio": pred,
            "rel_err": abs(pair["mean_ratio"] - pred) / pred,
            "raptor": pair["raptor"], "stock": pair["stock"],
        }

    # closed-loop keygen: correlation also feeds the backlog; a recovery
    # policy (timeout + retry) trims the correlated tail
    pol = RecoveryPolicy(timeout_ms=6_000.0, max_retries=1,
                         backoff_ms=50.0)
    for tag, corr in (("iid", False), ("correlated", True)):
        fp = FaultProfile(correlated=corr, **base)
        sim = QueueFlightSim(keygen_queue(faults=fp), load="medium",
                             seed=seed, device=device, **sim_kw)
        out[f"closed_loop/{tag}"] = sim.run_pair(jobs, queue_trials)
        simp = QueueFlightSim(keygen_queue(faults=fp, recovery=pol),
                              load="medium", seed=seed, device=device,
                              **sim_kw)
        out[f"closed_loop_policy/{tag}"] = simp.run_pair(jobs, queue_trials)
    return out
