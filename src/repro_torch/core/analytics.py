"""Order-statistics theory, batch reductions and Monte-Carlo helpers.

The port of ``repro/core/analytics.py``.  For i.i.d. exponential task
times Z_i with mean 1:

  E[min of n]  = 1/n
  E[max of n]  = H_n (harmonic number)
  paper's prediction for the 2-task / flight-2 SSH workload:
      E[T_Raptor] / E[T_OpenWhisk] = 2 E[min(Z1,Z2)] / E[max(Z1,Z2)] = 2/3.

Failure model (Figure 8): task failure probability p, N parallel tasks:
  fork-join job failure      = 1 - (1-p)^N      (all must succeed)
  Raptor flight job failure  = p^N              (any one suffices)

The batch reductions take and return tensors on the samples' device, so
a run can summarize without a host round trip; ``torch.quantile``
interpolates linearly between order statistics, as ``jnp.percentile``
and numpy do.  The Monte-Carlo helpers (:func:`mc_flight_time`, the
brownout-mixture predictions) are numpy, as in the reference, and give
its numbers at the same seed.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def harmonic(n: int) -> float:
    return sum(1.0 / i for i in range(1, n + 1))


def e_min_exp(n: int, mean: float = 1.0) -> float:
    return mean / n


def e_max_exp(n: int, mean: float = 1.0) -> float:
    return mean * harmonic(n)


def raptor_speedup_prediction(num_tasks: int, flight: int) -> float:
    """E[T_Raptor]/E[T_baseline] for `num_tasks` independent exp(1) tasks.

    Raptor races the whole flight task-by-task (each task completes at the
    min over `flight` executors, tasks in series); the baseline fork-join
    waits for the max over the parallel tasks.
    """
    t_raptor = num_tasks * e_min_exp(flight)
    t_base = e_max_exp(num_tasks)
    return t_raptor / t_base


def raptor_plateau_prediction(num_tasks: int, flight: int) -> float:
    """Corrected F>>K plateau: K * E[min_{F/K}] / E[max_K].

    The paper's K*E[min_F]/E[max_K] form silently assumes all F members
    race every task in lockstep.  Under the §3.3.3 shifted sequences (or
    ANY admissible per-member order) the flight splits over the K tasks,
    so only ~F/K members race a given task concurrently — the effective
    race width is F/K, not F (EXPERIMENTS.md has the derivation; measured
    0.198 vs corrected 0.167 vs paper 0.083 at F=16, K=2).  For F <= K
    the split does not bind (finishers re-race the remaining tasks almost
    immediately) and the paper's form stays the better model — this
    function is the wide-flight asymptote, not a general replacement.
    """
    width = max(flight // num_tasks, 1)
    return num_tasks * e_min_exp(width) / e_max_exp(num_tasks)


def forkjoin_failure(p: float, n: int) -> float:
    return 1.0 - (1.0 - p) ** n


def raptor_failure(p: float, n: int) -> float:
    """The paper's Figure 8 expression: p^N (per-task replication bound)."""
    return p ** n


def raptor_failure_exact(p: float, n_tasks: int, flight: int = None) -> float:
    """Exact job failure for an N-task manifest on a flight of size F with
    error-broadcast semantics (§3.3.4): a task is lost only if all F
    attempts error; the job fails if any task is lost.  The paper's p^N is
    the single-task term; the sim matches this exact form (see
    tests/test_sim_repro.py)."""
    f = flight if flight is not None else n_tasks
    return 1.0 - (1.0 - p ** f) ** n_tasks


def response_ratio_paper() -> float:
    """The paper's headline number: 2*E[min]/E[max] = 1/1.5 ~ 0.67."""
    return raptor_speedup_prediction(num_tasks=2, flight=2)


# --------------------------------------------------------------------------
# batched reductions on tensors — used by the vector engines
# --------------------------------------------------------------------------

def _as_float(samples) -> torch.Tensor:
    a = torch.as_tensor(samples)
    return a if a.is_floating_point() else a.to(torch.float32)


def summarize_batch(samples):
    """Mean, median, p90, p99, squared coefficient of variation and count
    of a 1-D sample batch; one fused quantile call (one device sort)."""
    a = _as_float(samples).reshape(-1)
    mean = a.mean()
    qs = torch.quantile(a, torch.tensor([0.5, 0.9, 0.99], dtype=a.dtype,
                                        device=a.device))
    return {
        "mean": mean,
        "median": qs[0],
        "p90": qs[1],
        "p99": qs[2],
        "scv": a.var(unbiased=False) / (mean * mean + 1e-12),
        "n": a.numel(),
    }


def summarize_masked_batch(samples, ok):
    """Success-conditioned :func:`summarize_batch`.

    Failed jobs' "responses" are failure-detection times, not delays, so
    the delay statistics condition on ``ok``; ``fail_rate`` and
    ``n_failed`` account for the rest.  Percentiles sort with failures
    pushed to +inf and interpolate linearly over the first ``n_ok`` order
    statistics.  With ``n_ok == 0`` the delay statistics are NaN and
    ``n`` is 0.
    """
    a = _as_float(samples).reshape(-1)
    m = torch.as_tensor(ok, device=a.device).reshape(-1).to(torch.bool)
    n_ok = m.sum()
    denom = torch.clamp(n_ok, min=1)
    s = torch.sort(torch.where(m, a, torch.inf)).values
    nan = torch.tensor(float("nan"), dtype=a.dtype, device=a.device)

    def q(p):
        idx = p / 100.0 * (denom - 1).to(a.dtype)
        lo = torch.clamp(torch.floor(idx).long(), 0, a.numel() - 1)
        hi = torch.clamp(torch.ceil(idx).long(), 0, a.numel() - 1)
        w = idx - lo.to(a.dtype)
        return torch.where(n_ok > 0, s[lo] * (1 - w) + s[hi] * w, nan)

    mean = torch.where(n_ok > 0, torch.where(m, a, 0.0).sum() / denom, nan)
    var = torch.where(m, (a - mean) ** 2, 0.0).sum() / denom
    return {
        "mean": mean,
        "median": q(50.0),
        "p90": q(90.0),
        "p99": q(99.0),
        "scv": var / (mean * mean + 1e-12),
        "n": n_ok,
        "fail_rate": 1.0 - n_ok / a.numel(),
        "n_failed": a.numel() - n_ok,
    }


def emp_min_mean(z, dim: int = -1):
    """E[min] estimate: mean over the batch of the min over ``dim``."""
    return _as_float(z).amin(dim=dim).mean()


def emp_max_mean(z, dim: int = -1):
    """E[max] estimate: mean over the batch of the max over ``dim``."""
    return _as_float(z).amax(dim=dim).mean()


def flight_fail_rate_batch(fail):
    """Job failure rate from a (trials, flight, tasks) attempt-error tensor.

    A task is lost only when every flight member's attempt errors (§3.3.4
    error-broadcast semantics); the job fails if any task is lost — the
    empirical counterpart of :func:`raptor_failure_exact`.
    """
    f = torch.as_tensor(fail).to(torch.bool)
    task_lost = f.all(dim=1)                # (trials, tasks)
    return task_lost.any(dim=-1).float().mean()


def forkjoin_fail_rate_batch(fail):
    """Stock fork-join failure rate from a (trials, tasks) error tensor:
    the job fails when any of its single-attempt tasks errors."""
    return torch.as_tensor(fail).to(torch.bool).any(dim=-1).float().mean()


def response_ratio_batch(t_raptor, t_stock):
    """Mean-response ratio E[T_Raptor]/E[T_stock] from two sample batches."""
    return _as_float(t_raptor).mean() / _as_float(t_stock).mean()


# --------------------------------------------------------------------------
# empirical helpers
# --------------------------------------------------------------------------

def summarize(samples: Sequence[float]) -> dict:
    a = np.asarray(samples, dtype=np.float64)
    return {
        "mean": float(a.mean()),
        "median": float(np.median(a)),
        "p90": float(np.percentile(a, 90)),
        "p99": float(np.percentile(a, 99)),
        "scv": float(a.var() / (a.mean() ** 2 + 1e-12)),
        "n": int(a.size),
    }


def mc_flight_time(num_tasks: int, flight: int, n_samples: int = 200_000,
                   rotated: bool = True, seed: int = 0) -> dict:
    """Monte-Carlo of the flight completion time under exp(1) tasks.

    rotated=True models the paper's cyclic-shift sequences with state
    sharing: the flight finishes when the union of per-executor progress
    covers every task (each executor skips tasks already broadcast).
    rotated=False models pure task-by-task racing: sum of min-order stats.
    """
    rng = np.random.default_rng(seed)
    if not rotated:
        t = rng.exponential(size=(n_samples, num_tasks, flight))
        t = t.min(axis=2).sum(axis=1)
        return summarize(t)
    # event-driven per sample with true preemption: when a task first
    # completes anywhere, members currently running it are preempted at
    # that instant and immediately start their next pending task.
    times = np.empty(n_samples)
    seqs = [list(np.roll(np.arange(num_tasks), -e)) for e in range(flight)]
    z = rng.exponential(size=(n_samples, flight, 2 * num_tasks + 2))
    for s in range(n_samples):
        completed: dict = {}
        draw_i = [0] * flight
        cur = [None] * flight          # (task, finish_time) or None (idle)
        ptr = [0] * flight

        def start_next(e, now):
            while ptr[e] < num_tasks and seqs[e][ptr[e]] in completed:
                ptr[e] += 1
            if ptr[e] >= num_tasks:
                cur[e] = None
                return
            t_ = seqs[e][ptr[e]]
            cur[e] = (t_, now + z[s, e, draw_i[e]])
            draw_i[e] = min(draw_i[e] + 1, z.shape[2] - 1)
            ptr[e] += 1

        for e in range(flight):
            start_next(e, 0.0)
        while len(completed) < num_tasks:
            running = [(c[1], e) for e, c in enumerate(cur) if c is not None]
            if not running:
                break
            fin, e = min(running)
            task = cur[e][0]
            if task not in completed:
                completed[task] = fin
                # preempt peers running this task
                for pe, c in enumerate(cur):
                    if pe != e and c is not None and c[0] == task:
                        start_next(pe, fin)
            start_next(e, fin)
        times[s] = max(completed.values()) if completed else 0.0
    return summarize(times)


# --------------------------------------------------------------------------
# independence-prediction under a brownout mixture (sim/faults.py)
# --------------------------------------------------------------------------
# The paper's §4.2.1 predictions treat the flight members' service times as
# mutually independent.  Under AZ brownouts the stationary marginal is a
# MIXTURE — with probability pi the member's AZ is degraded and its draws
# inflate — and the independence assumption becomes a claim about the
# degradation indicators: with per-AZ (i.i.d.) brownouts the mixture draws
# stay independent across members and the order-statistics prediction
# still holds; with one shared (correlated) process every member degrades
# together and the prediction breaks (experiments.fault_sweep measures
# exactly this gap against the open-loop engine).

def _mixture_draws(rng, shape, dist: str, mean: float, cv: float,
                   offset: float):
    if dist == "exp":
        z = rng.exponential(mean, shape)
    elif dist == "lognorm":
        sigma2 = math.log(1.0 + cv * cv)
        mu = math.log(mean) - sigma2 / 2.0
        z = rng.lognormal(mu, math.sqrt(sigma2), shape)
    else:
        raise ValueError(f"unknown dist {dist!r}")
    return z + offset


def mc_flight_time_mixture(num_tasks: int, flight: int, *,
                           p_deg: float = 0.0, inflation: float = 1.0,
                           correlated: bool = False, dist: str = "exp",
                           mean: float = 1.0, cv: float = 1.0,
                           offset: float = 0.0, n_samples: int = 20_000,
                           seed: int = 0) -> dict:
    """Raptor flight completion time under the brownout service mixture.

    Each member's AZ is degraded with probability ``p_deg`` (the CTMC's
    stationary point, :attr:`FaultProfile.stationary_degraded`), inflating
    every draw it serves by ``inflation`` for the whole invocation (the
    open-loop stationary-snapshot semantics).  ``correlated=False`` draws
    the indicators i.i.d. per member — the independence prediction;
    ``correlated=True`` shares ONE indicator across the flight — the
    regime the prediction cannot see.  Same cyclic-shift event-driven
    race as :func:`mc_flight_time`.
    """
    rng = np.random.default_rng(seed)
    nd = 2 * num_tasks + 2
    z = _mixture_draws(rng, (n_samples, flight, nd), dist, mean, cv, offset)
    deg = rng.random((n_samples, 1 if correlated else flight)) < p_deg
    z = z * np.where(deg, inflation, 1.0)[:, :, None]
    times = np.empty(n_samples)
    seqs = [list(np.roll(np.arange(num_tasks), -e)) for e in range(flight)]
    for s in range(n_samples):
        completed: dict = {}
        draw_i = [0] * flight
        cur = [None] * flight
        ptr = [0] * flight

        def start_next(e, now):
            while ptr[e] < num_tasks and seqs[e][ptr[e]] in completed:
                ptr[e] += 1
            if ptr[e] >= num_tasks:
                cur[e] = None
                return
            t_ = seqs[e][ptr[e]]
            cur[e] = (t_, now + z[s, e, draw_i[e]])
            draw_i[e] = min(draw_i[e] + 1, nd - 1)
            ptr[e] += 1

        for e in range(flight):
            start_next(e, 0.0)
        while len(completed) < num_tasks:
            running = [(c[1], e) for e, c in enumerate(cur) if c is not None]
            if not running:
                break
            fin, e = min(running)
            task = cur[e][0]
            if task not in completed:
                completed[task] = fin
                for pe, c in enumerate(cur):
                    if pe != e and c is not None and c[0] == task:
                        start_next(pe, fin)
            start_next(e, fin)
        times[s] = max(completed.values()) if completed else 0.0
    return summarize(times)


def mc_forkjoin_mixture(num_tasks: int, *, p_deg: float = 0.0,
                        inflation: float = 1.0, correlated: bool = False,
                        dist: str = "exp", mean: float = 1.0,
                        cv: float = 1.0, offset: float = 0.0,
                        n_samples: int = 20_000, seed: int = 0) -> dict:
    """Stock fork-join completion (max over tasks) under the same service
    mixture — the denominator of the mixture speedup prediction.  Tasks
    spread round-robin over AZs, so per-task indicators are i.i.d. in the
    independent regime and shared in the correlated one."""
    rng = np.random.default_rng(seed)
    z = _mixture_draws(rng, (n_samples, num_tasks), dist, mean, cv, offset)
    deg = rng.random((n_samples, 1 if correlated else num_tasks)) < p_deg
    z = z * np.where(deg, inflation, 1.0)
    return summarize(z.max(axis=1))


def mixture_speedup_prediction(num_tasks: int, flight: int, *,
                               p_deg: float, inflation: float,
                               correlated: bool = False, dist: str = "exp",
                               mean: float = 1.0, cv: float = 1.0,
                               offset: float = 0.0,
                               n_samples: int = 20_000,
                               seed: int = 0) -> float:
    """E[T_Raptor]/E[T_stock] under the brownout mixture — the §4.2.1
    speedup prediction lifted to a degraded-but-independent cluster.  With
    ``correlated=False`` this is what an independence-assuming predictor
    forecasts; the fault_sweep experiment holds it against the measured
    ratio in both brownout regimes."""
    r = mc_flight_time_mixture(
        num_tasks, flight, p_deg=p_deg, inflation=inflation,
        correlated=correlated, dist=dist, mean=mean, cv=cv, offset=offset,
        n_samples=n_samples, seed=seed)
    s = mc_forkjoin_mixture(
        num_tasks, p_deg=p_deg, inflation=inflation, correlated=correlated,
        dist=dist, mean=mean, cv=cv, offset=offset, n_samples=n_samples,
        seed=seed + 1)
    return r["mean"] / s["mean"]
