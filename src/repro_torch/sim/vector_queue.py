"""Closed-loop vectorized cluster engine: batched worker queues and DAG
flights replayed on the device.

The port of ``repro/sim/vector_queue.py``.  Each trial replays a whole
Poisson arrival stream against a finite worker pool:

* raptor: every arriving job claims ``F`` workers (HA placement: a
  uniform-random free worker in an AZ the flight has not used, else any
  free worker; a queued member is handed the next-released worker), races
  its flight over the workflow graph's per-member sequences and
  dependency masks (:func:`dag_flight_trial`), and releases its workers;
* stock: the fork-join at TASK granularity — every job's per-task ready
  times are merged into one sorted stream per trial and booked best-fit
  in ready order; staged ready times come from a bounded fixed point over
  stage depth.

Fault mode (an enabled :class:`repro_torch.sim.faults.FaultProfile` or a
non-default :class:`repro_torch.sim.policies.RecoveryPolicy`): per-trial
brownout and crash interval tables are drawn once and read by every
booking; raptor places members health-first and folds each launch's
whole timeout/retry/backoff chain into its one race event; stock expands
every task into ``policy.stock_attempts`` attempt slots (retries and the
hedge copy) that join the one merged stream, their ready times
materialized by the same bounded fixed point as staged readies.

Both replays run on the blocked event-replay substrate
(:mod:`repro_torch.sim.scan_core`); ``block=1`` is the sequential oracle.
The trial axis is a leading batch dimension: one call books every trial.
Configuration sweeps (:func:`load_sweep`, :func:`rate_sweep`, through
:mod:`repro_torch.sim.sweeps`) give the trial bodies one arrival rate and
one Table-6 overhead lognormal per configuration: the configurations read
the same draws and stack as more rows of the one batch, so a sweep is its
per-configuration runs, bit for bit, and one kernel launch books
``configs x trials`` rows.
Draws come from an explicit ``torch.Generator`` seeded from ``seed``, so
the port matches the reference by distribution; fed the reference's
drawn events and fault tables (:mod:`repro_torch.sim.interop`), its
booking step is bitwise the reference's.

Backends: ``booking_backend`` "scan" (the substrate) or "kernel" (the
``queue_booking`` CUDA kernel) books the stock stream — fault mode needs
the substrate, as the reference's Pallas route refuses it;
``summary_backend`` "torch" or "kernel" (the ``maxplus_scan`` CUDA
kernel) runs the log-depth summary prefix, fault mode included.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.workflow import (WorkflowGraph, compile_spec, fanout,
                                       task)
from repro_torch.sim.cluster import OverheadModel, lognormal_params
from repro_torch.sim.faults import (FaultProfile, first_start_in,
                                    interval_active, push_out)
from repro_torch.sim.policies import (NO_RECOVERY, RecoveryPolicy,
                                      attempt_end, backoff_after,
                                      fault_statics, fold_chain)
from repro_torch.sim.scan_core import (blocked_bestfit_booking,
                                       blocked_event_replay,
                                       stock_booking_fins)
from repro_torch.sim.vector import (_cfg_col, host_summary, summary_row,
                                    unit_draws)
from repro_torch.sim.workloads import (ETL_QUARANTINE_MS, KEYGEN_CV,
                                       KEYGEN_OFFSET_MS, THUMB_CV,
                                       THUMB_DOWNLOAD_MS, WC_STORAGE_HOP_MS,
                                       etl_graph, keygen_graph,
                                       mapreduce_graph, thumbnail_graph,
                                       thumbnail_stock_graph, wordcount_graph)
from repro_torch.sim.workloads import arrival_rate_hz as _rate_for_load

_INF = float("inf")
BOOKING_BACKENDS = ("scan", "kernel")
SUMMARY_BACKENDS = ("torch", "kernel")


@dataclasses.dataclass(frozen=True)
class QueueWorkload:
    """One compiled manifest bound to the vector engines' service model.

    ``graph`` is the workflow compiler's IR: frozen and hashable, it is
    the static key of the cached trial factories.  The stock graph may
    differ (thumbnail's stock functions re-download the source, so its
    task list drops the shared download stage and each task pays
    ``stock_extra_means`` as a second service draw); conditionals are
    always flattened for stock.  ``faults``/``recovery`` (frozen,
    hashable) carry the fault environment and the recovery policy;
    ``QueueFlightSim`` keywords override them.
    """
    graph: WorkflowGraph
    flight: int
    dist: str = "exp"                       # "exp" | "lognorm" | "pareto"
    cv: float = 1.0
    offset_ms: float = 0.0
    raptor_stage_ms: float = 0.5            # stream hop per attempt
    stock: WorkflowGraph = None             # alternative stock-path graph
    stock_extra_means: Tuple[float, ...] = None
    stock_stage_ms: float = 0.0             # storage round-trip per stage hop
    fail_prob: float = 0.0
    work_est_ws: float = 2.0
    faults: FaultProfile = None
    recovery: RecoveryPolicy = None

    @property
    def name(self) -> str:
        return self.graph.name

    @property
    def tasks(self) -> Tuple[str, ...]:
        return self.graph.tasks

    @property
    def task_means(self) -> Tuple[float, ...]:
        return self.graph.means

    def stock_graph(self) -> WorkflowGraph:
        g = self.stock if self.stock is not None else self.graph
        return g.flatten()

    def stock_extras(self) -> Tuple[float, ...]:
        if self.stock_extra_means is None:
            return (0.0,) * self.stock_graph().K
        return self.stock_extra_means


def keygen_queue(fail_prob: float = 0.0, faults: FaultProfile = None,
                 recovery: RecoveryPolicy = None) -> QueueWorkload:
    """ssh-keygen: two independent entropy-bound tasks, flight of 2."""
    return QueueWorkload(
        keygen_graph(), flight=2,
        dist="lognorm", cv=KEYGEN_CV, offset_ms=KEYGEN_OFFSET_MS,
        fail_prob=fail_prob, work_est_ws=1.9,
        faults=faults, recovery=recovery)


def wordcount_queue(fail_prob: float = 0.0, faults: FaultProfile = None,
                    recovery: RecoveryPolicy = None) -> QueueWorkload:
    """Map-reduce: split -> 4 maps -> reduce; stock pays the S3 hop."""
    return QueueWorkload(wordcount_graph(), flight=2,
                         dist="exp", stock_stage_ms=WC_STORAGE_HOP_MS,
                         fail_prob=fail_prob, work_est_ws=4.2,
                         faults=faults, recovery=recovery)


def thumbnail_queue(fail_prob: float = 0.0, faults: FaultProfile = None,
                    recovery: RecoveryPolicy = None) -> QueueWorkload:
    """Download + 4 resizes; stock functions each re-download the source."""
    return QueueWorkload(
        thumbnail_graph(), flight=4,
        dist="lognorm", cv=THUMB_CV,
        stock=thumbnail_stock_graph(),
        stock_extra_means=(THUMB_DOWNLOAD_MS,) * 4,
        fail_prob=fail_prob, work_est_ws=5.6,
        faults=faults, recovery=recovery)


def etl_queue(rank: int = 6, fail_prob: float = 0.08,
              faults: FaultProfile = None,
              recovery: RecoveryPolicy = None) -> QueueWorkload:
    """Workload-bank ETL pipeline: a ``validate`` guard routes poison jobs
    to quarantine (the conditional mask-select path); ``fail_prob``
    doubles as the poison rate."""
    g = etl_graph(rank)
    work = (sum(g.means) - ETL_QUARANTINE_MS) / 1000.0
    return QueueWorkload(g, flight=3, dist="exp",
                         stock_stage_ms=WC_STORAGE_HOP_MS,
                         fail_prob=fail_prob, work_est_ws=work,
                         faults=faults, recovery=recovery)


def mapreduce_queue(rank: int = 4, reducers: int = 2,
                    fail_prob: float = 0.0,
                    faults: FaultProfile = None,
                    recovery: RecoveryPolicy = None) -> QueueWorkload:
    """Workload-bank ranked map-reduce with a sync barrier."""
    g = mapreduce_graph(rank, reducers)
    return QueueWorkload(g, flight=3, dist="exp",
                         stock_stage_ms=WC_STORAGE_HOP_MS,
                         fail_prob=fail_prob,
                         work_est_ws=sum(g.means) / 1000.0,
                         faults=faults, recovery=recovery)


def heavytail_queue(num_tasks: int = 2, mean_ms: float = 1000.0,
                    flight: int = 2, cv: float = 2.5, dist: str = "pareto",
                    fail_prob: float = 0.0,
                    faults: FaultProfile = None,
                    recovery: RecoveryPolicy = None) -> QueueWorkload:
    """Heavy-tailed service family for the streaming traffic bank:
    "pareto" or high-cv "lognorm", both unit-mean so ``work_est_ws`` and
    the load targets stay comparable with :func:`exponential_queue`."""
    if dist not in ("pareto", "lognorm"):
        raise ValueError(
            f"heavy-tail dist must be 'pareto' or 'lognorm', got {dist!r}")
    if cv <= 0.0:
        raise ValueError(f"cv must be positive, got {cv}")
    return QueueWorkload(
        compile_spec(fanout(task("t", mean_ms), num_tasks),
                     name=f"{dist}{num_tasks}"),
        flight=flight, dist=dist, cv=cv, fail_prob=fail_prob,
        work_est_ws=num_tasks * mean_ms / 1000.0,
        faults=faults, recovery=recovery)


def exponential_queue(num_tasks: int = 2, mean_ms: float = 1000.0,
                      flight: int = 2, fail_prob: float = 0.0,
                      faults: FaultProfile = None,
                      recovery: RecoveryPolicy = None) -> QueueWorkload:
    """Pure exp(mu) independent tasks — the §4.2.1 theory's hypothesis."""
    return QueueWorkload(
        compile_spec(fanout(task("t", mean_ms), num_tasks),
                     name=f"exp{num_tasks}"),
        flight=flight, dist="exp", fail_prob=fail_prob,
        work_est_ws=num_tasks * mean_ms / 1000.0,
        faults=faults, recovery=recovery)


# --------------------------------------------------------------------------
# one flight race with dependency masks (the DAG-aware event scan)
# --------------------------------------------------------------------------

def _pick(x, idx):
    """``x[..., idx]`` per leading index: the exact one-hot selection."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def dag_flight_trial(z_seq, fail_seq, t_join, seq, dep_mask, slat,
                     direct_start: bool = False, num_events: int = None,
                     no_failures: bool = False, recovery=None, cond=None,
                     has_deps: bool = None):
    """Replay flights of a (possibly DAG) manifest, batched over leading
    dimensions.

    ``z_seq`` ``(..., F, K)`` are each member's sequence-ordered attempt
    times, ``fail_seq`` ``(..., F, K)`` bool their injected errors,
    ``t_join`` ``(..., F)`` the members' join times; ``seq`` ``(F, K)`` the
    member sequences and ``dep_mask`` ``(K, K)`` bool (``dep_mask[t, d]``:
    task t needs task d), both on the device; ``slat`` the stream
    half-RTT.  A member whose next task has unmet dependencies parks
    (``fin = inf``) and is woken by the completion broadcast; member joins
    are events too (``cur = -1``) unless ``direct_start``.  ``num_events``
    overrides the trip count with a tighter exact budget;
    ``no_failures`` drops the attempted mask (error-free attempts end
    only when their task completes).  ``cond`` is the IR's conditional
    select pair ``(cond_guard, cond_sense)``: a guard completes on its
    first finished attempt, and the same event cancels the arm gated on
    the opposite outcome.  ``has_deps`` saves a device read of
    ``dep_mask`` when the caller knows it.

    ``recovery`` (optional) is the fault/policy bundle ``(policy, faults,
    base_fail, bs, be, cs, ce, u_err, u_jit)``: per-member brownout
    tables of the PLACED AZ (``(..., F, I)``), crash tables of the placed
    worker (``(..., F, C)``; contiguous and sorted, as drawn) and
    pre-drawn per-attempt uniforms (``(..., F, K, R+1)`` errors,
    ``(..., F, K, R)`` backoff jitter, by sequence position).  Each launch then folds its whole
    timeout/retry/backoff chain into its ONE race event
    (:func:`repro_torch.sim.policies.fold_chain`): retries re-run on the
    same worker with the same service draw, the member stays busy for the
    whole chain, and the first-success broadcast preempts a chain as a
    unit.  ``fail_seq`` is ignored in this mode.

    Returns ``(t_resp, ok, t_release)`` with per-member worker release
    times.
    """
    F, K = z_seq.shape[-2:]
    lead = tuple(z_seq.shape[:-2])
    dev = z_seq.device
    if recovery is not None:
        (r_pol, r_fp, r_base_fail, r_bs, r_be, r_cs, r_ce,
         u_err, u_jit) = recovery

        def chain(t0, z, u_e, u_j):
            return fold_chain(t0, z, u_e, u_j, r_bs, r_be, r_cs, r_ce,
                              policy=r_pol, faults=r_fp,
                              base_fail=r_base_fail)

        def at_position(u, j):
            # the uniforms of each member's j-th sequence position
            idx = j[..., None, None].expand(j.shape + (1, u.shape[-1]))
            return torch.gather(u, -2, idx)[..., 0, :]
    if has_deps is None:
        has_deps = bool(dep_mask.any())
    has_cond = cond is not None and any(g >= 0 for g in cond[0])
    if has_cond:
        guards = {g for g in cond[0] if g >= 0}
        c_gated = torch.tensor([g >= 0 for g in cond[0]], device=dev)
        c_guard = torch.tensor([max(g, 0) for g in cond[0]], device=dev)
        c_sense = torch.tensor([bool(s) for s in cond[1]], device=dev)
        c_is_guard = torch.tensor([k in guards for k in range(K)],
                                  device=dev)
    k_ar = torch.arange(K, device=dev)
    f_ar = torch.arange(F, device=dev)
    done = torch.zeros(lead + (K,), dtype=torch.bool, device=dev)
    released = torch.zeros(lead + (F,), dtype=torch.bool, device=dev)
    trel = torch.zeros(lead + (F,), dtype=z_seq.dtype, device=dev)
    attempted = torch.zeros(lead + (F, K), dtype=torch.bool, device=dev)
    if direct_start:
        attempted[..., 0] = True
        cur = seq[:, 0].expand(lead + (F,))
        if recovery is None:
            curfail = fail_seq[..., 0]
            fin = t_join + z_seq[..., 0]
        else:
            fin, curfail = chain(t_join, z_seq[..., 0], u_err[..., 0, :],
                                 u_jit[..., 0, :])
    else:
        cur = torch.full(lead + (F,), -1, dtype=seq.dtype, device=dev)
        curfail = torch.zeros(lead + (F,), dtype=torch.bool, device=dev)
        fin = t_join
    outcome = (torch.zeros(lead + (K,), dtype=torch.bool, device=dev)
               if has_cond else None)
    finished = torch.zeros(lead, dtype=torch.bool, device=dev)
    ok = torch.zeros(lead, dtype=torch.bool, device=dev)
    t_resp = torch.full(lead, _INF, dtype=z_seq.dtype, device=dev)
    seq_b = seq.expand(lead + (F, K))
    # F join events (unless direct_start) + at most F*K attempt completions
    steps = (int(num_events) if num_events is not None
             else (F * K if direct_start else F * (K + 1)))
    for _ in range(steps):
        t = fin.amin(dim=-1)
        e_idx = fin.argmin(dim=-1)
        e_hot = f_ar == e_idx[..., None]
        any_busy = ~torch.isinf(t)
        task = _pick(cur, e_idx)                      # -1 on a join event
        raw_ok = ~torch.any(curfail & e_hot, dim=-1)
        succ = any_busy & (task >= 0) & raw_ok
        t_hot = k_ar == task[..., None]
        if has_cond:
            # a guard's first finished attempt COMPLETES it either way;
            # the attempt's error bit becomes the recorded branch outcome
            ev_guard = torch.any(t_hot & c_is_guard, dim=-1)
            succ = succ | (any_busy & (task >= 0) & ev_guard)
            outcome = torch.where(t_hot & succ[..., None], raw_ok[..., None],
                                  outcome)
        done2 = done | (t_hot & succ[..., None])
        if has_cond:
            # mask-select: cancel the arm gated on the opposite outcome
            done2 = done2 | (c_gated & done2[..., c_guard]
                             & (outcome[..., c_guard] != c_sense))
        busy = ~torch.isinf(fin)
        # first-success broadcast preempts peers mid-`task` (§3.3.4)
        preempted = (succ[..., None] & (cur == task[..., None]) & busy
                     & ~e_hot)
        freed = (e_hot & any_busy[..., None]) | preempted
        busy_after = busy & ~freed
        idle = ~busy_after & ~released
        # next task per member: first in its shifted order neither
        # complete nor already attempted by this member (head-of-line)
        cand = ~done2[..., seq]
        if not no_failures:
            cand = cand & ~attempted
        has_next = torch.any(cand, dim=-1)
        j = cand.to(torch.uint8).argmax(dim=-1)
        nxt = _pick(seq_b, j)
        z_next = _pick(z_seq, j)
        can_start = idle & has_next
        if has_deps:
            can_start = can_start & ~torch.any(
                dep_mask[nxt] & ~done2[..., None, :], dim=-1)
        # the finisher chains immediately; preempted/woken members restart
        # after the stream half-RTT
        start = torch.where(e_hot, t[..., None], t[..., None] + slat)
        if recovery is None:
            fin_try, f_next = start + z_next, _pick(fail_seq, j)
        else:
            # the whole chain is ONE event on the member's placed worker;
            # only its final outcome is visible to peers (§3.3.4)
            fin_try, f_next = chain(start, z_next, at_position(u_err, j),
                                    at_position(u_jit, j))
        fin2 = torch.where(can_start, fin_try,
                           torch.where(busy_after, fin, _INF))
        cur2 = torch.where(can_start, nxt, torch.where(busy_after, cur, -1))
        curfail2 = torch.where(can_start, f_next, busy_after & curfail)
        if not no_failures:
            attempted = attempted | ((k_ar == j[..., None])
                                     & can_start[..., None])
        newly_rel = idle & ~has_next
        released2 = released | newly_rel
        trel2 = torch.where(newly_rel, t[..., None], trel)
        complete = torch.all(done2, dim=-1)
        no_busy = torch.all(torch.isinf(fin2), dim=-1)
        terminal = (complete | no_busy) & ~finished
        trel = torch.where(terminal[..., None] & ~released2, t[..., None],
                           trel2)
        released = released2 | terminal[..., None]
        ok = torch.where(terminal, complete, ok)
        t_resp = torch.where(terminal, t, t_resp)
        finished = finished | terminal
        done, cur, curfail, fin = done2, cur2, curfail2, fin2
    return t_resp, ok, trel


def _race_f2k2(z_seq, t_join):
    """Closed form of the error-free F=2, K=2 dep-free direct-start race
    (keygen): the earlier first-attempt completion chains its member
    straight into the other task, and the flight completes at the
    earlier of the other member's first finish and that chained attempt;
    both members release then.  The same adds and selections as the
    generic event scan, so bitwise its result."""
    f_first = t_join + z_seq[..., 0]
    t1 = f_first.amin(dim=-1)
    f_other = f_first.amax(dim=-1)
    second = t1 + _pick(z_seq[..., 1], f_first.argmin(dim=-1))
    t_resp = torch.minimum(f_other, second)
    return (t_resp, torch.ones_like(t_resp, dtype=torch.bool),
            t_resp[..., None].expand(t_resp.shape + (2,)))


# --------------------------------------------------------------------------
# closed-loop trial bodies (one whole arrival stream per trial)
# --------------------------------------------------------------------------

def auto_config(engine: str, scan: str = "auto",
                device="cpu") -> Tuple[int, str, str]:
    """Default (block, resolver, scan) per engine and device.

    On the CPU the reference's measured host defaults hold: the chain
    mode is "seq", raptor runs fused unrolled blocks of 8, stock the
    sequential oracle, a forced log-depth chain the adaptive
    ``ceil(n/3)`` split with unrolled blocks.  On a CUDA card the eager
    engine is bound by kernel launches, so the defaults are the
    configurations with the fewest passes, measured at full width
    (``python -m repro_torch.launch.bench_config``, PERF.md): raptor
    chains fixpoint blocks of 64 through the log-depth prefix (its outer
    Jacobi converges in a few passes), stock runs the order-statistic
    fixpoint on blocks of 256.  ``scan`` other than "auto" forces the
    chain mode.
    """
    if torch.device(device).type == "cuda":
        if engine == "stock":
            return 256, "fixpoint", "seq" if scan == "auto" else scan
        return 64, "fixpoint", "logdepth" if scan == "auto" else scan
    if scan == "auto":
        scan = "seq"
    if scan == "logdepth":
        return 0, "unrolled", scan
    if engine == "stock":
        return 1, "fixpoint", scan
    return 8, "unrolled", scan


def _raptor_env(fp: FaultProfile, gen: torch.Generator, A: int, W: int,
                lead=()):
    """Exogenous fault environment ``(bs, be, cs, ce)``: one brownout
    table per AZ ``(*lead, A, I)``, one crash table per worker ``(*lead,
    W, C)``, drawn from ``gen`` (policy-only mode: the inactive ``[inf,
    inf)`` sentinels).  Drawn per trial by the whole-trace replay and once
    per stream by the streaming scheduler."""
    lead = tuple(lead)
    if fp is not None:
        bs, be = fp.brownout_tables(gen, A, lead)
        cs, ce = fp.crash_tables(gen, W, lead)
        return bs, be, cs, ce
    az = torch.full(lead + (A, 1), _INF, device=gen.device)
    wk = torch.full(lead + (W, 1), _INF, device=gen.device)
    return az, az, wk, wk


def _f32(x, device):
    """A float32 scalar on ``device``: engine parameters enter the
    arithmetic rounded to float32 first, as the reference's traced
    arguments do."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _config_count(*xs) -> int:
    """How many configurations the per-config knobs carry: each knob is a
    sequence with one value per configuration, all of one length."""
    if any(np.ndim(x) != 1 for x in xs):
        raise ValueError("per-config knobs must be 1-D sequences")
    ns = {len(x) for x in xs}
    if len(ns) > 1:
        raise ValueError(f"per-config knobs disagree in length: {sorted(ns)}")
    return ns.pop()


def _arrival_times(gaps, rate_hz):
    """Absolute arrival times ``(C, T, jobs)`` from unit gaps ``(T, jobs)``,
    one rate per configuration.  Each scale is the float64 quotient
    ``1000 / rate_hz`` rounded to float32 once (a rate rounded first would
    move arrivals by an ulp), and each configuration takes its own
    cumulative sum over the ``(T, jobs)`` rows a one-configuration run
    sums: on CUDA the scan's rounding depends on how many rows one call
    holds."""
    return torch.stack([torch.cumsum(gaps * _f32(1000.0 / float(r),
                                                 gaps.device), dim=-1)
                        for r in rate_hz])


def _stack_rows(x, C: int):
    """A per-trial ``(T, ...)`` tensor repeated for ``C`` configurations
    as ``(C*T, ...)`` rows."""
    return x.expand((C,) + tuple(x.shape)).reshape(
        (C * x.shape[0],) + tuple(x.shape[1:]))


def _unstack(out, C: int, T: int):
    """Trial outputs of ``C*T`` rows (nested tuples) as ``(C, T, ...)``."""
    if isinstance(out, tuple):
        return tuple(_unstack(x, C, T) for x in out)
    return out.reshape((C, T) + tuple(out.shape[1:]))


def _raptor_job_draws(gen, arrivals, *, W, A, F, K, seq, dist, cv, rho,
                      means, offset, stage_oh, oh_mu, oh_sigma, fail_prob,
                      fault_mode=False, R=0):
    """Per-job event tensors for ``(T, jobs)`` arrivals — the event tuple
    :func:`_raptor_job_body` books, without the trial-level fault tables.
    Shared by the whole-trace trial and the streaming engine's
    per-microbatch draw.

    The arrivals are configuration-stacked, ``(C, T, jobs)``, with
    ``oh_mu`` and ``oh_sigma`` holding one value per configuration: every
    configuration reads the one draw per (trial, job), and the events come
    back as ``C*T`` rows."""
    dev = arrivals.device
    C = arrivals.shape[0]
    lead = tuple(arrivals.shape[1:])

    def rows(x, per_config=False):
        """``(T, ...)``, or ``(C, T, ...)`` when ``per_config``, as
        ``(C*T, ...)`` rows."""
        if per_config:
            return x.reshape((C * x.shape[1],) + tuple(x.shape[2:]))
        return _stack_rows(x, C)
    rho, offset, stage_oh = (_f32(x, dev) for x in (rho, offset, stage_oh))
    means = _f32(means, dev)
    # one draw for the AZ-shared S block and the private X block
    sx = unit_draws(gen, lead + (A + F, K), dist, cv)
    s, x = sx[..., :A, :], sx[..., A:, :]
    oh = torch.exp(_cfg_col(oh_mu, 3, dev) + _cfg_col(oh_sigma, 3, dev)
                   * torch.randn(lead + (F + 1,), generator=gen, device=dev))
    # member 0 pays the arrival overhead; later members a second
    # control-plane hop (the fork's recursive invocation, §3.3.2)
    t_oh = oh[..., :1] + torch.where(torch.arange(F, device=dev) == 0, 0.0,
                                     oh[..., 1:])
    # service mixture for EVERY possible member->AZ placement, in the
    # reference's arithmetic order: z_case[..., a, m, :] = member m's
    # sequence-ordered attempt times were it placed in AZ a
    z_case = (rho * s[..., :, None, :] + (1 - rho) * x[..., None, :, :]) \
        * means + offset + stage_oh
    z_case = torch.gather(z_case, -1, seq.expand(lead + (A, F, K)))
    # placement tie-break randomness: one priority per (job, worker)
    prio = torch.rand(lead + (W,), generator=gen, device=dev)
    head = (rows(arrivals, True), rows(z_case))
    t_oh, prio = rows(t_oh, True), rows(prio)
    if fault_mode:
        # fault mode folds base errors into the per-attempt chain
        # uniforms, by sequence position — no precomputed outcome bitmap
        u_err = torch.rand(lead + (F, K, R + 1), generator=gen, device=dev)
        u_jit = torch.rand(lead + (F, K, R), generator=gen, device=dev)
        return head + (t_oh, prio, rows(u_err), rows(u_jit))
    if fail_prob == 0.0:
        return head + (t_oh, prio)
    fail = torch.rand(lead + (F, K), generator=gen, device=dev) < fail_prob
    fail_seq = torch.gather(fail, -1, seq.expand(lead + (F, K)))
    return head + (rows(fail_seq), t_oh, prio)


def _raptor_race_budget(block: int, F: int, K: int, anyfail: bool,
                        fault_mode: bool, direct: bool, has_deps: bool):
    """(race_events, closed_form) for the flight race inside the replay.

    With no injected errors every race event is a distinct task
    completion, so K completions (+ the F joins when members cannot start
    mid-attempt) bound the race exactly, and the F=2/K=2 dep-free case
    close-forms entirely — outside fault mode, since the closed form knows
    nothing of inflation, crashes or timeouts.  The block=1 oracle keeps
    the full budget and the generic event scan.
    """
    if block <= 1:
        return None, False
    race_events = (K if not anyfail else F * K) + (0 if direct else F)
    closed_form = (F == 2 and K == 2 and not anyfail and not fault_mode
                   and direct and not has_deps)
    return race_events, closed_form


# --------------------------------------------------------------------------
# per-worker fault tables, queried through their sort order
# --------------------------------------------------------------------------
# A booking reads every worker's table.  Queries ``(T, *rest, W)`` are laid
# out as ``(T, W, M)`` against the tables ``(T, W, C)`` so one binary
# search per (event, worker) answers them
# (:func:`repro_torch.sim.faults.push_out` and its siblings).

def _twm(q):
    """``(T, *rest, W)`` -> ``(T, W, M)``."""
    return q.reshape(q.shape[0], -1, q.shape[-1]).transpose(1, 2).contiguous()


def _untwm(x, shape):
    """``(T, W, M)`` -> ``(T, *rest, W)``."""
    return x.transpose(1, 2).reshape(shape)


def _raptor_job_body(*, W, A, F, w_az, seq, dep_mask, has_deps, slat,
                     direct, closed_form, race_events, anyfail,
                     has_failseq, trace, fault_mode=False, pol=None,
                     fp=None, fail_prob=0.0, env=None, cond=None):
    """The one-job booking body (HA placement + flight race) the blocked
    substrate replays, shared by the whole-trace trial and the streaming
    scheduler.  Every op broadcasts over the leading (trials, block,
    event) dimensions the substrate hands it.  ``env`` is the
    ``(T, ...)`` fault-table bundle of :func:`_raptor_env` (fault mode
    only)."""
    K = seq.shape[1]
    w_ar = torch.arange(W, device=w_az.device)
    if fault_mode:
        bs_az, be_az, cs_w, ce_w = env
        bs_w, be_w = bs_az[:, w_az].contiguous(), be_az[:, w_az].contiguous()

    def per_trial(x, nx):
        """A ``(T, ...)`` table broadcast over ``nx`` event axes."""
        return x.reshape(x.shape[:1] + (1,) * nx + x.shape[1:])

    def job_body(wfree, inp):
        if fault_mode:
            arrival, zcj, ohj, prj, u_e, u_j = inp
        elif has_failseq:
            arrival, zcj, fj, ohj, prj = inp
        else:
            arrival, zcj, ohj, prj = inp
        if not has_failseq:
            fj = torch.zeros(tuple(arrival.shape) + (F, K), dtype=torch.bool,
                             device=arrival.device)
        if fault_mode:
            # health snapshot at arrival: a worker is healthy iff its AZ
            # is not browned out when the flight places
            q = arrival[..., None].expand(wfree.shape)
            hw = ~_untwm(interval_active(_twm(q), bs_w, be_w),
                         q.shape)
        # HA placement: a free member picks a uniform-random free worker
        # in an AZ the flight hasn't used, else a uniform-random free
        # worker; a queued member is handed the next-released worker
        wf = wfree
        fresh = torch.ones_like(wf, dtype=torch.bool)  # workers in unused AZs
        arr = arrival[..., None]
        t_disp, widx, m_az = [], [], []
        for _ in range(F):
            t_any = wf.amin(dim=-1)
            contended = t_any > arrival
            free = wf <= arr
            if fault_mode:
                # health-aware HA: healthy beats fresh beats neither,
                # random-uniform within each tier
                key = torch.where(free, prj + 2.0 * hw + 1.0 * fresh, -1.0)
            else:
                # fresh free workers rank in (1, 2], other free in (0, 1],
                # busy at -1 — random-uniform per tier
                key = torch.where(fresh & free, prj + 1.0,
                                  torch.where(free, prj, -1.0))
            w = torch.where(contended, wf.argmin(dim=-1), key.argmax(dim=-1))
            az = w_az[w]
            fresh = fresh & (w_az != az[..., None])
            t_disp.append(torch.maximum(arrival, t_any))
            widx.append(w)
            m_az.append(az)
            wf = torch.where(w_ar == w[..., None], _INF, wf)
        t_disp = torch.stack(t_disp, dim=-1)
        widx = torch.stack(widx, dim=-1)
        m_az = torch.stack(m_az, dim=-1)
        lead = tuple(m_az.shape[:-1])
        # the AZ-shared S block follows the actual placement (co-located
        # members re-correlate); an exact row selection
        z_seq = torch.gather(
            zcj, -3, m_az[..., None, :, None].expand(
                lead + (1, F, K)))[..., 0, :, :]
        recovery = None
        if fault_mode:
            # per-member fault tables follow the actual placement:
            # brownouts of the placed AZ, crashes of the placed worker
            nx = arrival.dim() - 1

            def rows(table, idx):
                t = per_trial(table, nx).expand(lead + table.shape[1:])
                return torch.gather(t, -2, idx[..., None].expand(
                    lead + (F, table.shape[-1])))
            recovery = (pol, fp, fail_prob, rows(bs_az, m_az),
                        rows(be_az, m_az), rows(cs_w, widx),
                        rows(ce_w, widx), u_e, u_j)
        if closed_form:
            t_resp, ok, t_rel = _race_f2k2(z_seq, t_disp + ohj)
        else:
            t_resp, ok, t_rel = dag_flight_trial(
                z_seq, fj, t_disp + ohj, seq, dep_mask, slat,
                direct_start=direct, num_events=race_events,
                no_failures=not anyfail, recovery=recovery, cond=cond,
                has_deps=has_deps)
        # a padded (dead) job must book nothing: releases gated to -inf
        live = ~torch.isinf(arrival)
        rel = torch.where(live[..., None], t_rel, float("-inf"))
        out = (t_resp - arrival, ok)
        if trace:
            out = out + (t_disp, widx.to(torch.int32), t_rel)
        return (widx, rel), out

    return job_body


@functools.lru_cache(maxsize=None)
def _graph_consts(graph: WorkflowGraph, F: int, W: int, A: int,
                  device: str):
    """Manifest constants on the device: member sequences, dependency
    mask, the worker->AZ map, and whether members may start mid-attempt
    (only if a late joiner can never find its first task already done)."""
    seq_np = graph.member_sequences(F)
    seq = torch.as_tensor(np.asarray(seq_np), dtype=torch.long,
                          device=device)
    dep_mask = torch.as_tensor(np.asarray(graph.dep_mask()),
                               dtype=torch.bool, device=device)
    w_az = torch.arange(W, device=device) % A
    direct = (not graph.has_deps
              and len({int(s) for s in seq_np[:, 0]}) == F)
    return seq, dep_mask, w_az, direct


def _raptor_stream_fns(W: int, A: int, F: int, graph: WorkflowGraph,
                       dist: str, fail_prob: float,
                       faults: FaultProfile = None,
                       policy: RecoveryPolicy = None, block: int = 1,
                       resolver: str = "fixpoint", scan: str = "seq",
                       summary_backend: str = "torch", trace: bool = False,
                       device="cpu"):
    """``(draw_env, draw_events, step)`` for the streaming scheduler and
    the whole-trace trial.

    * ``draw_env(gen, trials=1) -> env`` — the ``(trials, ...)`` fault
      tables (:func:`_raptor_env`), drawn once per stream; ``None``
      outside fault mode.
    * ``draw_events(gen, arrivals, rho, means, offset, cv, stage_oh,
      oh_mu, oh_sigma) -> events`` — the per-job event tensors, ``C*T``
      rows, for ``(C, T, mb)`` sorted absolute-ms arrivals and one
      ``oh_mu``/``oh_sigma`` per configuration.  Padded (``inf``) arrivals
      are dead events: they book nothing and leave the W-state bitwise
      untouched.
    * ``step(wf, events, env, slat) -> (wf', outs)`` — book ``(T, mb)``
      events through :func:`blocked_event_replay` on the ``(T, W)``
      W-state.  Because an event observes earlier events only through the
      carried W-vector, consecutive ``step`` calls over slices of a
      stream equal one replay of the concatenated stream, bitwise, faults
      on or off.
    """
    fault_mode, pol, fp, anyfail = fault_statics(fail_prob, faults, policy)
    device = str(torch.device(device))
    seq, dep_mask, w_az, direct = _graph_consts(graph, F, W, A, device)
    K = graph.K

    def draw_env(gen, trials: int = 1):
        if not fault_mode:
            return None
        return _raptor_env(fp, gen, A, W, (int(trials),))

    def draw_events(gen, arrivals, rho, means, offset, cv, stage_oh,
                    oh_mu, oh_sigma):
        return _raptor_job_draws(
            gen, arrivals, W=W, A=A, F=F, K=K, seq=seq, dist=dist, cv=cv,
            rho=rho, means=means, offset=offset, stage_oh=stage_oh,
            oh_mu=oh_mu, oh_sigma=oh_sigma, fail_prob=fail_prob,
            fault_mode=fault_mode, R=pol.max_retries)

    def step(wf, events, env, slat):
        mb = int(events[0].shape[-1])
        blk = block if block else max(1, -(-mb // 3))
        race_events, closed_form = _raptor_race_budget(
            blk, F, K, anyfail, fault_mode, direct, graph.has_deps)
        job_body = _raptor_job_body(
            W=W, A=A, F=F, w_az=w_az, seq=seq, dep_mask=dep_mask,
            has_deps=graph.has_deps, slat=_f32(slat, wf.device),
            direct=direct, closed_form=closed_form, race_events=race_events,
            anyfail=anyfail,
            has_failseq=(fail_prob > 0.0 and not fault_mode), trace=trace,
            fault_mode=fault_mode, pol=pol, fp=fp, fail_prob=fail_prob,
            env=env, cond=graph.cond_static)
        return blocked_event_replay(job_body, wf, events, block=blk,
                                    resolver=resolver, scan=scan,
                                    summary_backend=summary_backend)

    return draw_env, draw_events, step


def _raptor_trial_fn(jobs: int, W: int, A: int, F: int,
                     graph: WorkflowGraph, dist: str, fail_prob: float,
                     faults: FaultProfile = None,
                     policy: RecoveryPolicy = None, block: int = 1,
                     resolver: str = "fixpoint", scan: str = "seq",
                     summary_backend: str = "torch", trace: bool = False,
                     device="cpu"):
    """Closed-loop raptor replay of ``trials`` whole arrival streams at
    once: Poisson arrivals, the shared event draw, the trials' fault
    tables (fault mode), and one :func:`blocked_event_replay` of the
    shared booking body from an idle pool.  ``block=0`` is the adaptive
    log-depth split ``ceil(jobs/3)``.  ``trace=True`` also returns
    ``(arrival, dispatch, worker, release)`` per (job, member).

    ``rate_hz``, ``oh_mu`` and ``oh_sigma`` hold one value per
    configuration: the trial books every configuration on the same draws
    as more rows of one batch and returns ``(C, trials, ...)`` tensors."""
    draw_env, draw_events, step = _raptor_stream_fns(
        W, A, F, graph, dist, fail_prob, faults, policy, block, resolver,
        scan, summary_backend, trace, device)

    def trial(gen, trials, rate_hz, rho, means, offset, cv, stage_oh, slat,
              oh_mu, oh_sigma):
        dev = gen.device
        C = _config_count(rate_hz, oh_mu, oh_sigma)
        gaps = torch.empty((trials, jobs), device=dev).exponential_(
            generator=gen)
        arrivals = _arrival_times(gaps, rate_hz)
        events = draw_events(gen, arrivals, rho, means, offset, cv,
                             stage_oh, oh_mu, oh_sigma)
        env = draw_env(gen, trials)
        if env is not None:
            env = tuple(_stack_rows(x, C) for x in env)
        wf0 = torch.zeros((C * trials, W), device=dev)
        _, outs = step(wf0, events, env, slat)
        if trace:
            resp, ok, t_disp, widx, t_rel = outs
            outs = (resp, ok, (events[0], t_disp, widx, t_rel))
        return _unstack(outs, C, trials)

    return trial


def _stock_trial_fn(jobs: int, W: int, A: int, graph: WorkflowGraph,
                    dist: str, fail_prob: float,
                    faults: FaultProfile = None,
                    policy: RecoveryPolicy = None, passes: int = 1,
                    has_extras: bool = False, block: int = 1,
                    backend: str = "scan", resolver: str = "fixpoint",
                    scan: str = "seq", summary_backend: str = "torch",
                    trace: bool = False, device="cpu"):
    """Closed-loop stock replay at TASK granularity (task FCFS), all
    trials at once.

    All ``jobs * K`` per-task ready times of a trial merge into one
    sorted stream that is booked best-fit in ready order
    (:func:`repro_torch.sim.scan_core.stock_booking_fins`, or the
    ``queue_booking`` kernel when ``backend="kernel"``); the trace's
    final pass resolves worker ids through the generic fixed point.
    Staged ready times depend on queueing, so ``passes`` rounds of a
    fixed point over stage depth materialize them (dep-free graphs are
    exact in one).  The merged stream is sorted stably: exact ties occur
    only among one job's dep-free roots (shared arrival + overhead), and
    the reference's unstable sort may order those differently, which the
    statistics do not see.  ``trace=True`` also returns ``(arrival,
    ready, start, fin, worker)``.

    Fault mode (``faults``/``policy``, as for raptor): every task expands
    into ``policy.stock_attempts`` attempt slots (primary, retries, the
    hedge copy) that all join the one merged stream; unlaunched slots
    ride at ``ready = inf`` and book nothing.  Each booking takes the
    worker whose start, pushed past its crash outages, is earliest (exact
    ties: a healthy AZ first, then the lowest index) and resolves its
    outcome against the trial's brownout and crash tables through the
    generic blocked replay (``block``/``resolver``/``scan``).  Retry and
    hedge ready times depend on earlier bookings, so they materialize
    through the same bounded fixed point as staged readies (the caller
    scales ``passes`` by the attempt budget).  The trace gains the
    attempt axis, the per-attempt ``fail`` outcomes and the four tables.

    Returns ``trial(gen, trials, rate_hz, rho, means, extras, offset, cv,
    stage_oh, oh_mu, oh_sigma)`` (``rate_hz``/``oh_mu``/``oh_sigma`` per
    configuration as for the raptor trial); ``trial.replay(draws,
    stage_oh)`` books given draws — ``(arrivals, z, ok, oh)``, or in fault
    mode ``(arrivals, z, oh, env, u_err, u_jit)`` — which is how the tests
    feed it the reference's.
    """
    device = str(torch.device(device))
    K = graph.K
    dep_rows = np.array(graph.dep_mask(), dtype=bool)
    has_deps = bool(dep_rows.any())
    dep_mask = torch.as_tensor(dep_rows, device=device)
    root = torch.as_tensor(~dep_rows.any(axis=1), device=device)
    fault_mode, pol, fp, _ = fault_statics(fail_prob, faults, policy)
    A_att = pol.stock_attempts if fault_mode else 1
    R = pol.max_retries
    N = jobs * K
    Na = N * A_att
    if not block:
        block = max(1, -(-Na // 3))     # adaptive log-depth split
    w_az = torch.arange(W, device=device) % A
    w_ar = torch.arange(W, device=device)

    def replay(draws, stage_oh):
        if fault_mode:
            arrivals, z, oh, env, u_err, u_jit = draws
        else:
            arrivals, z, ok, oh = draws
        dev = arrivals.device
        T = arrivals.shape[0]
        oh0, ohd = oh[..., 0], oh[..., 1:]
        # roots queue after the arrival overhead; staged tasks are inf
        # until a fixed-point pass materializes their dependencies
        ready0 = torch.where(root, (arrivals + oh0)[..., None], _INF)
        wf0 = torch.zeros((T, W), device=dev)

        def refresh(fin):
            # stage hops (storage round-trip + control-plane draw) elapse
            # BEFORE a worker is occupied
            dmax = torch.where(dep_mask, fin[..., None, :],
                               float("-inf")).amax(dim=-1)
            return torch.where(root, ready0,
                               dmax + _f32(stage_oh, dev) + ohd)

        if fault_mode:
            return _stock_fault_passes(arrivals, z, env, u_err, u_jit,
                                       ready0, refresh, wf0)
        z_flat = z.reshape(T, N)

        def book(ready, full):
            r_flat = ready.reshape(T, N)
            order = torch.argsort(r_flat, dim=-1, stable=True)
            r_s = torch.gather(r_flat, -1, order)
            z_s = torch.gather(z_flat, -1, order)

            def unsort(v):
                return torch.empty_like(v).scatter_(-1, order, v).reshape(
                    T, jobs, K)
            if not full:
                fins, = stock_booking_fins(wf0, r_s, z_s, block=block,
                                           backend=backend, scan=scan,
                                           summary_backend=summary_backend)
                return unsort(fins), None, None
            fins, sts, wks = blocked_bestfit_booking(
                wf0, r_s, z_s, block=block, full=True, backend=backend,
                scan=scan, summary_backend=summary_backend)
            return unsort(fins), unsort(sts), unsort(wks)

        ready = ready0
        for p in range(passes):
            fin, start, wkr = book(ready, trace and p + 1 == passes)
            if has_deps and p + 1 < passes:
                ready = refresh(fin)
        resp = fin.amax(dim=-1) - arrivals
        if trace:
            return resp, ok, (arrivals, ready, start, fin, wkr)
        return resp, ok

    def _stock_fault_passes(arrivals, z, env, u_err, u_jit, ready0,
                            refresh, wf0):
        T = arrivals.shape[0]
        bs_az, be_az, cs_w, ce_w = (x.contiguous() for x in env)
        bs_w, be_w = bs_az[:, w_az].contiguous(), be_az[:, w_az].contiguous()
        infl = fp.degraded_inflation if fp is not None else 1.0
        pdeg = fp.degraded_fail_prob if fp is not None else fail_prob
        # the service draw is shared across a task's attempts
        # (deterministic re-execution)
        z_flat = z[..., None].expand(T, jobs, K, A_att).reshape(T, Na)
        u_flat = u_err.reshape(T, Na)

        def att_body(wf, inp):
            r, zb, u = inp
            live = ~torch.isinf(r)
            # per-worker start were the attempt booked there: the
            # free-at/ready floor pushed past the worker's crash outages;
            # earliest start wins, exact ties broken toward healthy AZs
            # then the lowest index — the lexicographic (start, degraded,
            # w) dispatch key
            q = torch.maximum(wf, r[..., None])
            stw_t = push_out(_twm(q), cs_w, ce_w)
            deg_w = _untwm(interval_active(stw_t, bs_w, be_w),
                           q.shape)
            stw = _untwm(stw_t, q.shape)
            tie = stw == stw.amin(dim=-1, keepdim=True)
            w = torch.where(tie, deg_w.to(stw.dtype), _INF).argmin(dim=-1)
            s = _pick(stw, w)
            deg = _pick(deg_w, w)
            fin, zi = attempt_end(s, zb, torch.where(deg, infl, 1.0),
                                  pol.timeout_ms)
            # the first crash of the chosen worker inside (s, fin)
            c1 = _pick(_untwm(first_start_in(
                _twm(s[..., None].expand(q.shape)),
                _twm(fin[..., None].expand(q.shape)), cs_w), q.shape), w)
            crashed = c1 < fin
            end = torch.where(crashed, c1, fin)
            p_err = torch.where(deg, pdeg, fail_prob)
            fl = (u < p_err) | (zi > pol.timeout_ms) | crashed
            rel = torch.where(live, end, float("-inf"))
            return (w[..., None], rel[..., None]), (end, s, fl, w)

        def book_f(att_ready):
            # joint task-FCFS over every attempt slot: one merged
            # ready-sorted stream of jobs*K*A_att events
            r_flat = att_ready.reshape(T, Na)
            order = torch.argsort(r_flat, dim=-1, stable=True)
            evs = tuple(torch.gather(x, -1, order)
                        for x in (r_flat, z_flat, u_flat))
            _, outs = blocked_event_replay(
                att_body, wf0, evs, block=block, resolver=resolver,
                scan=scan, summary_backend=summary_backend)

            def unsort(v):
                return torch.empty_like(v).scatter_(-1, order, v).reshape(
                    T, jobs, K, A_att)
            return tuple(unsort(v) for v in outs)

        def task_outcomes(fin_a, fl_a):
            booked = ~torch.isinf(fin_a)
            succ = booked & ~fl_a
            any_s = succ.any(dim=-1)
            fin_s = torch.where(succ, fin_a, _INF).amin(dim=-1)
            # a task dies once its retry chain is spent: the LAST chain
            # attempt launched and failed; detection = latest attempt end
            dead = booked[..., R] & fl_a[..., R]
            fin_d = torch.where(booked, fin_a, float("-inf")).amax(dim=-1)
            tfin = torch.where(any_s, fin_s, torch.where(dead, fin_d, _INF))
            return tfin, any_s

        def fault_ready(fin_a, st_a, fl_a, base_r):
            # attempt 0 queues at the task's stage ready; retry r queues
            # backoff after attempt r-1's failure; the hedge copy queues
            # hedge_ms after attempt 0 started iff the primary is still
            # running then (outcomes are pre-resolved: no cancellation)
            booked = ~torch.isinf(fin_a)
            cols = [base_r]
            for a in range(1, pol.chain_attempts):
                prev = booked[..., a - 1] & fl_a[..., a - 1]
                nxt = backoff_after(fin_a[..., a - 1], pol, a - 1,
                                    u_jit[..., a - 1])
                cols.append(torch.where(prev, nxt, _INF))
            if pol.has_hedge:
                st0, fin0 = st_a[..., 0], fin_a[..., 0]
                hedge = st0 + pol.hedge_ms
                cols.append(torch.where(booked[..., 0] & (fin0 > hedge),
                                        hedge, _INF))
            return torch.stack(cols, dim=-1)

        att_ready = torch.cat(
            [ready0[..., None],
             torch.full((T, jobs, K, A_att - 1), _INF,
                        device=ready0.device)], dim=-1)
        for p in range(passes):
            fin_a, st_a, fl_a, wk_a = book_f(att_ready)
            tfin, any_s = task_outcomes(fin_a, fl_a)
            if p + 1 < passes:
                base_r = refresh(tfin) if has_deps else ready0
                att_ready = fault_ready(fin_a, st_a, fl_a, base_r)
        okf = any_s.all(dim=-1)
        resp = tfin.amax(dim=-1) - arrivals
        if trace:
            return resp, okf, (arrivals, att_ready, st_a, fin_a,
                               wk_a.to(torch.int32), fl_a, cs_w, ce_w,
                               bs_az, be_az)
        return resp, okf

    def trial(gen, trials, rate_hz, rho, means, extras, offset, cv,
              stage_oh, oh_mu, oh_sigma):
        dev = gen.device
        T = trials
        C = _config_count(rate_hz, oh_mu, oh_sigma)
        rho_t = _f32(rho, dev)
        gaps = torch.empty((T, jobs), device=dev).exponential_(generator=gen)
        arrivals = _arrival_times(gaps, rate_hz)
        # each task's time is the rho-mixture of two i.i.d. draws
        zz = unit_draws(gen, (T, jobs, 4 if has_extras else 2, K), dist, cv)
        z = (rho_t * zz[..., 0, :] + (1 - rho_t) * zz[..., 1, :]) \
            * _f32(means, dev) + _f32(offset, dev)
        if has_extras:
            z = z + (rho_t * zz[..., 2, :] + (1 - rho_t) * zz[..., 3, :]) \
                * _f32(extras, dev)
        if fault_mode:
            ok = None        # derived from the attempt outcomes
        elif fail_prob == 0.0:
            ok = torch.ones((T, jobs), dtype=torch.bool, device=dev)
        else:
            ok = ~torch.any(torch.rand((T, jobs, K), generator=gen,
                                       device=dev) < fail_prob, dim=-1)
        oh = torch.exp(_cfg_col(oh_mu, 3, dev) + _cfg_col(oh_sigma, 3, dev)
                       * torch.randn((T, jobs, K + 1), generator=gen,
                                     device=dev))
        # configurations stack as row blocks: per-config arrivals and
        # overheads, the per-trial draws repeated
        arrivals = arrivals.reshape(-1, jobs)
        oh = oh.reshape(-1, jobs, K + 1)
        z = _stack_rows(z, C)
        if not fault_mode:
            out = replay((arrivals, z, _stack_rows(ok, C), oh), stage_oh)
        else:
            # the exogenous fault environment (policy-only mode rides the
            # inactive sentinels) and the per-attempt policy uniforms
            env = _raptor_env(fp, gen, A, W, (T,))
            u_err = torch.rand((T, jobs, K, A_att), generator=gen,
                               device=dev)
            u_jit = torch.rand((T, jobs, K, R), generator=gen, device=dev)
            out = replay((arrivals, z, oh,
                          tuple(_stack_rows(x, C) for x in env),
                          _stack_rows(u_err, C), _stack_rows(u_jit, C)),
                         stage_oh)
        return _unstack(out, C, T)

    trial.replay = replay
    return trial


# --------------------------------------------------------------------------
# public entry point
# --------------------------------------------------------------------------

@dataclasses.dataclass
class QueueResult:
    response_ms: torch.Tensor    # (trials, jobs), on the engine's device
    ok: torch.Tensor             # (trials, jobs) bool
    raptor: bool

    @property
    def jobs(self) -> int:
        return int(self.response_ms.numel())

    def fail_rate(self) -> float:
        return float(1.0 - self.ok.float().mean())

    def summary(self) -> dict:
        """Delay summary conditioned on SUCCESS (a failed job's "response"
        is its failure-detection time), with the failure accounting
        alongside: ``n`` counts the successful jobs summarized."""
        return host_summary(summary_row(self.response_ms, self.ok).cpu())


class QueueFlightSim:
    """Closed-loop batched Monte-Carlo of one (workload, deployment) pair.

    One *trial* is a whole replication of the queue: ``jobs`` Poisson
    arrivals contending for ``num_workers`` workers spread over
    ``num_azs`` AZs, starting empty.  Runs on the CUDA card unless
    ``device`` says otherwise; without a card and without ``device`` it
    raises.
    """

    def __init__(self, wl: QueueWorkload, *, num_workers: int = 15,
                 num_azs: int = 3, flight: int = None, rho: float = 0.95,
                 load: str = "medium", arrival_rate_hz: float = None,
                 stream_latency_ms: float = 0.5, seed: int = 0,
                 stock_extra_passes: int = 1, block: int = None,
                 resolver: str = "auto", scan: str = "auto",
                 booking_backend: str = "scan",
                 summary_backend: str = "torch",
                 faults: FaultProfile = None,
                 recovery: RecoveryPolicy = None, device=None):
        """``block``/``resolver``/``scan`` configure the blocked replay;
        results are invariant to them (bitwise), so they are performance
        knobs: ``None``/"auto" resolve per engine and device through
        :func:`auto_config`, ``block=1`` forces the sequential oracle.
        ``booking_backend`` ("scan" or "kernel") books the stock stream;
        ``summary_backend`` ("torch" or "kernel") runs the log-depth
        summary prefix.  ``stock_extra_passes``: extra stage-depth
        fixed-point passes of the staged stock schedule.

        ``faults``/``recovery``: the fault environment and the recovery
        policy; ``None`` defaults from the workload's own fields.  An
        enabled profile or a non-default policy switches both engines
        onto the fault branch (still block/resolver/scan invariant,
        bitwise); it refuses ``booking_backend="kernel"``, whose kernel
        books plain FCFS finish times only."""
        self.device = resolve_device(device)
        self.wl = wl
        self.W = int(num_workers)
        self.A = int(num_azs)
        self.flight = int(flight if flight is not None else wl.flight)
        if self.flight > self.W:
            raise ValueError(
                f"flight={self.flight} needs distinct workers but the "
                f"deployment has only num_workers={self.W}")
        if booking_backend not in BOOKING_BACKENDS:
            raise ValueError(f"unknown booking backend {booking_backend!r}; "
                             f"expected one of {BOOKING_BACKENDS}")
        if summary_backend not in SUMMARY_BACKENDS:
            raise ValueError(f"unknown summary backend {summary_backend!r}; "
                             f"expected one of {SUMMARY_BACKENDS}")
        self.faults = faults if faults is not None else wl.faults
        self.recovery = (recovery if recovery is not None
                         else (wl.recovery if wl.recovery is not None
                               else NO_RECOVERY))
        # statics handed to the trial factories: None unless they change
        # behavior, so a disabled profile runs the pre-fault path
        self.fault_mode, pol, self._fp, _ = fault_statics(
            wl.fail_prob, self.faults, self.recovery)
        self._policy = pol if self.fault_mode else None
        if self.fault_mode and booking_backend == "kernel":
            raise ValueError(
                "booking_backend='kernel' books plain FCFS finish times "
                "only; fault injection needs the scan substrate")
        self.rho = float(rho)
        self.load = load
        self.slat = float(stream_latency_ms)
        self.seed = int(seed)
        self.rate_hz = float(
            arrival_rate_hz if arrival_rate_hz is not None
            else _rate_for_load(wl.work_est_ws, self.W, load))
        self.utilization = self.rate_hz * wl.work_est_ws / self.W
        self._block = None if block is None else int(block)
        self.resolver = str(resolver)
        self.scan = str(scan)
        self.booking_backend = str(booking_backend)
        self.summary_backend = str(summary_backend)
        self.oh_mu, self.oh_sigma = lognormal_params(
            *OverheadModel.TABLE[(self.A > 1, load)])
        self._sgraph = wl.stock_graph()
        self._smeans = np.asarray(self._sgraph.means, dtype=np.float32)
        self._sextras = np.asarray(wl.stock_extras(), dtype=np.float32)
        # fixed-point pass budget for the task-FCFS stock replay: depth+1
        # passes materialize every ready time, extras refine the estimates
        sdepth = self._sgraph.stage_depth()
        if self.fault_mode:
            # retry/hedge readies materialize through the same bounded
            # fixed point as staged readies: each stage level needs its
            # whole attempt chain resolved, so the budget scales by the
            # per-task attempt count
            self._spasses = ((sdepth + 1) * self.recovery.stock_attempts
                             + int(stock_extra_passes))
        else:
            self._spasses = (1 if sdepth == 0
                             else sdepth + 1 + int(stock_extra_passes))

    def engine_config(self, engine: str) -> Tuple[int, str, str]:
        """Resolved (block, resolver, scan) for ``engine`` ("raptor"/
        "stock"): explicit constructor knobs win, the rest comes from
        :func:`auto_config`."""
        blk, res, sc = auto_config(engine, self.scan, self.device)
        if self._block is not None:
            blk = self._block
        if self.resolver != "auto":
            res = self.resolver
        return blk, res, sc

    def _raptor_fn(self, jobs: int, trace: bool = False):
        blk, res, sc = self.engine_config("raptor")
        return _raptor_trial_fn(
            int(jobs), self.W, self.A, self.flight, self.wl.graph,
            self.wl.dist, self.wl.fail_prob, self._fp, self._policy, blk,
            res, sc, self.summary_backend, trace, self.device)

    def _stock_fn(self, jobs: int, trace: bool = False):
        blk, res, sc = self.engine_config("stock")
        return _stock_trial_fn(
            int(jobs), self.W, self.A, self._sgraph, self.wl.dist,
            self.wl.fail_prob, self._fp, self._policy, self._spasses,
            bool(self._sextras.any()), blk, self.booking_backend, res, sc,
            self.summary_backend, trace, self.device)

    def _raptor_args(self):
        """The raptor trial's arguments: this sim as one configuration."""
        wl = self.wl
        return ([self.rate_hz], self.rho, wl.task_means, wl.offset_ms,
                wl.cv, wl.raptor_stage_ms, self.slat, [self.oh_mu],
                [self.oh_sigma])

    def _stock_args(self):
        """The stock trial's arguments: this sim as one configuration."""
        wl = self.wl
        return ([self.rate_hz], self.rho, self._smeans, self._sextras,
                wl.offset_ms, wl.cv, wl.stock_stage_ms, [self.oh_mu],
                [self.oh_sigma])

    def _gen(self, raptor: bool) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 2 + (1 if raptor else 0))
        return gen

    def run(self, jobs: int = 1024, trials: int = 16, *,
            raptor: bool = True) -> QueueResult:
        if raptor:
            resp, ok = self._raptor_fn(jobs)(self._gen(True), int(trials),
                                             *self._raptor_args())
        else:
            resp, ok = self._stock_fn(jobs)(self._gen(False), int(trials),
                                            *self._stock_args())
        return QueueResult(resp[0], ok[0], raptor)

    def run_pair(self, jobs: int = 1024, trials: int = 16) -> Dict[str, dict]:
        stock = self.run(jobs, trials, raptor=False)
        rap = self.run(jobs, trials, raptor=True)
        out = {"stock": stock.summary(), "raptor": rap.summary()}
        out["mean_ratio"] = out["raptor"]["mean"] / out["stock"]["mean"]
        return out

    def trace_run(self, jobs: int = 256, trials: int = 4, *,
                  raptor: bool = True) -> Dict[str, np.ndarray]:
        """Replay with the booking trace exposed (host numpy arrays).

        Stock: per-(trial, job, task) ``ready`` (the value the final
        scheduling pass honored), ``start``, ``fin``, ``worker``; in fault
        mode with a trailing attempt axis ``(trials, jobs, K, A_att)``
        (an unlaunched slot shows ready/start/fin = inf), the per-attempt
        ``fail`` outcomes and the trials' fault tables (``crash_start``/
        ``crash_end`` ``(trials, W, C)``, ``az_start``/``az_end``
        ``(trials, A, I)``).  Raptor: per-(trial, job, member)
        ``dispatch``/``worker``/``release``.  Same seeds as :meth:`run`,
        so the traced replay IS the measured one.
        """
        def host(x):
            return x[0].cpu().numpy()
        if raptor:
            resp, ok, (arr, disp, widx, rel) = self._raptor_fn(
                jobs, trace=True)(self._gen(True), int(trials),
                                  *self._raptor_args())
            return {"response": host(resp), "ok": host(ok),
                    "arrival": host(arr), "dispatch": host(disp),
                    "worker": host(widx), "release": host(rel)}
        out = self._stock_fn(jobs, trace=True)(
            self._gen(False), int(trials), *self._stock_args())
        if self.fault_mode:
            resp, ok, (arr, ready, start, fin, wkr, fl, cs, ce, bs,
                       be) = out
            return {"response": host(resp), "ok": host(ok),
                    "arrival": host(arr), "ready": host(ready),
                    "start": host(start), "fin": host(fin),
                    "worker": host(wkr), "fail": host(fl),
                    "crash_start": host(cs), "crash_end": host(ce),
                    "az_start": host(bs), "az_end": host(be)}
        resp, ok, (arr, ready, start, fin, wkr) = out
        return {"response": host(resp), "ok": host(ok),
                "arrival": host(arr), "ready": host(ready),
                "start": host(start), "fin": host(fin),
                "worker": host(wkr)}


# --------------------------------------------------------------------------
# batched config sweeps: thin plans over repro_torch.sim.sweeps
# --------------------------------------------------------------------------
# Arrival rate and the Table-6 overhead lognormal vary per configuration,
# so the configuration axis is pure batching: one booking per engine for
# the whole grid, bitwise each configuration's own run_pair.

def load_sweep(wl: QueueWorkload, *, num_workers: int = 15, num_azs: int = 3,
               loads=("low", "medium", "high"), rho: float = 0.95,
               jobs: int = 1024, trials: int = 16, seed: int = 0,
               devices=None, device=None, **sim_kw) -> Dict[str, dict]:
    """All Table-6 load points of one deployment, one batch per engine.
    ``sim_kw`` (``block``, ``booking_backend``, ...) go to every
    :class:`QueueFlightSim` of the plan."""
    from repro_torch.sim.sweeps import queue_pair_plan
    sims = [QueueFlightSim(wl, num_workers=num_workers, num_azs=num_azs,
                           load=load, rho=rho, seed=seed, device=device,
                           **sim_kw) for load in loads]
    return dict(zip(loads,
                    queue_pair_plan(sims, jobs, trials).run(devices=devices)))


def rate_sweep(wl: QueueWorkload, rates_hz, *, loads=None,
               num_workers: int = 15, num_azs: int = 3, rho: float = 0.95,
               jobs: int = 1024, trials: int = 16, seed: int = 0,
               devices=None, device=None, **sim_kw):
    """Arbitrary arrival-rate grid (continuous load axis) on one
    deployment; ``loads`` optionally names the Table-6 overhead regime per
    point (defaults to "medium").  Returns one pair dict per rate."""
    from repro_torch.sim.sweeps import queue_pair_plan
    loads = list(loads) if loads is not None else ["medium"] * len(rates_hz)
    sims = [QueueFlightSim(wl, num_workers=num_workers, num_azs=num_azs,
                           load=load, rho=rho, arrival_rate_hz=float(r),
                           seed=seed, device=device, **sim_kw)
            for r, load in zip(rates_hz, loads)]
    return queue_pair_plan(sims, jobs, trials).run(devices=devices)
