"""The scalar oracle: an event-driven queueing + flight simulator, stock
OpenWhisk fork-join vs Raptor flights on a worker cluster, with Poisson
arrivals, preemption, and work accounting.

The port of ``repro/sim/flights.py`` in plain numpy: given the same seeds
it returns the reference's job records exactly
(tests/test_torch_flights.py), so keep its draw order, its ``set``
iteration orders and its ``rng.shuffle``/``rng.integers`` calls as they
are.

Stock mode: a job's tasks queue independently FCFS for workers as their
dependencies complete; each inter-stage hop pays the control-plane overhead
plus any storage round-trip (``stock_stage_overhead``); the job completes
when all tasks do (fork-join).

Raptor mode: a job is one flight of ``concurrency`` members over distinct
workers (HA placement spreads them across AZs).  Members run the manifest
in cyclically shifted order (§3.3.3), skip tasks whose first completion has
been broadcast, and are preempted mid-task when a peer finishes first —
their worker is freed after the half-RTT stream latency (§3.3.4).  Member
task failures degrade the flight; the job fails only if every member fails
(Figure 8's p^N).

Job-accounting conventions (shared with the vectorized engines so
agreement tests compare like with like — see sim/vector_queue.py):

* horizon drain: arrivals stop at ``duration_s`` but the event queue
  drains past it, so jobs still in flight at the horizon run to
  completion instead of being censored (dropping them biases the
  high-load tails low — the in-flight jobs are exactly the slow ones);
* dependency waits are event-driven: a member whose next task has an
  unmet dependency parks and is re-woken one stream half-RTT after the
  unblocking completion broadcast (any ``stream_latency_ms`` >= 0 is
  honored exactly — there is no poll floor);
* a flight that can never progress (every attempt of some dependency
  errored) terminates with ``ok=False`` at its last event, so every
  admitted job is returned, successful or not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.workflow import WorkflowGraph
from repro_torch.sim.cluster import Cluster
from repro_torch.sim.events import EventQueue
from repro_torch.sim.faults import FaultProfile, interval_active_np
from repro_torch.sim.policies import (NO_RECOVERY, RecoveryPolicy,
                                      attempt_outcome_np, fold_chain_np,
                                      push_out_np)


@dataclasses.dataclass
class SimWorkload:
    """Service-time model of one compiled manifest.

    ``graph`` is the workflow compiler's IR (:mod:`repro_torch.core.workflow`)
    — the SAME object the vectorized engines key their trial factories
    on, so scalar/vector pairs can never disagree on the DAG.
    """
    graph: WorkflowGraph
    concurrency: int
    make_draws: Callable                 # cluster -> InvocationDraws
    stock_stage_overhead: float = 0.0    # storage/requeue per stage hop (ms)
    raptor_stage_overhead: float = 0.5   # stream hop (ms)
    fail_prob: float = 0.0
    work_est_ws: float = 2.0             # worker-seconds/job (load targeting)
    # optional alternative graph for the STOCK path (workloads whose stock
    # functions are self-contained, e.g. thumbnail re-downloads); default
    # is the flight graph with conditionals flattened — the stock baseline
    # has no data-dependent short-circuiting
    stock: Optional[WorkflowGraph] = None
    # fault environment + recovery policy carried with the workload so a
    # scalar/vector pair built from the same object injects identically
    # (sim/faults.py, sim/policies.py); constructor kwargs override
    faults: Optional[FaultProfile] = None
    recovery: Optional[RecoveryPolicy] = None

    @property
    def name(self) -> str:
        return self.graph.name

    @property
    def stock_graph(self) -> WorkflowGraph:
        return self.stock if self.stock is not None else self.graph.flatten()


@dataclasses.dataclass
class JobRecord:
    t_arrive: float
    t_done: float = -1.0
    ok: bool = True
    work_ms: float = 0.0

    @property
    def response(self) -> float:
        return self.t_done - self.t_arrive


class FlightSim:
    def __init__(self, cluster: Cluster, wl: SimWorkload, *, raptor: bool,
                 arrival_rate_hz: float, duration_s: float = 1800.0,
                 load: str = "medium", stream_latency_ms: float = 0.5,
                 seed: int = 0, rotate: bool = True,
                 faults: FaultProfile = None,
                 recovery: RecoveryPolicy = None):
        """rotate=True (default) uses the paper's §3.3.3 cyclic-shift
        sequences — essential for parallelizable DAGs (racing one shared
        order serialises them).  rotate=False has all members race the same
        sequence, the dynamics the paper's §4.2.1 2*E[min]/E[max] equation
        actually describes (see EXPERIMENTS.md for the measured gap)."""
        self.cl = cluster
        self.wl = wl
        self.raptor = raptor
        self.lam = arrival_rate_hz
        self.duration_ms = duration_s * 1000
        self.load = load
        self.slat = stream_latency_ms
        self.rng = np.random.default_rng(seed + 1)
        self.q = EventQueue()
        self.free = set(range(cluster.num_workers))
        self.backlog: List = []
        self.jobs: List[JobRecord] = []
        # cached views of the compiled IR (the hot loops index these)
        self._deps = wl.graph.dep_map()
        self._K = wl.graph.K
        sg = wl.stock_graph
        self._stock_tasks = list(sg.tasks)
        self._stock_deps = sg.dep_map()
        # conditional select masks: guard name -> [(task, sense), ...]
        self._guards: Dict[str, list] = {}
        for t, g, s in zip(wl.graph.tasks, wl.graph.cond_guard,
                           wl.graph.cond_sense):
            if g >= 0:
                self._guards.setdefault(wl.graph.tasks[g], []).append((t, s))
        n_seq = max(wl.concurrency, 1) if rotate else 1
        self._seqs = [self._exec_sequence(i) for i in range(n_seq)]
        # fault environment + recovery policy (sim/faults.py, sim/
        # policies.py): explicit kwargs win, else whatever the workload
        # carries.  Tables come from a dedicated rng stream so enabling
        # faults does not perturb the service/arrival draws.
        fp = faults if faults is not None else wl.faults
        self.fp = fp if (fp is not None and fp.enabled) else None
        pol = recovery if recovery is not None else wl.recovery
        self.policy = pol if pol is not None else NO_RECOVERY
        self.fault_mode = self.fp is not None or not self.policy.is_default
        frng = np.random.default_rng(seed + 7919)
        if self.fp is not None:
            self._bs, self._be = self.fp.brownout_tables_np(
                frng, cluster.num_azs)
            self._cs, self._ce = self.fp.crash_tables_np(
                frng, cluster.num_workers)
        else:                         # policy-only mode: healthy sentinels
            self._bs = np.full((cluster.num_azs, 1), np.inf)
            self._be = self._bs
            self._cs = np.full((cluster.num_workers, 1), np.inf)
            self._ce = self._cs

    # ------------------------------------------------------------------
    def run(self) -> List[JobRecord]:
        """Replay the arrival stream; returns ONE record per admitted job.

        Horizon-drain semantics: arrivals stop at the horizon, but the
        event queue drains past it so every admitted job runs to
        completion — nothing is censored.  Flights that can never progress
        (deadlocked on errored dependencies) fail at their last event
        (``_check_deadlock``); the rare cross-flight stall — parked
        members of partially-joined flights holding every worker — is
        resolved after the drain by failing the stuck jobs at the stall
        instant rather than silently dropping them.
        """
        t = float(self.rng.exponential(1000.0 / self.lam))
        while t < self.duration_ms:
            self.q.schedule(t, self._arrive)
            t += float(self.rng.exponential(1000.0 / self.lam))
        self.q.run()
        for j in self.jobs:
            if j.t_done < 0:
                j.t_done = self.q.now
                j.ok = False
        return self.jobs

    def _arrive(self):
        rec = JobRecord(t_arrive=self.q.now)
        self.jobs.append(rec)
        overhead = float(self.cl.sample_overhead(self.load, 1)[0])
        draws = self.wl.make_draws(self.cl)
        draws.raptor = self.raptor
        if self.raptor:
            fl = {
                "rec": rec, "members": [], "draws": draws,
                "ptr": {}, "seq_idx": {},
                "done": {}, "running": {},
                "released": set(), "failed_members": set(),
                "n_members": 0,
                # event-driven dependency waits + deadlock detection
                "parked": set(), "done_members": set(), "pending": 0,
            }
            for m in range(max(self.wl.concurrency, 1)):
                oh = overhead if m == 0 else overhead + float(
                    self.cl.sample_overhead(self.load, 1)[0])
                self.backlog.append(("member", fl, m, oh))
            self._dispatch()
        else:
            state = {"rec": rec, "done": set(), "queued": set(),
                     "draws": draws}
            if self.fault_mode:
                # per-task attempt bookkeeping: the service draw shared by
                # the whole attempt set (deterministic re-execution — see
                # sim/policies.py), attempts committed-but-unfinished, and
                # which finalized tasks actually succeeded
                state.update(zbase={}, att_open={}, succ=set())
            self._stock_enqueue_ready(state, overhead)

    def _ready(self, done: set) -> List[str]:
        return [t for t in self._stock_tasks
                if t not in done
                and all(d in done for d in self._stock_deps[t])]

    def _stock_enqueue_ready(self, state, overhead):
        """Stage hops (control plane + storage round-trips) elapse BEFORE a
        worker is occupied — they are control-path delays, not service."""
        for task in self._ready(state["done"]):
            if task not in state["queued"]:
                state["queued"].add(task)
                if self.fault_mode:
                    state["att_open"][task] = 1
                self.q.schedule(self.q.now + overhead, self._stock_push,
                                state, task)

    def _stock_push(self, state, task, attempt: int = 0):
        self.backlog.append(("task", state["rec"], task, state, attempt))
        self._dispatch()

    # ------------------------------------------------------------------
    def _dispatch(self):
        while self.backlog and self.free:
            kind = self.backlog[0][0]
            if kind == "task":
                _, rec, task, state, att = self.backlog.pop(0)
                if self.fault_mode:
                    self._stock_dispatch_attempt(rec, state, task, att)
                    continue
                w = self.free.pop()
                svc = state["draws"].draw(task, w)
                fail = self.rng.random() < self.wl.fail_prob
                self.q.schedule(self.q.now + svc,
                                self._stock_finish, rec, state, task, w,
                                fail, svc)
            else:
                # one flight MEMBER (paper §3.3.2: the fork's recursive
                # invocations queue independently and join the stream late)
                _, fl, member_idx, overhead = self.backlog.pop(0)
                if fl["rec"].t_done >= 0:
                    continue                      # flight already finished
                w = self._pick_worker_for(fl)
                self.free.discard(w)
                self._join_member(fl, w, member_idx, overhead)

    def _pick_worker_for(self, fl) -> int:
        """HA-aware pick: prefer AZs not yet used by this flight; with
        faults active, health trumps freshness (skip browned-out AZs,
        degrading gracefully — a fully-degraded pool still places).
        Uniform within the best tier, like the vector engine's
        ``prio + 2*healthy + fresh`` placement key."""
        used_azs = {int(self.cl.az_of[w]) for w in fl["members"]}

        def tier(w: int) -> int:
            az = int(self.cl.az_of[w])
            fresh = az not in used_azs
            if not self.fault_mode:
                return int(fresh)
            healthy = not interval_active_np(
                self.q.now, self._bs[az], self._be[az])
            return 2 * int(healthy) + int(fresh)

        best = max(tier(w) for w in self.free)
        pool = [w for w in self.free if tier(w) == best]
        return pool[int(self.rng.integers(len(pool)))]

    # ------------------------------------------------------------------
    # stock OpenWhisk fork-join, fault/policy path: every attempt is its
    # own dispatch; a failed attempt requeues up to the retry budget, a
    # slow primary gets a hedged duplicate (no cancellation — first
    # success wins, losers run to completion).  Mirrors the vector
    # engine's attempt-expanded event stream (sim/vector_queue.py).
    def _stock_dispatch_attempt(self, rec, state, task, att):
        now = self.q.now
        # earliest pushed start among FREE workers; healthy AZ, then the
        # lowest index break ties (the vector body's deterministic order)
        best = None
        for w in sorted(self.free):
            az = int(self.cl.az_of[w])
            s = push_out_np(now, self._cs[w], self._ce[w])
            key = (s, interval_active_np(s, self._bs[az], self._be[az]), w)
            if best is None or key < best[0]:
                best = (key, w, az)
        _, w, az = best
        self.free.discard(w)
        z = state["zbase"].get(task)
        if z is None:
            z = state["zbase"][task] = state["draws"].draw(task, w)
        s, end, fail = attempt_outcome_np(
            now, z, float(self.rng.random()),
            self._bs[az], self._be[az], self._cs[w], self._ce[w],
            policy=self.policy, faults=self.fp,
            base_fail=self.wl.fail_prob)
        self.q.schedule(end, self._stock_attempt_finish,
                        rec, state, task, w, fail, att, now)
        # hedge commit: the primary's outcome is already determined, so
        # the "still running at start + hedge_ms" test is exact here and
        # matches the vector's ready_hedge = start0 + hedge_ms gate
        if (att == 0 and self.policy.has_hedge
                and end > s + self.policy.hedge_ms):
            state["att_open"][task] += 1
            self.q.schedule(s + self.policy.hedge_ms, self._stock_push,
                            state, task, self.policy.chain_attempts)

    def _stock_attempt_finish(self, rec, state, task, w, fail, att, t_disp):
        self.free.add(w)
        rec.work_ms += self.q.now - t_disp
        # chain continues regardless of other attempts (no cancellation);
        # the hedge slot (att == chain_attempts) never retries
        if fail and att < self.policy.max_retries:
            state["att_open"][task] += 1
            delay = self.policy.backoff(att, float(self.rng.random()))
            self.q.schedule(self.q.now + delay, self._stock_push,
                            state, task, att + 1)
        state["att_open"][task] -= 1
        if task not in state["done"]:
            if not fail:
                # first success finalizes the task (min successful finish)
                state["done"].add(task)
                state["succ"].add(task)
                self._stock_task_final(rec, state)
            elif state["att_open"][task] == 0:
                # every attempt exhausted: the task completes FAILED at its
                # last attempt's finish so the stage still progresses
                state["done"].add(task)
                rec.ok = False
                self._stock_task_final(rec, state)
        self._dispatch()

    def _stock_task_final(self, rec, state):
        oh = self.wl.stock_stage_overhead + float(
            self.cl.sample_overhead(self.load, 1)[0])
        self._stock_enqueue_ready(state, oh)
        if len(state["done"]) == len(self._stock_tasks):
            rec.t_done = self.q.now

    # ------------------------------------------------------------------
    # stock OpenWhisk fork-join
    def _stock_finish(self, rec, state, task, worker, fail, svc):
        self.free.add(worker)
        rec.work_ms += svc
        if fail:
            rec.ok = False
        state["done"].add(task)
        oh = self.wl.stock_stage_overhead + float(
            self.cl.sample_overhead(self.load, 1)[0])
        self._stock_enqueue_ready(state, oh)
        if len(state["done"]) == len(self._stock_tasks):
            rec.t_done = self.q.now
        self._dispatch()

    # ------------------------------------------------------------------
    # Raptor flight
    def _join_member(self, fl, w: int, member_idx: int, overhead: float):
        fl["members"].append(w)
        fl["seq_idx"][w] = member_idx % len(self._seqs)
        fl["ptr"][w] = 0
        fl["n_members"] += 1
        self._wake(fl, w, overhead)

    def _wake(self, fl, w, delay: float):
        """Schedule a member continuation, counted in ``fl["pending"]`` so
        deadlock detection can tell 'quiescent' from 'wake in flight'."""
        fl["pending"] += 1
        self.q.schedule(self.q.now + delay, self._member_wake, fl, w)

    def _member_wake(self, fl, w):
        fl["pending"] -= 1
        self._member_next(fl, w)

    def _check_deadlock(self, fl):
        """Fail the flight the moment no member can ever progress: every
        joined member parked on an unmet dependency or out of tasks, no
        attempt running, no wake pending, and the whole flight joined.
        (Without this, members parked on a dependency whose every attempt
        errored would wait forever and the event queue would never drain —
        the job could not even be *observed* as censored.)  Subsumes the
        old every-member-exhausted check: that is the ``parked``-empty
        special case.

        Retry-budget accounting: an "attempt" here is a whole folded
        timeout/retry chain (``_member_next``), so under an active
        ``RecoveryPolicy`` a member counts as exhausted on a task only
        after ``1 + max_retries`` tries — the flight is dead only when
        every dependency attempt is exhausted under the policy, never on
        the first full-member failure.  ``core.scheduler`` mirrors this
        in its ``dead_after`` fail-fast threshold."""
        if (fl["rec"].t_done < 0 and not fl["running"]
                and fl["pending"] == 0
                and fl["n_members"] >= max(self.wl.concurrency, 1)
                and len(fl["parked"]) + len(fl["done_members"])
                >= fl["n_members"]
                and len(fl["done"]) < self._K):
            fl["rec"].t_done = self.q.now
            fl["rec"].ok = False
            self._finish_flight(fl)

    def _exec_sequence(self, index: int) -> List[str]:
        from repro_torch.core.dag import execution_sequence
        man = self.wl.graph.to_manifest(max(self.wl.concurrency, 1))
        return execution_sequence(man, index)

    def _member_next(self, fl, w):
        if fl["rec"].t_done >= 0 or w in fl["released"]:
            return
        seq = self._seqs[fl["seq_idx"][w]]
        ptr = fl["ptr"][w]
        while ptr < len(seq):
            task = seq[ptr]
            if task in fl["done"]:
                ptr += 1
                continue
            if all(d in fl["done"] for d in self._deps[task]):
                break
            # dependency not yet visible on the stream: park until a
            # completion broadcast re-wakes us half an RTT later.  Event-
            # driven, not polled — the old max(slat, 0.1)ms poll both
            # busy-polled and quantized sub-0.1ms stream latencies away
            # from the vector scan's exact broadcast+slat wake.
            fl["ptr"][w] = ptr
            fl["parked"].add(w)
            self._check_deadlock(fl)
            return
        fl["ptr"][w] = ptr
        if ptr >= len(seq):
            # member exhausted its sequence; the job fails once NO member
            # can make progress with tasks still incomplete (all attempts
            # of some task errored) — _check_deadlock's terminal case
            fl["done_members"].add(w)
            self._release_member(fl, w)
            self._check_deadlock(fl)
            return
        task = seq[ptr]
        svc = fl["draws"].draw(task, w)
        if self.fault_mode:
            # the whole timeout/retry/backoff chain folds into ONE event
            # (sim/policies.py): the member holds its worker and stays in
            # ``running`` for the chain's full span, so a peer's success
            # broadcast preempts the chain as a unit and a member
            # exhausts a task only after the full retry budget — the
            # deadlock/dead_after accounting below inherits the budget
            az = int(self.cl.az_of[w])
            t_end, fail = fold_chain_np(
                self.q.now, svc + self.wl.raptor_stage_overhead,
                self.rng, self._bs[az], self._be[az],
                self._cs[w], self._ce[w], policy=self.policy,
                faults=self.fp, base_fail=self.wl.fail_prob)
            eid = self.q.schedule(
                t_end, self._member_finish, fl, w, task, fail, self.q.now)
        else:
            fail = self.rng.random() < self.wl.fail_prob
            eid = self.q.schedule(
                self.q.now + svc + self.wl.raptor_stage_overhead,
                self._member_finish, fl, w, task, fail, self.q.now)
        fl["running"][w] = (task, eid, self.q.now)

    def _member_finish(self, fl, w, task, fail, t0):
        fl["running"].pop(w, None)
        fl["rec"].work_ms += self.q.now - t0
        fl["ptr"][w] += 1
        guard = task in self._guards
        if fail and not guard:
            # §3.3.4: the error event is broadcast and IGNORED by peers; the
            # member moves on.  The task stays pending for other members.
            fl["failed_members"].add(w)
            self._wake(fl, w, 0.0)
            return
        if task not in fl["done"]:
            fl["done"][task] = self.q.now
            if guard:
                # conditional mask-select: the guard's FIRST finished
                # attempt decides the branch — failure is a routing
                # outcome, not a job error.  Tasks gated on the other
                # sense are cancelled: marked complete with zero service
                # (they structurally depend on the guard, so none can be
                # mid-attempt here), and their dependents wake below.
                outcome = not fail
                for t, sense in self._guards[task]:
                    if sense != outcome and t not in fl["done"]:
                        fl["done"][t] = self.q.now
            # broadcast: preempt peers running `task` (half-RTT delivery)
            for pw, (ptask, eid, pt0) in list(fl["running"].items()):
                if ptask == task:
                    self.q.cancel(eid)
                    fl["running"].pop(pw)
                    fl["rec"].work_ms += (self.q.now + self.slat) - pt0
                    fl["ptr"][pw] += 0
                    self._wake(fl, pw, self.slat)
            # ...and wake members parked on a dependency: they re-check
            # their head-of-line task half an RTT after the broadcast
            # (re-parking if still blocked) — the vector scan's semantics
            for pw in list(fl["parked"]):
                fl["parked"].discard(pw)
                self._wake(fl, pw, self.slat)
        if len(fl["done"]) == self._K:
            fl["rec"].t_done = self.q.now
            fl["rec"].ok = True
            self._finish_flight(fl)
            return
        self._wake(fl, w, 0.0)

    def _finish_flight(self, fl):
        for pw, (ptask, eid, pt0) in list(fl["running"].items()):
            self.q.cancel(eid)
            fl["rec"].work_ms += self.q.now - pt0
            fl["running"].pop(pw)
        for pw in fl["members"]:
            self._release_member(fl, pw)

    def _release_member(self, fl, w):
        if w not in fl["released"]:
            fl["released"].add(w)
            self.free.add(w)
            self._dispatch()
