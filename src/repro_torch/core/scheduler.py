"""The Raptor execution engine (paper §3.2–§3.3): flights of peer executors
speculatively running a manifest with state sharing and preemption.

This is the *real* (non-simulated) engine: executors are threads (one per
flight member — the stand-in for one process per serverless sandbox), the
state-sharing stream is an in-process broadcast board (the stand-in for the
SCTP mesh; on a multi-host deployment each executor is a separate process
and the board is backed by the collective fabric), and preemption is a
cooperative cancellation token checked by the function between work slices
(the stand-in for POSIX job-control signals, with the same at-boundary
delivery granularity).

Functions receive a ``TaskContext`` and must return their output; they may
call ``ctx.sleep(dt)`` for interruptible waits and must treat
``ctx.cancelled`` as a preemption request.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.dag import execution_sequence, validate_acyclic
from repro_torch.core.manifest import ActionManifest, ExecutionContext


class Preempted(Exception):
    """Raised inside a function when its result arrived from a peer."""


@dataclasses.dataclass
class TaskResult:
    name: str
    value: Any
    error: Optional[BaseException]
    executor: int
    t_finish: float
    attempt: int = 0


class StateStream:
    """State-sharing stream: first non-error result per function wins
    (paper §3.3.4); later duplicates are discarded.  ``latency`` models the
    half-RTT broadcast delivery delay of the SCTP stream."""

    def __init__(self, latency: float = 0.0):
        self._lock = threading.Lock()
        self._results: Dict[str, TaskResult] = {}
        self._errors: Dict[str, set] = {}
        self._event = threading.Condition(self._lock)
        self.latency = latency
        self.duplicates = 0

    def publish(self, res: TaskResult) -> bool:
        """Returns True if this was the winning (first) result."""
        with self._lock:
            cur = self._results.get(res.name)
            if res.error is not None:
                # errors never overwrite a success, but every one is counted
                # per distinct (executor, attempt) so waiters can detect a
                # dead task: with an R-retry policy a task is only dead
                # after size * (1 + R) failed attempts, not size failures
                self._errors.setdefault(res.name, set()).add(
                    (res.executor, res.attempt))
                if cur is None:
                    self._results[res.name] = res
                self._event.notify_all()
                return cur is None
            if cur is not None and cur.error is None:
                self.duplicates += 1
                return False
            self._results[res.name] = res
            self._event.notify_all()
            return True

    def error_count(self, name: str) -> int:
        """Distinct (executor, attempt) failures recorded for ``name``."""
        with self._lock:
            return len(self._errors.get(name, ()))

    def visible(self, name: str, now: Optional[float] = None) -> Optional[TaskResult]:
        """Result of ``name`` if its broadcast has been delivered."""
        with self._lock:
            r = self._results.get(name)
        if r is None or r.error is not None:
            return None
        now = time.monotonic() if now is None else now
        if r.t_finish + self.latency <= now:
            return r
        return None

    def completed(self) -> Dict[str, TaskResult]:
        with self._lock:
            return {k: v for k, v in self._results.items() if v.error is None}

    def wait_all(self, names, timeout: float,
                 dead_after: Optional[int] = None) -> bool:
        """Block until every name has an error-free result, the timeout
        elapses, or — when ``dead_after`` is given — some task has
        accumulated ``dead_after`` distinct failed attempts with no
        success.  ``dead_after`` is the flight's whole attempt budget:
        ``size * (1 + max_retries)`` under a recovery policy (each member
        retries a failed task up to ``max_retries`` times before moving
        on), collapsing to ``size`` without one — once the budget is
        burned the task can never complete and the flight fails fast
        instead of waiting out the full timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                ok = all(n in self._results and self._results[n].error is None
                         for n in names)
                if ok:
                    return True
                if dead_after is not None:
                    dead = any(
                        len(self._errors.get(n, ())) >= dead_after
                        and (n not in self._results
                             or self._results[n].error is not None)
                        for n in names)
                    if dead:
                        return False
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._event.wait(rem)


@dataclasses.dataclass
class TaskContext:
    """Handed to every function invocation."""
    manifest_name: str
    task_name: str
    follower_index: int
    context: ExecutionContext
    inputs: Dict[str, Any]
    _cancel: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def sleep(self, dt: float, slice_s: float = 0.002):
        """Interruptible sleep — the preemption point (signal delivery)."""
        end = time.monotonic() + dt
        while True:
            if self._cancel.is_set():
                raise Preempted(self.task_name)
            rem = end - time.monotonic()
            if rem <= 0:
                return
            time.sleep(min(slice_s, rem))

    def checkpoint(self):
        if self._cancel.is_set():
            raise Preempted(self.task_name)


@dataclasses.dataclass
class ExecutorReport:
    index: int
    executed: List[str]
    skipped: List[str]
    preempted: List[str]
    failed: List[str]
    busy_time: float


@dataclasses.dataclass
class FlightReport:
    outputs: Dict[str, Any]
    ok: bool
    elapsed: float
    executors: List[ExecutorReport]
    duplicates: int

    @property
    def total_busy(self) -> float:
        return sum(e.busy_time for e in self.executors)


class _Executor(threading.Thread):
    def __init__(self, flight: "Flight", index: int):
        super().__init__(daemon=True, name=f"raptor-exec-{index}")
        self.flight = flight
        self.index = index
        self.report = ExecutorReport(index, [], [], [], [], 0.0)
        self.current_ctx: Optional[TaskContext] = None
        self._die = threading.Event()

    def preempt_current(self, task_name: str):
        ctx = self.current_ctx
        if ctx is not None and ctx.task_name == task_name:
            ctx._cancel.set()

    def kill(self):
        self._die.set()
        ctx = self.current_ctx
        if ctx is not None:
            ctx._cancel.set()

    def run(self):
        fl = self.flight
        seq = execution_sequence(fl.manifest, self.index)
        for name in seq:
            if self._die.is_set():
                break
            if fl.stream.visible(name) is not None:
                self.report.skipped.append(name)
                continue
            spec = fl.manifest.spec(name)
            inputs = {d: fl.stream.completed()[d].value
                      for d in spec.dependencies
                      if d in fl.stream.completed()}
            # retry loop: under a recovery policy a member re-attempts its
            # own failed invocation (backoff between attempts) before
            # moving on; every failed attempt is published so the stream's
            # dead-task budget counts attempts, not members
            for attempt in range(fl.attempt_budget):
                if self._die.is_set():
                    break
                if attempt and fl.stream.visible(name) is not None:
                    break          # a peer won while we were backing off
                ctx = TaskContext(fl.manifest.name, name, self.index,
                                  fl.context.fork(self.index) if self.index else fl.context,
                                  inputs)
                self.current_ctx = ctx
                fl.register_running(self.index, name)
                t0 = time.monotonic()
                try:
                    value = spec.fn(ctx) if spec.fn is not None else None
                    res = TaskResult(name, value, None, self.index,
                                     time.monotonic(), attempt)
                    self.report.executed.append(name)
                    won = fl.stream.publish(res)
                    if won:
                        fl.on_first_completion(name, self.index)
                    break
                except Preempted:
                    self.report.preempted.append(name)
                    break
                except Exception as e:  # noqa: BLE001 - executor failure path
                    self.report.failed.append(name)
                    fl.stream.publish(TaskResult(name, None, e, self.index,
                                                 time.monotonic(), attempt))
                finally:
                    self.report.busy_time += time.monotonic() - t0
                    fl.register_running(self.index, None)
                    self.current_ctx = None
                if attempt + 1 < fl.attempt_budget:
                    # backoff is idle time, not busy time
                    self._die.wait(fl.backoff_s(attempt))


class Flight:
    """N peer executors speculatively running one manifest invocation."""

    def __init__(self, manifest: ActionManifest, context: Optional[ExecutionContext] = None,
                 size: Optional[int] = None, stream_latency: float = 0.0,
                 recovery: Optional[Any] = None):
        validate_acyclic(manifest)
        self.manifest = manifest
        self.context = context or ExecutionContext.fresh()
        # elastic degradation (paper §3.3.2): fewer members than requested is
        # a smaller flight, not a failure.
        self.size = max(1, size if size is not None else manifest.concurrency)
        # ``recovery`` is duck-typed (anything exposing max_retries /
        # backoff_ms / backoff_jitter — e.g. repro_torch.sim.policies.
        # RecoveryPolicy) so the live engine carries no sim dependency;
        # None keeps the historical one-attempt-per-member behavior
        self.recovery = recovery
        self.attempt_budget = 1 + int(getattr(recovery, "max_retries", 0) or 0)
        self.stream = StateStream(latency=stream_latency)
        self._running: Dict[int, Optional[str]] = {}
        self._lock = threading.Lock()
        self._executors: List[_Executor] = []

    def register_running(self, idx: int, name: Optional[str]):
        with self._lock:
            self._running[idx] = name

    def backoff_s(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt + 1`` (exponential;
        jitter is deterministic-free here — the live engine's clock noise
        already decorrelates members)."""
        base = float(getattr(self.recovery, "backoff_ms", 0.0) or 0.0)
        return base * (2.0 ** attempt) / 1000.0

    def on_first_completion(self, name: str, winner: int):
        """Broadcast receipt: preempt peers still running ``name``
        (paper §3.3.4)."""
        for ex in self._executors:
            if ex.index != winner:
                ex.preempt_current(name)

    def run(self, timeout: float = 60.0) -> FlightReport:
        t0 = time.monotonic()
        self._executors = [_Executor(self, i) for i in range(self.size)]
        for ex in self._executors:
            ex.start()
        ok = self.stream.wait_all(self.manifest.names, timeout,
                                  dead_after=self.size * self.attempt_budget)
        # flight complete: reclaim everything still running
        for ex in self._executors:
            ex.kill()
        for ex in self._executors:
            ex.join(timeout=5.0)
        outputs = {k: v.value for k, v in self.stream.completed().items()}
        return FlightReport(
            outputs=outputs,
            ok=ok,
            elapsed=time.monotonic() - t0,
            executors=[ex.report for ex in self._executors],
            duplicates=self.stream.duplicates,
        )


class RaptorScheduler:
    """Top-level entry: schedules manifest invocations onto a bounded pool
    of executor slots, forming (possibly reduced) flights."""

    def __init__(self, num_workers: int = 8, stream_latency: float = 0.0):
        self.num_workers = num_workers
        self.stream_latency = stream_latency
        self._slots = threading.Semaphore(num_workers)

    def invoke(self, manifest: ActionManifest,
               params: Optional[Dict[str, Any]] = None,
               timeout: float = 60.0,
               recovery: Optional[Any] = None) -> FlightReport:
        want = manifest.concurrency
        got = 0
        for _ in range(want):
            if self._slots.acquire(blocking=(got == 0)):
                got += 1
        try:
            ctx = ExecutionContext.fresh(user_params=params or {})
            flight = Flight(manifest, ctx, size=got,
                            stream_latency=self.stream_latency,
                            recovery=recovery)
            return flight.run(timeout=timeout)
        finally:
            for _ in range(got):
                self._slots.release()
