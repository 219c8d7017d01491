"""Declarative workflow specs compiled to one IR for every engine.

The paper's action manifests (§3.3.1, Table 1) are a general DAG
abstraction, but hand-transcribing each workflow per engine (scalar
oracle dep-dicts, vector deps tuples, streaming static keys) caps the
reproduction at two graphs.  This module is the single frontend:

* **spec combinators** — :func:`task`, :func:`chain`, :func:`fanout`
  (parameterized rank), :func:`branch`, :func:`barrier`, and
  data-dependent :func:`conditional` on task outcomes — compose an
  immutable spec tree (the taxonomy of Ripple's declarative frontend
  and Wukong's DAG model, PAPERS.md);
* :func:`compile_spec` lowers any spec to a :class:`WorkflowGraph` —
  the one IR every engine consumes: per-member dependency masks
  (:meth:`WorkflowGraph.dep_mask`, :meth:`WorkflowGraph
  .member_sequences`), level schedules (:meth:`WorkflowGraph.levels`),
  conditional select masks (:attr:`WorkflowGraph.cond_static`), and
  per-task service-model bindings (:attr:`WorkflowGraph.means`).

``WorkflowGraph`` is frozen and hashable, so the compiled graph IS the
static cache key of the trial factories and the sweep bucket
cores (`sim/vector_queue.py`, `sim/sweeps.py`) — content-equal graphs
share compiled executables, and :attr:`WorkflowGraph.manifest_hash`
names the compiled content for bench records and bucket bookkeeping.

Chain linking rule: consecutive fragments connect **lane-wise** when
the upstream sink count equals the downstream source count (ranked
fan-out lanes stay parallel), else **all-to-all** (a fan-in join);
:func:`barrier` forces the all-to-all collapse regardless of rank —
the explicit synchronization point.

Conditional semantics (mask-select on outcomes): the guard task's
FIRST finished attempt decides the branch regardless of its
success/failure — failure is a *routing outcome*, not a job error.
Every task in the not-taken branch is cancelled at that instant
(marked complete with zero service; its dependents become runnable).
All gated tasks structurally depend on the guard, so no executor can
be mid-attempt on a task when it is cancelled.  Nested conditionals
are rejected at compile time (one (guard, sense) select slot per
task).  The stock baseline has no data-dependent short-circuiting, so
stock engines consume :meth:`WorkflowGraph.flatten` — both branches
run unconditionally.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# spec combinators (an immutable AST)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Task:
    """One unit of work: a name and its mean service time binding."""
    name: str
    mean_ms: float = 1.0


@dataclasses.dataclass(frozen=True)
class Chain:
    parts: Tuple


@dataclasses.dataclass(frozen=True)
class Fanout:
    proto: object
    rank: int


@dataclasses.dataclass(frozen=True)
class Branch:
    parts: Tuple


@dataclasses.dataclass(frozen=True)
class Barrier:
    pass


@dataclasses.dataclass(frozen=True)
class Conditional:
    guard: Task
    then: object
    orelse: Optional[object] = None


def task(name: str, mean_ms: float = 1.0) -> Task:
    return Task(str(name), float(mean_ms))


def chain(*parts) -> Chain:
    """Sequential composition; lane-wise when ranks match, else fan-in."""
    if not parts:
        raise ValueError("chain needs at least one part")
    return Chain(tuple(parts))


def fanout(proto, rank: int) -> Fanout:
    """``rank`` replicas of ``proto``, each task name suffixed by its
    lane index (``task('map')`` -> ``map0..map{rank-1}``)."""
    if rank < 1:
        raise ValueError(f"fanout rank must be >= 1, got {rank}")
    return Fanout(proto, int(rank))


def branch(*parts) -> Branch:
    """Independent parallel composition (no cross-part edges)."""
    if not parts:
        raise ValueError("branch needs at least one part")
    return Branch(tuple(parts))


def barrier() -> Barrier:
    """Explicit sync point inside a chain: forces the next link to join
    all-to-all even when lane counts match."""
    return Barrier()


def conditional(guard: Task, then, orelse=None) -> Conditional:
    """Data-dependent branch on ``guard``'s outcome: ``then`` runs when
    the guard's deciding attempt succeeds, ``orelse`` when it fails; the
    other branch is cancelled (mask-select, see module docstring)."""
    if not isinstance(guard, Task):
        raise ValueError("conditional guard must be a single task()")
    return Conditional(guard, then, orelse)


# --------------------------------------------------------------------------
# compilation: spec tree -> fragment -> WorkflowGraph
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Fragment:
    """Partially-linked subgraph: ordered rows + open frontier lists."""
    rows: list          # [name, mean, deps(list), cond((guard, sense)|None)]
    sources: list       # task names awaiting upstream edges
    sinks: list         # task names downstream fragments attach to


def _suffixed(frag: _Fragment, i: int) -> _Fragment:
    ren = {r[0]: f"{r[0]}{i}" for r in frag.rows}
    rows = [[ren[n], m, [ren[d] for d in ds],
             None if c is None else (ren[c[0]], c[1])]
            for n, m, ds, c in frag.rows]
    return _Fragment(rows, [ren[s] for s in frag.sources],
                     [ren[s] for s in frag.sinks])


def _concat(frags) -> _Fragment:
    out = _Fragment([], [], [])
    for f in frags:
        out.rows += f.rows
        out.sources += f.sources
        out.sinks += f.sinks
    return out


def _link(up: _Fragment, down: _Fragment, force_join: bool) -> None:
    """Wire ``down.sources`` onto ``up.sinks``: lane-wise on matching
    rank (unless a barrier forced the join), else all-to-all."""
    by_name = {r[0]: r for r in down.rows}
    if not force_join and len(up.sinks) == len(down.sources):
        for s, d in zip(up.sinks, down.sources):
            by_name[d][2].append(s)
    else:
        for d in down.sources:
            by_name[d][2].extend(up.sinks)


def _build(node) -> _Fragment:
    if isinstance(node, Task):
        return _Fragment([[node.name, node.mean_ms, [], None]],
                         [node.name], [node.name])
    if isinstance(node, Fanout):
        return _concat(_suffixed(_build(node.proto), i)
                       for i in range(node.rank))
    if isinstance(node, Branch):
        return _concat(_build(p) for p in node.parts)
    if isinstance(node, Chain):
        frags, pending = [], False
        for part in node.parts:
            if isinstance(part, Barrier):
                if not frags:
                    raise ValueError("barrier cannot open a chain")
                pending = True
                continue
            frag = _build(part)
            if frags:
                _link(frags[-1], frag, pending)
            frags.append(frag)
            pending = False
        if pending:
            raise ValueError("barrier cannot close a chain")
        if not frags:
            raise ValueError("chain needs at least one non-barrier part")
        out = _concat(frags)
        out.sources = frags[0].sources
        out.sinks = frags[-1].sinks
        return out
    if isinstance(node, Conditional):
        guard = _build(node.guard)
        gname = guard.rows[0][0]
        arms = [(node.then, True)]
        if node.orelse is not None:
            arms.append((node.orelse, False))
        out = _Fragment(list(guard.rows), list(guard.sources), [])
        for arm, sense in arms:
            frag = _build(arm)
            for row in frag.rows:
                if row[3] is not None:
                    raise ValueError(
                        f"nested conditional at task {row[0]!r}: one "
                        "(guard, sense) select slot per task")
                row[3] = (gname, sense)
            # gated tasks structurally depend on the guard, so nothing
            # can be mid-attempt when the deciding event cancels a branch
            for s in frag.sources:
                next(r for r in frag.rows if r[0] == s)[2].append(gname)
            out.rows += frag.rows
            out.sinks += frag.sinks
        return out
    if isinstance(node, Barrier):
        raise ValueError("barrier is only meaningful inside a chain")
    raise TypeError(f"not a workflow spec node: {node!r}")


def compile_spec(spec, *, name: str) -> "WorkflowGraph":
    """Lower a combinator spec to the :class:`WorkflowGraph` IR."""
    frag = _build(spec)
    names = [r[0] for r in frag.rows]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate task names in spec: {dupes}")
    idx = {n: i for i, n in enumerate(names)}
    # dedupe edges preserving first-seen order (lane + join links can
    # both land on a source when ranks collapse)
    deps = tuple(tuple(dict.fromkeys(r[2])) for r in frag.rows)
    guard = tuple(-1 if r[3] is None else idx[r[3][0]] for r in frag.rows)
    sense = tuple(False if r[3] is None else bool(r[3][1])
                  for r in frag.rows)
    return WorkflowGraph(name=str(name), tasks=tuple(names),
                         means=tuple(float(r[1]) for r in frag.rows),
                         deps=deps, cond_guard=guard, cond_sense=sense)


# --------------------------------------------------------------------------
# the IR
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkflowGraph:
    """One compiled workflow: the IR every engine consumes.

    Frozen and hashable — field tuples only — so the graph itself is the
    static key of the lru-cached trial factories and the sweep bucket
    cores.  ``cond_guard[t] == -1`` marks an unconditional task; else it
    is the guard's task index and ``cond_sense[t]`` the outcome that
    keeps task ``t`` alive (see module docstring).
    """
    name: str
    tasks: Tuple[str, ...]
    means: Tuple[float, ...]
    deps: Tuple[Tuple[str, ...], ...]
    cond_guard: Tuple[int, ...] = ()
    cond_sense: Tuple[bool, ...] = ()

    def __post_init__(self):
        k = len(self.tasks)
        if not self.cond_guard:
            object.__setattr__(self, "cond_guard", (-1,) * k)
        if not self.cond_sense:
            object.__setattr__(self, "cond_sense", (False,) * k)
        if not (len(self.means) == len(self.deps) == len(self.cond_guard)
                == len(self.cond_sense) == k):
            raise ValueError(
                f"{self.name!r}: tasks/means/deps/cond lengths disagree")
        known = set(self.tasks)
        if len(known) != k:
            raise ValueError(f"{self.name!r}: duplicate task names")
        for t, ds in zip(self.tasks, self.deps):
            missing = set(ds) - known
            if missing:
                raise ValueError(f"{t}: unknown dependencies {missing}")
        from repro_torch.core.dag import kahn_order   # dag imports manifest
        kahn_order(dict(zip(self.tasks, self.deps)))  # names any cycle
        closure = self._ancestors()
        for t, g in enumerate(self.cond_guard):
            if g < 0:
                continue
            if not 0 <= g < k:
                raise ValueError(f"{self.tasks[t]}: guard index {g} out "
                                 "of range")
            if self.cond_guard[g] >= 0:
                raise ValueError(
                    f"{self.tasks[t]}: guard {self.tasks[g]!r} is itself "
                    "conditional (nested conditionals are rejected)")
            if g not in closure[t]:
                raise ValueError(
                    f"{self.tasks[t]}: must depend (transitively) on its "
                    f"guard {self.tasks[g]!r} so cancellation can never "
                    "hit a running attempt")

    # -- core shape ------------------------------------------------------
    @property
    def K(self) -> int:
        return len(self.tasks)

    @functools.cached_property
    def index(self) -> Dict[str, int]:
        return {t: i for i, t in enumerate(self.tasks)}

    def dep_map(self) -> Dict[str, Tuple[str, ...]]:
        return dict(zip(self.tasks, self.deps))

    def _ancestors(self):
        idx = {t: i for i, t in enumerate(self.tasks)}
        anc = [set() for _ in self.tasks]
        for t in self.topo_order():
            for d in self.deps[t]:
                di = idx[d]
                anc[t].add(di)
                anc[t] |= anc[di]
        return anc

    # -- dependency masks (the vector engines' statics) ------------------
    @functools.cached_property
    def _dep_mask_np(self) -> np.ndarray:
        m = np.zeros((self.K, self.K), dtype=bool)
        for t, ds in enumerate(self.deps):
            for d in ds:
                m[t, self.index[d]] = True
        return m

    def dep_mask(self) -> np.ndarray:
        """(K, K) bool, ``mask[t, d]`` = task t needs task d (read-only)."""
        return self._dep_mask_np

    @functools.cached_property
    def has_deps(self) -> bool:
        return any(len(d) for d in self.deps)

    def member_sequences(self, flight: int) -> np.ndarray:
        """(F, K) member task orders — the §3.3.3 cyclic-shift
        linearisation (``core.dag.execution_sequence``), as indices."""
        from repro_torch.core.dag import execution_sequence
        man = self.to_manifest(max(int(flight), 1))
        return np.array([[self.index[t] for t in execution_sequence(man, m)]
                         for m in range(int(flight))])

    # -- level schedules -------------------------------------------------
    def topo_order(self) -> Tuple[int, ...]:
        from repro_torch.core.dag import kahn_order
        order = kahn_order(dict(zip(self.tasks, self.deps)))
        return tuple(self.index[t] for t in order)

    @functools.cached_property
    def _depths(self) -> Tuple[int, ...]:
        depth = [0] * self.K
        for t in self.topo_order():
            if self.deps[t]:
                depth[t] = 1 + max(depth[self.index[d]]
                                   for d in self.deps[t])
        return tuple(depth)

    def stage_depth(self) -> int:
        return max(self._depths) if self.K else 0

    def levels(self) -> Tuple[Tuple[int, ...], ...]:
        """Tasks grouped by stage depth — the level schedule."""
        return tuple(
            tuple(t for t in range(self.K) if self._depths[t] == lv)
            for lv in range(self.stage_depth() + 1))

    # -- conditional select masks ----------------------------------------
    @functools.cached_property
    def has_conditionals(self) -> bool:
        return any(g >= 0 for g in self.cond_guard)

    @property
    def cond_static(self):
        """``(cond_guard, cond_sense)`` when any task is gated, else
        ``None`` — the trial factories statically elide the select logic
        on ``None`` (bitwise the pre-conditional scan)."""
        if not self.has_conditionals:
            return None
        return (self.cond_guard, self.cond_sense)

    def flatten(self) -> "WorkflowGraph":
        """Drop the conditional select masks (deps kept): the stock
        baseline's view, where both branches run unconditionally."""
        if not self.has_conditionals:
            return self
        return WorkflowGraph(name=self.name, tasks=self.tasks,
                             means=self.means, deps=self.deps)

    # -- interop ---------------------------------------------------------
    def to_manifest(self, concurrency: int = 1):
        from repro_torch.core.manifest import ActionManifest, FunctionSpec
        return ActionManifest(
            tuple(FunctionSpec(t, None, tuple(d))
                  for t, d in zip(self.tasks, self.deps)),
            concurrency=max(int(concurrency), 1), name=self.name)

    @functools.cached_property
    def manifest_hash(self) -> str:
        """sha256 of the canonical compiled content — the identity the
        sweep bucket keys and bench records carry for a compiled graph."""
        canon = repr((self.name, self.tasks, self.means, self.deps,
                      self.cond_guard, self.cond_sense))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]
