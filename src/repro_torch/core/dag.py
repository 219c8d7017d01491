"""DAG construction and decorrelated execution sequences (paper §3.3.3).

Each executor linearises the manifest DAG by repeatedly searching — in
*reverse in-order*, starting from the sinks — for the first function whose
dependencies are all satisfied.  To decorrelate parallel executors, the
search order of candidate nodes is **cyclically shifted by the follower
index**, reproducing Table 3 exactly.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Mapping, Sequence, Tuple

from repro_torch.core.manifest import ActionManifest


def kahn_order(dep_map: Mapping[str, Sequence[str]]) -> List[str]:
    """Kahn's algorithm over a name -> dependencies map: the ONE toposort
    shared by the scalar and vector paths (manifest validation, the IR's
    level schedules, the stock stage-depth walk).

    Nodes pop in declaration order among the currently-available set (a
    heap on declaration index), so the order is deterministic and matches
    the old per-engine polling loops it replaces.  Raises ``ValueError``
    **naming one cycle** when the map is not a DAG.
    """
    names = list(dep_map)
    pos = {n: i for i, n in enumerate(names)}
    remaining = {n: {d for d in dep_map[n] if d != n} for n in names}
    self_cycle = next((n for n in names if n in dep_map[n]), None)
    if self_cycle is not None:
        raise ValueError(
            f"dependency cycle: {self_cycle} -> {self_cycle}")
    dependents: Dict[str, List[str]] = {n: [] for n in names}
    for n, ds in remaining.items():
        for d in ds:
            dependents[d].append(n)
    ready = [pos[n] for n, ds in remaining.items() if not ds]
    heapq.heapify(ready)
    out: List[str] = []
    while ready:
        n = names[heapq.heappop(ready)]
        out.append(n)
        for m in dependents[n]:
            remaining[m].discard(n)
            if not remaining[m]:
                heapq.heappush(ready, pos[m])
    if len(out) != len(names):
        # walk the leftover subgraph until a node repeats: that loop IS
        # a cycle, and the error names it (start at the first declared
        # leftover so the message is hash-seed independent)
        left = {n for n in names if remaining[n]}
        path, seen, n = [], {}, next(n for n in names if remaining[n])
        while n not in seen:
            seen[n] = len(path)
            path.append(n)
            n = next(d for d in dep_map[n] if d in left)
        cyc = path[seen[n]:] + [n]
        raise ValueError(f"dependency cycle: {' -> '.join(cyc)}")
    return out


def validate_acyclic(manifest: ActionManifest) -> List[str]:
    """Toposort the manifest via :func:`kahn_order`; raises ValueError
    naming a cycle.  Returns one topo order."""
    return kahn_order(manifest.dependency_map())


def _search_order(manifest: ActionManifest) -> List[str]:
    """Reverse in-order node visitation: sinks first, then their
    dependencies depth-first in REVERSED declaration order (the paper walks
    the DAG 'starting at the end ... in the reverse direction'; this
    ordering reproduces Table 3 exactly — see test_core_dag)."""
    children = manifest.dependency_map()
    is_dep = {d for f in manifest.functions for d in f.dependencies}
    sinks = [n for n in manifest.names if n not in is_dep]
    order: List[str] = []
    seen = set()

    def visit(n: str):
        if n in seen:
            return
        seen.add(n)
        order.append(n)
        for d in children[n]:
            visit(d)

    for s in sinks:
        visit(s)
    return order


def execution_sequence(manifest: ActionManifest, follower_index: int) -> List[str]:
    """The order in which executor ``follower_index`` runs the functions.

    At every step, collect the runnable candidates in reverse in-order
    search order and apply a cyclic shift **by the follower index** to the
    candidate list — executor i takes the i-th runnable (mod count).  This
    is the paper's §3.3.3 shift applied at the scan level; it reproduces
    Table 3 exactly AND spreads any flight maximally over every DAG shape
    (a static whole-list rotation collides executors on fan-out nodes —
    see test_core_dag.py for both properties).
    """
    validate_acyclic(manifest)
    base = _search_order(manifest)
    n = len(base)
    done: List[str] = []
    deps = manifest.dependency_map()
    while len(done) < n:
        cands = [c for c in base
                 if c not in done and all(d in done for d in deps[c])]
        if not cands:  # pragma: no cover - unreachable on a validated DAG
            raise RuntimeError("no runnable function found")
        done.append(cands[follower_index % len(cands)])
    return done


def sequences_for_flight(manifest: ActionManifest) -> List[List[str]]:
    return [execution_sequence(manifest, i) for i in range(manifest.concurrency)]


def ready_functions(manifest: ActionManifest, completed: Sequence[str]) -> Tuple[str, ...]:
    deps = manifest.dependency_map()
    done = set(completed)
    return tuple(n for n in manifest.names
                 if n not in done and all(d in done for d in deps[n]))
