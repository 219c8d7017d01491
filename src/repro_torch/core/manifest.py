"""Action manifests and execution contexts (paper §3.3.1–§3.3.2).

An *action manifest* indexes the user functions of a workflow by name,
declares their dependencies (a DAG), and sets the flight concurrency
(Table 1).  An *execution context* wraps user parameters with the metadata
Raptor adds during an action fork (Table 2): context UUID, leader address,
follower index.
"""
from __future__ import annotations

import dataclasses
import uuid as _uuid
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """One row of an action manifest."""
    name: str
    fn: Optional[Callable] = None          # the executable ("Location")
    dependencies: Tuple[str, ...] = ()
    # resources consumed while running (for capacity accounting)
    cost: float = 1.0


@dataclasses.dataclass(frozen=True)
class ActionManifest:
    """DAG of functions + flight concurrency (paper Table 1)."""
    functions: Tuple[FunctionSpec, ...]
    concurrency: int = 1
    name: str = "manifest"

    def __post_init__(self):
        names = [f.name for f in self.functions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate function names in manifest: {names}")
        known = set(names)
        for f in self.functions:
            missing = set(f.dependencies) - known
            if missing:
                raise ValueError(f"{f.name}: unknown dependencies {missing}")
        if self.concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        # a cyclic manifest dies HERE, naming the cycle — not deep inside
        # an engine's toposort (function-level import: core.dag imports
        # this module at its top level)
        from repro_torch.core.dag import kahn_order
        kahn_order({f.name: f.dependencies for f in self.functions})
        # name -> spec index for O(1) lookups; written through
        # object.__setattr__ (frozen dataclass) and excluded from the
        # generated __eq__/__hash__, which cover declared fields only
        object.__setattr__(self, "_by_name",
                           {f.name: f for f in self.functions})

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.functions)

    def spec(self, name: str) -> FunctionSpec:
        return self._by_name[name]

    def dependency_map(self) -> Dict[str, Tuple[str, ...]]:
        return {f.name: f.dependencies for f in self.functions}


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """Invocation metadata added by the action fork (paper Table 2)."""
    context_uuid: str
    leader_address: str
    follower_index: int                    # 0 = flight leader
    user_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def fresh(cls, leader_address: str = "local", follower_index: int = 0,
              user_params: Optional[Mapping[str, Any]] = None):
        return cls(context_uuid=str(_uuid.uuid4()),
                   leader_address=leader_address,
                   follower_index=follower_index,
                   user_params=user_params or {})

    def fork(self, follower_index: int) -> "ExecutionContext":
        """Recursive invocation for follower ``follower_index`` (> 0)."""
        if follower_index <= 0:
            raise ValueError("followers must have index > 0")
        return dataclasses.replace(self, follower_index=follower_index)


def sequential(names_fns: Sequence[Tuple[str, Callable]], concurrency: int = 1,
               name: str = "seq") -> ActionManifest:
    """Chain helper: fn_i depends on fn_{i-1}."""
    fns = []
    prev: Tuple[str, ...] = ()
    for n, f in names_fns:
        fns.append(FunctionSpec(n, f, prev))
        prev = (n,)
    return ActionManifest(tuple(fns), concurrency, name)


def parallel(names_fns: Sequence[Tuple[str, Callable]], concurrency: int = 1,
             name: str = "par") -> ActionManifest:
    """All-independent helper (e.g. the 2x ssh-keygen manifest, Table 8)."""
    return ActionManifest(
        tuple(FunctionSpec(n, f) for n, f in names_fns), concurrency, name)
