"""Attempt-level recovery policy: timeout, bounded retry, hedging.

:class:`RecoveryPolicy` names the recovery design space declaratively
(``timeout_ms``, ``max_retries``/``backoff_ms``/``backoff_jitter``, the
stock-only ``hedge_ms``).  The engines of this package run the default
policy only: a non-default policy switches the reference engines onto
their fault branch, which is not ported yet, so
:class:`repro_torch.sim.vector_queue.QueueFlightSim` refuses it.
:func:`can_fail` is the static gate the race budgets read.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.sim.faults import FaultProfile

@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    timeout_ms: float = math.inf
    max_retries: int = 0
    backoff_ms: float = 0.0
    backoff_jitter: float = 0.0    # multiplicative U[1, 1+jitter) on backoff
    hedge_ms: float = math.inf     # stock only; raptor racing = hedge-at-0

    @property
    def is_default(self) -> bool:
        return (math.isinf(self.timeout_ms) and self.max_retries == 0
                and math.isinf(self.hedge_ms))

    @property
    def has_hedge(self) -> bool:
        return math.isfinite(self.hedge_ms)

    @property
    def chain_attempts(self) -> int:
        """Attempts in one retry chain (primary + retries)."""
        return 1 + self.max_retries

    @property
    def stock_attempts(self) -> int:
        """Attempt slots per stock task: the chain plus the hedge copy."""
        return self.chain_attempts + (1 if self.has_hedge else 0)

    def backoff(self, r: int, u: float) -> float:
        """Backoff before retry ``r+1`` (exponential, jittered)."""
        return self.backoff_ms * (2.0 ** r) * (1.0 + self.backoff_jitter * u)


#: the no-op policy — engines compile to their pre-policy paths
NO_RECOVERY = RecoveryPolicy()


def can_fail(base_fail: float, faults: FaultProfile | None,
             policy: RecoveryPolicy | None) -> bool:
    """Static: can ANY attempt outcome be a failure?  Gates the race event
    budgets, the closed forms, and the error-uniform draws."""
    if base_fail > 0.0:
        return True
    if policy is not None and math.isfinite(policy.timeout_ms):
        return True
    if faults is not None and faults.enabled:
        if faults.degraded_fail_prob > 0.0 or faults.has_crashes:
            return True
    return False
