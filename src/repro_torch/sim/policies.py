"""Attempt-level recovery policy: timeout, bounded retry, hedging.

The port of ``repro/sim/policies.py``.  :class:`RecoveryPolicy` names the
recovery design space declaratively:

* ``timeout_ms`` — an attempt running longer fails at the timeout;
* ``max_retries``/``backoff_ms``/``backoff_jitter`` — a failed attempt is
  retried on the SAME worker after ``backoff_ms * 2**r * (1 + jitter*U)``;
  the whole chain counts as one racing attempt;
* ``hedge_ms`` — stock engine only: if the primary attempt is still
  running ``hedge_ms`` after it started, a duplicate is enqueued on
  another worker (no cancellation; first success wins).

Retried and hedged attempts reuse the SAME service draw (deterministic
re-execution); per-attempt error uniforms are redrawn; intermediate chain
failures broadcast nothing.

:func:`fold_chain` turns a whole timeout/retry/backoff chain into ONE
``(end, failed)`` pair at scheduling time, so the race keeps one event per
(member, task); :func:`chain_transform` is its open-loop limit, and
:func:`fold_chain_np` the scalar oracle's float64 twin.

Rounding: the reference runs these folds jitted on XLA, which contracts a
multiply feeding an add into one fused multiply-add and drops
``min(x, inf)``.  The port rounds as it does — :func:`fma` where XLA
fuses, plain float32 operations elsewhere — so both folds are bitwise the
reference's (tests/test_torch_faults.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.sim.faults import (FaultProfile, first_start_in,
                                    first_start_in_np, interval_active,
                                    interval_active_np, push_out,
                                    push_out_np)


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


#: the no-op policy — engines run their pre-policy paths
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


def fault_statics(fail_prob: float, faults: FaultProfile | None,
                  policy: RecoveryPolicy | None):
    """``(fault_mode, policy, faults, anyfail)``, the statics every engine
    branches on.  Fault mode is an enabled profile or a non-default
    policy; ``policy`` comes back :data:`NO_RECOVERY` when ``None``;
    ``faults`` comes back ``None`` unless enabled (policy-only mode rides
    the inactive sentinel tables); ``anyfail`` says whether any attempt
    can fail (it gates the race budgets and the error draws)."""
    fault_mode = ((faults is not None and faults.enabled)
                  or (policy is not None and not policy.is_default))
    pol = policy if policy is not None else NO_RECOVERY
    fp = faults if (faults is not None and faults.enabled) else None
    anyfail = (can_fail(fail_prob, fp, pol) if fault_mode
               else fail_prob > 0.0)
    return fault_mode, pol, fp, anyfail


# --------------------------------------------------------------------------
# float32 arithmetic as the reference's compiled folds round it
# --------------------------------------------------------------------------

def _f32(x: float) -> float:
    """A Python scalar rounded to float32, as it enters float32 math."""
    return float(np.float32(x))


def fma(a, b, c):
    """``a * b + c`` rounded once to float32 (a fused multiply-add).  The
    product of two float32 values is exact in float64; the sum is rounded
    there and then to float32 (the double rounding differs from a true
    fused operation on about one input in 2^29).  Scalars are float32
    values first."""
    def wide(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return _f32(x)
    out = wide(a) * wide(b) + wide(c)
    if not isinstance(out, torch.Tensor):
        raise TypeError("fma needs at least one tensor operand")
    return out.float()


def backoff_after(t, policy: RecoveryPolicy, r: int, u):
    """``t + backoff_ms * 2**r * (1 + jitter * u)``: the ready time of the
    retry after an attempt that ended at ``t``, in the reference's
    rounding (two fused multiply-adds)."""
    x = fma(policy.backoff_jitter, u, 1.0)
    return fma(policy.backoff_ms * (2.0 ** r), x, t)


def attempt_end(s, z, mult, timeout_ms: float):
    """``(end, zi)`` of an attempt started at ``s`` with base duration
    ``z`` and service multiplier ``mult``: ``zi = z * mult`` and ``end = s
    + min(zi, timeout)``.  Without a timeout the reference drops the
    ``min`` and fuses the multiply into the add."""
    zi = z * mult
    if math.isinf(timeout_ms):
        return fma(z, mult, s), zi
    return s + torch.clamp_max(zi, timeout_ms), zi


# --------------------------------------------------------------------------
# attempt arithmetic — one attempt, then the folded chain
# --------------------------------------------------------------------------
# An attempt asked to start at t on worker w in AZ a:
#   s       = push_out(t, crash outages of w)        (never start in one)
#   deg     = AZ a degraded at s
#   zi      = z * (inflation if deg else 1)
#   dur     = min(zi, timeout);  timeout-fail iff zi > timeout
#   p       = degraded_fail_prob if deg else base_fail;  error iff U < p
#   crash   = first crash start in (s, s+dur) kills the attempt there
#   end     = crash time if crashed else s + dur
# The chain runs attempts until one succeeds or the budget is spent; the
# next attempt starts at end + backoff(r).

def fold_chain(t0, z, u_err, u_jit, bs, be, cs, ce, *,
               policy: RecoveryPolicy, faults: FaultProfile | None,
               base_fail: float):
    """Batched chain fold.

    ``t0``/``z``: ``(...)`` requested start and base attempt duration;
    ``u_err``: ``(..., R+1)`` per-attempt error uniforms; ``u_jit``:
    ``(..., R)`` backoff jitter uniforms; ``bs``/``be``: ``(..., I)``
    brownout tables of each lane's AZ; ``cs``/``ce``: ``(..., C)`` crash
    tables of its worker — contiguous, with exactly the leading axes of
    ``t0``, and sorted, as drawn tables are: they are queried by binary
    search (the helpers of :mod:`repro_torch.sim.faults`).
    Returns ``(end, failed)`` — the chain's completion time and final
    outcome.  Statically unrolled over the retry budget (R is tiny).
    """
    infl = faults.degraded_inflation if faults is not None else 1.0
    pdeg = (faults.degraded_fail_prob if faults is not None else base_fail)
    def push(t):
        return push_out(t[..., None], cs, ce)[..., 0]

    def active(t):
        return interval_active(t[..., None], bs, be)[..., 0]

    def first_crash(s, e):
        return first_start_in(s[..., None], e[..., None], cs)[..., 0]

    end = failed = settled = None
    t = t0
    for r in range(policy.max_retries + 1):
        s = push(t)
        deg = active(s)
        fin, zi = attempt_end(s, z, torch.where(deg, infl, 1.0),
                              policy.timeout_ms)
        p = torch.where(deg, pdeg, base_fail)
        a_fail = (u_err[..., r] < p) | (zi > policy.timeout_ms)
        c1 = first_crash(s, fin)
        crashed = c1 < fin
        a_end = torch.where(crashed, c1, fin)
        a_fail = a_fail | crashed
        if r == 0:
            end, failed, settled = a_end, a_fail, ~a_fail
        else:
            end = torch.where(settled, end, a_end)
            failed = torch.where(settled, failed, a_fail)
            settled = settled | ~a_fail
        if r < policy.max_retries:
            t = backoff_after(a_end, policy, r, u_jit[..., r])
    return end, failed


def chain_transform(z, u_err, u_jit, deg, *, policy: RecoveryPolicy,
                    faults: FaultProfile | None, base_fail: float):
    """Open-loop chain fold — the zero-queueing limit of
    :func:`fold_chain`.

    One open-loop trial is one invocation on an idle cluster, so the
    brownout state is a stationary snapshot frozen for the invocation
    (``deg``) and crashes and hedging do not apply.  With the AZ state
    frozen and the service draw reused, an attempt's duration and timeout
    outcome repeat exactly, so the chain reduces to a draw transform:
    total busy time = attempt durations + backoffs while failing, final
    outcome = every attempt errored.

    ``z``: ``(...)`` base durations; ``u_err``: ``(..., R+1)``; ``u_jit``:
    ``(..., R)``; ``deg``: ``(...)`` bool.  Returns ``(duration,
    failed)``.
    """
    infl = faults.degraded_inflation if faults is not None else 1.0
    pdeg = (faults.degraded_fail_prob if faults is not None else base_fail)
    mult = torch.where(deg, infl, 1.0)
    zi = z * mult
    no_timeout = math.isinf(policy.timeout_ms)
    dur1 = zi if no_timeout else torch.clamp_max(zi, policy.timeout_ms)
    tfail = zi > policy.timeout_ms
    p = torch.where(deg, pdeg, base_fail)
    failed = (u_err[..., 0] < p) | tfail
    total = dur1
    for r in range(1, policy.max_retries + 1):
        a_fail = (u_err[..., r] < p) | tfail
        again = backoff_after(total, policy, r - 1, u_jit[..., r - 1])
        again = fma(z, mult, again) if no_timeout else again + dur1
        total = torch.where(failed, again, total)
        failed = failed & a_fail
    return total, failed


# --------------------------------------------------------------------------
# the scalar oracle's forms (float64 numpy, one attempt at a time)
# --------------------------------------------------------------------------

def attempt_outcome_np(t: float, z: float, u_err: float, deg_bs, deg_be,
                       cs, ce, *, policy: RecoveryPolicy,
                       faults: FaultProfile | None, base_fail: float):
    """One scalar attempt: returns (start, end, failed)."""
    s = push_out_np(t, cs, ce)
    deg = (faults is not None and interval_active_np(s, deg_bs, deg_be))
    zi = z * (faults.degraded_inflation if deg else 1.0) \
        if faults is not None else z
    dur = min(zi, policy.timeout_ms)
    p = ((faults.degraded_fail_prob if deg else base_fail)
         if faults is not None else base_fail)
    a_fail = (u_err < p) or (zi > policy.timeout_ms)
    c1 = first_start_in_np(s, s + dur, cs)
    crashed = c1 < s + dur
    end = c1 if crashed else s + dur
    return s, end, (a_fail or crashed)


def fold_chain_np(t0: float, z: float, rng, deg_bs, deg_be, cs, ce, *,
                  policy: RecoveryPolicy, faults: FaultProfile | None,
                  base_fail: float):
    """Scalar chain fold — the oracle's twin of :func:`fold_chain`.
    Draws the per-attempt error/jitter uniforms from ``rng`` (the vector
    engines pre-draw theirs; both are i.i.d. per attempt)."""
    t = float(t0)
    end, a_fail = t, True
    for r in range(policy.max_retries + 1):
        _, end, a_fail = attempt_outcome_np(
            t, z, float(rng.random()), deg_bs, deg_be, cs, ce,
            policy=policy, faults=faults, base_fail=base_fail)
        if not a_fail:
            return end, False
        if r < policy.max_retries:
            t = end + policy.backoff(r, float(rng.random()))
    return end, True
