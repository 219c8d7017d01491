"""Correlated fault injection: AZ brownouts and worker crashes as interval
tables.

The port of ``repro/sim/faults.py``.  Two fault processes:

* **AZ brownouts**: each AZ alternates healthy/degraded through an on/off
  CTMC (exp(``az_mtbf_ms``) up, exp(``az_mttr_ms``) down).  While degraded,
  service times inflate by ``degraded_inflation`` and the per-attempt
  error probability rises to ``degraded_fail_prob``.  ``correlated=True``
  drives every AZ from ONE shared process.
* **worker crashes**: each worker fails after exp(``crash_mtbf_ms``) of
  wall-clock and is unavailable for ``crash_restart_ms``.  A crash kills
  the in-flight attempt at the crash instant; bookings never start inside
  an outage — they are pushed past its end.

Both processes are pre-drawn as interval tables (``(n, max_intervals)``
start/end pairs), exogenous inputs of the replay, so every blocked and
log-depth configuration stays bitwise equal to the ``block=1`` oracle
with faults on.  After the last drawn cycle a process is healthy forever:
size the tables to the horizon with :meth:`FaultProfile.coverage_ms`.
A process that is off is the one-column ``[inf, inf)`` sentinel table.

The interval helpers answer each query by one binary search in its
table row, on tables whose starts and ends are non-decreasing along the
last axis, as drawn tables and the sentinels are: the intervals are then
disjoint and in order, so only the last interval starting at or before
``t`` can hold it, and only the first start after ``s`` can be the
earliest inside ``(s, e)``.  They equal the reference's full scans over
the table (tests/test_torch_faults.py) and keep a booking's cost
logarithmic in the table width.  The query axis is explicit, as in
``torch.searchsorted``: ``t`` is ``(..., M)``, ``M`` queries against each
``(..., C)`` table row with the same leading axes; the reference's one
query per row is ``t[..., None]``.  The ``*_np`` helpers are the scalar
oracle's full scans over one numpy table row.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Declarative fault environment (hashable — it joins the static keys
    of the cached trial factories and the sweep bucket keys).

    Defaults describe a healthy cluster; ``enabled`` is False until a
    brownout or crash process is configured.
    """
    az_mtbf_ms: float = 0.0        # mean healthy dwell per AZ (0 = off)
    az_mttr_ms: float = 0.0        # mean degraded dwell per AZ
    correlated: bool = False       # one shared brownout process for all AZs
    degraded_inflation: float = 1.0   # service multiplier while degraded
    degraded_fail_prob: float = 0.0   # per-attempt error prob while degraded
    crash_mtbf_ms: float = 0.0     # mean per-worker uptime (0 = off)
    crash_restart_ms: float = 0.0  # outage length after a crash
    max_intervals: int = 64        # static brownout table width per AZ
    max_crashes: int = 32          # static crash table width per worker

    @property
    def has_brownouts(self) -> bool:
        return self.az_mtbf_ms > 0.0 and self.az_mttr_ms > 0.0

    @property
    def has_crashes(self) -> bool:
        return self.crash_mtbf_ms > 0.0

    @property
    def enabled(self) -> bool:
        return self.has_brownouts or self.has_crashes

    @property
    def stationary_degraded(self) -> float:
        """CTMC stationary probability of the degraded state."""
        if not self.has_brownouts:
            return 0.0
        return self.az_mttr_ms / (self.az_mtbf_ms + self.az_mttr_ms)

    def coverage_ms(self) -> float:
        """Expected horizon the drawn tables cover (mean cycle x width).
        Size ``max_intervals``/``max_crashes`` so this comfortably exceeds
        the replay horizon — beyond the table the process is healthy."""
        covs = []
        if self.has_brownouts:
            covs.append((self.az_mtbf_ms + self.az_mttr_ms)
                        * self.max_intervals)
        if self.has_crashes:
            covs.append((self.crash_mtbf_ms + self.crash_restart_ms)
                        * self.max_crashes)
        return min(covs) if covs else math.inf

    # -- table draws (numpy) ---------------------------------------------
    def brownout_tables_np(self, rng: np.random.Generator, num_azs: int):
        """(num_azs, I) start/end tables; disabled -> [inf, inf) sentinel."""
        if not self.has_brownouts:
            s = np.full((num_azs, 1), np.inf)
            return s, s.copy()
        n = 1 if self.correlated else num_azs
        up = rng.exponential(self.az_mtbf_ms, (n, self.max_intervals))
        down = rng.exponential(self.az_mttr_ms, (n, self.max_intervals))
        ends = np.cumsum(up + down, axis=1)
        starts = ends - down
        if self.correlated:
            starts = np.broadcast_to(starts, (num_azs, self.max_intervals))
            ends = np.broadcast_to(ends, (num_azs, self.max_intervals))
        return np.ascontiguousarray(starts), np.ascontiguousarray(ends)

    def crash_tables_np(self, rng: np.random.Generator, num_workers: int):
        """(num_workers, C) crash outage tables; disabled -> sentinel."""
        if not self.has_crashes:
            s = np.full((num_workers, 1), np.inf)
            return s, s.copy()
        gaps = rng.exponential(self.crash_mtbf_ms,
                               (num_workers, self.max_crashes))
        ends = np.cumsum(gaps + self.crash_restart_ms, axis=1)
        return ends - self.crash_restart_ms, ends

    # -- table draws (torch, on the generator's device) ------------------
    def brownout_tables(self, gen: torch.Generator, num_azs: int,
                        lead=()):
        """``(*lead, num_azs, I)`` float32 start/end tables drawn from
        ``gen``; disabled -> the ``[inf, inf)`` width-1 sentinel."""
        lead = tuple(lead)
        dev = gen.device
        if not self.has_brownouts:
            s = torch.full(lead + (num_azs, 1), _INF, device=dev)
            return s, s
        n = 1 if self.correlated else num_azs
        shape = lead + (n, self.max_intervals)
        up = torch.empty(shape, device=dev).exponential_(
            generator=gen) * self.az_mtbf_ms
        down = torch.empty(shape, device=dev).exponential_(
            generator=gen) * self.az_mttr_ms
        ends = torch.cumsum(up + down, dim=-1)
        starts = ends - down
        if self.correlated:
            full = lead + (num_azs, self.max_intervals)
            starts, ends = starts.expand(full), ends.expand(full)
        return starts, ends

    def crash_tables(self, gen: torch.Generator, num_workers: int,
                     lead=()):
        """``(*lead, num_workers, C)`` crash outage tables from ``gen``."""
        lead = tuple(lead)
        dev = gen.device
        if not self.has_crashes:
            s = torch.full(lead + (num_workers, 1), _INF, device=dev)
            return s, s
        gaps = torch.empty(lead + (num_workers, self.max_crashes),
                           device=dev).exponential_(
            generator=gen) * self.crash_mtbf_ms
        ends = torch.cumsum(gaps + self.crash_restart_ms, dim=-1)
        return ends - self.crash_restart_ms, ends


#: healthy cluster — the engines' static no-op (the pre-fault code paths)
NO_FAULTS = FaultProfile()


# --------------------------------------------------------------------------
# interval helpers (binary search on sorted tables; the table is the last
# axis, ``t``'s last axis holds each row's queries)
# --------------------------------------------------------------------------

def _last_start_at_or_before(t, starts, ends):
    """End of the last interval starting at or before ``t`` (``-inf``
    when none)."""
    k = torch.searchsorted(starts, t, right=True) - 1
    e = torch.gather(ends, -1, k.clamp_min(0))
    return torch.where(k >= 0, e, -_INF)


def interval_active(t, starts, ends):
    """True where ``t`` falls inside an interval ([start, end)).  The
    table must be sorted, as drawn tables are."""
    return t < _last_start_at_or_before(t, starts, ends)


def push_out(t, starts, ends):
    """Earliest time >= ``t`` outside every interval.  One step suffices:
    the intervals are disjoint, and an interval's end never lands inside a
    later interval (gaps are a.s. positive).  The table must be sorted."""
    e = _last_start_at_or_before(t, starts, ends)
    return torch.where(t < e, e, t)


def first_start_in(s, e, starts):
    """Earliest interval start strictly inside (s, e); inf when none (the
    crash-kill query: ``s`` itself is never inside an outage, bookings are
    pushed out first).  The starts must be sorted."""
    i = torch.searchsorted(starts, s, right=True)
    c = torch.gather(starts, -1, i.clamp_max(starts.shape[-1] - 1))
    return torch.where((i < starts.shape[-1]) & (c < e), c, _INF)


# --------------------------------------------------------------------------
# interval helpers — scalar numpy forms (the event-driven oracle)
# --------------------------------------------------------------------------

def interval_active_np(t: float, starts, ends) -> bool:
    return bool(np.any((t >= starts) & (t < ends)))


def push_out_np(t: float, starts, ends) -> float:
    hit = (t >= starts) & (t < ends)
    if hit.any():
        return float(ends[hit].max())
    return float(t)


def first_start_in_np(s: float, e: float, starts) -> float:
    inside = starts[(starts > s) & (starts < e)]
    return float(inside.min()) if inside.size else math.inf
