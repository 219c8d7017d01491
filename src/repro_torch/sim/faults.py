"""Correlated fault injection: the declarative fault environment.

AZ brownouts (an on/off CTMC per AZ, or one shared process when
``correlated``) and worker crashes (exp uptime, fixed restart outage),
described by :class:`FaultProfile`.  The engines of this package do not
run fault mode yet: :class:`repro_torch.sim.vector_queue.QueueFlightSim`
refuses an enabled profile.  The profile is kept so that workloads and
callers carry the same hashable description as the reference engines,
and so the refusal can name what was asked for.
"""
from __future__ import annotations

import dataclasses
import math

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

