"""Cluster model: workers across availability zones, control-plane
overhead (paper Table 6), and AZ-correlated service times.

Service times follow the AZ-correlated mixture
``Z = rho * S(t, az(w)) + (1 - rho) * X(t, w)`` (paper §4.2.1): ``S`` is
shared by every worker of one AZ, ``X`` is private to the worker, so
replicas spread over AZs race nearly independent draws, while replicas
co-located in one AZ see nearly identical delays.  A 1-AZ/5-worker
deployment forces same-AZ placement; the 3-AZ/15-worker HA deployment
spreads flights across AZs — the paper's scale effect with no other
change.

:class:`Cluster` and :class:`InvocationDraws` are the scalar oracle's
numpy draws (:mod:`repro_torch.sim.flights`); the vector engines draw the
same mixture on the device (:mod:`repro_torch.sim.vector_queue`) and
share :func:`lognormal_params` and :class:`OverheadModel`'s table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def lognormal_params(med: float, p90: float) -> tuple:
    """(mu, sigma) of the lognormal with the given median and p90."""
    mu = float(np.log(med))
    sigma = max((float(np.log(p90)) - mu) / 1.2816, 0.05)
    return mu, sigma


@dataclasses.dataclass
class OverheadModel:
    """Control-plane latency (paper Table 6) as a lognormal per (ha, load)."""
    TABLE = {
        (True, "low"): (8.0, 14.0), (True, "medium"): (9.0, 16.0),
        (True, "high"): (9.0, 15.0),
        (False, "low"): (6.0, 12.0), (False, "medium"): (6.0, 9.0),
        (False, "high"): (7.0, 15.0),
    }

    def sample(self, rng, ha: bool, load: str, n: int = 1) -> np.ndarray:
        mu, sigma = lognormal_params(*self.TABLE[(ha, load)])
        return np.exp(rng.normal(mu, sigma, size=n))


class InvocationDraws:
    """Correlated service-time draws for ONE invocation of a manifest: the
    AZ-shared ``S`` is drawn once per (task, AZ) and memoised, the private
    ``X`` afresh on every draw."""

    def __init__(self, cluster: "Cluster", mean_ms: float, offset_ms: float,
                 dist: str = "exp", cv: float = 1.0):
        self.cl = cluster
        self.mean = mean_ms
        self.offset = offset_ms
        self.dist = dist
        self.cv = cv
        self._shared: Dict[tuple, float] = {}

    def _base_draw(self) -> float:
        rng = self.cl.rng
        if self.dist == "exp":
            return float(rng.exponential(self.mean))
        # lognormal with the given cv (thumbnail-style near-deterministic
        # tasks)
        sigma2 = np.log(1 + self.cv ** 2)
        mu = np.log(self.mean) - sigma2 / 2
        return float(np.exp(rng.normal(mu, np.sqrt(sigma2))))

    def draw(self, task: str, worker: int) -> float:
        az = int(self.cl.az_of[worker])
        key = (task, az)
        if key not in self._shared:
            self._shared[key] = self._base_draw()
        s = self._shared[key]
        x = self._base_draw()
        rho = self.cl.rho
        return rho * s + (1 - rho) * x + self.offset


@dataclasses.dataclass
class Cluster:
    """Workers round-robin over AZs, one numpy generator for the
    control-plane and service draws, and HA flight placement."""
    num_workers: int = 15
    num_azs: int = 3
    rho: float = 0.95          # AZ-shared fraction of service time
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.az_of = np.arange(self.num_workers) % self.num_azs
        self.overhead = OverheadModel()

    @property
    def ha(self) -> bool:
        return self.num_azs > 1

    def sample_overhead(self, load: str, n: int = 1) -> np.ndarray:
        return self.overhead.sample(self.rng, self.ha, load, n)

    def draws(self, mean_ms: float, offset_ms: float = 0.0, dist: str = "exp",
              cv: float = 1.0) -> InvocationDraws:
        return InvocationDraws(self, mean_ms, offset_ms, dist, cv)

    def place_flight(self, size: int, busy: Optional[set] = None) -> List[int]:
        """HA placement: spread flight members over AZs first."""
        busy = busy or set()
        free = [w for w in range(self.num_workers) if w not in busy]
        by_az: Dict[int, List[int]] = {}
        for w in free:
            by_az.setdefault(int(self.az_of[w]), []).append(w)
        for ws in by_az.values():
            self.rng.shuffle(ws)
        azs = list(by_az)
        self.rng.shuffle(azs)
        picked: List[int] = []
        i = 0
        while len(picked) < size and any(by_az.values()):
            az = azs[i % len(azs)]
            if by_az[az]:
                picked.append(by_az[az].pop())
            i += 1
        return picked
