"""Control-plane overhead model (paper Table 6) shared by the engines.

Service times follow the AZ-correlated mixture
``Z = rho * S(t, az(w)) + (1 - rho) * X(t, w)`` (paper §4.2.1): ``S`` is
shared by every worker of one AZ, ``X`` is private to the worker, so
replicas spread over AZs race nearly independent draws.  The vector
engines draw that mixture themselves (:mod:`repro_torch.sim.vector_queue`);
this module keeps the Table-6 control-plane latency parameters they
consume.
"""
from __future__ import annotations

import dataclasses

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
