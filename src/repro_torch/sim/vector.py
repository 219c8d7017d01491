"""Draw primitives shared by the vector engines.

The port of ``repro/sim/vector.py::unit_draws``; the open-loop engine of
that module comes with a later slice.  Draws come from an explicit
``torch.Generator`` on the engine's device, so they differ from the
reference's threefry stream: the engines are held to the reference by
distribution (tests/test_torch_engine.py), and bitwise only where both
are fed the same drawn events.
"""
from __future__ import annotations

import math

import torch


def unit_draws(gen: torch.Generator, shape, dist: str, cv: float):
    """Unit-mean service draws: exp(1), lognormal(mean=1, cv), or
    Pareto(mean=1, cv) with alpha = 1 + sqrt(1 + 1/cv^2) (> 2, so mean and
    variance exist) and xm = (alpha - 1)/alpha, drawn by inversion."""
    dev = gen.device
    if dist == "exp":
        return torch.empty(shape, device=dev).exponential_(generator=gen)
    if dist == "pareto":
        alpha = 1.0 + math.sqrt(1.0 + 1.0 / (cv * cv))
        xm = (alpha - 1.0) / alpha
        u = torch.rand(shape, generator=gen, device=dev).clamp_min(
            torch.finfo(torch.float32).tiny)
        return xm * u ** (-1.0 / alpha)
    if dist != "lognorm":
        raise ValueError(f"unknown service distribution {dist!r}")
    sigma2 = math.log1p(cv * cv)
    return torch.exp(-sigma2 / 2 + math.sqrt(sigma2)
                     * torch.randn(shape, generator=gen, device=dev))
