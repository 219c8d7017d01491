"""On-device summaries of response-time batches.

The port's counterparts of ``repro/core/analytics.py::summarize_batch``
and ``summarize_masked_batch``: every statistic is a 0-d tensor on the
samples' device, so a run can summarize without a host round trip.
``torch.quantile`` interpolates linearly between order statistics, as
``jnp.percentile`` and numpy do by default.
"""
from __future__ import annotations

import torch


def _as_float(samples) -> torch.Tensor:
    a = torch.as_tensor(samples)
    return a if a.is_floating_point() else a.to(torch.float32)


def summarize_batch(samples):
    """Mean, median, p90, p99, squared coefficient of variation and count
    of a 1-D sample batch; one fused quantile call (one device sort)."""
    a = _as_float(samples).reshape(-1)
    mean = a.mean()
    qs = torch.quantile(a, torch.tensor([0.5, 0.9, 0.99], dtype=a.dtype,
                                        device=a.device))
    return {
        "mean": mean,
        "median": qs[0],
        "p90": qs[1],
        "p99": qs[2],
        "scv": a.var(unbiased=False) / (mean * mean + 1e-12),
        "n": a.numel(),
    }


def summarize_masked_batch(samples, ok):
    """Success-conditioned :func:`summarize_batch`.

    Failed jobs' "responses" are failure-detection times, not delays, so
    the delay statistics condition on ``ok``; ``fail_rate`` and
    ``n_failed`` account for the rest.  Percentiles sort with failures
    pushed to +inf and interpolate linearly over the first ``n_ok`` order
    statistics.  With ``n_ok == 0`` the delay statistics are NaN and
    ``n`` is 0.
    """
    a = _as_float(samples).reshape(-1)
    m = torch.as_tensor(ok, device=a.device).reshape(-1).to(torch.bool)
    n_ok = m.sum()
    denom = torch.clamp(n_ok, min=1)
    s = torch.sort(torch.where(m, a, torch.inf)).values
    nan = torch.tensor(float("nan"), dtype=a.dtype, device=a.device)

    def q(p):
        idx = p / 100.0 * (denom - 1).to(a.dtype)
        lo = torch.clamp(torch.floor(idx).long(), 0, a.numel() - 1)
        hi = torch.clamp(torch.ceil(idx).long(), 0, a.numel() - 1)
        w = idx - lo.to(a.dtype)
        return torch.where(n_ok > 0, s[lo] * (1 - w) + s[hi] * w, nan)

    mean = torch.where(n_ok > 0, torch.where(m, a, 0.0).sum() / denom, nan)
    var = torch.where(m, (a - mean) ** 2, 0.0).sum() / denom
    return {
        "mean": mean,
        "median": q(50.0),
        "p90": q(90.0),
        "p99": q(99.0),
        "scv": var / (mean * mean + 1e-12),
        "n": n_ok,
        "fail_rate": 1.0 - n_ok / a.numel(),
        "n_failed": a.numel() - n_ok,
    }
