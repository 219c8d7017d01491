"""Mamba2 / SSD (state-space duality) block.

The port of ``repro/models/mamba2.py``: five separate input projections
(z, x, B, C, dt), three depthwise causal convolutions (x, B, C), the SSD
scan, the gated RMS norm and the output projection.  A prefill's scan goes
through the ``ssd_scan`` kernel (:func:`repro_torch.kernels.ssd_scan.ops
.ssd`); a decode step runs the single-token recurrence
(:func:`ssd_decode_step`).  ``ssd_chunked`` is the kernel's plain version,
the reference's chunked algorithm (``kernels/ssd_scan/ops.py::ssd_plain``,
with ``segsum``).

The decode cache of a layer is ``{"conv_x": [B, K-1, din], "conv_B",
"conv_C": [B, K-1, G*N], "state": [B, H, P, N] float32}``; unlike the
reference's functional update, prefill and decode write it IN PLACE, as
the attention caches are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    ssd_plain as ssd_chunked)        # the reference's name for it
from repro_torch.models.layers import rms_norm


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token SSD recurrence.  state: [b, h, p, n]; x: [b, h, p];
    dt: [b, h]; B, C: [b, g, n].  Returns (y [b, h, p], new state)."""
    rep = x.shape[1] // B.shape[1]
    Bh = torch.repeat_interleave(B, rep, dim=1)               # [b,h,n]
    Ch = torch.repeat_interleave(C, rep, dim=1)
    decay = torch.exp(dt * A[None, :])                        # [b,h]
    state = state * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x * dt[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y, state


def causal_conv(x, w, b):
    """Depthwise causal conv via shifts.  x: [B, S, C]; w: [K, C]; b: [C]."""
    k = w.shape[0]
    out = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[k - 1 - i]
    return out + b


def _conv_step(cache, x_t, w, b):
    """Single-token conv.  cache: [B, K-1, C]; x_t: [B, 1, C].  Returns
    (y [B, 1, C], the next cache [B, K-1, C])."""
    full = torch.cat([cache, x_t], dim=1)                     # [B,K,C]
    y = (full * w[None]).sum(dim=1, keepdim=True) + b
    return y, full[:, 1:]


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))            # as jax.nn


def mamba2_block(x, p, ssm: SSMConfig, *, mode: str, cache, constrain=None):
    """x: [B, S, D] (S = 1 in decode).  ``mode="prefill"`` scans the
    prompt through the ``ssd_scan`` kernel and writes the conv tails and
    the final state into ``cache``; ``mode="decode"`` advances them by one
    token; ``mode="train"`` is a prefill without a cache (``cache`` None).
    ``constrain(t, role)`` is the sharding plan's hook, applied at the
    reference's ``ssm_inner`` points.  Returns (y [B, S, D], cache)."""
    if constrain is None:
        def constrain(t, role):
            return t
    b, s, d = x.shape
    din = ssm.expand * d
    g, n = ssm.ngroups, ssm.state_dim
    h = din // ssm.head_dim
    p_dim = ssm.head_dim

    z = x @ p["in_z"]                                         # [B,S,din]
    xs = x @ p["in_x"]                                        # [B,S,din]
    B_ = x @ p["in_B"]                                        # [B,S,g*n]
    C_ = x @ p["in_C"]                                        # [B,S,g*n]
    dt = x @ p["in_dt"]                                       # [B,S,h]
    xs = constrain(xs, "ssm_inner")
    z = constrain(z, "ssm_inner")
    dt = _softplus(dt.float() + p["dt_bias"])

    if mode == "decode":
        xs, cx = _conv_step(cache["conv_x"], xs, p["conv_x_w"],
                            p["conv_x_b"])
        B_, cB = _conv_step(cache["conv_B"], B_, p["conv_B_w"],
                            p["conv_B_b"])
        C_, cC = _conv_step(cache["conv_C"], C_, p["conv_C_w"],
                            p["conv_C_b"])
        for name, new in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC)):
            cache[name].copy_(new)
    elif mode in ("prefill", "train"):
        k = ssm.conv_width
        if cache is not None:
            for name, t in (("conv_x", xs), ("conv_B", B_), ("conv_C", C_)):
                cache[name].copy_(F.pad(t, (0, 0, k - 1, 0))[:, -(k - 1):])
        xs = causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
        B_ = causal_conv(B_, p["conv_B_w"], p["conv_B_b"])
        C_ = causal_conv(C_, p["conv_C_w"], p["conv_C_b"])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    xs = F.silu(xs).reshape(b, s, h, p_dim)
    B_ = F.silu(B_).reshape(b, s, g, n)
    C_ = F.silu(C_).reshape(b, s, g, n)
    A = -torch.exp(p["A_log"].float())                        # [h]

    if mode == "decode":
        y, st = ssd_decode_step(cache["state"], xs[:, 0].float(), dt[:, 0],
                                A, B_[:, 0].float(), C_[:, 0].float())
        y = y[:, None]
    else:
        y, st = ssd(xs.float(), dt, A, B_.float(), C_.float(),
                    chunk=ssm.chunk_size)
    if cache is not None:
        cache["state"].copy_(st)

    y = y + xs.float() * p["D"][None, None, :, None]
    y = constrain(y.reshape(b, s, din).to(x.dtype), "ssm_inner")
    y = rms_norm(y * F.silu(z), p["norm"])                    # gated norm
    return y @ p["out_proj"], cache


def init_mamba2_params(d_model: int, ssm: SSMConfig, dtype, *,
                       generator: torch.Generator, device) -> dict:
    """The reference's Mamba2 parameters: projections N(0, 0.02) in
    ``dtype``, the x conv N(0, 0.2) and the B/C convs 0.25 in float32,
    biases 0, ``A_log`` 0 (A = -1), ``D`` 1, the norm scale 0; drawn from
    ``generator`` (the numbers differ from the reference's threefry
    draws)."""
    din = ssm.expand * d_model
    gn = ssm.ngroups * ssm.state_dim
    h = din // ssm.head_dim
    k = ssm.conv_width
    f32 = torch.float32

    def normal(shape, scale, dt=dtype):
        if torch.device(device).type == "meta":
            return torch.empty(shape, dtype=dt, device=device)
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dt).mul_(scale)

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=device)

    return {
        "in_z": normal((d_model, din), 0.02),
        "in_x": normal((d_model, din), 0.02),
        "in_B": normal((d_model, gn), 0.02),
        "in_C": normal((d_model, gn), 0.02),
        "in_dt": normal((d_model, h), 0.02),
        "conv_x_w": normal((k, din), 0.2, f32),
        "conv_x_b": full((din,), 0.0),
        "conv_B_w": full((k, gn), 0.25),
        "conv_B_b": full((gn,), 0.0),
        "conv_C_w": full((k, gn), 0.25),
        "conv_C_b": full((gn,), 0.0),
        "dt_bias": full((h,), 0.0),
        "A_log": full((h,), 0.0),
        "D": full((h,), 1.0),
        "norm": full((din,), 0.0),
        "out_proj": normal((din, d_model), 0.02),
    }


def init_ssm_cache(batch: int, d_model: int, ssm: SSMConfig, dtype, *,
                   device) -> dict:
    """A layer's zero decode cache: conv tails in ``dtype``, the state in
    float32."""
    din = ssm.expand * d_model
    gn = ssm.ngroups * ssm.state_dim
    h = din // ssm.head_dim
    k = ssm.conv_width

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"conv_x": zeros((batch, k - 1, din)),
            "conv_B": zeros((batch, k - 1, gn)),
            "conv_C": zeros((batch, k - 1, gn)),
            "state": zeros((batch, h, ssm.head_dim, ssm.state_dim),
                           torch.float32)}
