"""Mamba2 / SSD (state-space duality) block.

The port of ``repro/models/mamba2.py``: five separate input projections
(z, x, B, C, dt), three depthwise causal convolutions (x, B, C), the SSD
scan, the gated RMS norm and the output projection; on DTensors (a
sharded step) the inner block runs on each rank's heads.  A prefill's
scan goes through the ``ssd_scan`` kernel
(:func:`repro_torch.kernels.ssd_scan.ops.ssd`); a decode step runs the
single-token recurrence
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
from repro_torch.distributed.local import (assign, coord, is_dtensor,
                                           kv_for_heads, linear, settle,
                                           shard_dims)
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


def _inner(xs, z, B_, C_, dt, p, ssm: SSMConfig, *, mode: str, cache,
           dtype, heads=None):
    """The block between the projections and the gated norm on (local)
    tensors: the convolutions (and their cache tails), the SSD scan or
    the decode step (and the state), the D skip.  ``heads`` = (h0, hpg):
    the tensors hold heads h0 .. of a model whose groups serve ``hpg``
    heads each, and B, C hold every group.  Returns y [B, S, h * P]."""
    b, s = xs.shape[0], xs.shape[1]
    h, n = dt.shape[-1], ssm.state_dim
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
    xs = F.silu(xs).reshape(b, s, h, ssm.head_dim)
    B_ = F.silu(B_).reshape(b, s, -1, n)
    C_ = F.silu(C_).reshape(b, s, -1, n)
    if heads is not None:
        B_, C_ = kv_for_heads(B_, C_, heads[0], h, heads[1])
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
    return y.reshape(b, s, -1).to(dtype)


def mamba2_block(x, p, ssm: SSMConfig, *, mode: str, cache, constrain=None):
    """x: [B, S, D] (S = 1 in decode).  ``mode="prefill"`` scans the
    prompt through the ``ssd_scan`` kernel and writes the conv tails and
    the final state into ``cache``; ``mode="decode"`` advances them by one
    token; ``mode="train"`` is a prefill without a cache (``cache`` None).
    ``constrain(t, role)`` is the sharding plan's hook, applied at the
    reference's ``ssm_inner`` points.  DTensors run the inner block on
    each rank's heads (:func:`_sharded_inner`).  Returns (y [B, S, D],
    cache)."""
    if constrain is None:
        def constrain(t, role):
            return t
    z = linear(x, p["in_z"])                                   # [B,S,din]
    xs = linear(x, p["in_x"])                                  # [B,S,din]
    B_ = linear(x, p["in_B"])                                  # [B,S,g*n]
    C_ = linear(x, p["in_C"])                                  # [B,S,g*n]
    dt = linear(x, p["in_dt"])                                 # [B,S,h]
    xs = constrain(xs, "ssm_inner")
    z = constrain(z, "ssm_inner")
    dt = _softplus(dt.float() + p["dt_bias"])
    if is_dtensor(xs):
        y = _sharded_inner(xs, z, B_, C_, dt, p, ssm, mode=mode,
                           cache=cache)
        return linear(y, p["out_proj"]), cache
    y = _inner(xs, z, B_, C_, dt, p, ssm, mode=mode, cache=cache,
               dtype=x.dtype)
    y = constrain(y, "ssm_inner")
    y = rms_norm(y * F.silu(z), p["norm"])                    # gated norm
    return linear(y, p["out_proj"]), cache


_HEAD_PARAMS = ("A_log", "D")                      # [h]
_CHANNEL_PARAMS = {"conv_x_w": ("x", 1), "conv_x_b": ("x", 0),
                   "norm": ("x", 0), "conv_B_w": ("g", 1),
                   "conv_B_b": ("g", 0), "conv_C_w": ("g", 1),
                   "conv_C_b": ("g", 0)}


def _sharded_inner(xs, z, B_, C_, dt, p, ssm: SSMConfig, *, mode: str,
                   cache):
    """The inner block and the gated norm on DTensors, each rank on its
    heads under ``local_map``: xs and z sharded over din where their
    blocks are whole heads (else gathered), dt, A and D over the heads,
    B and C over the groups where the groups divide the heads' mesh dims
    (else replicated, each rank reading its heads' groups), the conv
    weights with their channels, the caches moved to these layouts and
    back; the norm's sum of squares summed over the heads' dims.
    Returns the normed y [B, S, din] placed as xs."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    xs, z, B_, C_, dt = (settle(t) for t in (xs, z, B_, C_, dt))
    mesh = xs.device_mesh
    h, g = dt.shape[-1], ssm.ngroups
    din = xs.shape[-1]
    heads = shard_dims(xs, 2)
    h_idx, n_h = coord(mesh, heads)
    if h % n_h:                    # din's blocks are not whole heads
        heads, h_idx, n_h = [], 0, 1
    batch = shard_dims(xs, 0)
    g_split = g % n_h == 0

    def pl(dim, split=True, batch_dim=0):
        out = [Replicate()] * mesh.ndim
        for i in batch:
            if batch_dim is not None:
                out[i] = Shard(batch_dim)
        if split:
            for i in heads:
                out[i] = Shard(dim)
        return tuple(out)

    def grad(place):
        return tuple(Partial() if p_.is_replicate() and (i in heads
                                                        or i in batch)
                     else p_ for i, p_ in enumerate(place))

    x_pl, g_pl = pl(2), pl(2, g_split)
    acts = [xs, z, B_, C_, dt]
    act_pl = [x_pl, x_pl, g_pl, g_pl, x_pl]
    names = list(_HEAD_PARAMS) + list(_CHANNEL_PARAMS)
    par_pl = [pl(0, batch_dim=None) for _ in _HEAD_PARAMS] + [
        pl(d, kind == "x" or g_split, batch_dim=None)
        for kind, d in _CHANNEL_PARAMS.values()]
    groups = [mesh.get_group(i) for i in heads]
    moved = {}
    if cache is not None:
        for name, place in (("conv_x", x_pl), ("conv_B", g_pl),
                            ("conv_C", g_pl), ("state", pl(1))):
            moved[name] = cache[name].redistribute(mesh, place)

    def local(xs_l, z_l, B_l, C_l, dt_l, *params):
        w = dict(zip(names, params))
        c = {k: v.to_local() for k, v in moved.items()} or None
        y = _inner(xs_l, z_l, B_l, C_l, dt_l, w, ssm, mode=mode, cache=c,
                   dtype=xs_l.dtype,
                   heads=None if g_split else (h_idx * (h // n_h), h // g))
        return rms_norm(y * F.silu(z_l), w["norm"], groups=groups,
                        width=din)

    ins = act_pl + par_pl
    fn = local_map(local, out_placements=list(x_pl), in_placements=tuple(ins),
                   in_grad_placements=tuple(grad(q) for q in ins),
                   device_mesh=mesh)
    y = fn(*(t.redistribute(mesh, q) for t, q in zip(acts, act_pl)),
           *(p[n].redistribute(mesh, q) for n, q in zip(names, par_pl)))
    for name, t in moved.items():
        if t is not cache[name]:
            assign(cache[name], t)
    return y


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
