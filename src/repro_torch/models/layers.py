"""Core layers: norms, rotary embeddings, the gated MLP, attention.

The port of ``repro/models/layers.py`` for the dense family.  Every
self-attention of a prefill goes through :func:`attention` and so through
the ``flash_attention`` kernel on the card; the reference's three jnp
strategies (``attention_full``, ``attention_blockwise``,
``attention_sliding_blocked``) are XLA memory layouts of that one
function, and the tests hold the kernel's plain version to each of them.
The encoder's self-attention and the decoder's cross attention of an
encoder-decoder model go through the same kernel with ``causal=False``.
On ``DTensor`` inputs (a sharded step) the kernel runs on each rank's
heads or sequence block (``distributed.local.sharded_attention``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.functional import all_reduce_sum
from repro_torch.distributed.local import (is_dtensor, linear,
                                           sharded_attention)
from repro_torch.kernels.flash_attention.ops import mha


def rms_norm(x, scale, eps: float = 1e-6, *, groups=None, width=None):
    """RMS norm in float32, scaled by ``1 + scale``; back in x's dtype.
    With ``groups`` x is this rank's block of the normed dim, ``width``
    wide in all: the sum of squares is summed over the groups."""
    dt = x.dtype
    x = x.float()
    if groups:
        var = all_reduce_sum(torch.sum(torch.square(x), dim=-1,
                                       keepdim=True), groups) / width
    else:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def mlp_block(x, p, variant: str):
    """SwiGLU / GeGLU gated MLP (GeGLU's GELU is the tanh approximation)."""
    gate = linear(x, p["w_gate"])
    up = linear(x, p["w_up"])
    act = (F.silu(gate) if variant == "swiglu"
           else F.gelu(gate, approximate="tanh"))
    return linear(act * up, p["w_down"])


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, hd: int, theta: float):
    """cos and sin of the rotary angles, float32 [B, S, 1, hd/2].  Every
    layer of a pass rotates by the same positions, so a pass computes them
    once (:func:`rotate`)."""
    freqs = rope_freqs(hd, theta, positions.device)         # [hd/2]
    ang = positions.float()[..., None] * freqs              # [B, S, hd/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def mrope_tables(positions_thw, hd: int, theta: float, sections):
    """qwen2-vl's multimodal rotary tables: cos and sin, float32 [B, S, 1,
    hd/2], for ``positions_thw`` [3, B, S] (the t, h and w ids).  The
    half-dims are cut into ``sections``; half-dim ``j`` takes its angle
    from stream ``np.repeat(arange(3), sections)[j]``, so each section
    of the frequencies is scaled by its own stream (no index map)."""
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must add up to "
                         f"head_dim / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, positions_thw.device)     # [hd/2]
    pos = positions_thw.float()[..., None]                   # [3, B, S, 1]
    ang = torch.cat([pos[i] * f for i, f in
                     enumerate(freqs.split(list(sections)))], dim=-1)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x, cos, sin):
    """Half-split rotary embedding in float32, given the tables.
    x: [B, S, H, hd]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding in float32.  x: [B, S, H, hd];
    positions: [B, S] int."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x, positions_thw, theta: float, sections):
    """qwen2-vl multimodal rotary embedding in float32.  x: [B, S, H, hd];
    positions_thw: [3, B, S] int (the t, h and w ids)."""
    return rotate(x, *mrope_tables(positions_thw, x.shape[-1], theta,
                                   sections))


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              logit_cap: float = 0.0, scale: float):
    """Attention of a prefill through the ``flash_attention`` kernel:
    causal self-attention, or with ``causal=False`` an encoder's
    self-attention or a decoder's cross attention (Sk may differ from Sq).
    q: [B, Sq, Hq, hd]; k, v: [B, Sk, Hkv, hd] -> [B, Sq, Hq, hd].

    The kernel reads the ``transpose(1, 2)`` views through their strides
    and writes a ``[B, S, Hq, hd]`` buffer, so no copy is made here on the
    card.  DTensors run the kernel on each rank's block.
    """
    def attend(q, k, v, q_offset=None):
        out = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, window=window, logit_cap=logit_cap,
                  scale=scale, q_offset=q_offset)
        return out.transpose(1, 2)
    if is_dtensor(q):
        return sharded_attention(q, k, v, attend)
    return attend(q, k, v)
