"""Mixture-of-Experts block, the global-view (un-meshed) path.

The port of ``repro/models/moe.py``: a float32 router with top-k gates
(ties to the lowest expert, as ``lax.top_k``), capacity dispatch of every
(token, rank) slot into a dense ``[E, C, D]`` buffer (rank-major priority;
slots past an expert's capacity are dropped), the experts' gated MLPs as
three expert-batched GEMMs through the ``expert_matmul`` kernel
(:func:`repro_torch.kernels.moe_gmm.ops.gmm`), the gate-weighted combine,
an optional always-on shared expert (llama4) and the load-balancing aux
loss.  The expert-parallel path (``moe_block_ep``, ``EPSpec``) waits for
the distributed slice and is refused.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.models.layers import mlp_block

_EP_ITEM = "ROADMAP.md §1 item 13 (distributed)"


def moe_capacity(num_tokens: int, moe: MoEConfig,
                 capacity_factor: float = 1.25,
                 num_buckets: Optional[int] = None) -> int:
    """Slots per expert: ``num_tokens * top_k * capacity_factor / E``
    rounded up to a multiple of 4, at least 4."""
    e = num_buckets or moe.num_experts
    cap = int(num_tokens * moe.top_k * capacity_factor / e)
    return max(4, -(-cap // 4) * 4)


def top_k(x, k: int):
    """The k largest entries of the last dim and their indices, in
    descending order, the lower index first among equal values (as
    ``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt, router, k: int):
    """(topw [T, k] f32, topi [T, k] int64, gates [T, E] f32)."""
    logits = xt.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    topw, topi = top_k(gates, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi, gates


def _slot_ranks(slot_e, e_pad: int):
    """Each slot's rank among the earlier slots routed to its expert (the
    reference's exclusive one-hot cumsum), from one stable sort."""
    n = slot_e.shape[0]
    order = torch.argsort(slot_e, stable=True)
    counts = torch.zeros(e_pad, dtype=slot_e.dtype, device=slot_e.device)
    counts.scatter_add_(0, slot_e, torch.ones_like(slot_e))
    start = torch.cumsum(counts, dim=0) - counts
    ranks = torch.empty_like(slot_e)
    ranks[order] = (torch.arange(n, device=slot_e.device)
                    - start[slot_e[order]])
    return ranks


def _dispatch_local(xt, topi, topw, e_pad: int, cap: int):
    """Capacity dispatch.  xt: [T, D]; topi/topw: [T, k].  Returns buf
    [e_pad, cap, D] and (slot_e, pos, keep, slot_t) for the combine."""
    t, d = xt.shape
    k = topi.shape[1]
    slot_e = topi.t().reshape(-1)                 # [k*T] rank-major priority
    slot_t = torch.arange(t, device=xt.device).repeat(k)
    pos = _slot_ranks(slot_e, e_pad)
    keep = pos < cap
    # kept slots own distinct (expert, position) cells; dropped slots go to
    # a discarded last row (the reference adds zero to the expert's last
    # cell instead: the same buffer)
    flat = torch.where(keep, slot_e * cap + pos, e_pad * cap)
    buf = torch.zeros((e_pad * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[flat] = xt[slot_t]
    pos = torch.where(keep, pos, cap - 1)
    return buf[:-1].view(e_pad, cap, d), (slot_e, pos, keep, slot_t)


def _combine_local(out_buf, routing, topw, t: int, d: int, dtype):
    """Every token's gate-weighted sum of its slots' expert outputs."""
    slot_e, pos, keep, _ = routing
    k = topw.shape[1]
    slot_gate = topw.t().reshape(-1)
    slot_out = out_buf[slot_e, pos] * (slot_gate * keep)[:, None].to(dtype)
    # slot r * T + i belongs to token i
    return slot_out.reshape(k, t, d).sum(dim=0)


def _expert_mlps(buf, wg, wu, wd, variant: str):
    """The experts' gated MLPs on their capacity buffers, each product
    through the ``expert_matmul`` kernel."""
    h_gate = gmm(buf, wg)
    h_up = gmm(buf, wu)
    act = (F.silu(h_gate) if variant == "swiglu"
           else F.gelu(h_gate, approximate="tanh"))
    return gmm(act * h_up, wd)


def _aux_loss(gates, topi, e: int):
    t = topi.shape[0]
    top1 = topi[:, 0]
    counts = torch.zeros(e, dtype=torch.float32, device=top1.device)
    frac_tokens = counts.scatter_add_(0, top1, torch.ones_like(
        top1, dtype=torch.float32)) / t
    frac_gates = gates.mean(dim=0)
    return e * torch.sum(frac_tokens * frac_gates)


def moe_mlp(x, p, moe: MoEConfig, mlp_variant: str, *,
            capacity_factor: float = 1.25):
    """The block's output without the aux loss (serving's forward): y [B, S,
    D] and the routing (gates, topi) the aux loss reads."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    topw, topi, gates = _route(xt, p["router"], moe.top_k)
    cap = moe_capacity(t, moe, capacity_factor)
    buf, routing = _dispatch_local(xt, topi, topw, moe.num_experts, cap)
    out_buf = _expert_mlps(buf, p["w_gate"], p["w_up"], p["w_down"],
                           mlp_variant)
    y = _combine_local(out_buf, routing, topw, t, d, x.dtype)
    if moe.shared_expert_ff:
        y = y + mlp_block(xt, p["shared"], mlp_variant)
    return y.reshape(b, s, d), (gates, topi)


def moe_block_global(x, p, moe: MoEConfig, mlp_variant: str, *,
                     capacity_factor: float = 1.25):
    """x: [B, S, D] -> (y [B, S, D], the load-balancing aux loss)."""
    y, (gates, topi) = moe_mlp(x, p, moe, mlp_variant,
                               capacity_factor=capacity_factor)
    return y, _aux_loss(gates, topi, moe.num_experts)


class EPSpec:
    """Expert-parallel execution context: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"expert parallelism is not ported yet; "
                                  f"see {_EP_ITEM}")


def moe_block_ep(*args, **kwargs):
    raise NotImplementedError(f"moe_block_ep (expert parallelism) is not "
                              f"ported yet; see {_EP_ITEM}")


def moe_block(x, p, moe: MoEConfig, mlp_variant: str, *,
              capacity_factor: float = 1.25, ep=None):
    if ep is not None:
        return moe_block_ep(x, p, moe, mlp_variant, ep)
    return moe_block_global(x, p, moe, mlp_variant,
                            capacity_factor=capacity_factor)


def init_moe_params(d_model: int, moe: MoEConfig, dtype, *,
                    generator: torch.Generator, device) -> dict:
    """The reference's MoE parameters: the router N(0, 0.02) in float32,
    every expert matrix N(0, 0.02) in ``dtype``, drawn from ``generator``
    (the numbers differ from the reference's threefry draws)."""
    e, ff = moe.num_experts, moe.expert_ff

    def normal(shape, dt=dtype):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dt).mul_(0.02)

    p = {"router": normal((d_model, e), torch.float32),
         "w_gate": normal((e, d_model, ff)),
         "w_up": normal((e, d_model, ff)),
         "w_down": normal((e, ff, d_model))}
    if moe.shared_expert_ff:
        sff = moe.shared_expert_ff
        p["shared"] = {"w_gate": normal((d_model, sff)),
                       "w_up": normal((d_model, sff)),
                       "w_down": normal((sff, d_model))}
    return p
