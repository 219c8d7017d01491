"""Mixture-of-Experts block, the global-view (un-meshed) path.

The port of ``repro/models/moe.py``: a float32 router with top-k gates
(ties to the lowest expert, as ``lax.top_k``), capacity dispatch of every
(token, rank) slot into a dense ``[E, C, D]`` buffer (rank-major priority;
slots past an expert's capacity are dropped), the experts' gated MLPs as
three expert-batched GEMMs through the ``expert_matmul`` kernel
(:func:`repro_torch.kernels.moe_gmm.ops.gmm`), the gate-weighted combine,
an optional always-on shared expert (llama4) and the load-balancing aux
loss.

``moe_block_ep`` is the expert-parallel path over a ``DeviceMesh`` of
(data, model) axes (:class:`EPSpec`): each rank holds its block of the
batch over the data axes, replicated over the model axis, and the
experts are split over the model axis.  Tokens are split over the model
axis too where they divide (else every model rank dispatches the same
tokens, duplicated compute, as in the reference); each rank dispatches
its tokens into a local ``[E_pad, C, D]`` buffer, an all-to-all over the
model group hands every expert owner its slots, the local experts' MLPs
run through ``expert_matmul`` on ``[E_loc, tp*C, D]``, the reverse
all-to-all and the local combine follow.  Experts whose count does not
divide the model axis are padded with zero weights to
``E_pad = ceil(E/tp)*tp``.  Parameters are replicated on every rank; the
gradients of the experts a rank does not own come from their owners
(``distributed/functional.py``).

A sharded step's ``DTensor`` input runs :func:`moe_block_sharded`: the
same EP block on each rank's local tensors under ``local_map``, the
experts that the plan shards over the model axis used as each rank's
own (no gather), the others gathered and padded as above, the router
replicated, the shared expert a tensor-parallel DTensor MLP beside it
and the aux loss from the blocks' fractions summed over the data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import functional as dfn
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.launch.mesh import axis_sizes, batch_axes, is_abstract
from repro_torch.models.layers import mlp_block


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


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


def _dispatch_local(xt, topi, topw, e_pad: int, cap: int, *,
                    limit: Optional[int] = None, offset=None):
    """Capacity dispatch.  xt: [T, D]; topi/topw: [T, k].  Returns buf
    [e_pad, cap, D] and (slot_e, pos, keep, slot_t) for the combine.  A
    slot is kept where its rank plus ``offset`` [k, e_pad] (at its
    choice and expert) is below ``limit`` (default ``cap``)."""
    t, d = xt.shape
    k = topi.shape[1]
    slot_e = topi.t().reshape(-1)                 # [k*T] rank-major priority
    slot_t = torch.arange(t, device=xt.device).repeat(k)
    pos = _slot_ranks(slot_e, e_pad)
    if offset is None:
        keep = pos < (cap if limit is None else limit)
    else:
        choice = torch.arange(k, device=xt.device).repeat_interleave(t)
        keep = pos + offset[choice, slot_e] < limit
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


def _aux_fractions(gates, topi, e: int):
    """(the top-1 token fractions [e], the mean gates [e]) of a block."""
    t = topi.shape[0]
    top1 = topi[:, 0]
    counts = torch.zeros(e, dtype=torch.float32, device=top1.device)
    frac_tokens = counts.scatter_add_(0, top1, torch.ones_like(
        top1, dtype=torch.float32)) / t
    return frac_tokens, gates.mean(dim=0)


def _aux_loss(gates, topi, e: int, groups=(), n: int = 1):
    """The load-balancing loss from the top-1 token fractions and the mean
    gates; with ``groups``, of the whole batch: the fractions averaged
    over the n equal blocks of the groups' ranks."""
    frac_tokens, frac_gates = _aux_fractions(gates, topi, e)
    if n > 1:
        fracs = dfn.all_reduce_sum(torch.cat([frac_tokens, frac_gates]),
                                   groups) / n
        frac_tokens, frac_gates = fracs[:e], fracs[e:]
    return e * torch.sum(frac_tokens * frac_gates)


def _global_offsets(topi, e: int, shard: dfn.BatchShard):
    """[k, e] counts of the batch's slots that come before this block's
    choice-j slots to expert e in the global priority order (choice
    major, then the tokens in batch order) and are not its own earlier
    slots: with a block's slot ranks they give the global ones."""
    t, k = topi.shape
    rows = torch.arange(k, device=topi.device)[:, None] * e + topi.t()
    mine = torch.zeros(k * e, dtype=torch.int64, device=topi.device)
    mine = mine.scatter_add_(0, rows.reshape(-1), torch.ones(
        k * t, dtype=torch.int64, device=topi.device)).view(k, e)
    every = dfn.gather_blocks(mine, shard)          # [blocks, k, e]
    others = every.sum(0) - mine
    return (torch.cumsum(others, 0) - others
            + every[:shard.index].sum(0))


def moe_mlp(x, p, moe: MoEConfig, mlp_variant: str, *,
            capacity_factor: float = 1.25, ep=None, constrain=None,
            shard: Optional[dfn.BatchShard] = None):
    """The block's output without the aux loss (serving's forward): y [B, S,
    D] and the routing (gates, topi) the aux loss reads.  With ``shard``
    (x is this rank's block of the batch) and no ``ep``, the capacity and
    each slot's place in its expert's queue are the whole batch's, as
    the reference's global view computes them: a block keeps the slots
    that the whole batch's dispatch keeps."""
    if _is_dtensor(x):
        return moe_block_sharded(x, p, moe, mlp_variant, ep, aux=False)[0], \
            None
    if ep is not None:
        return _moe_ep(x, p, moe, mlp_variant, ep, constrain)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    topw, topi, gates = _route(xt, p["router"], moe.top_k)
    e = moe.num_experts
    if shard is None or shard.size == 1:
        cap = moe_capacity(t, moe, capacity_factor)
        buf, routing = _dispatch_local(xt, topi, topw, e, cap)
    else:
        # a block keeps at most its tokens (one slot each an expert)
        cap = moe_capacity(t * shard.size, moe, capacity_factor)
        buf, routing = _dispatch_local(
            xt, topi, topw, e, min(cap, t), limit=cap,
            offset=_global_offsets(topi, e, shard))
    out_buf = _expert_mlps(buf, p["w_gate"], p["w_up"], p["w_down"],
                           mlp_variant)
    y = _combine_local(out_buf, routing, topw, t, d, x.dtype)
    if moe.shared_expert_ff:
        y = y + mlp_block(xt, p["shared"], mlp_variant)
    return y.reshape(b, s, d), (gates, topi)


def moe_block_global(x, p, moe: MoEConfig, mlp_variant: str, *,
                     capacity_factor: float = 1.25,
                     shard: Optional[dfn.BatchShard] = None):
    """x: [B, S, D] -> (y [B, S, D], the load-balancing aux loss).  With
    ``shard``, x is this rank's block of the batch, and the dispatch and
    the aux loss are the whole batch's (:func:`moe_mlp`)."""
    y, (gates, topi) = moe_mlp(x, p, moe, mlp_variant,
                               capacity_factor=capacity_factor, shard=shard)
    if shard is None:
        return y, _aux_loss(gates, topi, moe.num_experts)
    return y, _aux_loss(gates, topi, moe.num_experts, shard.groups,
                        shard.size)


# --------------------------------------------------------------------------
# expert parallelism
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EPSpec:
    """Expert-parallel execution context: a mesh (a ``DeviceMesh`` to run;
    an ``AbstractMesh`` serves the dry run's sizes) and its axis names."""
    mesh: Any
    data_axes: Tuple[str, ...]
    model_axis: str = "model"
    capacity_factor: float = 1.25

    @property
    def dp(self) -> int:
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in self.data_axes:
            n *= sizes[a]
        return n

    @property
    def tp(self) -> int:
        return axis_sizes(self.mesh)[self.model_axis]

    def e_pad(self, num_experts: int) -> int:
        return -(-num_experts // self.tp) * self.tp

    def data_groups(self) -> list:
        return [self.mesh.get_group(a) for a in self.data_axes]


def _pad_experts(w, e_pad: int):
    if w.shape[0] == e_pad:
        return w
    pad = w.new_zeros((e_pad - w.shape[0],) + tuple(w.shape[1:]))
    return torch.cat([w, pad])


def _moe_ep(x, p, moe: MoEConfig, mlp_variant: str, ep: EPSpec,
            constrain=None, *, local_experts: bool = False,
            shared: bool = True):
    """The expert-parallel forward on this rank's block x [B, S, D]:
    (y [B, S, D], (gates, topi) of the block's tokens).  With
    ``local_experts`` the expert weights are this rank's own [E/tp, ...]
    (E divides the model axis); ``shared=False`` leaves the shared
    expert to the caller."""
    if is_abstract(ep.mesh):
        raise ValueError("an EPSpec over an AbstractMesh plans a layout; "
                         "running the block needs a DeviceMesh")
    b, s, d = x.shape
    t = b * s
    tp = ep.tp
    e_pad = ep.e_pad(moe.num_experts)
    e_loc = e_pad // tp
    # tokens split over the model axis where they divide (the reference's
    # t % (dp * tp) == 0 over the global batch); else every model rank
    # dispatches the same tokens and each expert sees tp copies
    split = tp > 1 and t % tp == 0
    t_loc = t // tp if split else t
    cap = moe_capacity(t_loc, moe, ep.capacity_factor, num_buckets=e_pad)

    xt = x.reshape(t, d)
    if constrain is not None:
        xt = constrain(xt, "moe_tokens")
    topw, topi, gates = _route(xt, p["router"], moe.top_k)
    group = ep.mesh.get_group(ep.model_axis)
    me = ep.mesh.get_local_rank(ep.model_axis)
    xt_l, topw_l, topi_l = xt, topw, topi
    if split:
        xt_l, topw_l = dfn.split(xt, group), dfn.split(topw, group)
        topi_l = topi[me * t_loc:(me + 1) * t_loc]

    # the owner of expert o*e_loc + e is model rank o; a rank's gradient of
    # the experts it does not own comes from their owners (summed over the
    # model group; 1/tp where every owner saw tp copies of each slot)
    scale = 1.0 if split or tp == 1 else 1.0 / tp
    if local_experts:
        ws = [dfn.reduce_grad(p[n], (), scale)
              for n in ("w_gate", "w_up", "w_down")]
    else:
        ws = [dfn.reduce_grad(_pad_experts(p[n], e_pad), [group], scale)
              [me * e_loc:(me + 1) * e_loc] for n in ("w_gate", "w_up",
                                                       "w_down")]

    buf, routing = _dispatch_local(xt_l, topi_l, topw_l, e_pad, cap)
    # to the expert owners: [e_pad, C, D] -> [tp (source), e_loc, C, D]
    # -> [e_loc, tp*C, D], the capacity in source order (the reference's
    # all_to_all(split_axis=0, concat_axis=1, tiled=True))
    buf = dfn.all_to_all(buf, group)
    buf = buf.view(tp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, tp * cap, d)
    out = _expert_mlps(buf, *ws, mlp_variant)
    # back to the token owners: [e_loc, tp*C, D] -> [e_pad, C, D]
    out = out.view(e_loc, tp, cap, d).transpose(0, 1).reshape(
        tp * e_loc, cap, d)
    out = dfn.all_to_all(out, group)
    y = _combine_local(out, routing, topw_l, t_loc, d, x.dtype)
    if split:
        y = dfn.gather(y, group)
    if moe.shared_expert_ff and shared:
        y = y + mlp_block(xt, p["shared"], mlp_variant)
    return y.reshape(b, s, d), (gates, topi)


def moe_block_sharded(x, p, moe: MoEConfig, mlp_variant: str,
                      ep: Optional[EPSpec] = None, *, aux: bool = True):
    """The EP block on a ``DTensor`` x [B, S, D] (a sharded step; ``p``
    reads the weights gathered over the data axes): (y, the whole batch's
    aux loss, or None without ``aux``), both DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.local import settle
    x = settle(x)
    mesh = x.device_mesh
    if ep is None:
        ep = EPSpec(mesh, batch_axes(mesh))
    names = mesh.mesh_dim_names
    data_dims = [names.index(a) for a in ep.data_axes]
    mi = names.index(ep.model_axis)
    rep = [Replicate()] * mesh.ndim
    x_pl = [x.placements[i] if i in data_dims and x.placements[i].is_shard(0)
            else Replicate() for i in range(mesh.ndim)]
    summed = [Partial() if i in data_dims else Replicate()
              for i in range(mesh.ndim)]
    wg = p["w_gate"]
    local_experts = (ep.tp > 1 and wg.placements[mi].is_shard(0)
                     and moe.num_experts % ep.tp == 0)
    w_pl = list(rep)
    if local_experts:
        w_pl[mi] = Shard(0)
    w_grad = [Partial() if i in data_dims else w_pl[i]
              for i in range(mesh.ndim)]
    e = moe.num_experts

    def local(xl, router, w_gate, w_up, w_down):
        pl = {"router": router, "w_gate": w_gate, "w_up": w_up,
              "w_down": w_down}
        y, (gates, topi) = _moe_ep(xl, pl, moe, mlp_variant, ep,
                                   local_experts=local_experts,
                                   shared=False)
        if not aux:
            return y
        return y, torch.cat(_aux_fractions(gates, topi, e))

    out_pl = (tuple(x_pl), tuple(summed)) if aux else list(x_pl)
    fn = local_map(local, out_placements=out_pl,
                   in_placements=(tuple(x_pl), tuple(rep)) + (tuple(w_pl),)
                   * 3,
                   in_grad_placements=(tuple(x_pl), tuple(summed))
                   + (tuple(w_grad),) * 3, device_mesh=mesh)
    x = x.redistribute(mesh, x_pl)
    ws = [p[n].redistribute(mesh, w_pl) for n in ("w_gate", "w_up",
                                                   "w_down")]
    out = fn(x, p["router"].redistribute(mesh, rep), *ws)
    y, fracs = out if aux else (out, None)
    if moe.shared_expert_ff:
        y = y + mlp_block(x, p["shared"], mlp_variant)
    if not aux:
        return y, None
    fracs = fracs.redistribute(mesh, rep)
    if ep.dp > 1:
        fracs = fracs / ep.dp
    return y, e * torch.sum(fracs[:e] * fracs[e:])


def moe_block_ep(x, p, moe: MoEConfig, mlp_variant: str, ep: EPSpec, *,
                 constrain=None):
    """x: this rank's block [B, S, D] of the batch over ``ep.data_axes``
    (the same on every rank of the model axis) -> (y [B, S, D], the whole
    batch's load-balancing aux loss)."""
    y, (gates, topi) = _moe_ep(x, p, moe, mlp_variant, ep, constrain)
    if ep.dp == 1:
        return y, _aux_loss(gates, topi, moe.num_experts)
    return y, _aux_loss(gates, topi, moe.num_experts, ep.data_groups(),
                        ep.dp)


def moe_block(x, p, moe: MoEConfig, mlp_variant: str, *,
              capacity_factor: float = 1.25, ep=None, constrain=None,
              shard: Optional[dfn.BatchShard] = None):
    if _is_dtensor(x):
        return moe_block_sharded(x, p, moe, mlp_variant, ep)
    if ep is not None:
        return moe_block_ep(x, p, moe, mlp_variant, ep, constrain=constrain)
    return moe_block_global(x, p, moe, mlp_variant,
                            capacity_factor=capacity_factor, shard=shard)


def init_moe_params(d_model: int, moe: MoEConfig, dtype, *,
                    generator: torch.Generator, device) -> dict:
    """The reference's MoE parameters: the router N(0, 0.02) in float32,
    every expert matrix N(0, 0.02) in ``dtype``, drawn from ``generator``
    (the numbers differ from the reference's threefry draws)."""
    e, ff = moe.num_experts, moe.expert_ff

    def normal(shape, dt=dtype):
        if torch.device(device).type == "meta":
            return torch.empty(shape, dtype=dt, device=device)
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
