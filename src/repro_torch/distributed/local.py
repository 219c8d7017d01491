"""The model's kernels on the local shards of ``DTensor`` activations.

A sharded step (``Plan.shard_state``, ``Plan.shard_batch``,
``Plan.init_cache``) carries every leaf as a ``DTensor`` placed by the
plan's specs.  DTensor's propagation runs the projections, norms and
elementwise ops on the shards; the kernels cannot run on a ``DTensor``,
so each runs on every rank's local block under ``local_map``, with the
layout read from the placements the plan's ``constrain`` gave the
inputs:

- :func:`sharded_attention` (K3): queries sharded over heads (the keys
  and values of each rank's heads: sharded with them where the kv heads
  divide the axis, else replicated and each rank takes exactly the kv
  heads of its own query heads) or over the sequence (the keys whole, the
  block's start passed as the kernel's query offset for its causal mask
  and window);
- :func:`sharded_decode` (K4): a cache sharded over kv heads decodes each
  rank's heads; a cache sharded over its slots runs the kernel over each
  rank's slice of the ring and merges the parts across the slot axes by
  their log-sum-exp;
- :func:`write_slots`: a ring write of new keys into a cache, whose
  slots may be sharded: only the rank that owns a slot writes it.

The MoE block (K5, ``models/moe.py``) and the Mamba2 inner block (K6,
``models/mamba2.py``) use the helpers here to read their layouts.

Gradients: an input that is replicated over a mesh dim on which each rank
used only a part of it (the keys of a rank's query heads or sequence
block) gets a ``Partial`` gradient there, summed when it is
redistributed to its parameter's placements.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def settle(t):
    """A DTensor with every ``Partial`` placement reduced (``Replicate``):
    DTensor's propagation leaves a sum pending where the ops allow it
    (a norm's output is linear in its input), a kernel needs values."""
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def coord(mesh, dims) -> tuple:
    """(this rank's flat coordinate over mesh ``dims``, major to minor;
    the number of blocks they make)."""
    idx, n = 0, 1
    for i in dims:
        s = mesh.size(i)
        idx, n = idx * s + mesh.get_local_rank(i), n * s
    return idx, n


def shard_dims(t, dim: int) -> list:
    """The mesh dims over which ``t`` is sharded on tensor dim ``dim``."""
    return [i for i, p in enumerate(t.placements) if p.is_shard(dim)]


def linear(x, w):
    """``x @ w`` of an activation x [B, S, K] and a weight w [K, N].  A
    DTensor x has its pending sums reduced first (:func:`settle`: else
    DTensor would gather the weight and multiply the partial sums, the
    whole width on every rank), and so has the product (a row-parallel
    weight's partial sums, reduced once in the model dtype: left
    pending, the next norm would reduce them in float32, twice).  With
    x sharded over the sequence (the plan's sequence-parallel residual),
    the product runs on each rank's block under ``local_map``, w
    gathered over the mesh dims where x is sharded or where w's own
    sharding would cut the contraction: DTensor's matmul would flatten
    the batch and sequence dims, which two mesh dims shard, into one it
    cannot split.  Else ``x @ w``."""
    if not is_dtensor(x):
        return x @ w
    x = settle(x)
    if not shard_dims(x, 1):
        return settle(x @ w)
    mesh = x.device_mesh
    w_pl, out_pl, w_grad = [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if xp.is_shard():
            w_pl.append(Replicate())
            out_pl.append(xp)
            w_grad.append(Partial())
        elif wp.is_shard(1):
            w_pl.append(wp)
            out_pl.append(Shard(2))
            w_grad.append(wp)
        else:
            w_pl.append(Replicate())
            out_pl.append(Replicate())
            w_grad.append(Replicate())
    fn = local_map(torch.matmul, out_placements=out_pl,
                   in_placements=(tuple(x.placements), tuple(w_pl)),
                   in_grad_placements=(tuple(x.placements), tuple(w_grad)),
                   device_mesh=mesh)
    return fn(x, w.redistribute(mesh, w_pl))


def heads_weight(w, h: int, dim: int = 1):
    """A projection weight whose ``dim`` is ``h`` heads (the output of
    ``wq`` [D, h * hd], the input of ``wo`` [h * hd, D]): a DTensor
    sharded on it over mesh dims whose blocks are not whole heads is
    gathered over them (the heads' layout is then the plan's
    ``act_heads``: the sequence); else ``w``."""
    if not is_dtensor(w):
        return w
    dims = shard_dims(w, dim)
    n = 1
    for i in dims:
        n *= w.device_mesh.size(i)
    if not dims or h % n == 0:
        return w
    return w.redistribute(w.device_mesh, [
        Replicate() if i in dims else p for i, p in enumerate(w.placements)])


def kv_for_heads(k, v, h0: int, n: int, rep: int):
    """The keys and values that query heads ``h0 .. h0 + n - 1`` read
    (query head ``h`` reads kv head ``h // rep``), on dim 2 of [B, S, H,
    D]: a slice where the heads take whole groups or share one kv head,
    else one kv head per query head."""
    g0, g1 = h0 // rep, (h0 + n - 1) // rep + 1
    if g1 - g0 == 1 or (h0 % rep == 0 and n % rep == 0):
        return k[:, :, g0:g1], v[:, :, g0:g1]
    idx = torch.arange(h0, h0 + n, device=k.device) // rep
    return k[:, :, idx], v[:, :, idx]


def sharded_attention(q, k, v, attend):
    """``attend(q, k, v, q_offset)`` (plain tensors [B, S, H, D]) on each
    rank's block of the DTensors q [B, Sq, Hq, D] and k, v [B, Sk, Hkv,
    D]; returns the output as a DTensor placed as q."""
    q, k, v = settle(q), settle(k), settle(v)
    mesh = q.device_mesh
    hq, hkv, sq, sk = q.shape[2], k.shape[2], q.shape[1], k.shape[1]
    head_dims = shard_dims(q, 2)
    seq_dims = shard_dims(q, 1)
    h_idx, n_h = coord(mesh, head_dims)
    s_idx, n_s = coord(mesh, seq_dims)
    kv_split = bool(head_dims) and hkv % n_h == 0
    kv_pl, kv_grad = [], []
    for i, p in enumerate(q.placements):
        if p.is_shard(0):
            kv_pl.append(Shard(0))
            kv_grad.append(Shard(0))
        elif i in head_dims and kv_split:
            kv_pl.append(Shard(2))
            kv_grad.append(Shard(2))
        elif i in head_dims or i in seq_dims:
            kv_pl.append(Replicate())          # each rank reads a part
            kv_grad.append(Partial())
        elif p.is_replicate():
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
        else:
            raise ValueError(f"attention over a query placed {p}")
    hq_l, sq_l = hq // n_h, sq // n_s
    q_offset = (sk - sq) + s_idx * sq_l
    rep = hq // hkv

    def local(ql, kl, vl):
        if head_dims and not kv_split:
            kl, vl = kv_for_heads(kl, vl, h_idx * hq_l, hq_l, rep)
        return attend(ql, kl, vl, q_offset)

    qpl = tuple(q.placements)
    fn = local_map(local, out_placements=list(qpl),
                   in_placements=(qpl, tuple(kv_pl), tuple(kv_pl)),
                   in_grad_placements=(qpl, tuple(kv_grad),
                                       tuple(kv_grad)),
                   device_mesh=mesh)
    return fn(q, k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl))


def merge_over(out, lse, mesh, dims):
    """Attention parts over disjoint slices of a cache (``out`` [B, H, D],
    ``lse`` [B, H] on this rank) merged across mesh ``dims``: each part
    weighs ``exp(lse - max lse)``, in float32."""
    m = lse
    for i in dims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    w = torch.exp(lse - m)
    num = out.float() * w[..., None]
    for i in dims:
        num = funcol.all_reduce(num, "sum", (mesh, i))
        w = funcol.all_reduce(w, "sum", (mesh, i))
    return (num / w[..., None]).to(out.dtype)


def sharded_decode(q, kc, vc, kv_pos, decode):
    """``decode(q, k, v, kv_pos, return_lse)`` (plain tensors: q [B, Hq,
    D], k, v [B, C, Hkv, D], kv_pos [C]) on each rank's block of the
    DTensor cache ``kc``, ``vc`` [B, C, Hkv, D] for the DTensor q [B, Hq,
    D]; ``kv_pos`` is the whole cache's (a plain tensor).  Where the
    cache's slots are sharded, q is replicated over those dims, each rank
    attends over its slice of the ring and the parts merge by their
    log-sum-exp.  Returns a DTensor [B, Hq, D]."""
    mesh = kc.device_mesh
    q_pl = []
    for p in kc.placements:
        if p.is_shard(0):
            q_pl.append(Shard(0))
        elif p.is_shard(2):
            q_pl.append(Shard(1))
        else:
            q_pl.append(Replicate())
    slot_dims = shard_dims(kc, 1)
    s_idx, n_s = coord(mesh, slot_dims)
    c_l = kc.shape[1] // n_s
    pos = kv_pos[s_idx * c_l:(s_idx + 1) * c_l]
    ql = settle(q).redistribute(mesh, q_pl).to_local()
    kl, vl = kc.to_local(), vc.to_local()
    if slot_dims:
        out, lse = decode(ql, kl, vl, pos, True)
        out = merge_over(out, lse, mesh, slot_dims)
    else:
        out = decode(ql, kl, vl, pos, False)
    return DTensor.from_local(out, mesh, q_pl, run_check=False,
                              shape=(q.shape[0], q.shape[1], q.shape[2]),
                              stride=(q.shape[1] * q.shape[2], q.shape[2],
                                      1))


def _runs(start: int, n: int, c: int):
    """(source index, slot, length) of the contiguous runs of a write of
    ``n`` values at slots ``(start + i) mod c``."""
    start %= c
    first = min(n, c - start)
    yield 0, start, first
    if n > first:
        yield first, 0, n - first


def write_slots(buf, vals, start: int) -> None:
    """Write ``vals`` [B, n, ...] into the ring ``buf`` [B, C, ...] at
    slots ``(start + i) mod C``, in place.  On DTensors each rank writes
    its block: where the slots are sharded, the slots it owns."""
    if is_dtensor(buf):
        mesh = buf.device_mesh
        slot_dims = shard_dims(buf, 1)
        pl = [Replicate() if i in slot_dims else p
              for i, p in enumerate(buf.placements)]
        vl = settle(vals).redistribute(mesh, pl).to_local()
        bl = buf.to_local()
        idx, n_s = coord(mesh, slot_dims)
    else:
        vl, bl, idx, n_s = vals, buf, 0, 1
    c_l = buf.shape[1] // n_s
    lo = idx * c_l
    for src, dst, length in _runs(start, vals.shape[1], buf.shape[1]):
        a, b = max(dst, lo), min(dst + length, lo + c_l)
        if a < b:
            bl[:, a - lo:b - lo] = vl[:, src + a - dst:src + b - dst]


def assign(buf, val) -> None:
    """``buf.copy_(val)`` for DTensors of one shape: ``val`` moved to
    ``buf``'s placements, each rank copying its block."""
    buf.to_local().copy_(val.redistribute(buf.device_mesh,
                                          buf.placements).to_local())
