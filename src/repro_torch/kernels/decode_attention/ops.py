"""Single-token GQA attention over a (ring) KV cache: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/decode_attention/kernel.py::
decode_attention``.  q ``[B, Hq, D]``; k and v ``[B, C, Hkv, D]``, the
model's cache layout; ``kv_pos [C]`` int32, where a slot with
``kv_pos < 0`` is masked (``NEG_INF``, finite).  Query head ``h`` reads kv
head ``h // (Hq // Hkv)``.  Per score: ``s = q.k * scale``, then
``tanh(s / cap) * cap``, then the mask; softmax in float32.  With
``return_lse`` each row's log-sum-exp of its scores comes back too
(float32 ``[B, Hq]``): parts of one row computed over disjoint slices of
the cache (a slot-sharded cache's ranks) merge by it
(:func:`merge_parts`).

On this card the kernel is bound by the bytes of the cache it reads (see
the note in ``csrc/decode_attention.cu``): the cache of each (batch, kv
head) is split over the blocks of a thread-block cluster, each block
streams its part through a TMA ring and computes every query head of its
group, and the cluster merges the parts inside the launch.  :func:`plan`
picks the cluster's size and split.  :func:`gqa_decode` launches the
kernel for CUDA tensors and runs :func:`decode_attention_plain` only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from repro_torch.kernels._build import library

NEG_INF = -2.3819763e38
HEAD_DIMS = (32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The library, its argument types set once, when it is loaded."""
    lib = library("decode_attention")
    lib.decode_attention_launch.argtypes = (
        [_P] * 6 + [_I] * 8 + [_L] * 10 + [_F, _F, _P])
    lib.decode_attention_launch.restype = _I
    for fn in ("decode_attention_tile", "decode_attention_blocks_per_sm"):
        getattr(lib, fn).argtypes = [_I, _I, _I]
        getattr(lib, fn).restype = _I
    for fn in ("decode_attention_max_rep", "decode_attention_max_cluster"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _shape(dtype: int, d: int, rep: int):
    """(slots per tile, blocks that fit an SM, most blocks of a cluster)
    of the instantiation that serves (dtype, d, rep)."""
    lib = _lib()
    per_sm = lib.decode_attention_blocks_per_sm(dtype, d, rep)
    if per_sm < 1:
        raise RuntimeError(f"decode_attention: no block of dtype {dtype}, "
                           f"D={d}, rep={rep} fits an SM")
    return (lib.decode_attention_tile(dtype, d, rep), per_sm,
            lib.decode_attention_max_cluster())


def decode_attention_plain(q, k, v, kv_pos, *, scale: float | None = None,
                           logit_cap: float = 0.0, return_lse: bool = False):
    """The plain PyTorch version (grouped GQA, materialised scores).
    q: [B, Hq, D]; k, v: [B, C, Hkv, D]; kv_pos: [C] -> [B, Hq, D] (and
    the rows' log-sum-exp [B, Hq] float32 with ``return_lse``)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bcgd->bgrc", qg, k.float()) * scale
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = torch.where((kv_pos >= 0)[None, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", p, v.float())
    out = out.reshape(b, hq, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(b, hq)
    return out


def merge_parts(outs, lses):
    """One row's attention from its parts over disjoint slices of the
    cache: ``outs`` [n, B, Hq, D] and ``lses`` [n, B, Hq] (each part's
    output and log-sum-exp) -> [B, Hq, D] in the parts' dtype; the parts
    weigh ``exp(lse_i - max_i lse_i)``, in float32."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m)
    out = (outs.float() * w[..., None]).sum(0) / w.sum(0)[..., None]
    return out.to(outs.dtype)


def _check(q, k, v, kv_pos):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, Hq, D] and k, v [B, C, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kv_pos.shape != (k.shape[1],) or kv_pos.dtype != torch.int32:
        raise ValueError(f"kv_pos must be int32 [C={k.shape[1]}], got "
                         f"{kv_pos.dtype} {tuple(kv_pos.shape)}")
    for name, x in (("k", k), ("v", v), ("kv_pos", kv_pos)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def plan(groups: int, c: int, tile: int, slots: int, max_cluster: int):
    """(cluster, tiles per block) for ``groups`` (batch, kv head) caches of
    ``c`` slots in tiles of ``tile``: the largest cluster, up to
    ``max_cluster`` blocks and one block per tile, whose grid still fits
    the ``slots`` blocks the card runs at once; every block of a cluster
    gets at least one tile."""
    tiles = math.ceil(c / tile)
    want = max(1, min(max_cluster, tiles, slots // groups))
    per = math.ceil(tiles / want)
    return math.ceil(tiles / per), per


def gqa_decode(q, k, v, kv_pos, *, scale: float | None = None,
               logit_cap: float = 0.0, return_lse: bool = False):
    """One token's attention over the cache.

    q: [B, Hq, D]; k, v: [B, C, Hkv, D] (D contiguous); kv_pos: [C]
    int32.  CUDA tensors launch the kernel; CPU tensors run
    :func:`decode_attention_plain`.  Returns [B, Hq, D], and with
    ``return_lse`` also each row's log-sum-exp, float32 [B, Hq].
    """
    _check(q, k, v, kv_pos)
    return _forward(q, k, v, kv_pos, scale, logit_cap, return_lse)


def _forward(q, k, v, kv_pos, scale, logit_cap, return_lse):
    """The kernel on CUDA tensors, :func:`decode_attention_plain` on CPU
    ones."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_pos, scale=scale,
                                      logit_cap=logit_cap,
                                      return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode runs on cuda or cpu, not {q.device}")
    lib = _lib()
    b, hq, d = q.shape
    c, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if d not in HEAD_DIMS or rep > lib.decode_attention_max_rep():
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS} and at "
                         f"most {lib.decode_attention_max_rep()} query heads"
                         f" per kv head; got D={d}, {rep}")
    vec = 16 // q.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dim, rows "
                             f"16-byte aligned; strides {x.stride()}")
    if q.stride(2) != 1:
        raise ValueError(f"q needs a contiguous head dim, strides "
                         f"{q.stride()}")
    kv_pos = kv_pos.contiguous()
    if kv_pos.data_ptr() % 16:           # a TMA source is 16-byte aligned
        kv_pos = kv_pos.clone()
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or c == 0:
        return (out, lse) if return_lse else out
    tile, per_sm, max_cluster = _shape(_DTYPES[q.dtype], d, rep)
    cluster, per = plan(b * hkv, c, tile, per_sm * _sm_count(q.device),
                        max_cluster)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), lse.data_ptr() if return_lse else None,
        _DTYPES[q.dtype], b, hq, hkv, c, d,
        cluster, per, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), out.stride(0),
        out.stride(1), float(scale), float(logit_cap or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    with _count_lock:            # flight members launch from threads
        gqa_decode.launches += 1
    return (out, lse) if return_lse else out


#: kernel launches since the count was last set to 0
gqa_decode.launches = 0
_count_lock = threading.Lock()
