"""Causal / sliding-window / logit-capped GQA attention: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``.  Layout as there: q ``[B, Hq, Sq, D]``, k and v
``[B, Hkv, Sk, D]``; query head ``h`` reads kv head ``h // (Hq // Hkv)``;
query ``i`` sits at key position ``i + q_offset``, by default ``Sk - Sq``
(a rank's block of a sequence-sharded query passes its block's start).
Per score: ``s = q.k * scale``, then ``tanh(s / cap) * cap``, then the
causal and window masks (``NEG_INF``, finite), softmax in float32,
output in the input dtype.

On this card the kernel is bound by its operations (see the note in
``csrc/flash_attention.cu``).  :func:`mha` launches it for CUDA tensors,
reading q, k and v through their strides, so the model's ``[B, S, H, D]``
tensors go in as ``transpose(1, 2)`` views without a copy; its output is
a ``[B, Hq, Sq, D]`` view of a ``[B, Sq, Hq, D]`` buffer.  CPU tensors run
:func:`attention_plain`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels._build import library

NEG_INF = -2.3819763e38
HEAD_DIMS = (32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = library("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [_P] * 4 + [_I] * 7 + [_L] * 12 + [_F, _F, _I, _I, _I, _P])
    lib.flash_attention_launch.restype = _I
    return lib


def _offset(sq: int, sk: int, q_offset) -> int:
    return sk - sq if q_offset is None else int(q_offset)


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, scale: float | None = None,
                    q_offset: int | None = None):
    """The plain PyTorch version (materialised scores, grouped GQA).
    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, hkv, rep, sq, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    qpos = torch.arange(sq, device=q.device)[:, None] + _offset(sq, sk,
                                                                q_offset)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _check(q, k, v, causal, q_offset=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, Hq, Sq, D] and k, v [B, Hkv, Sk, "
                         f"D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if causal and _offset(sq, k.shape[2], q_offset) < 0:
        raise ValueError(f"causal attention needs a query offset >= 0 "
                         f"(Sq <= Sk by default), got Sq={sq}, "
                         f"Sk={k.shape[2]}, q_offset={q_offset}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def mha(q, k, v, *, causal: bool = True, window: int = 0,
        logit_cap: float = 0.0, scale: float | None = None,
        q_offset: int | None = None):
    """GQA attention with an online softmax.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D], float32 or bfloat16, any
    strides with D contiguous; ``q_offset``: the key position of query
    row 0 (default ``Sk - Sq``).  CUDA tensors launch the kernel (D in
    ``HEAD_DIMS``); CPU tensors run :func:`attention_plain`.  When grad
    mode is on and an input requires grad, the call goes through an
    autograd Function whose backward is :func:`attention_vjp`; otherwise
    (serving) it launches directly.
    """
    _check(q, k, v, causal, q_offset)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    q_offset = _offset(q.shape[2], k.shape[2], q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window, logit_cap, scale,
                                q_offset)
    return _forward(q, k, v, causal, window, logit_cap, scale, q_offset)


def _forward(q, k, v, causal, window, logit_cap, scale, q_offset):
    """The kernel on CUDA tensors, :func:`attention_plain` on CPU ones."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               logit_cap=logit_cap, scale=scale,
                               q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cuda or cpu, not {q.device}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dim, rows "
                             f"16-byte aligned; strides {x.stride()}")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(scale), float(logit_cap or 0.0),
        int(bool(causal)), int(window or 0), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    with _count_lock:            # flight members launch from threads
        mha.launches += 1
    return out


#: kernel launches since the count was last set to 0
mha.launches = 0


def attention_vjp(q, k, v, dout, *, causal: bool = True,
                  window: int = 0, logit_cap: float = 0.0,
                  scale: float | None = None, block_q: int | None = None,
                  q_offset: int | None = None):
    """The gradient of :func:`mha` by the explicit softmax rule, in float32.

    For each block of queries: the scores ``s = q.k * scale`` again from q
    and k, the cap ``t = tanh(s / cap)``, ``s' = cap t``, the causal and
    window masks, ``P = softmax(s')``; then ``dV = P^T dO``, ``dP = dO
    V^T``, ``dS' = P o (dP - rowsum(dO o O))``, ``dS = dS' (1 - t^2)``
    under a cap, ``dQ = dS K scale`` and ``dK = dS^T Q scale``, dK and dV
    summed over each GQA group.  The row sum ``rowsum(dO o O)`` is taken
    as ``rowsum(P o dP)``, its equal (O = P V), from the float32 P: the
    forward's output rounded to bf16 would put that rounding into every
    dS (in bf16 it took dQ 2.5 x past the bf16 bar of its plain version's
    float32 autograd; this form stays within a quarter of it).  Sk may
    differ from Sq when ``causal=False`` (an encoder's or a cross
    attention); ``q_offset`` as in :func:`mha`.  Queries go in blocks of
    ``block_q`` (by default as many as keep a block's scores within 2**26
    elements).  Returns (dq, dk, dv) in the inputs' dtype.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    if block_q is None:
        block_q = max(1, min(sq, (1 << 26) // max(1, b * hq * sk)))
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kpos = torch.arange(sk, device=q.device)[None, :]
    off = _offset(sq, sk, q_offset)
    for i0 in range(0, sq, block_q):
        i1 = min(sq, i0 + block_q)
        qg = q[:, :, i0:i1].float().reshape(b, hkv, rep, i1 - i0, d)
        dog = dout[:, :, i0:i1].float().reshape(b, hkv, rep, i1 - i0, d)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kf) * scale
        if logit_cap:
            t = torch.tanh(s / logit_cap)
            s = t * logit_cap
        qpos = torch.arange(i0, i1, device=q.device)[:, None] + off
        mask = torch.ones((i1 - i0, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        p = torch.softmax(s.masked_fill_(~mask, NEG_INF), dim=-1)
        del s
        dv += torch.einsum("bgrqk,bgrqd->bgkd", p, dog)
        dp = torch.einsum("bgrqd,bgkd->bgrqk", dog, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del p, dp
        if logit_cap:
            ds = ds * (1 - torch.square(t))
            del t
        ds = ds * scale
        dq[:, :, i0:i1] = torch.einsum("bgrqk,bgkd->bgrqd", ds, kf).reshape(
            b, hq, i1 - i0, d)
        dk += torch.einsum("bgrqk,bgrqd->bgkd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """:func:`mha` with its gradient: the kernel (or the plain version
    on the CPU) forward, :func:`attention_vjp` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap,
                        scale=scale, q_offset=q_offset)
        return _forward(q, k, v, causal, window, logit_cap, scale, q_offset)

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = attention_vjp(*ctx.saved_tensors, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
_count_lock = threading.Lock()
