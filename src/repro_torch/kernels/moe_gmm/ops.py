"""Capacity-batched expert matmul (the MoE grouped GEMM): the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/moe_gmm/kernel.py::
expert_matmul``: ``buf [E, C, D] @ w [E, D, F] -> [E, C, F]``, every
product summed in float32 and rounded once to the input dtype.

On this card the prefill's shape (C in the thousands) is bound by its
operations and the decode's (C = 4) by the bytes of the weights it reads
(see the note in ``csrc/expert_matmul.cu``).  :func:`gmm` launches the
kernel for CUDA tensors and runs :func:`expert_matmul_plain` only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels._build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = library("expert_matmul")
    lib.expert_matmul_launch.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.expert_matmul_launch.restype = _I
    return lib


def expert_matmul_plain(buf, w):
    """The plain PyTorch version: an einsum in float32, rounded once.
    buf: [E, C, D]; w: [E, D, F] -> [E, C, F] in buf's dtype."""
    return torch.einsum("ecd,edf->ecf", buf.float(), w.float()).to(
        buf.dtype)


def _check(buf, w):
    if buf.dim() != 3 or w.dim() != 3 or buf.shape[0] != w.shape[0] \
            or buf.shape[2] != w.shape[1]:
        raise ValueError(f"buf must be [E, C, D] and w [E, D, F], got "
                         f"{tuple(buf.shape)}, {tuple(w.shape)}")
    if w.dtype != buf.dtype:
        raise TypeError(f"w is {w.dtype}, buf is {buf.dtype}")
    if w.device != buf.device:
        raise ValueError(f"w is on {w.device}, buf on {buf.device}")


def gmm(buf, w):
    """Expert-batched GEMM with float32 accumulation.

    buf: [E, C, D]; w: [E, D, F], float32 or bfloat16, both contiguous.
    CUDA tensors launch the kernel (D and F multiples of 8); CPU tensors
    run :func:`expert_matmul_plain`.  Returns [E, C, F].  When grad mode
    is on and an input requires grad, the call goes through an autograd
    Function whose backward is two more of these products
    (:func:`gmm_vjp`); otherwise (serving) it launches directly.
    """
    _check(buf, w)
    if torch.is_grad_enabled() and (buf.requires_grad or w.requires_grad):
        return _ExpertMatmul.apply(buf, w)
    return _forward(buf, w)


def _forward(buf, w):
    """The kernel on CUDA tensors, :func:`expert_matmul_plain` on CPU
    ones."""
    if buf.device.type == "cpu":
        return expert_matmul_plain(buf, w)
    if buf.device.type != "cuda":
        raise ValueError(f"gmm runs on cuda or cpu, not {buf.device}")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{buf.dtype}")
    e, c, d = buf.shape
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"the kernel takes D and F multiples of 8, got "
                         f"D={d}, F={f}")
    for name, x in (("buf", buf), ("w", w)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned; strides {x.stride()}")
    out = torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = _lib().expert_matmul_launch(
        buf.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPES[buf.dtype],
        e, c, d, f, stream)
    if err != 0:
        raise RuntimeError(f"expert_matmul launch failed: CUDA error {err}")
    with _count_lock:            # flight members launch from threads
        gmm.launches += 1
    return out


#: kernel launches since the count was last set to 0
gmm.launches = 0


def _pad_rows(x, multiple: int):
    """``x`` [E, C, N] with zero rows appended until C is a multiple of
    ``multiple``."""
    pad = -x.shape[1] % multiple
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def gmm_vjp(buf, w, dout, *, need=(True, True)):
    """The gradient of :func:`gmm`.  The gradient of a batched GEMM is two
    batched GEMMs, so this runs the same kernel twice (the plain version
    on CPU tensors): ``dbuf = dout @ w^T`` and ``dw = buf^T @ dout``, the
    transposes made contiguous.  In ``dw`` the capacity C is the
    contraction, which the kernel takes in multiples of 8, so C is padded
    with zero rows there (``moe_capacity`` rounds it to 4).  ``need``
    says which of (dbuf, dw) to compute; the other is None."""
    dout = dout.contiguous()
    dbuf = dw = None
    if need[0]:
        dbuf = _forward(dout, w.transpose(1, 2).contiguous())
    if need[1]:
        dw = _forward(_pad_rows(buf, 8).transpose(1, 2).contiguous(),
                      _pad_rows(dout, 8))
    return dbuf, dw


class _ExpertMatmul(torch.autograd.Function):
    """:func:`gmm` with its gradient: the kernel forward, :func:`gmm_vjp`
    (two more launches) backward."""

    @staticmethod
    def forward(ctx, buf, w):
        ctx.save_for_backward(buf, w)
        return _forward(buf, w)

    @staticmethod
    def backward(ctx, dout):
        buf, w = ctx.saved_tensors
        return gmm_vjp(buf, w, dout, need=ctx.needs_input_grad)
_count_lock = threading.Lock()
