"""Exclusive prefix of factored max-plus block operators: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/maxplus_scan/kernel.py::
maxplus_scan``.  A block operator ``(d, b)`` maps a free-at vector to
``max(wf + d, b)``; compose is ``(d1 + d2, max(b1 + d2, b2))`` with
identity ``(0, -inf)``.  For each trial's tape of ``nb`` operators the
result is every block's entry vector (row 0 is ``wf0``) and the whole
tape applied to ``wf0``.

On this card the kernel is bound by its launch (the tape is a few KB at
the engine's shapes); ``csrc/maxplus_scan.cu`` scans each (trial,
worker) column in registers, :func:`scan_plan`'s lanes of one warp, with
shuffles and no barrier, and runs tapes too long for that in one CTA's
shared memory.  Both the
kernel and :func:`maxplus_entries_plain` run the same doubling sweeps
with the same per-element adds and maxes, so they are bitwise equal on
any input; against a sequential fold or an associative-scan tree they
are bitwise equal wherever compose is exact (integer-valued tapes, and
the engines' ``d = 0`` tapes, where compose is a float max).
:func:`maxplus_entries` launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

_P, _I = ctypes.c_void_p, ctypes.c_int
#: longest tape the register kernel scans: 32 lanes of 32 registers
REG_BLOCKS = 32 * 32


def scan_plan(nb: int):
    """(lanes per column, registers per lane) of the register kernel for a
    tape of ``nb`` blocks: the fewest lanes (a power of two, up to a warp)
    that hold the tape one block each, then the fewest registers (a power
    of two) per lane of a whole warp; ``(0, 0)`` past ``REG_BLOCKS``, where
    the shared-memory kernel runs."""
    if nb < 1:
        raise ValueError("the tape needs at least one block operator")
    if nb > REG_BLOCKS:
        return 0, 0
    if nb <= 32:
        return 1 << (nb - 1).bit_length(), 1
    return 32, 1 << ((nb + 31) // 32 - 1).bit_length()


@functools.cache
def _launcher():
    """The library's launch functions, bound once, and its size limit."""
    lib = library("maxplus_scan")
    lib.maxplus_scan_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.maxplus_scan_launch.restype = _I
    lib.maxplus_scan_noop_launch.argtypes = [_P]
    lib.maxplus_scan_noop_launch.restype = _I
    lib.maxplus_scan_max_elems.restype = _I
    lib.maxplus_scan_max_reg_blocks.restype = _I
    if lib.maxplus_scan_max_reg_blocks() != REG_BLOCKS:
        raise RuntimeError("csrc/maxplus_scan.cu and scan_plan disagree on "
                           "the register kernel's longest tape")
    return (lib.maxplus_scan_launch, lib.maxplus_scan_noop_launch,
            lib.maxplus_scan_max_elems())


def maxplus_entries_plain(diag, off, wf0):
    """The plain PyTorch version: Hillis-Steele doubling over the block
    axis, batched over trials.  diag/off: (T, nb, W); wf0: (T, W).
    Returns ``(entries (T, nb, W), wf_out (T, W))``."""
    T, nb, W = diag.shape
    d, b = diag, off
    s = 1
    while s < nb:
        d_sh = torch.cat([torch.zeros_like(d[:, :s]), d[:, :nb - s]], dim=1)
        b_sh = torch.cat([torch.full_like(b[:, :s], float("-inf")),
                          b[:, :nb - s]], dim=1)
        d, b = d_sh + d, torch.maximum(b_sh + d, b)
        s *= 2
    pd = torch.cat([torch.zeros_like(d[:, :1]), d[:, :nb - 1]], dim=1)
    pb = torch.cat([torch.full_like(b[:, :1], float("-inf")),
                    b[:, :nb - 1]], dim=1)
    entries = torch.maximum(wf0[:, None, :] + pd, pb)
    return entries, torch.maximum(wf0 + d[:, nb - 1], b[:, nb - 1])


def _check(diag, off, wf0):
    if diag.dim() != 3 or off.shape != diag.shape:
        raise ValueError(f"diag/off must both be (T, nb, W), got "
                         f"{tuple(diag.shape)} and {tuple(off.shape)}")
    T, nb, W = diag.shape
    if tuple(wf0.shape) != (T, W):
        raise ValueError(f"wf0 must be (T, W) = {(T, W)}, got "
                         f"{tuple(wf0.shape)}")
    if nb < 1:
        raise ValueError("the tape needs at least one block operator")
    for name, x in (("diag", diag), ("off", off), ("wf0", wf0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != diag.device:
            raise ValueError(f"{name} is on {x.device}, diag on "
                             f"{diag.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def maxplus_entries(diag, off, wf0):
    """Batched factored-operator prefix: diag/off (T, nb, W) float32, wf0
    (T, W) float32.  CUDA tensors launch the kernel, which raises when
    ``nb * W`` exceeds the shared memory of one CTA; CPU tensors run the
    plain version.  Returns ``(entries (T, nb, W), wf_out (T, W))``."""
    _check(diag, off, wf0)
    if diag.device.type == "cpu":
        return maxplus_entries_plain(diag, off, wf0)
    if diag.device.type != "cuda":
        raise ValueError(f"maxplus_entries runs on cuda or cpu, not "
                         f"{diag.device}")
    launch, _, max_elems = _launcher()
    T, nb, W = diag.shape
    if nb * W > max_elems:
        raise ValueError(
            f"nb * W = {nb * W} exceeds the {max_elems} elements one CTA's "
            f"shared memory holds")
    lanes, regs = scan_plan(nb)
    entries = torch.empty_like(diag)
    wf_out = torch.empty_like(wf0)
    stream = torch.cuda.current_stream(diag.device).cuda_stream
    err = launch(diag.data_ptr(), off.data_ptr(), wf0.data_ptr(),
                 entries.data_ptr(), wf_out.data_ptr(), T, nb, W, lanes,
                 regs, stream)
    if err != 0:
        raise RuntimeError(f"maxplus_scan launch failed: CUDA error {err}")
    maxplus_entries.launches += 1
    return entries, wf_out


#: kernel launches since the count was last set to 0
maxplus_entries.launches = 0


def noop_launch(device=None):
    """Launch the library's empty kernel (one warp) on the current stream
    of ``device``, as :func:`maxplus_entries` launches the scan: the launch
    floor its device time is held against.  Counted nowhere."""
    _, noop, _ = _launcher()
    err = noop(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"no-op launch failed: CUDA error {err}")
