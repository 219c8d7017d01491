"""Best-fit booking of ready-sorted event streams: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/queue_booking/kernel.py::
queue_booking``.  Per event: ``key = where(wf <= r, wf, -wf)``, ``w =
argmax(key)`` (lowest index on a tie), ``start = max(r, -max(key))``,
``fin = start + s``; ``r = inf`` books nothing (worker -1, start and fin
inf).  The W-vector is carried across the whole stream.

On this card the kernel is bound by the chain of N dependent steps per
trial, not by bytes; ``csrc/queue_booking.cu`` keeps the W-vector in the
registers of one warp per trial and reduces with warp shuffles (see the
note there).  :func:`book_stream` launches it for CUDA tensors and runs
:func:`book_stream_plain` only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import library

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = library("queue_booking")
    lib.queue_booking_launch.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.queue_booking_launch.restype = _I
    lib.queue_booking_max_workers.restype = _I
    lib.queue_booking_max_tile.restype = _I
    return lib


def book_stream_plain(ready, service, wf0):
    """The plain PyTorch version: one event at a time, batched over
    trials.  ready/service: (T, N) ready-sorted; wf0: (T, W).  Returns
    ``(fin (T, N), start (T, N), worker (T, N) int32, wf (T, W))``."""
    T, N = ready.shape
    wf = wf0.clone()
    fin = torch.empty_like(ready)
    start = torch.empty_like(ready)
    worker = torch.empty((T, N), dtype=torch.int32, device=ready.device)
    inf = torch.tensor(float("inf"), dtype=ready.dtype, device=ready.device)
    for i in range(N):
        r = ready[:, i]
        key = torch.where(wf <= r[:, None], wf, -wf)
        kmax = key.amax(dim=1)
        w = key.argmax(dim=1)
        st = torch.maximum(r, -kmax)
        f = st + service[:, i]
        live = ~torch.isinf(r)
        hot = (torch.arange(wf.shape[1], device=wf.device)[None, :]
               == w[:, None]) & live[:, None]
        wf = torch.where(hot, f[:, None], wf)
        fin[:, i] = torch.where(live, f, inf)
        start[:, i] = torch.where(live, st, inf)
        worker[:, i] = torch.where(live, w, -1).to(torch.int32)
    return fin, start, worker, wf


def _check(ready, service, wf0):
    if ready.dim() != 2 or service.shape != ready.shape:
        raise ValueError(f"ready/service must both be (T, N), got "
                         f"{tuple(ready.shape)} and {tuple(service.shape)}")
    if wf0.dim() != 2 or wf0.shape[0] != ready.shape[0]:
        raise ValueError(f"wf0 must be (T, W) with T={ready.shape[0]}, got "
                         f"{tuple(wf0.shape)}")
    for name, x in (("ready", ready), ("service", service), ("wf0", wf0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != ready.device:
            raise ValueError(f"{name} is on {x.device}, ready on "
                             f"{ready.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def book_stream(ready, service, wf0, *, block: int = 64):
    """Resolve batched ready-sorted booking streams.

    ready/service: (T, N) float32; wf0: (T, W) float32.  ``block`` is the
    kernel's shared-memory tile of events; it does not change the result.
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Returns ``(fin, start, worker int32, wf_final)``.
    """
    _check(ready, service, wf0)
    if ready.device.type == "cpu":
        return book_stream_plain(ready, service, wf0)
    if ready.device.type != "cuda":
        raise ValueError(f"book_stream runs on cuda or cpu, not "
                         f"{ready.device}")
    lib = _lib()
    T, N = ready.shape
    W = wf0.shape[1]
    if W > lib.queue_booking_max_workers():
        raise ValueError(f"the kernel takes at most "
                         f"{lib.queue_booking_max_workers()} workers, "
                         f"got W={W}")
    tile = max(1, min(int(block), lib.queue_booking_max_tile()))
    fin = torch.empty_like(ready)
    start = torch.empty_like(ready)
    worker = torch.empty((T, N), dtype=torch.int32, device=ready.device)
    wf = torch.empty_like(wf0)
    stream = torch.cuda.current_stream(ready.device).cuda_stream
    err = lib.queue_booking_launch(
        ready.data_ptr(), service.data_ptr(), wf0.data_ptr(),
        fin.data_ptr(), start.data_ptr(), worker.data_ptr(),
        wf.data_ptr(), T, N, W, tile, stream)
    if err != 0:
        raise RuntimeError(f"queue_booking launch failed: CUDA error {err}")
    book_stream.launches += 1
    return fin, start, worker, wf


#: kernel launches since the count was last set to 0
book_stream.launches = 0
