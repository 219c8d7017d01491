"""Best-fit booking of ready-sorted event streams: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/queue_booking/kernel.py::
queue_booking``.  Per event: ``key = where(wf <= r, wf, -wf)``, ``w =
argmax(key)`` (lowest index on a tie), ``start = max(r, -max(key))``,
``fin = start + s``; ``r = inf`` books nothing (worker -1, start and fin
inf).  The W-vector is carried across the whole stream.

On this card the kernel is bound by the chain of N dependent steps per
trial, not by bytes; ``csrc/queue_booking.cu`` keeps each trial's
W-vector in the registers of :func:`booking_plan`'s lanes (one at W <=
16, so no shuffle on the chain) and books each event with a balanced
compare-select tree (see the note there).  :func:`book_stream` launches
it for CUDA tensors and runs :func:`book_stream_plain` only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import library

_P, _I = ctypes.c_void_p, ctypes.c_int
#: workers one lane holds in registers, and lanes a trial may take
MAX_SLOTS, MAX_LANES = 16, 16


def booking_plan(W: int):
    """(lanes per trial, worker slots per lane) for a pool of ``W``: the
    fewest lanes (a power of two) that hold ``W`` at ``MAX_SLOTS`` each.
    One lane holds the whole pool in ``W`` slots; several hold
    ``MAX_SLOTS`` each, the last ones padded."""
    if not 1 <= W <= MAX_SLOTS * MAX_LANES:
        raise ValueError(f"the kernel takes 1 to {MAX_SLOTS * MAX_LANES} "
                         f"workers, got W={W}")
    lanes = 1
    while math.ceil(W / lanes) > MAX_SLOTS:
        lanes *= 2
    return lanes, W if lanes == 1 else MAX_SLOTS


def events_per_pass() -> int:
    """Events one pass of the kernel's main loop books (its loads and
    stores are of that many events at once)."""
    return library("queue_booking").queue_booking_group()


@functools.cache
def _launcher():
    """The library's launch function, bound once, and its tile limit."""
    lib = library("queue_booking")
    lib.queue_booking_launch.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.queue_booking_launch.restype = _I
    lib.queue_booking_max_workers.restype = _I
    lib.queue_booking_max_tile.restype = _I
    if lib.queue_booking_max_workers() != MAX_SLOTS * MAX_LANES:
        raise RuntimeError("csrc/queue_booking.cu and booking_plan disagree "
                           "on the largest pool")
    return lib.queue_booking_launch, lib.queue_booking_max_tile()


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

    ready/service: (T, N) float32; wf0: (T, W) float32, W at most 256.
    ``block`` is the reference kernel's block of events; the kernel
    checks it and it does not change the result.
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Returns ``(fin, start, worker int32, wf_final)``.
    """
    _check(ready, service, wf0)
    if ready.device.type == "cpu":
        return book_stream_plain(ready, service, wf0)
    if ready.device.type != "cuda":
        raise ValueError(f"book_stream runs on cuda or cpu, not "
                         f"{ready.device}")
    T, N = ready.shape
    W = wf0.shape[1]
    lanes, slots = booking_plan(W)
    launch, max_tile = _launcher()
    tile = max(1, min(int(block), max_tile))
    fin = torch.empty_like(ready)
    start = torch.empty_like(ready)
    worker = torch.empty((T, N), dtype=torch.int32, device=ready.device)
    wf = torch.empty_like(wf0)
    stream = torch.cuda.current_stream(ready.device).cuda_stream
    err = launch(ready.data_ptr(), service.data_ptr(), wf0.data_ptr(),
                 fin.data_ptr(), start.data_ptr(), worker.data_ptr(),
                 wf.data_ptr(), T, N, W, tile, lanes, slots, stream)
    if err != 0:
        raise RuntimeError(f"queue_booking launch failed: CUDA error {err}")
    book_stream.launches += 1
    return fin, start, worker, wf


#: kernel launches since the count was last set to 0
book_stream.launches = 0
