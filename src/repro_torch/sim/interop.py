"""Carry the reference's exported state into the port.

Data takes the place of weights in this system: the reference's drawn
event tensors, a W-vector, or a sorted booking stream, exported as numpy
arrays, become port tensors on a given device.  The tests feed both
packages the same inputs through these functions.  Nothing here imports
the reference; callers hand over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def events_from_numpy(events, device="cpu"):
    """A drawn event tuple as the reference's ``_raptor_stream_fns(...)[1]``
    returns it — ``(arrivals, z_case, [fail_seq,] t_oh, prio)``, or in
    fault mode ``(arrivals, z_case, t_oh, prio, u_err, u_jit)`` — each
    leaf with a leading per-stream axis ``(T, jobs, ...)``, as port
    tensors (float32, bool) on ``device``."""
    return tuple(_tensor(x, device) for x in events)


def env_from_numpy(bs, be, cs, ce, device="cpu"):
    """The reference's drawn fault tables — ``(T, A, I)`` brownout
    starts/ends and ``(T, W, C)`` crash starts/ends, as its
    ``_raptor_stream_fns(...)[0]`` or a fault-mode stock trace gives them
    — as the port's ``env`` bundle of float32 tensors on ``device``."""
    return tuple(_tensor(x, device).contiguous() for x in (bs, be, cs, ce))


def wvector_from_numpy(wf, device="cpu"):
    """A ``(T, W)`` (or ``(W,)``) worker free-at vector as float32."""
    return _tensor(wf, device)


def booking_stream_from_numpy(ready, service, wf0, device="cpu"):
    """A ready-sorted booking stream ``(T, N)`` and its ``(T, W)`` entry
    vectors as float32 port tensors."""
    return (_tensor(ready, device), _tensor(service, device),
            _tensor(wf0, device))
