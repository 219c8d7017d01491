"""The Mamba2 SSD (state-space duality) scan: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan``.  x ``[b, s, h, p]``, dt ``[b, s, h]`` (after the softplus), A
``[h]`` (negative), B and C ``[b, s, g, n]`` with ``h % g == 0``, all
float32; head ``i`` reads group ``i // (h // g)``.  Per step t of head i
the state ``[p, n]`` is ``S_t = exp(dt_t A) S_{t-1} + (dt_t x_t) B_t^T``
and ``y_t = S_t C_t``; returns y ``[b, s, h, p]`` and the final state
``[b, h, p, n]``, float32.

:func:`ssd_plain` is the reference's ``ssd_chunked``
(``repro/models/mamba2.py``) in PyTorch: every chunk's work as batched
matrix products, the inter-chunk recurrence as an associative scan in the
reference's bracketing.  :func:`ssd` launches the kernel for CUDA tensors
(the sequence cut into chunks that run in parallel: the chunks' own
states, a short recurrence over them that leaves each chunk's entry
state, then every chunk's output from its entry state, the products on
the tensor cores in 3xTF32; see the note in ``csrc/ssd_scan.cu``;
:func:`chunk_plan` gives the cut) and runs :func:`ssd_plain` only for CPU
tensors.
The two sum in other orders: they agree to float32 rounding.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels._build import library
from repro_torch.sim.scan_core import associative_scan

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The library, its argument types set once, when it is loaded."""
    lib = library("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.ssd_scan_launch.restype = _I
    for fn in ("ssd_scan_max_dim", "ssd_scan_chunk"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
    return lib


def chunk_plan(s: int, chunk: int) -> int:
    """The chunks of the kernel's cut of ``s`` steps into chunks of
    ``chunk`` (the last one shorter): they run in parallel, and the
    workspace holds one state and one decay per chunk."""
    return -(-s // chunk)


def segsum(a):
    """Stable segment sum: ``out[..., i, j] = sum a[..., j+1..i]``, -inf
    for ``j > i``.  a: [..., Q] -> [..., Q, Q]."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, d, float("-inf"))


def _chunk_limit(s: int, chunk: int) -> int:
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"the sequence length {s} must be a multiple of "
                         f"the chunk {q}")
    return q


def ssd_plain(x, dt, A, B, C, *, chunk: int):
    """The plain PyTorch version: the reference's ``ssd_chunked``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = _chunk_limit(s, chunk)
    nc = s // q
    rep = h // g

    xb = x.reshape(b, nc, q, h, p)
    dtb = dt.reshape(b, nc, q, h)
    Bb = torch.repeat_interleave(B.reshape(b, nc, q, g, n), rep, dim=3)
    Cb = torch.repeat_interleave(C.reshape(b, nc, q, g, n), rep, dim=3)

    a = dtb * A[None, None, None, :]                          # log-decay
    a_hc = a.permute(0, 1, 3, 2)                              # [b,nc,h,q]
    L = torch.exp(segsum(a_hc))                               # [b,nc,h,q,q]

    # intra-chunk, batched over all chunks
    cb = torch.einsum("bcqhn,bckhn->bchqk", Cb, Bb)
    dtx = xb * dtb[..., None]                                 # [b,nc,q,h,p]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", cb * L, dtx)

    # chunk states
    cum = torch.cumsum(a_hc, dim=-1)                          # [b,nc,h,q]
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", Bb, decay_to_end, dtx)

    # inter-chunk recurrence h_c = h_{c-1} exp(sum a_c) + states_c
    chunk_decay = torch.exp(cum[..., -1])                     # [b,nc,h]

    def combine(left, right):
        dl, sl = left
        dr, sr = right
        return dl * dr, sl * dr[..., None, None] + sr

    _, st_all = associative_scan(combine, (chunk_decay, states), dim=1)
    st_prev = torch.cat([torch.zeros_like(st_all[:, :1]), st_all[:, :-1]],
                        dim=1)

    decay_in = torch.exp(cum)
    y_inter = torch.einsum("bcqhn,bchq,bchpn->bcqhp", Cb, decay_in, st_prev)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, st_all[:, -1]


def _check(x, dt, A, B, C):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.shape != B.shape:
        raise ValueError(
            f"x must be [b, s, h, p], dt [b, s, h], A [h], B and C [b, s, "
            f"g, n]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, _ = x.shape
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s) \
            or h % B.shape[2]:
        raise ValueError(
            f"shapes do not match: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """The SSD scan over a whole sequence; returns (y, final_state).

    CUDA tensors launch the kernel (float32, contiguous, p and n
    multiples of 16 up to ``ssd_scan_max_dim``); CPU tensors run
    :func:`ssd_plain`.  As in the reference, the sequence length must be a
    multiple of ``min(chunk, s)``; the kernel's own tiling does not depend
    on it.  When grad mode is on and an input requires grad, the call
    goes through an autograd Function (the kernel on contiguous copies of
    the inputs forward, :func:`ssd_vjp` backward); otherwise (serving) it
    launches directly.
    """
    _check(x, dt, A, B, C)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        return _SSD.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C, chunk)


def _forward(x, dt, A, B, C, chunk):
    """The kernel on CUDA tensors, :func:`ssd_plain` on CPU ones."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    _chunk_limit(s, chunk)
    lib = _lib()
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; strides "
                             f"{t.stride()}")
    top = lib.ssd_scan_max_dim()
    if not (0 < p <= top and 0 < n <= top and p % 16 == 0 and n % 16 == 0):
        raise ValueError(f"the kernel takes p and n multiples of 16 up to "
                         f"{top}, got p={p}, n={n}")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    nc = chunk_plan(s, lib.ssd_scan_chunk())
    ws = torch.empty((b, h, nc, p * n), dtype=torch.float32,
                     device=x.device)
    dec = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(),
        dec.data_ptr(), b, s, h, p, g, n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    with _count_lock:            # flight members launch from threads
        ssd.launches += 1
    return y, state


#: kernel launches since the count was last set to 0
ssd.launches = 0


def ssd_vjp(x, dt, A, B, C, dy, dstate, *, chunk: int):
    """The gradient of :func:`ssd` by the reverse of the chunked form.

    Recomputes :func:`ssd_plain`'s intermediates, then takes the
    cotangents ``dy`` [b, s, h, p] and ``dstate`` [b, h, p, n] (the final
    state's) back through them: the inter-chunk outputs and the
    intra-chunk products as einsums, the inter-chunk recurrence
    ``S_c = S_{c-1} exp(sum a_c) + states_c`` backwards over the chunk
    decays seeded by ``dstate``, and the log-decay ``a = dt A`` through
    the ``segsum`` matrix, ``cum``, ``decay_to_end``, ``chunk_decay`` and
    ``decay_in`` into dt and A.  B and C's gradients are summed over the
    heads of their group.  Returns (dx, ddt, dA, dB, dC), float32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = _chunk_limit(s, chunk)
    nc = s // q
    rep = h // g
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))

    xb = x.reshape(b, nc, q, h, p)
    dtb = dt.reshape(b, nc, q, h)
    Bb = torch.repeat_interleave(B.reshape(b, nc, q, g, n), rep, dim=3)
    Cb = torch.repeat_interleave(C.reshape(b, nc, q, g, n), rep, dim=3)
    a_hc = (dtb * A).permute(0, 1, 3, 2)                      # [b,nc,h,q]
    cum = torch.cumsum(a_hc, dim=-1)
    L = torch.exp(segsum(a_hc))                               # [b,nc,h,q,q]
    cb = torch.einsum("bcqhn,bckhn->bchqk", Cb, Bb)
    dtx = xb * dtb[..., None]                                 # [b,nc,q,h,p]
    decay_to_end = torch.exp(cum[..., -1:] - cum)             # [b,nc,h,q]
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", Bb, decay_to_end, dtx)
    chunk_decay = torch.exp(cum[..., -1])                     # [b,nc,h]
    decay_in = torch.exp(cum)
    # the states entering each chunk, by the plain recurrence
    st_prev = torch.empty_like(states)
    run = torch.zeros_like(states[:, 0])
    for c in range(nc):
        st_prev[:, c] = run
        run = run * chunk_decay[:, c, :, None, None] + states[:, c]

    dyb = dy.float().reshape(b, nc, q, h, p)
    # y_inter = C . decay_in . st_prev
    dCb = torch.einsum("bcqhp,bchq,bchpn->bcqhn", dyb, decay_in, st_prev)
    d_decay_in = torch.einsum("bcqhp,bcqhn,bchpn->bchq", dyb, Cb, st_prev)
    d_st_prev = torch.einsum("bcqhp,bcqhn,bchq->bchpn", dyb, Cb, decay_in)
    # the recurrence backwards: G_c, the whole gradient of S_c, is
    # dS_c (dstate for the last chunk, d_st_prev[c + 1] before it) plus
    # G_{c+1} exp(sum a_{c+1}); states_c takes G_c, the chunk decay
    # G_c . S_{c-1}
    d_states = torch.empty_like(states)
    grad = (torch.zeros_like(states[:, 0]) if dstate is None
            else dstate.float())
    for c in range(nc - 1, -1, -1):
        d_states[:, c] = grad
        if c:
            grad = d_st_prev[:, c] + grad * chunk_decay[:, c, :, None, None]
    d_chunk_decay = torch.einsum("bchpn,bchpn->bch", d_states, st_prev)
    # states = B . decay_to_end . dtx
    dBb = torch.einsum("bchpn,bchq,bcqhp->bcqhn", d_states, decay_to_end,
                       dtx)
    d_dte = torch.einsum("bchpn,bcqhn,bcqhp->bchq", d_states, Bb, dtx)
    d_dtx = torch.einsum("bchpn,bcqhn,bchq->bcqhp", d_states, Bb,
                         decay_to_end)
    # y_intra = (cb o L) . dtx
    dM = torch.einsum("bcqhp,bckhp->bchqk", dyb, dtx)
    d_dtx = d_dtx + torch.einsum("bchqk,bcqhp->bckhp", cb * L, dyb)
    d_cb = dM * L
    dCb = dCb + torch.einsum("bchqk,bckhn->bcqhn", d_cb, Bb)
    dBb = dBb + torch.einsum("bchqk,bcqhn->bckhn", d_cb, Cb)
    # the log-decay: L = exp(segsum), segsum[i, j] = cum_i - cum_j (j <= i;
    # L is 0 above the diagonal, so d_seg is too)
    d_seg = dM * cb * L
    d_cum = d_seg.sum(-1) - d_seg.sum(-2)
    d_end = d_dte * decay_to_end                  # decay_to_end = exp(e - cum)
    d_cum = d_cum - d_end
    d_cum[..., -1] += d_end.sum(-1) + d_chunk_decay * chunk_decay
    d_cum = d_cum + d_decay_in * decay_in
    d_a = torch.flip(torch.cumsum(torch.flip(d_cum, (-1,)), -1), (-1,))
    d_a = d_a.permute(0, 1, 3, 2)                             # [b,nc,q,h]
    # a = dt A, dtx = x dt
    ddt = d_a * A + (d_dtx * xb).sum(-1)
    dA = (d_a * dtb).sum((0, 1, 2))
    dx = d_dtx * dtb[..., None]
    dB = dBb.reshape(b, nc, q, g, rep, n).sum(4).reshape(b, s, g, n)
    dC = dCb.reshape(b, nc, q, g, rep, n).sum(4).reshape(b, s, g, n)
    return (dx.reshape(b, s, h, p), ddt.reshape(b, s, h), dA, dB, dC)


class _SSD(torch.autograd.Function):
    """:func:`ssd` with its gradient: the kernel (the plain version on the
    CPU) on contiguous float32 copies forward, :func:`ssd_vjp` backward
    with the cotangents of both outputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        x, dt, A, B, C = (t.float().contiguous() for t in (x, dt, A, B, C))
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ssd_vjp(*ctx.saved_tensors, dy, dstate, chunk=ctx.chunk)
        return (*grads, None)
_count_lock = threading.Lock()
