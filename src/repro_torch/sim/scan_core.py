"""Blocked event-replay substrate: chunked max-plus scans over a worker pool.

The port of ``repro/sim/scan_core.py``.  Every closed-loop engine replays
one sorted event stream per trial against a pool of ``W`` workers,
carrying only the per-worker free-at vector (the W-vector).  The stream
is chunked into blocks of ``B`` events; all bookings inside a block are
resolved by a bounded parallel fixed point, and only the W-vector crosses
block boundaries.

Why the fixed point is exact: an event observes earlier events only
through the W-vector, and every booking enters it as a per-worker max, so
the vector event ``i`` observes is ``max(wf_in, max_{j<i} contrib_j)`` —
an exclusive running max (``torch.cummax``).  That dependency is strictly
lower-triangular in event order, so re-booking every event against the
vectors reconstructed from the previous pass has a unique fixed point,
the sequential schedule, reached in at most ``B`` passes.  Chaining
resolved blocks is itself a max-plus linear recurrence over factored
``(diag, offset)`` operators that compose associatively, so
``scan="logdepth"`` gets every block's entry vector from one prefix scan
per outer pass (the ``maxplus_scan`` kernel or a PyTorch associative
scan).

Shapes: the reference writes every function for one trial and ``vmap``s
it; here the trial axis (and, inside a block, the block and event axes)
are leading batch dimensions written out.  An event stream is a tuple of
tensors whose event axis sits right after the W-vector's batch axes:
``wf0`` is ``(T, W)`` and every event leaf ``(T, N, ...)``.  A booking
``body(wf, event) -> ((widx, rel), out)`` must broadcast over any leading
dimensions: ``wf`` is ``(*L, W)``, each event leaf ``(*L, ...)``, ``widx``
and ``rel`` are ``(*L, M)`` (``widx < 0`` books nothing; ``rel`` must be
``-inf`` wherever the event must not touch the pool), and ``out`` is a
tuple of ``(*L, ...)`` tensors.

``while_loop``s become Python loops whose convergence flag is computed
on the device and read once per pass.  Batching trials together changes
nothing: once a trial's iteration has converged, another pass returns
bitwise the same state, so running every trial until the last one
converges equals running each on its own.

Every comparison and selection is exact, argmax/argmin return the lowest
index on a tie, and sorts are stable, so every configuration here is
bitwise equal to the reference on the same inputs
(tests/test_torch_scan_core.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
from repro_torch.kernels.queue_booking.ops import book_stream

_NEG_INF = float("-inf")
_INF = float("inf")


def _tmap(fn, *trees):
    return tuple(fn(*xs) for xs in zip(*trees))


def _take(tree, dim, i):
    return tuple(a.select(dim, i) for a in tree)


def _stack(seq, dim):
    return tuple(torch.stack(xs, dim=dim) for xs in zip(*seq))


def booking_contrib(num_workers: int, widx, rel):
    """Dense ``(..., W)`` max-map of one event's bookings from its booked
    worker indices and release times ``(..., M)``; a negative index
    matches no worker and contributes ``-inf`` everywhere."""
    oh = widx[..., None] == torch.arange(num_workers, device=widx.device)
    return torch.where(oh, rel[..., None], _NEG_INF).amax(dim=-2)


def apply_bookings(wf, widx, rel):
    """Fold one event's bookings into the free-at vector (max-plus)."""
    return torch.maximum(wf, booking_contrib(wf.shape[-1], widx, rel))


def exclusive_running_max(contrib, wf_in):
    """Per-event observed W-vectors: ``contrib`` is ``(..., n, W)``, row
    ``i`` of the result is ``max(wf_in, max_{j<i} contrib[j])``."""
    run = torch.cummax(contrib, dim=-2).values
    prev = torch.cat([torch.full_like(run[..., :1, :], _NEG_INF),
                      run[..., :-1, :]], dim=-2)
    return torch.maximum(wf_in[..., None, :], prev)


# --------------------------------------------------------------------------
# factored W x W max-plus block operators (the log-depth summaries)
# --------------------------------------------------------------------------
# apply((d, b), wf) = max(wf + d, b) elementwise.  The engines only emit
# d = 0 operators (a booking replaces a worker's free-at time), where
# compose is an elementwise float max — exactly associative, which keeps
# scan="logdepth" bitwise against the sequential chain.

def maxplus_identity(num_workers: int, dtype=torch.float32, device=None):
    """The do-nothing block operator: d = 0, b = -inf."""
    return (torch.zeros(num_workers, dtype=dtype, device=device),
            torch.full((num_workers,), _NEG_INF, dtype=dtype, device=device))


def maxplus_compose(first, then):
    """Operator for "apply ``first``, then ``then``": max(max(wf + d1, b1)
    + d2, b2) = max(wf + (d1 + d2), max(b1 + d2, b2))."""
    d1, b1 = first
    d2, b2 = then
    return d1 + d2, torch.maximum(b1 + d2, b2)


def maxplus_apply(op, wf):
    """Push a free-at vector through a factored block operator."""
    d, b = op
    return torch.maximum(wf + d, b)


def block_summary(num_workers: int, widx, rel):
    """Offset part of a resolved block's operator: the per-worker max of
    its booking contributions, ``(..., W)`` from ``(..., B, M)``."""
    return booking_contrib(num_workers, widx, rel).amax(dim=-2)


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``fn(earlier, later)``: the odd/even recursion of
    ``jax.lax.associative_scan``, so every element is combined in the
    reference's bracketing."""
    def slc(x, start, stop, step=None):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    def interleave(a, b):
        shape = list(a.shape)
        shape[dim] = a.shape[dim] + b.shape[dim]
        out = a.new_empty(shape)
        idx = [slice(None)] * a.dim()
        idx[dim] = slice(0, None, 2)
        out[tuple(idx)] = a
        idx[dim] = slice(1, None, 2)
        out[tuple(idx)] = b
        return out

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn(tuple(slc(e, 0, -1, 2) for e in elems),
                     tuple(slc(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(slc(e, 0, -1) for e in odd),
                      tuple(slc(e, 2, None, 2) for e in elems))
        else:
            even = fn(odd, tuple(slc(e, 2, None, 2) for e in elems))
        even = tuple(torch.cat([slc(e, 0, 1), r], dim=dim)
                     for e, r in zip(elems, even))
        return tuple(interleave(a, b) for a, b in zip(even, odd))

    return scan(tuple(elems))


def maxplus_prefix_entries(diag, off, wf0, *, backend: str = "torch"):
    """Entry vectors of every block from one associative prefix scan.

    ``diag``/``off``: ``(T, nb, W)`` factored per-block operators,
    ``wf0``: ``(T, W)`` each stream's entry vector.  Returns ``(entries,
    wf_out)``: row ``k`` of ``entries`` ``(T, nb, W)`` is the vector block
    ``k`` begins with (row 0 is ``wf0``), ``wf_out`` the exit vector.
    ``backend="kernel"`` runs the ``maxplus_scan`` kernel
    (:mod:`repro_torch.kernels.maxplus_scan.ops`); ``"torch"`` the
    associative scan above.
    """
    if backend == "kernel":
        return maxplus_entries(diag, off, wf0)
    if backend != "torch":
        raise ValueError(f"unknown summary backend {backend!r}")
    pd, pb = associative_scan(maxplus_compose, (diag, off), dim=1)
    w0 = wf0[:, None, :]
    entries = torch.cat(
        [w0, maxplus_apply((pd[:, :-1], pb[:, :-1]), w0)], dim=1)
    return entries, maxplus_apply((pd[:, -1], pb[:, -1]), wf0)


# --------------------------------------------------------------------------
# intra-block resolvers (exact, shape-generic over the block length)
# --------------------------------------------------------------------------

def _fixpoint_resolver(body, W):
    """Bounded parallel Jacobi over one block: re-book every event against
    the per-event W-vectors reconstructed from the previous pass until the
    OBSERVED vectors converge (bitwise); the returned ``(est, out)`` are
    evaluated at the converged rows."""
    def resolve(wf, ev):
        nev = ev[0].shape[wf.dim() - 1]

        def rows_of(est):
            return exclusive_running_max(booking_contrib(W, *est), wf)

        # pass 1 observes the carried vector alone (the empty-prefix rows)
        used = wf[..., None, :].expand(*wf.shape[:-1], nev, W)
        est, out = body(used, ev)
        rows = rows_of(est)
        p = 1
        while p < nev and bool(torch.any(rows != used)):
            est, out = body(rows, ev)
            used, rows = rows, rows_of(est)
            p += 1
        return est, out

    return resolve


def _unrolled_resolver(body):
    """Resolve one block event by event; also returns the booking
    estimates so the caller can summarize the block."""
    def resolve(wf, ev):
        ax = wf.dim() - 1
        w, ests, outs = wf, [], []
        for i in range(ev[0].shape[ax]):
            (widx, rel), out = body(w, _take(ev, ax, i))
            w = apply_bookings(w, widx, rel)
            ests.append((widx, rel))
            outs.append(out)
        return _stack(ests, ax), _stack(outs, ax)

    return resolve


def blocked_event_replay(body, wf0, events, *, block: int,
                         resolver: str = "fixpoint", scan: str = "seq",
                         summary_backend: str = "torch"):
    """Replay sorted event streams in blocks, carrying only the W-vector.

    ``wf0`` is ``(T, W)``; ``events`` a tuple of ``(T, N, ...)`` tensors
    (each trial's stream, already sorted); ``body`` books one event (see
    the module docstring).  ``block`` need not divide ``N``: the ragged
    tail is resolved as one final partial block.  ``block=0`` picks the
    adaptive log-depth split ``ceil(N/3)``.

    ``block=1`` (and ``resolver="unrolled"`` with ``scan="seq"``) is the
    plain sequential replay — the oracle path.  Otherwise each block is
    resolved by ``resolver``: ``"fixpoint"`` (the bounded parallel Jacobi,
    exact in at most ``block`` passes) or ``"unrolled"`` (event by
    event).  ``scan`` chains the blocks: ``"seq"`` carries the W-vector
    block to block; ``"logdepth"`` summarizes every block as a factored
    max-plus operator and gets all entry vectors from one prefix scan per
    outer pass (``summary_backend`` "torch" or the "kernel"), iterating a
    block-level Jacobi to its unique fixed point (at most ``nb`` passes).

    Every configuration is bitwise equal to the ``block=1`` oracle.
    Returns ``(wf_final (T, W), outs)`` with each out leaf stacked along
    the event axis.
    """
    W = int(wf0.shape[-1])
    ax = wf0.dim() - 1
    n = int(events[0].shape[ax])
    block = int(block)
    if not block:
        block = max(1, -(-n // 3))
    if scan not in ("seq", "logdepth"):
        raise ValueError(f"unknown block scan mode {scan!r}")

    if block <= 1 or (resolver == "unrolled" and scan == "seq"):
        wf, outs = wf0, []
        for i in range(n):
            (widx, rel), out = body(wf, _take(events, ax, i))
            wf = apply_bookings(wf, widx, rel)
            outs.append(out)
        return wf, _stack(outs, ax)

    if resolver == "fixpoint":
        resolve = _fixpoint_resolver(body, W)
    elif resolver == "unrolled":
        resolve = _unrolled_resolver(body)
    else:
        raise ValueError(f"unknown block resolver {resolver!r}")

    nb, rem = divmod(n, block)
    split = n - rem
    lead = tuple(wf0.shape[:-1])

    def resolve_step(wf, ev):
        est, out = resolve(wf, ev)
        return (torch.maximum(wf, booking_contrib(W, *est).amax(dim=-2)),
                out)

    wf_r, outs = wf0, None
    if nb and scan == "seq":
        parts = []
        for k in range(nb):
            ev = tuple(a.narrow(ax, k * block, block) for a in events)
            wf_r, out = resolve_step(wf_r, ev)
            parts.append(out)
        outs = tuple(torch.cat(xs, dim=ax) for xs in zip(*parts))
    elif nb:
        main = tuple(a.narrow(ax, 0, split).reshape(
            lead + (nb, block) + tuple(a.shape[ax + 1:])) for a in events)
        wf_r, outs = _logdepth_replay(resolve, wf0, main, nb, W,
                                      summary_backend)
        outs = tuple(a.reshape(lead + (split,) + tuple(a.shape[ax + 2:]))
                     for a in outs)
    if rem:
        tail = tuple(a.narrow(ax, split, rem) for a in events)
        wf_r, out_t = resolve_step(wf_r, tail)
        outs = out_t if outs is None else _tmap(
            lambda x, y: torch.cat([x, y], dim=ax), outs, out_t)
    return wf_r, outs


def _logdepth_replay(resolve, wf0, ev_blocks, nb, W, summary_backend):
    """Block-level Jacobi over entry vectors with the associative max-plus
    prefix supplying every block's entry at O(log nb) depth per pass.

    At exit the returned ``out`` was produced by a resolve pass whose
    entry estimates equal the entries its bookings regenerate — the
    unique fixed point, i.e. the sequential schedule.  Summaries are
    offset-only (diag = 0), so the prefix composes float maxes only.
    """
    zeros = wf0.new_zeros(tuple(wf0.shape[:-1]) + (nb, W))

    def prefix(est):
        off = block_summary(W, *est)            # (T, nb, W)
        return maxplus_prefix_entries(zeros, off, wf0,
                                      backend=summary_backend)

    used = wf0[..., None, :].expand(*wf0.shape[:-1], nb, W)
    est, out = resolve(used, ev_blocks)
    entries, wf_out = prefix(est)
    p = 1
    while p < nb and bool(torch.any(entries != used)):
        est, out = resolve(entries, ev_blocks)
        entries2, wf_out = prefix(est)
        used, entries = entries, entries2
        p += 1
    return wf_out, out


# --------------------------------------------------------------------------
# the shared booking step (task-FCFS stock discipline) + its blocked form
# --------------------------------------------------------------------------

def bestfit_book_step(wf, ready, service):
    """Book one ready task: best-fit among free workers, earliest-free
    fallback when all are busy.

    Fused key: free workers (``wf <= ready``) rank by ``wf``, busy ones by
    ``-wf`` (< 0, so they lose to any free worker, and among them the
    argmax is the earliest-free); ``-max(key)`` is the booking-delay
    floor, so ``start = max(ready, -max(key))``.  A ``ready`` of ``inf``
    books nothing: worker -1, start and fin inf.  ``wf`` is ``(..., W)``,
    ``ready``/``service`` ``(...)``.  Returns (worker, start, fin).
    """
    live = ~torch.isinf(ready)
    key = torch.where(wf <= ready[..., None], wf, -wf)
    w = key.argmax(dim=-1)
    start = torch.maximum(ready, -key.amax(dim=-1))
    fin = start + service
    return (torch.where(live, w, -1), torch.where(live, start, _INF),
            torch.where(live, fin, _INF))


def blocked_bestfit_booking(wf0, ready, service, *, block: int,
                            full: bool = True, backend: str = "scan",
                            resolver: str = "fixpoint", scan: str = "seq",
                            summary_backend: str = "torch"):
    """Resolve whole ready-sorted streams of best-fit bookings.

    ``ready``/``service`` are ``(T, N)``, ``wf0`` the ``(T, W)`` entry
    free-at vectors.  Returns ``(fin, start, worker int32)`` when ``full``
    else ``(fin,)``.  ``backend="scan"`` runs :func:`blocked_event_replay`
    with the given ``resolver``/``scan``/``summary_backend``;
    ``"kernel"`` runs the ``queue_booking`` kernel
    (:mod:`repro_torch.kernels.queue_booking.ops`), whose tile is
    ``block``.
    """
    if backend == "kernel":
        fin, start, worker, _ = book_stream(ready, service, wf0,
                                            block=max(int(block), 1))
        return (fin, start, worker) if full else (fin,)
    if backend != "scan":
        raise ValueError(f"unknown booking backend {backend!r}")

    def body(wf, ev):
        w, start, fin = bestfit_book_step(wf, *ev)
        out = (fin, start, w) if full else (fin,)
        # widx=-1 already gates dead events out of the pool; fin is their
        # (constant) inf, so the convergence check stays stable
        return (w[..., None], fin[..., None]), out

    _, outs = blocked_event_replay(body, wf0, (ready, service),
                                   block=block, resolver=resolver, scan=scan,
                                   summary_backend=summary_backend)
    if full:
        return outs[0], outs[1], outs[2].to(torch.int32)
    return outs


def blocked_sorted_booking(wf0, ready, service, *, block: int):
    """Finish times of ready-sorted best-fit booking streams, resolved
    block-parallel through the order-statistic form of the recurrence.

    Under ready-sorted FCFS only the sorted pool matters, and the start
    time is an order statistic: ``st_i = max(r_i, c_i-th smallest of
    (pool_in ∪ {fin_j : j < i}))`` with ``c_i`` the count of live events
    through ``i``.  Each Jacobi pass is one stable sort of the ``(W + B)``
    pool tagged by availability rank plus a cumulative-count selection;
    passes repeat until the finish times stop changing.  ``wf0`` is
    ``(T, W)``, ``ready``/``service`` ``(T, N)``.  Returns ``(fin,)``
    (inf for dead events), bitwise the sequential scan's finish times.
    """
    W = int(wf0.shape[-1])
    n = int(ready.shape[-1])
    block = int(block)
    dev = ready.device

    def resolve(pool, r, s):
        blk = r.shape[-1]
        idx = torch.arange(blk, device=dev)
        avail = torch.cat([torch.zeros(W, dtype=torch.long, device=dev),
                           1 + idx])
        live = ~torch.isinf(r)
        c = torch.cumsum(live, dim=-1)        # live bookings through event i

        def one_pass(fin):
            vals = torch.cat([pool, fin], dim=-1)
            order = torch.argsort(vals, dim=-1, stable=True)
            v_s = torch.gather(vals, -1, order)
            a_s = avail[order]
            # element q is in event i's pool iff its availability rank
            # a_s[q] <= i (0 = entry pool, j+1 = fin_j); the c_i-th
            # included element of the sorted tape IS the order statistic
            incl = a_s[..., None, :] <= idx[:, None]
            cnt = torch.cumsum(incl, dim=-1)
            hit = incl & (cnt == c[..., None])
            sig = torch.where(hit, v_s[..., None, :], 0.0).sum(dim=-1)
            st = torch.maximum(r, sig)
            return torch.where(live, st + s, _INF)

        prev = torch.where(live, r + s, _INF)  # zero-queueing bound
        fin = one_pass(prev)
        p = 1
        while p < blk and bool(torch.any(fin != prev)):
            prev, fin = fin, one_pass(fin)
            p += 1
        # block exit: the c_B consumed values are exactly the c_B smallest
        # of the pool ∪ fins (consume-min equivalence); keep the rest
        tape = torch.sort(torch.cat([pool, fin], dim=-1), dim=-1).values
        keep = c[..., -1:] + torch.arange(W, device=dev)
        return torch.gather(tape, -1, keep), fin

    nb, rem = divmod(n, block)
    pool = torch.sort(wf0, dim=-1).values
    fins = []
    for k in range(nb + (1 if rem else 0)):
        lo, hi = k * block, min(n, (k + 1) * block)
        pool, fin = resolve(pool, ready[..., lo:hi], service[..., lo:hi])
        fins.append(fin)
    if not fins:
        return (ready.new_zeros(ready.shape),)
    return (torch.cat(fins, dim=-1),)


def stock_booking_fins(wf0, ready, service, *, block: int,
                       backend: str = "scan", scan: str = "seq",
                       summary_backend: str = "torch"):
    """Finish times only — the form the stock stage-depth fixed point
    consumes on every estimation pass.  ``block <= 1`` runs the
    sequential oracle scan, larger blocks the order-statistic resolver
    (``scan="seq"``) or the log-depth generic replay (``scan="logdepth"``),
    ``backend="kernel"`` the ``queue_booking`` kernel."""
    if backend == "kernel" or block <= 1:
        return blocked_bestfit_booking(
            wf0, ready, service, block=max(block, 1), full=False,
            backend=backend)
    if scan == "logdepth":
        return blocked_bestfit_booking(
            wf0, ready, service, block=block, full=False, backend=backend,
            resolver="unrolled", scan="logdepth",
            summary_backend=summary_backend)
    return blocked_sorted_booking(wf0, ready, service, block=block)
