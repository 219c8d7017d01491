"""The port's two scheduling kernels against the JAX reference kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, and the
plain version is held BITWISE to the reference: ``book_stream_ref`` and
``book_stream(interpret=True)`` for ``queue_booking``; ``maxplus_scan_ref``
and ``maxplus_entries(interpret=True)`` for ``maxplus_scan``, on the
reference tests' fixtures (integer-valued tapes with d != 0, and the
engines' d = 0 shape, where compose is exact).  Every op here is a
compare, select, max or add of the same float32 operands in the same
order, so the tolerance is zero.

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.maxplus_scan.ops import maxplus_entries as j_entries  # noqa: E402
from repro.kernels.maxplus_scan.ref import maxplus_scan_ref  # noqa: E402
from repro.kernels.queue_booking.ops import book_stream as j_book  # noqa: E402
from repro.kernels.queue_booking.ref import book_stream_ref  # noqa: E402
from repro_torch.kernels.maxplus_scan.ops import maxplus_entries  # noqa: E402
from repro_torch.kernels.queue_booking.ops import book_stream  # noqa: E402
from repro_torch.sim.interop import booking_stream_from_numpy  # noqa: E402


def make_stream(seed, T, N, W, util=0.8, dead_tail=0):
    """The reference test's booking fixture (ready-sorted, float32)."""
    rng = np.random.default_rng(seed)
    ready = np.sort(rng.uniform(0, N * 100 / (W * util), (T, N)),
                    axis=1).astype(np.float32)
    if dead_tail:
        ready[:, N - dead_tail:] = np.inf
    service = rng.exponential(100.0, (T, N)).astype(np.float32)
    wf0 = rng.uniform(0, 300.0, (T, W)).astype(np.float32)
    return ready, service, wf0


def make_tape(seed, T, nb, W, diag_free=True, p_ninf=0.25):
    """The reference test's operator tapes: integer-valued float32 (exact
    composes); ``diag_free=False`` is the engines' d = 0 shape."""
    rng = np.random.default_rng(seed)
    if diag_free:
        diag = rng.integers(-20, 20, (T, nb, W)).astype(np.float32)
    else:
        diag = np.zeros((T, nb, W), np.float32)
    off = rng.integers(0, 1000, (T, nb, W)).astype(np.float32)
    off = np.where(rng.uniform(size=off.shape) < p_ninf, -np.inf,
                   off).astype(np.float32)
    wf0 = rng.integers(0, 500, (T, W)).astype(np.float32)
    return diag, off, wf0


BOOK_CASES = [
    # (T, N, W, block, dead_tail) — the reference test's CASES
    (2, 128, 15, 64, 0),
    (4, 200, 15, 64, 30),
    (1, 96, 4, 16, 0),
    (3, 256, 31, 128, 10),
]
SCAN_CASES = [(2, 1, 15), (2, 8, 15), (3, 5, 15), (4, 13, 7), (1, 32, 1),
              (2, 48, 31)]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- K1 plain

@pytest.mark.parametrize("T,N,W,block,dead", BOOK_CASES)
def test_book_plain_matches_reference(T, N, W, block, dead):
    ready, service, wf0 = make_stream(0, T, N, W, dead_tail=dead)
    ref = book_stream_ref(jnp.asarray(ready), jnp.asarray(service),
                          jnp.asarray(wf0))
    interp = j_book(jnp.asarray(ready), jnp.asarray(service),
                    jnp.asarray(wf0), block=block, interpret=True)
    got = book_stream(*booking_stream_from_numpy(ready, service, wf0),
                      block=block)
    assert got[2].dtype == torch.int32
    for g, r, i in zip(got, ref, interp):
        _eq(g.numpy(), r)
        _eq(g.numpy(), i)


def test_book_block_invariance_and_dead_tail():
    """``block`` only tiles the kernel; dead (ready=inf) events book
    nothing: worker -1, fin inf, and the final W-vector equals a replay of
    the live prefix alone."""
    ready, service, wf0 = make_stream(3, 2, 96, 8, dead_tail=20)
    args = booking_stream_from_numpy(ready, service, wf0)
    base = book_stream(*args, block=1)
    for block in (16, 64, 96):
        for a, b in zip(base, book_stream(*args, block=block)):
            _eq(a, b)
    fin, _, worker, wf = base
    assert np.all(worker.numpy()[:, 76:] == -1)
    assert np.all(np.isinf(fin.numpy()[:, 76:]))
    _, _, _, wf_live = book_stream(args[0][:, :76].contiguous(),
                                   args[1][:, :76].contiguous(), args[2])
    _eq(wf, wf_live)


def test_book_state_carries():
    """Bookings early in the stream constrain later events."""
    ready, service, wf0 = make_stream(2, 1, 128, 4, util=1.2)
    fin1 = book_stream(*booking_stream_from_numpy(ready, service, wf0))[0]
    service[:, :32] = 0.0
    fin2 = book_stream(*booking_stream_from_numpy(ready, service, wf0))[0]
    assert not np.array_equal(fin1.numpy()[:, 64:], fin2.numpy()[:, 64:])


def test_book_wrapper_rejects_bad_inputs():
    ready, service, wf0 = (torch.as_tensor(x) for x in
                           make_stream(0, 2, 8, 3))
    with pytest.raises(TypeError):
        book_stream(ready.double(), service, wf0)
    with pytest.raises(ValueError):
        book_stream(ready, service[:, :4], wf0)
    with pytest.raises(ValueError):
        book_stream(ready, service, wf0[:1])
    with pytest.raises(ValueError):
        book_stream(ready.t().contiguous().t(), service, wf0)


# ---------------------------------------------------------------- K2 plain

@pytest.mark.parametrize("diag_free", [True, False])
@pytest.mark.parametrize("T,nb,W", SCAN_CASES)
def test_scan_plain_matches_reference(T, nb, W, diag_free):
    diag, off, wf0 = make_tape(0, T, nb, W, diag_free=diag_free)
    jargs = (jnp.asarray(diag), jnp.asarray(off), jnp.asarray(wf0))
    ref = maxplus_scan_ref(*jargs)
    interp = j_entries(*jargs, interpret=True)
    got = maxplus_entries(torch.as_tensor(diag), torch.as_tensor(off),
                          torch.as_tensor(wf0))
    for g, r, i in zip(got, ref, interp):
        _eq(g.numpy(), r)
        _eq(g.numpy(), i)


def test_scan_entry_rows_are_exclusive():
    diag, off, wf0 = (torch.as_tensor(x) for x in
                      make_tape(2, 1, 9, 5, diag_free=False))
    ent1, _ = maxplus_entries(diag, off, wf0)
    off2 = off.clone()
    off2[:, 4] = 2000.0
    ent2, wf2 = maxplus_entries(diag, off2, wf0)
    _eq(ent1[:, :5], ent2[:, :5])
    assert bool(torch.all(ent2[:, 5:] >= 2000.0))
    assert bool(torch.all(wf2 >= 2000.0))


def test_scan_wrapper_rejects_bad_inputs():
    diag, off, wf0 = (torch.as_tensor(x) for x in make_tape(0, 2, 4, 3))
    with pytest.raises(TypeError):
        maxplus_entries(diag.double(), off, wf0)
    with pytest.raises(ValueError):
        maxplus_entries(diag, off, wf0[:, :2])
    with pytest.raises(ValueError):
        maxplus_entries(diag[:, :0], off[:, :0], wf0)
