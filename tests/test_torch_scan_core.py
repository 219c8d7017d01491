"""The port's blocked event-replay substrate against the JAX reference.

Bar 1: every function of ``repro_torch.sim.scan_core`` uses only adds,
maxes, compares, selects and (stable) sorts, so on the same float32
inputs it must equal ``repro.sim.scan_core`` BITWISE (tolerance zero),
per trial (the reference vmaps its per-trial functions; the port takes
the trial axis as a leading batch dimension).  Inputs are made with numpy
from fixed seeds and handed to both packages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.sim import scan_core as J  # noqa: E402
from repro_torch.sim import scan_core as P  # noqa: E402


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=msg)


def _stream(seed, T, N, W, util=0.9, dead_tail=0):
    """Ready-sorted, tie-free booking streams (float32) with a non-zero
    entry W-vector and an optional dead (ready=inf) tail."""
    rng = np.random.default_rng(seed)
    ready = np.sort(rng.uniform(0, N * 100 / (W * util), (T, N)),
                    axis=1).astype(np.float32)
    if dead_tail:
        ready[:, N - dead_tail:] = np.inf
    service = rng.exponential(100.0, (T, N)).astype(np.float32)
    wf0 = rng.uniform(0, 300.0, (T, W)).astype(np.float32)
    return ready, service, wf0


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def test_exclusive_running_max_and_bookings():
    rng = np.random.default_rng(0)
    T, n, W, M = 3, 17, 6, 2
    contrib = rng.normal(size=(T, n, W)).astype(np.float32)
    contrib[rng.uniform(size=contrib.shape) < 0.3] = -np.inf
    wf = rng.normal(size=(T, W)).astype(np.float32)
    ref = jax.vmap(J.exclusive_running_max)(jnp.asarray(contrib),
                                            jnp.asarray(wf))
    _eq(P.exclusive_running_max(*_t(contrib, wf)), ref)
    widx = rng.integers(-1, W, (T, n, M)).astype(np.int32)
    rel = rng.normal(size=(T, n, M)).astype(np.float32)
    rel[widx < 0] = -np.inf
    _eq(P.booking_contrib(W, *_t(widx, rel)),
        J.booking_contrib(W, jnp.asarray(widx), jnp.asarray(rel)))
    _eq(P.block_summary(W, *_t(widx, rel)),
        jax.vmap(functools.partial(J.block_summary, W))(jnp.asarray(widx),
                                                        jnp.asarray(rel)))
    _eq(P.apply_bookings(*_t(wf, widx[:, 0], rel[:, 0])),
        J.apply_bookings(jnp.asarray(wf), jnp.asarray(widx[:, 0]),
                         jnp.asarray(rel[:, 0])))


@pytest.mark.parametrize("nb", [1, 2, 5, 8, 13, 32])
def test_prefix_entries_torch_backend_bitwise_on_floats(nb):
    """The port's associative scan brackets like ``lax.associative_scan``,
    so it is bitwise the reference even where compose rounds (random
    float d != 0); the kernel backend's plain version is bitwise where
    compose is exact (integer-valued tapes)."""
    rng = np.random.default_rng(nb)
    T, W = 3, 7
    diag = rng.normal(size=(T, nb, W)).astype(np.float32)
    off = (rng.normal(size=(T, nb, W)) * 100).astype(np.float32)
    off[rng.uniform(size=off.shape) < 0.25] = -np.inf
    wf0 = rng.normal(size=(T, W)).astype(np.float32)
    ref = jax.vmap(J.maxplus_prefix_entries)(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(wf0))
    for g, r in zip(P.maxplus_prefix_entries(*_t(diag, off, wf0)), ref):
        _eq(g, r)
    diag, off = np.round(diag * 10), np.round(off)
    ref = jax.vmap(J.maxplus_prefix_entries)(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(wf0))
    got = P.maxplus_prefix_entries(*_t(diag, off, wf0), backend="kernel")
    for g, r in zip(got, ref):
        _eq(g, r)


def test_maxplus_algebra():
    rng = np.random.default_rng(5)
    W = 6
    ops = [(torch.as_tensor(rng.integers(-20, 20, W).astype(np.float32)),
            torch.as_tensor(rng.integers(-20, 20, W).astype(np.float32)))
           for _ in range(3)]
    f, g, h = ops
    left = P.maxplus_compose(P.maxplus_compose(f, g), h)
    right = P.maxplus_compose(f, P.maxplus_compose(g, h))
    for a, b in zip(left, right):
        _eq(a, b)
    wf = torch.as_tensor(rng.integers(-20, 20, W).astype(np.float32))
    _eq(P.maxplus_apply(left, wf),
        P.maxplus_apply(h, P.maxplus_apply(g, P.maxplus_apply(f, wf))))
    ident = P.maxplus_identity(W)
    for a, b in zip(P.maxplus_compose(ident, f), f):
        _eq(a, b)


def test_bestfit_book_step():
    rng = np.random.default_rng(1)
    T, W = 64, 9
    wf = rng.uniform(0, 100, (T, W)).astype(np.float32)
    ready = rng.uniform(0, 100, T).astype(np.float32)
    ready[::7] = np.inf
    service = rng.exponential(10.0, T).astype(np.float32)
    ref = jax.vmap(J.bestfit_book_step)(jnp.asarray(wf), jnp.asarray(ready),
                                        jnp.asarray(service))
    for g, r in zip(P.bestfit_book_step(*_t(wf, ready, service)), ref):
        _eq(g, r)


REPLAY_CONFIGS = [(1, "fixpoint", "seq")] + [
    (block, resolver, scan)
    for block in (3, 8, 16, 0)
    for resolver in ("fixpoint", "unrolled")
    for scan in ("seq", "logdepth")]


@pytest.mark.parametrize("block,resolver,scan", REPLAY_CONFIGS)
def test_blocked_event_replay_grid(block, resolver, scan):
    """The generic replay (through the best-fit booking body) on a
    50-event stream — blocks 3, 8, 16 and the adaptive 0 (= 17) all leave
    a ragged tail — with a dead tail and a non-zero entry vector: bitwise
    the reference's same configuration."""
    ready, service, wf0 = _stream(4, 2, 50, 6, dead_tail=5)
    ref_fn = jax.jit(jax.vmap(functools.partial(
        J.blocked_bestfit_booking, block=block, full=True,
        resolver=resolver, scan=scan)))
    ref = ref_fn(jnp.asarray(wf0), jnp.asarray(ready), jnp.asarray(service))
    got = P.blocked_bestfit_booking(*_t(wf0, ready, service), block=block,
                                    resolver=resolver, scan=scan)
    for name, g, r in zip(("fin", "start", "worker"), got, ref):
        _eq(g, r, f"{name} block={block}/{resolver}/{scan}")


@pytest.mark.parametrize("block", [3, 8, 16, 64])
def test_blocked_sorted_booking(block):
    ready, service, wf0 = _stream(6, 3, 70, 5, util=1.3, dead_tail=4)
    ref = jax.jit(jax.vmap(functools.partial(
        J.blocked_sorted_booking, block=block)))(
        jnp.asarray(wf0), jnp.asarray(ready), jnp.asarray(service))
    got = P.blocked_sorted_booking(*_t(wf0, ready, service), block=block)
    _eq(got[0], ref[0])


@pytest.mark.parametrize("block,backend,scan", [
    (1, "scan", "seq"), (16, "scan", "seq"), (16, "scan", "logdepth"),
    (16, "kernel", "seq")])
def test_stock_booking_fins(block, backend, scan):
    """Every dispatch of the stock estimation pass; the reference's
    ``"pallas"`` backend is the port's ``"kernel"`` (its plain version
    on the CPU)."""
    ready, service, wf0 = _stream(8, 2, 60, 7)
    ref = jax.jit(jax.vmap(functools.partial(
        J.stock_booking_fins, block=block,
        backend="pallas" if backend == "kernel" else "scan", scan=scan,
        interpret=True)))(jnp.asarray(wf0), jnp.asarray(ready),
                          jnp.asarray(service))
    got = P.stock_booking_fins(*_t(wf0, ready, service), block=block,
                               backend=backend, scan=scan)
    _eq(got[0], ref[0])


def test_unknown_modes_raise():
    ready, service, wf0 = _t(*_stream(0, 1, 8, 3))
    with pytest.raises(ValueError):
        P.blocked_bestfit_booking(wf0, ready, service, block=4, scan="tree")
    with pytest.raises(ValueError):
        P.blocked_bestfit_booking(wf0, ready, service, block=4,
                                  resolver="magic")
    with pytest.raises(ValueError):
        P.blocked_bestfit_booking(wf0, ready, service, block=4,
                                  backend="pallas")
    with pytest.raises(ValueError):
        P.maxplus_prefix_entries(wf0[:, None], wf0[:, None], wf0,
                                 backend="xla")
