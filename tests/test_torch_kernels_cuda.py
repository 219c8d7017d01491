"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Each kernel is built with nvcc from ``src/repro_torch/csrc`` and must be
BITWISE equal to the plain version beside it (tolerance zero: both run
the same compares, selects, maxes and adds in the same order) at the
reference tests' shapes and at the engine's, and every launch must be
counted.  The plain versions are held to the JAX reference on the CPU by
tests/test_torch_kernels.py.  Every test here is marked ``cuda`` and
skips where there is no card; on a GPU machine run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.maxplus_scan.ops import (  # noqa: E402
    maxplus_entries, maxplus_entries_plain)
from repro_torch.kernels.queue_booking.ops import (  # noqa: E402
    book_stream, book_stream_plain)
from repro_torch.sim.interop import booking_stream_from_numpy  # noqa: E402

BOOK_CASES = [(2, 128, 15, 64, 0), (4, 200, 15, 64, 30), (1, 96, 4, 16, 0),
              (3, 256, 31, 128, 10), (2, 300, 100, 32, 7),
              (32, 4096, 15, 64, 0)]
SCAN_CASES = [(2, 1, 15), (2, 8, 15), (3, 5, 15), (4, 13, 7), (1, 32, 1),
              (2, 48, 31), (32, 64, 15), (2, 700, 20)]


def make_stream(seed, T, N, W, util=0.8, dead_tail=0):
    rng = np.random.default_rng(seed)
    ready = np.sort(rng.uniform(0, N * 100 / (W * util), (T, N)),
                    axis=1).astype(np.float32)
    if dead_tail:
        ready[:, N - dead_tail:] = np.inf
    service = rng.exponential(100.0, (T, N)).astype(np.float32)
    wf0 = rng.uniform(0, 300.0, (T, W)).astype(np.float32)
    return ready, service, wf0


def make_tape(seed, T, nb, W, diag_free=True, p_ninf=0.25):
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


def _eq(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,W,block,dead", BOOK_CASES)
def test_book_kernel_matches_plain_on_card(cuda, T, N, W, block, dead):
    args = booking_stream_from_numpy(*make_stream(0, T, N, W,
                                                  dead_tail=dead), cuda)
    n0 = book_stream.launches
    got = book_stream(*args, block=block)
    torch.cuda.synchronize()
    assert book_stream.launches == n0 + 1
    for g, p in zip(got, book_stream_plain(*args)):
        _eq(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("diag_free", [True, False])
@pytest.mark.parametrize("T,nb,W", SCAN_CASES)
def test_scan_kernel_matches_plain_on_card(cuda, T, nb, W, diag_free):
    diag, off, wf0 = (torch.as_tensor(x, device=cuda) for x in
                      make_tape(0, T, nb, W, diag_free=diag_free))
    n0 = maxplus_entries.launches
    got = maxplus_entries(diag, off, wf0)
    torch.cuda.synchronize()
    assert maxplus_entries.launches == n0 + 1
    for g, p in zip(got, maxplus_entries_plain(diag, off, wf0)):
        _eq(g, p)


@pytest.mark.cuda
def test_scan_kernel_refuses_oversized_tape(cuda):
    diag = torch.zeros((1, 4096, 16), device=cuda)
    with pytest.raises(ValueError):
        maxplus_entries(diag, diag, torch.zeros((1, 16), device=cuda))


@pytest.mark.cuda
def test_book_kernel_tile_invariance(cuda):
    args = booking_stream_from_numpy(*make_stream(5, 3, 1000, 15,
                                                  dead_tail=9), cuda)
    base = book_stream(*args, block=1)
    for block in (32, 64, 333, 4096):
        for a, b in zip(base, book_stream(*args, block=block)):
            _eq(a, b)
