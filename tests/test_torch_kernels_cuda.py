"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Each kernel is built with nvcc from ``src/repro_torch/csrc`` and every
launch must be counted.  The two scheduling kernels must be BITWISE equal
to the plain version beside them (tolerance zero: both run the same
compares, selects, maxes and adds in the same order) at the reference
tests' shapes and at the engine's.  The two attention kernels sum in
another order than their plain versions, so they are held to the
reference kernel tests' tolerances: 2e-5 in float32, 2e-2 in bfloat16,
at those tests' shapes, at gemma2-9b's head shapes and through the model's
``[B, S, H, D]`` strides; K3 with a query offset (a rank's block of a
sequence-sharded query) and K4's log-sum-exp (two halves of a cache
merged by it against the whole) likewise.  The expert matmul is held to
its plain version within the reference's ``tol * d`` in float32 (both
sum in float32) and within one bfloat16 rounding in bfloat16 (both
round once), at the
reference tests' shapes, the decode's few rows per expert and the
prefill's; the SSD scan within the reference's 2e-4, at its tests' cases,
a sequence that ends inside a tile and zamba2's head shapes.  The plain
versions are held to the JAX reference on the CPU by
tests/test_torch_kernels.py, tests/test_torch_attention.py,
tests/test_torch_moe.py and tests/test_torch_mamba2.py.  Every test here is marked ``cuda`` and
skips where there is no card; on a GPU machine run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_plain, gqa_decode)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_plain, mha)
from repro_torch.kernels.moe_gmm.ops import (  # noqa: E402
    expert_matmul_plain, gmm)
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_plain  # noqa: E402
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
# the lane plan's edges: one lane up to 16 workers, then 2, 4, 8, 16
BOOK_EDGE_W = [1, 15, 16, 17, 31, 32, 33, 100, 256]
# the register scan's edges (lanes and registers per lane change at
# powers of two up to 1,024 blocks, shared memory past that) and the
# launcher's limit, nb * W = 14,528
SCAN_EDGES = [(2, nb, 3) for nb in (1, 16, 31, 32, 33, 64, 700, 1024, 1025)
              ] + [(1, 14528, 1), (1, 968, 15)]


def make_stream(seed, T, N, W, util=0.8, dead_tail=0):
    rng = np.random.default_rng(seed)
    ready = np.sort(rng.uniform(0, N * 100 / (W * util), (T, N)),
                    axis=1).astype(np.float32)
    if dead_tail:
        ready[:, N - dead_tail:] = np.inf
    service = rng.exponential(100.0, (T, N)).astype(np.float32)
    wf0 = rng.uniform(0, 300.0, (T, W)).astype(np.float32)
    return ready, service, wf0


def make_tape(seed, T, nb, W, diag_free=True, p_ninf=0.25, exact=True):
    rng = np.random.default_rng(seed)
    if diag_free and not exact:
        diag = rng.normal(0.0, 10.0, (T, nb, W)).astype(np.float32)
    elif diag_free:
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


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 64, 4096])
@pytest.mark.parametrize("W", BOOK_EDGE_W)
def test_book_kernel_lane_plan_edges_on_card(cuda, W, block):
    """T = 33 (a warp and one more trial), a dead tail, and N = 200 + W %
    4: rows that are 16-byte aligned (vector loads) and rows that are not,
    a last pass short of a whole group."""
    args = booking_stream_from_numpy(*make_stream(
        W, 33, 200 + W % 4, W, dead_tail=7), cuda)
    got = book_stream(*args, block=block)
    for g, p in zip(got, book_stream_plain(*args)):
        _eq(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 5, 8, 9])
def test_book_kernel_short_streams_on_card(cuda, N):
    """Streams shorter than a group of events, one group, one past it."""
    args = booking_stream_from_numpy(*make_stream(1, 3, N, 15), cuda)
    for g, p in zip(book_stream(*args), book_stream_plain(*args)):
        _eq(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("tape", ["integer", "d = 0", "inexact"])
@pytest.mark.parametrize("T,nb,W", SCAN_EDGES)
def test_scan_kernel_edges_on_card(cuda, T, nb, W, tape):
    """Bitwise also on inexact tapes (d drawn from a normal): the kernel
    runs the plain version's doubling sweeps in the same association."""
    diag, off, wf0 = (torch.as_tensor(x, device=cuda) for x in make_tape(
        nb, T, nb, W, diag_free=tape != "d = 0", exact=tape != "inexact"))
    got = maxplus_entries(diag, off, wf0)
    for g, p in zip(got, maxplus_entries_plain(diag, off, wf0)):
        _eq(g, p)


@pytest.mark.cuda
def test_scheduling_kernels_are_bitwise_repeatable(cuda):
    """Two launches of each on the same inputs, at the main path's
    shapes."""
    args = booking_stream_from_numpy(*make_stream(2, 32, 4096, 15), cuda)
    for a, b in zip(book_stream(*args), book_stream(*args)):
        _eq(a, b)
    tape = [torch.as_tensor(x, device=cuda)
            for x in make_tape(3, 32, 16, 15, exact=False)]
    for a, b in zip(maxplus_entries(*tape), maxplus_entries(*tape)):
        _eq(a, b)


# b, hq, hkv, sq, sk, d, causal, window, cap: the reference kernel tests'
# cases, the head dims the kernel takes, ragged tiles, gemma2-9b's,
# qwen2-vl-2b's and seamless-m4t-medium's heads
FLASH_CASES = [
    (1, 1, 1, 128, 128, 64, True, 0, 0.0),
    (2, 4, 2, 256, 256, 64, True, 0, 0.0),
    (1, 8, 1, 128, 128, 128, True, 0, 0.0),
    (1, 2, 2, 256, 256, 64, True, 128, 0.0),
    (1, 2, 1, 256, 256, 64, True, 0, 50.0),
    (1, 2, 2, 192, 192, 64, True, 0, 0.0),
    (2, 2, 2, 128, 128, 64, False, 0, 0.0),
    (1, 4, 2, 100, 300, 32, True, 70, 30.0),
    (2, 4, 4, 77, 77, 96, True, 0, 0.0),
    (1, 16, 8, 320, 320, 256, True, 128, 50.0),
    (1, 16, 8, 200, 200, 256, True, 0, 50.0),
    # qwen2-vl-2b's heads (a group of 6 at D=128)
    (1, 12, 2, 256, 256, 128, True, 0, 0.0),
    (2, 12, 2, 200, 200, 128, True, 0, 0.0),
    # seamless-m4t-medium's cross attention: non-causal, Sq != Sk
    (1, 16, 16, 100, 300, 64, False, 0, 0.0),
    (2, 16, 16, 256, 77, 64, False, 0, 0.0),
    # D=256: gemma-2b's group of 8 (one kv head); non-causal with Sq != Sk;
    # a ragged Sq under Sk, the window's edge inside a key tile, a cap
    (2, 8, 1, 300, 300, 256, True, 0, 0.0),
    (1, 16, 8, 100, 300, 256, False, 0, 0.0),
    (2, 8, 1, 256, 77, 256, False, 0, 0.0),
    (1, 16, 8, 100, 333, 256, True, 97, 50.0),
]
# b, hq, hkv, c, d, valid, cap: the reference's cases, a ring, gemma2-9b's,
# qwen2-vl-2b's and seamless-m4t-medium's
DECODE_CASES = [
    (1, 1, 1, 256, 64, None, 0.0),
    (2, 8, 2, 512, 64, None, 0.0),
    (1, 16, 1, 256, 128, None, 0.0),
    (2, 4, 4, 512, 64, 300, 0.0),
    (1, 8, 8, 256, 64, None, 50.0),
    (2, 16, 8, 4648, 256, 4620, 50.0),
    (2, 16, 8, 4096, 256, "ring", 50.0),
    (3, 6, 2, 1000, 96, "ring", 0.0),
    (1, 8, 8, 37, 32, None, 0.0),
    # qwen2-vl-2b's decode (a group of 6 at D=128); seamless-m4t-medium's
    # cross cache (every slot valid)
    (2, 12, 2, 4128, 128, 4100, 0.0),
    (2, 16, 16, 777, 64, None, 0.0),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, b, hq, hkv, sq, sk, d,
                                            causal, window, cap, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=cuda).to(dtype)
    n0 = mha.launches
    got = mha(q, k, v, causal=causal, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert mha.launches == n0 + 1
    _close(got, attention_plain(q, k, v, causal=causal, window=window,
                                logit_cap=cap), dtype)


# sq, sk, window, cap: ragged 128-row q-tiles, Sk > Sq (the queries sit
# at the end), windows whose edge falls inside a key tile (of 32 and of
# 64 keys, D=256's tiles), a cap
EDGE_CASES = [(100, 300, 70, 30.0), (200, 200, 0, 50.0), (320, 450, 200, 0.0),
              (200, 333, 97, 0.0), (130, 390, 161, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,window,cap", EDGE_CASES)
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_kernel_tile_edges_on_card(cuda, d, sq, sk, window, cap):
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((2, 4, sq, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 2, sk, d), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 2, sk, d), generator=g, device=cuda).bfloat16()
    n0 = mha.launches
    got = mha(q, k, v, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert mha.launches == n0 + 1
    _close(got, attention_plain(q, k, v, window=window, logit_cap=cap),
           torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 512])
def test_flash_kernel_granite_heads_on_card(cuda, s):
    """granite-moe-3b-a800m's heads (24 q / 8 kv of 64) through the model's
    [B, S, H, D] layout."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((2, s, 40, 64), generator=g,
                    device=cuda).to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in (x[:, :, :24], x[:, :, 24:32],
                                            x[:, :, 32:]))
    got = mha(q, k, v, scale=0.125)
    want = attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale=0.125)
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_flash_kernel_reads_the_model_layout(cuda):
    """q, k, v as ``transpose(1, 2)`` views of [B, S, H, D] tensors (the
    model's projections), as the prefill passes them."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s, hq, hkv, d = 2, 300, 16, 8, 256
    x = torch.randn((b, s, hq + 2 * hkv, d), generator=g,
                    device=cuda).to(torch.bfloat16)
    q, k, v = x[:, :, :hq], x[:, :, hq:hq + hkv], x[:, :, hq + hkv:]
    got = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              window=128, logit_cap=50.0, scale=224 ** -0.5)
    assert got.transpose(1, 2).is_contiguous()
    want = attention_plain(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), window=128,
                           logit_cap=50.0, scale=224 ** -0.5)
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 64, 80), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        mha(q, q, q)
    with pytest.raises(TypeError):
        h = q[..., :64].half()
        mha(h, h, h)


def _ring(idx, c, window):
    slots = np.arange(c)
    kv_pos = idx - ((idx - slots) % c)
    ok = (kv_pos >= 0) & (kv_pos > idx - window) & (kv_pos <= idx)
    return np.where(ok, kv_pos, -1).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,c,d,valid,cap", DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(cuda, b, hq, hkv, c, d, valid,
                                             cap, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, c, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, c, hkv, d), generator=g, device=cuda).to(dtype)
    pos = np.arange(c, dtype=np.int32)
    if valid == "ring":
        pos = _ring(c + 700, c, c - 300)
        assert (pos < 0).any()
    elif valid is not None:
        pos[valid:] = -1
    pos = torch.as_tensor(pos, device=cuda)
    n0 = gqa_decode.launches
    got = gqa_decode(q, k, v, pos, scale=0.07, logit_cap=cap)
    torch.cuda.synchronize()
    assert gqa_decode.launches == n0 + 1
    _close(got, decode_attention_plain(q, k, v, pos, scale=0.07,
                                       logit_cap=cap), dtype)


# b, hq, hkv, sq, sk, d, window, cap, q_offset: a rank's block of a
# sequence-sharded query (its keys whole) at gemma2-9b's heads (window,
# cap), granite's (D=64, 3 q heads a kv head) and a ragged block; the
# default offset's place (Sk - Sq) given explicitly
FLASH_OFFSET_CASES = [
    (1, 16, 8, 128, 512, 256, 128, 50.0, 384),
    (2, 16, 8, 96, 384, 256, 0, 50.0, 96),
    (2, 24, 8, 128, 512, 64, 0, 0.0, 256),
    (1, 24, 8, 100, 400, 64, 70, 0.0, 300),
    (1, 4, 2, 77, 300, 128, 0, 0.0, 0),
    (1, 2, 1, 128, 256, 64, 0, 30.0, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,cap,off",
                         FLASH_OFFSET_CASES)
def test_flash_kernel_query_offset_on_card(cuda, b, hq, hkv, sq, sk, d,
                                           window, cap, off, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, logit_cap=cap, q_offset=off)
    n0 = mha.launches
    got = mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert mha.launches == n0 + 1
    _close(got, attention_plain(q, k, v, **kw), dtype)


# b, hq, hkv, c, d, valid, cap: each row's log-sum-exp beside the output,
# at gemma2-9b's, granite's and qwen2-vl-2b's heads, a ring with holes
DECODE_LSE_CASES = [
    (2, 16, 8, 4648, 256, 4620, 50.0),
    (2, 24, 8, 4136, 64, None, 0.0),
    (2, 12, 2, 1000, 128, "ring", 0.0),
    (1, 8, 8, 37, 32, None, 30.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,c,d,valid,cap", DECODE_LSE_CASES)
def test_decode_kernel_log_sum_exp_on_card(cuda, b, hq, hkv, c, d, valid,
                                           cap, dtype):
    """The output and each row's log-sum-exp against the plain version's;
    the two halves of the cache merged by their log-sum-exp against the
    whole (a slot-sharded cache's ranks)."""
    from repro_torch.kernels.decode_attention.ops import merge_parts
    q, k, v = _decode_inputs(cuda, 21, b, hq, hkv, c, d, dtype)
    pos = np.arange(c, dtype=np.int32)
    if valid == "ring":
        pos = _ring(c + 700, c, c - 300)
    elif valid is not None:
        pos[valid:] = -1
    pos = torch.as_tensor(pos, device=cuda)
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    n0 = gqa_decode.launches
    out, lse = gqa_decode(q, k, v, pos, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert gqa_decode.launches == n0 + 1
    want, want_lse = decode_attention_plain(q, k, v, pos, return_lse=True,
                                            **kw)
    _close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    h = c // 2
    parts = [gqa_decode(q, k[:, a:z], v[:, a:z], pos[a:z], return_lse=True,
                        **kw) for a, z in ((0, h), (h, c))]
    merged = merge_parts(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
    _close(merged, want, dtype)


def _decode_inputs(dev, seed, b, hq, hkv, c, d, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, c, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, c, hkv, d), generator=g, device=dev).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 3, 16])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_decode_kernel_every_head_dim_and_group(cuda, d, rep, dtype):
    """Each head dim and group width, with a cache that is not a whole
    number of tiles or of the cluster's parts, a logit cap and holes."""
    q, k, v = _decode_inputs(cuda, 11, 2, 2 * rep, 2, 777, d, dtype)
    pos = np.arange(777, dtype=np.int32)
    pos[::5] = -1
    pos = torch.as_tensor(pos, device=cuda)
    got = gqa_decode(q, k, v, pos, scale=d ** -0.5, logit_cap=30.0)
    _close(got, decode_attention_plain(q, k, v, pos, scale=d ** -0.5,
                                       logit_cap=30.0), dtype)


# c: below one tile, one slot past a tile, ragged over the cluster
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 20, 65, 1000, 2051])
def test_decode_kernel_cache_lengths(cuda, c, dtype):
    q, k, v = _decode_inputs(cuda, 12, 1, 8, 4, c, 64, dtype)
    pos = torch.arange(c, dtype=torch.int32, device=cuda)
    got = gqa_decode(q, k, v, pos, scale=0.125)
    _close(got, decode_attention_plain(q, k, v, pos, scale=0.125), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", ["first half", "all but one", "all"])
def test_decode_kernel_masked_parts_of_the_cluster(cuda, masked):
    """Blocks of the cluster whose whole part of the cache is masked: they
    must drop out of the merge (and with every slot masked, the softmax is
    uniform over the cache, as in the plain version)."""
    c = 4096
    q, k, v = _decode_inputs(cuda, 13, 2, 16, 8, c, 256, torch.bfloat16)
    pos = np.arange(c, dtype=np.int32)
    if masked == "first half":
        pos[: c // 2] = -1
    elif masked == "all but one":
        pos[:] = -1
        pos[c - 3] = 7
    else:
        pos[:] = -1
    pos = torch.as_tensor(pos, device=cuda)
    got = gqa_decode(q, k, v, pos, scale=0.0625, logit_cap=50.0)
    _close(got, decode_attention_plain(q, k, v, pos, scale=0.0625,
                                       logit_cap=50.0), torch.bfloat16)


@pytest.mark.cuda
def test_decode_kernel_is_bitwise_repeatable(cuda):
    """Two launches at gemma2-9b's decode shape give the same bits: the
    cluster's parts meet in rank order (no atomics)."""
    q, k, v = _decode_inputs(cuda, 14, 2, 16, 8, 4648, 256, torch.bfloat16)
    pos = torch.as_tensor(_ring(4640, 4648, 0), device=cuda)
    first = gqa_decode(q, k, v, pos, scale=0.0625, logit_cap=50.0)
    second = gqa_decode(q, k, v, pos, scale=0.0625, logit_cap=50.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# e, c, d, f: the reference's cases, decode's rows (C <= 8), ragged tiles,
# granite-moe-3b-a800m's experts at decode and prefill
GMM_CASES = [
    (4, 128, 64, 128), (8, 64, 128, 64), (2, 256, 256, 128),
    (40, 4, 1536, 512), (40, 4, 512, 1536), (3, 1, 64, 24), (5, 8, 40, 16),
    (3, 9, 72, 136), (2, 77, 200, 264), (40, 2048, 1536, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_CASES)
def test_gmm_kernel_matches_plain_on_card(cuda, e, c, d, f, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    buf = torch.randn((e, c, d), generator=g, device=cuda).to(dtype)
    w = torch.randn((e, d, f), generator=g, device=cuda).to(dtype)
    n0 = gmm.launches
    got = gmm(buf, w)
    torch.cuda.synchronize()
    assert gmm.launches == n0 + 1 and got.dtype == dtype
    want = expert_matmul_plain(buf, w)
    if dtype == torch.float32:       # tests/test_kernels_gmm.py's tol * d
        torch.testing.assert_close(got, want, atol=1e-5 * d, rtol=1e-5)
    else:                            # one rounding of the float32 sum
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=1.6e-2)


# e, c, d, f: decode's rows (C <= 8) with D split over a cluster of
# blocks in parts of unequal length (D = 1304: 6 blocks of 218 rows, the
# last 214; D = 520: 174, 174, 172)
SPLIT_CASES = [(6, 4, 1304, 72), (3, 7, 520, 136), (2, 1, 1304, 8),
               (4, 8, 2056, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", SPLIT_CASES)
def test_gmm_decode_split_on_card(cuda, e, c, d, f):
    g = torch.Generator(device=cuda).manual_seed(8)
    buf = torch.randn((e, c, d), generator=g, device=cuda).bfloat16()
    w = torch.randn((e, d, f), generator=g, device=cuda).bfloat16()
    got = gmm(buf, w)
    torch.testing.assert_close(got.float(), expert_matmul_plain(buf, w)
                               .float(), atol=1e-2, rtol=1.6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 2048])
def test_gmm_kernel_is_bitwise_repeatable(cuda, c):
    """Two launches on the same inputs give the same bits: the partial sums
    meet in a fixed order (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    buf = torch.randn((40, c, 1536), generator=g, device=cuda).bfloat16()
    w = (torch.randn((40, 1536, 512), generator=g, device=cuda)
         * 0.02).bfloat16()
    first = gmm(buf, w)
    second = gmm(buf, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_gmm_kernel_refuses_what_it_does_not_take(cuda):
    buf = torch.zeros((2, 4, 12), device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm(buf, torch.zeros((2, 12, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        gmm(torch.zeros((2, 8, 4), device=cuda).transpose(1, 2),
            torch.zeros((2, 8, 8), device=cuda))


# b, s, h, p, g, n, chunk: the reference's cases, a sequence ending inside
# a tile, two groups at larger dims, zamba2-1.2b's and mamba2-1.3b's heads,
# zamba2's heads in groups of 2, P = N = 128, and P and N that fill only
# part of their second 64
SSD_CASES = [
    (1, 64, 2, 16, 1, 16, 32), (2, 128, 4, 32, 1, 32, 64),
    (1, 128, 4, 16, 2, 16, 32), (1, 256, 2, 64, 1, 64, 128),
    (2, 96, 3, 32, 1, 48, 32), (1, 320, 8, 64, 2, 128, 64),
    (2, 4096, 64, 64, 1, 64, 256), (1, 512, 4, 64, 1, 128, 256),
    (2, 1024, 8, 64, 4, 64, 256), (1, 512, 4, 128, 2, 128, 256),
    (1, 300, 2, 96, 1, 80, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((h,), generator=gen, device=cuda) * 0.3)
    B = torch.randn((b, s, g, n), generator=gen, device=cuda) * 0.5
    C = torch.randn((b, s, g, n), generator=gen, device=cuda) * 0.5
    n0 = ssd.launches
    y, st = ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == n0 + 1
    yr, str_ = ssd_plain(x, dt, A, B, C, chunk=chunk)
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, str_, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_ssd_kernel_carries_the_state_across_tiles(cuda):
    """Slow decay (small dt): the first tile's input still moves the last
    tile's output, in the kernel as in the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, s, h, p, n = 1, 256, 2, 16, 16
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.full((b, s, h), 0.01, device=cuda)
    A = -torch.ones((h,), device=cuda)
    B = torch.randn((b, s, 1, n), generator=gen, device=cuda)
    C = torch.randn((b, s, 1, n), generator=gen, device=cuda)
    y1, _ = ssd(x, dt, A, B, C, chunk=64)
    x2 = x.clone()
    x2[:, :64] = 0
    y2, _ = ssd(x2, dt, A, B, C, chunk=64)
    assert not torch.allclose(y1[:, 192:], y2[:, 192:])
    torch.testing.assert_close(y2, ssd_plain(x2, dt, A, B, C, chunk=64)[0],
                               atol=2e-4, rtol=2e-4)


# b, s, h, p, g, n, chunk: shorter than one of the kernel's chunks, many
# chunks, a last chunk cut short, groups of 4 heads, 79 chunks (the carry
# walks them eight at a time)
SSD_CHUNK_CASES = [
    (2, 100, 4, 64, 1, 64, 256), (1, 8192, 2, 16, 1, 16, 256),
    (1, 1344, 3, 32, 1, 48, 64), (2, 768, 8, 32, 2, 32, 256),
    (1, 1024, 8, 64, 2, 128, 256), (1, 20224, 2, 64, 1, 64, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CHUNK_CASES)
def test_ssd_kernel_chunk_cuts(cuda, b, s, h, p, g, n, chunk):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((h,), generator=gen, device=cuda) * 0.3)
    B = torch.randn((b, s, g, n), generator=gen, device=cuda) * 0.5
    C = torch.randn((b, s, g, n), generator=gen, device=cuda) * 0.5
    y, st = ssd(x, dt, A, B, C, chunk=chunk)
    yr, str_ = ssd_plain(x, dt, A, B, C, chunk=chunk)
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, str_, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [(32, 32), (64, 64)])
def test_ssd_kernel_carries_the_state_across_chunks(cuda, p, n):
    """Slow decay over four of the kernel's chunks: the first chunk's input
    moves the last chunk's output and the final state, through the
    recurrence over the chunks' states, as in the plain version (P and N
    filling half of one 64 and all of it)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, s, h = 2, 1024, 4
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.full((b, s, h), 0.002, device=cuda)
    A = -torch.ones((h,), device=cuda)
    B = torch.randn((b, s, 1, n), generator=gen, device=cuda)
    C = torch.randn((b, s, 1, n), generator=gen, device=cuda)
    x2 = x.clone()
    x2[:, :256] = 0
    for xi in (x, x2):
        y, st = ssd(xi, dt, A, B, C, chunk=256)
        yr, str_ = ssd_plain(xi, dt, A, B, C, chunk=256)
        torch.testing.assert_close(y, yr, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(st, str_, atol=2e-4, rtol=2e-4)
    y1, st1 = ssd(x, dt, A, B, C, chunk=256)
    y2, st2 = ssd(x2, dt, A, B, C, chunk=256)
    assert not torch.allclose(y1[:, 768:], y2[:, 768:])
    assert not torch.allclose(st1, st2)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 64, 2, 24), device=cuda)
    dt = torch.zeros((1, 64, 2), device=cuda)
    A = torch.zeros((2,), device=cuda)
    B = torch.zeros((1, 64, 1, 16), device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd(x, dt, A, B, B, chunk=64)
    with pytest.raises(TypeError, match="float32"):
        ssd(x[..., :16].double(), dt.double(), A.double(), B.double(),
            B.double(), chunk=64)


# -- the training Functions: the kernels forward, the port's backward ------

def _grads_close(got, want, rel):
    """Each gradient within rel x its max |grad| (atol) + rel (rtol)."""
    for g, w in zip(got, want):
        w = w.float()
        torch.testing.assert_close(g.float(), w, rtol=rel,
                                   atol=rel * float(w.abs().max()))


# b, hq, hkv, sq, sk, d, causal, window, cap: gemma-2b's heads (MQA of
# 256), a window with a cap, and a non-causal cross attention (Sq != Sk)
FLASH_GRAD_CASES = [(2, 8, 1, 512, 512, 256, True, 0, 0.0),
                    (1, 4, 2, 384, 384, 64, True, 128, 50.0),
                    (2, 4, 4, 200, 640, 64, False, 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap",
                         FLASH_GRAD_CASES)
def test_flash_function_grads_on_card(cuda, b, hq, hkv, sq, sk, d, causal,
                                      window, cap, dtype):
    """The kernel forward and ``attention_vjp`` backward against float32
    autograd through ``attention_plain``; one launch, in the forward."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda)
    k = torch.randn((b, hkv, sk, d), generator=g, device=cuda)
    v = torch.randn((b, hkv, sk, d), generator=g, device=cuda)
    dout = torch.randn((b, hq, sq, d), generator=g, device=cuda)
    opts = dict(causal=causal, window=window, logit_cap=cap)
    ins = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    n0 = mha.launches
    out = mha(*ins, **opts)
    got = torch.autograd.grad(out, ins, dout.to(dtype))
    torch.cuda.synchronize()
    assert mha.launches == n0 + 1
    ref_in = [t.detach().float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(attention_plain(*ref_in, **opts), ref_in,
                               dout.to(dtype).float())
    _grads_close(got, want, 2e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(4, 128, 64, 128), (40, 1024, 1536,
                                                         512),
                                     (8, 12, 64, 40)])
def test_gmm_function_grads_on_card(cuda, e, c, d, f, dtype):
    """Forward and both products of the backward through the kernel:
    three launches, against float32 autograd through the plain version
    (C = 12 is padded to 16 where it is the contraction)."""
    g = torch.Generator(device=cuda).manual_seed(22)
    buf = torch.randn((e, c, d), generator=g, device=cuda).to(dtype)
    w = (torch.randn((e, d, f), generator=g, device=cuda) * 0.05).to(dtype)
    dout = torch.randn((e, c, f), generator=g, device=cuda).to(dtype)
    ins = [buf.requires_grad_(True), w.requires_grad_(True)]
    n0 = gmm.launches
    got = torch.autograd.grad(gmm(*ins), ins, dout)
    torch.cuda.synchronize()
    assert gmm.launches == n0 + 3
    ref_in = [t.detach().float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(expert_matmul_plain(*ref_in), ref_in,
                               dout.float())
    _grads_close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 512, 4, 64, 1, 64, 256),
                                               (2, 256, 8, 32, 2, 32, 64),
                                               (2, 2048, 64, 64, 1, 64,
                                                256)])
def test_ssd_function_grads_on_card(cuda, b, s, h, p, g, n, chunk):
    """The kernel forward and ``ssd_vjp`` backward (cotangents for y and
    the final state) against autograd through ``ssd_plain``."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=cuda)) * 0.1
    A = -torch.exp(torch.randn((h,), generator=gen, device=cuda) * 0.3)
    B = torch.randn((b, s, g, n), generator=gen, device=cuda) * 0.5
    C = torch.randn((b, s, g, n), generator=gen, device=cuda) * 0.5
    dy = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dst = torch.randn((b, h, p, n), generator=gen, device=cuda)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    n0 = ssd.launches
    got = torch.autograd.grad(ssd(*ins, chunk=chunk), ins, (dy, dst))
    torch.cuda.synchronize()
    assert ssd.launches == n0 + 1
    ref_in = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    want = torch.autograd.grad(ssd_plain(*ref_in, chunk=chunk), ref_in,
                               (dy, dst))
    _grads_close(got, want, 1e-3)
