"""Time the port's kernels at the shapes their paths give them.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels \
        [--reps 20] [--only queue_booking,maxplus_scan] \
        [--ssd-lengths 4096,32768] [--out bench_kernels.json]

``book_stream`` (K1) at the stock engine's stream (T=32 trials, N=21,316
events, W=15 workers) and ``maxplus_entries`` (K2) at the raptor
log-depth route's tape (T=32, nb=16, W=15), each on the one input the
engine has just written, beside the launch floor: an empty kernel
launched as K2 is, timed the same way (the ops module's ``noop_launch``;
``null`` for a checkout without it); and K1 under other lane plans than
the wrapper's (``K1_PLANS``), each with its SASS counts.
``gqa_decode`` (K4) at the decode shapes of the five served models, bf16,
B=2: gemma2-9b (16 q / 8 kv heads of 256; a global layer's cache of
4,648 slots and a local layer's ring of 4,096, logit cap 50, and both at
cap 0 beside ``scaled_dot_product_attention`` with the slot mask),
granite-moe-3b-a800m (24 / 8 heads of 64, 4,136 slots), zamba2-1.2b's
shared block (32 / 32 heads of 64, 4,136 slots), qwen2-vl-2b (12 / 2
heads of 128, 4,136 slots) and seamless-m4t-medium's cross attention (16
/ 16 heads of 64 over the encoder's 4,096 frames, every slot valid),
each beside SDPA; and
``ssd`` (K6) at zamba2-1.2b's prefill (B=2, 64 heads, P=N=64, float32)
at each of ``--ssd-lengths`` (S=4,096 is the served prompt; longer ones
show how the time grows with the number of chunks); and ``mha`` (K3) at
``FLASH_SHAPES``, bf16, B=2: gemma2-9b's prefill (16 / 8 heads of 256,
S=4,608, cap 50, window 4,096 and 0, and cap 0 beside SDPA), gemma-2b's
training forward (8 / 1 heads of 256, S=2,048) and the other served
prefills, each held to the plain version within the bf16 bar, with
ptxas' report of each bf16 K3 kernel.  Every timing cycles
through enough distinct inputs that they outgrow the card's 50 MB L2,
since a layer finds its cache and its activations cold.  Each call is
timed twice: as a CUDA graph of the loop replayed between CUDA events
(``ms``: the device's time, without the host's work per launch) and as
the loop itself between events (``loop_ms``: where the host takes longer
to launch a call than the device to run it, that is the host's pace).
Each row carries its bound, the larger of two times: the bytes it must
move (inputs once, output once) at 3.35 TB/s, and the operations: for K6
the plain recurrence's (5 P N per step and head) at the rate of the
units that run them, the tensor cores' TF32 rate over three (3xTF32);
for K1 and K2 their compares, selects, maxes and adds at float32's
67 TFLOP/s.

The script uses only the kernels' public wrappers, so it also times an
older checkout of the package: put that checkout's ``src`` on
``PYTHONPATH`` and run this file by its path.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
TF32_OPS_PER_S = 495e12      # H100 SXM, dense TF32 tensor cores
FP32_OPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
L2_BYTES = 50e6
PROMPT, DECODE_STEPS = 4608, 32
PROMPT2 = 4096               # granite's and zamba2's prompts
# the scheduler's main path: 32 trials of fig6's stream (10,658 jobs of 2
# tasks) on the HA deployment's 15 workers; its log-depth route's 16 blocks
SCHED_TRIALS, SCHED_EVENTS, SCHED_WORKERS, SCHED_BLOCKS = 32, 21316, 15, 16
BATCH = 50                   # short kernels' calls captured in one graph
# (name, Hq, Hkv, D, cache slots, window of the ring or 0, logit cap,
# prompt): the caches of the served runs, late in their decode
DECODE_SHAPES = [
    ("gemma2-9b global", 16, 8, 256, PROMPT + DECODE_STEPS + 8, 0, 50.0,
     PROMPT),
    ("gemma2-9b local", 16, 8, 256, 4096, 4096, 50.0, PROMPT),
    ("granite-moe-3b-a800m", 24, 8, 64, PROMPT2 + DECODE_STEPS + 8, 0, 0.0,
     PROMPT2),
    ("zamba2-1.2b shared", 32, 32, 64, PROMPT2 + DECODE_STEPS + 8, 0, 0.0,
     PROMPT2),
    ("qwen2-vl-2b", 12, 2, 128, PROMPT2 + DECODE_STEPS + 8, 0, 0.0,
     PROMPT2),
    # the cross attention's cache: the encoder's PROMPT2 frames, all valid
    ("seamless-m4t-medium cross", 16, 16, 64, PROMPT2, 0, 0.0, PROMPT2),
]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def loop_ms(fn, sets, reps: int, warmup: bool = True) -> float:
    """Mean time (ms) between the launches of ``fn(*s)`` over ``reps``
    passes through ``sets``, after one pass to warm up unless ``warmup``
    is false (CUDA events over the loop: where the host takes longer to
    launch a call than the device to run it, this is the host's pace)."""
    if warmup:
        for s in sets:
            fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for s in sets:
            fn(*s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


def graph_ms(fn, sets, reps: int) -> float:
    """The device's time per call of ``fn(*s)``: one pass through ``sets``
    captured as a CUDA graph and replayed ``reps`` times between two CUDA
    events, so that the host's work per launch is not in it."""
    for s in sets:
        fn(*s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up off the default stream
        for s in sets:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for s in sets:
            fn(*s)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * len(sets))


def booking_stream(T, N, W, util, dead_tail, seed, dev):
    """Ready-sorted booking streams like the stock engine's: Poisson-ish
    ready times at utilisation ``util``, exponential service."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ready = np.sort(rng.uniform(0, N * 100 / (W * util), (T, N)),
                    axis=1).astype(np.float32)
    if dead_tail:
        ready[:, N - dead_tail:] = np.inf
    service = rng.exponential(100.0, (T, N)).astype(np.float32)
    wf0 = rng.uniform(0, 300.0, (T, W)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (ready, service,
                                                         wf0))


def operator_tape(T, nb, W, diag_free, seed, dev):
    """Integer-valued operator tapes (exact composes); ``diag_free=False``
    is the engines' d = 0 shape."""
    import numpy as np
    rng = np.random.default_rng(seed)
    diag = (rng.integers(-20, 20, (T, nb, W)) if diag_free
            else np.zeros((T, nb, W))).astype(np.float32)
    off = rng.integers(0, 1000, (T, nb, W)).astype(np.float32)
    off = np.where(rng.uniform(size=off.shape) < 0.25, -np.inf,
                   off).astype(np.float32)
    wf0 = rng.integers(0, 500, (T, W)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (diag, off, wf0))


def booking_bound_ms(T, N, W) -> float:
    """K1's bound: 5 floats per event moved (ready, service in; fin, start,
    worker out) and the W-vector in and out, or its 3 W + 3 compares,
    selects and adds per event at float32's rate, whichever is longer."""
    nbytes = 4 * (T * N * 5 + T * W * 2)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     T * N * (3 * W + 3) / FP32_OPS_PER_S)


def scan_bound_ms(T, nb, W) -> float:
    """K2's bound: the tape (d, b) in and the entries out, wf0 in and the
    exit vector out, or its sweeps' adds and maxes at float32's rate."""
    nbytes = 4 * (3 * T * nb * W + 2 * T * W)
    ops = T * W * (3 * nb * math.ceil(math.log2(max(nb, 2))) + 2 * nb)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def launch_floor_ms(reps: int, batch: int = 1):
    """Device time per launch of an empty kernel launched as K2 is, by
    graph replay of ``batch`` launches (None where the package has no
    ``noop_launch``)."""
    try:
        from repro_torch.kernels.maxplus_scan.ops import noop_launch
    except ImportError:
        return None
    return graph_ms(noop_launch, [()] * batch, reps)


# K1 at W = 15 under other (lanes, slots) plans than booking_plan's one
# lane of 15: a trial's workers over more lanes, with shuffles on the chain
K1_PLANS = [(1, 16), (2, 8), (4, 4), (8, 2), (16, 1)]


def booking_plans(args, reps: int) -> list:
    """K1 on ``args`` under each of ``K1_PLANS`` through the library's
    launcher (bitwise against ``book_stream``), with the SASS counts of
    each instantiation's main loop; empty for a checkout without them."""
    try:
        from repro_torch.kernels import sass
        from repro_torch.kernels.queue_booking.ops import (
            _launcher, book_stream, events_per_pass)
    except ImportError:
        return []
    launch, _ = _launcher()
    ready, service, wf0 = args
    T, N = ready.shape
    W = wf0.shape[1]
    want = book_stream(*args)
    text = sass.disassemble("queue_booking")
    rows = []
    for lanes, slots in K1_PLANS:
        out = (torch.empty_like(ready), torch.empty_like(ready),
               torch.empty((T, N), dtype=torch.int32, device=ready.device),
               torch.empty_like(wf0))

        def call():
            err = launch(*(x.data_ptr() for x in args + out), T, N, W, 64,
                         lanes, slots, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"queue_booking launch failed: {err}")
        call()
        loop = sass.hottest_loop(sass.function(
            text, f"queue_booking_kernelILi{lanes}ELi{slots}ELb"
                  f"{int(N % 4 == 0)}E"))
        rows.append(dict(
            lanes=lanes, slots=slots, ms=graph_ms(call, [()], reps),
            bitwise=all(bool(torch.equal(a, b)) for a, b in zip(out, want)),
            dependent_per_event=sass.chain(loop) / events_per_pass(),
            alu_per_event=sass.alu_count(loop) / events_per_pass()))
    return rows


def bench_booking(reps: int, dev) -> dict:
    from repro_torch.kernels.queue_booking.ops import book_stream
    T, N, W = SCHED_TRIALS, SCHED_EVENTS, SCHED_WORKERS
    args = booking_stream(T, N, W, 0.75, 0, 1, dev)
    kern = lambda: book_stream(*args, block=64)  # noqa: E731
    return dict(shape="stock stream", T=T, N=N, W=W,
                ms=graph_ms(kern, [()], reps),
                loop_ms=loop_ms(kern, [()], max(2, reps // 4)),
                bound_ms=booking_bound_ms(T, N, W), bound_by="bytes",
                plans=booking_plans(args, reps))


def bench_scan(reps: int, dev) -> dict:
    """K2 timed two ways, each beside the launch floor timed the same way:
    ``ms``, ``BATCH`` calls captured in one graph, so that the device runs
    them back to back (its time per call, gaps between kernels included);
    ``graph1_ms``, one call per graph replay, where the replay's own cost
    on the host can exceed a short kernel's."""
    from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
    T, nb, W = SCHED_TRIALS, SCHED_BLOCKS, SCHED_WORKERS
    tape = operator_tape(T, nb, W, False, 3, dev)
    kern = lambda: maxplus_entries(*tape)  # noqa: E731
    ms = graph_ms(kern, [()] * BATCH, reps)
    floor = launch_floor_ms(reps, BATCH)
    return dict(shape="raptor log-depth tape", T=T, nb=nb, W=W, ms=ms,
                floor_ms=floor,
                over_floor=None if floor is None else ms / floor,
                graph1_ms=graph_ms(kern, [()], 10 * reps),
                floor1_ms=launch_floor_ms(10 * reps),
                loop_ms=loop_ms(kern, [()], 10 * reps),
                bound_ms=scan_bound_ms(T, nb, W), bound_by="bytes")


def copies(nbytes: int) -> int:
    """Distinct inputs of ``nbytes`` each that outgrow the L2 twice."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def decode_sets(hq, hkv, d, c, window, prompt, batch, seed, dev,
                count=None):
    """``count`` distinct (q, k, v, kv_pos), by default enough to outgrow
    the L2; the positions are the model's at a step late in the decode."""
    from repro_torch.models.transformer import decode_positions
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = decode_positions(prompt + DECODE_STEPS - 12, c, window, dev)
    nbytes = 2 * 2 * batch * c * hkv * d
    out = []
    for _ in range(count or copies(nbytes)):
        q = torch.randn((batch, hq, d), generator=gen, device=dev)
        k = torch.randn((batch, c, hkv, d), generator=gen, device=dev)
        v = torch.randn((batch, c, hkv, d), generator=gen, device=dev)
        out.append((q.bfloat16(), k.bfloat16(), v.bfloat16(), pos))
    return out, nbytes


def bench_decode(reps: int, dev, batch: int = 2) -> list:
    from repro_torch.kernels.decode_attention import ops as dops
    gqa_decode = dops.gqa_decode
    rows = []
    for name, hq, hkv, d, c, window, cap, prompt in DECODE_SHAPES:
        sets, nbytes = decode_sets(hq, hkv, d, c, window, prompt, batch, 5,
                                   dev)
        scale = d ** -0.5
        # the launch's shape: slots a tile, blocks a cluster, tiles a block
        tile, per_sm, max_cluster = dops._shape(1, d, hq // hkv)
        cluster, per = dops.plan(batch * hkv, c, tile,
                                 per_sm * dops._sm_count(dev), max_cluster)
        row = dict(shape=name, B=batch, Hq=hq, Hkv=hkv, D=d, C=c,
                   cap=cap, copies=len(sets), tile=tile, cluster=cluster,
                   tiles_per_block=per)
        kern = lambda q, k, v, p: gqa_decode(q, k, v, p, scale=scale,  # noqa
                                             logit_cap=cap)
        row["loop_ms"] = loop_ms(kern, sets, reps)
        row["ms"] = graph_ms(kern, sets, reps)
        row["cap0_ms"] = (row["ms"] if cap == 0.0 else
                          graph_ms(lambda q, k, v, p: gqa_decode(
                              q, k, v, p, scale=scale), sets, reps))
        # SDPA reads [B, H, C, D]: the same caches, transposed beforehand
        sdpa_sets = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous(),
                      (p >= 0)[None, None, None, :]) for q, k, v, p in sets]
        del sets
        sdpa = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa
            q, k, v, attn_mask=m, scale=scale, enable_gqa=True)
        row["sdpa_loop_ms"] = loop_ms(sdpa, sdpa_sets, reps)
        row["sdpa_ms"] = graph_ms(sdpa, sdpa_sets, reps)
        del sdpa_sets
        moved = nbytes + 2 * 2 * batch * hq * d + 4 * c
        row["bound_ms"] = 1e3 * moved / HBM_BYTES_PER_S
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def ssd_sets(batch, s, h, p, g, n, seed, dev, count):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(count):
        x = torch.randn((batch, s, h, p), generator=gen, device=dev)
        dt = F.softplus(torch.randn((batch, s, h), generator=gen,
                                    device=dev))
        A = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.3)
        B = torch.randn((batch, s, g, n), generator=gen, device=dev) * 0.5
        C = torch.randn((batch, s, g, n), generator=gen, device=dev) * 0.5
        out.append((x, dt, A, B, C))
    return out


def bench_ssd(reps: int, dev, batch: int = 2, s: int = 4096, h: int = 64,
              p: int = 64, n: int = 64, chunk: int = 256) -> dict:
    from repro_torch.kernels.ssd_scan.ops import ssd
    nbytes = 4 * (2 * batch * s * h * p + batch * s * h + 2 * batch * s * n)
    sets = ssd_sets(batch, s, h, p, 1, n, 6, dev, copies(nbytes))
    kern = lambda *a: ssd(*a, chunk=chunk)  # noqa: E731
    row = dict(shape=f"zamba2-1.2b heads, S={s}", B=batch, S=s, H=h, P=p,
               N=n, copies=len(sets), loop_ms=loop_ms(kern, sets, reps),
               ms=graph_ms(kern, sets, reps))
    del sets
    torch.cuda.empty_cache()
    ops_ms = 1e3 * 5 * p * n * batch * s * h / (TF32_OPS_PER_S / 3)
    bytes_ms = 1e3 * (nbytes + 4 * batch * h * p * n) / HBM_BYTES_PER_S
    row.update(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms > bytes_ms else "bytes")
    return row


# (label, config, Sq, Sk, causal, window, logit cap): K3 at the served
# prefill shapes and gemma-2b's training forward, B=2; heads, head_dim
# and scale from the config
FLASH_SHAPES = [
    ("gemma2-9b local", "gemma2-9b", PROMPT, PROMPT, True, 4096, 50.0),
    ("gemma2-9b global", "gemma2-9b", PROMPT, PROMPT, True, 0, 50.0),
    ("gemma2-9b cap 0", "gemma2-9b", PROMPT, PROMPT, True, 0, 0.0),
    ("gemma-2b training", "gemma-2b", 2048, 2048, True, 0, 0.0),
    ("granite-moe-3b-a800m", "granite-moe-3b-a800m", PROMPT2, PROMPT2, True,
     0, 0.0),
    ("qwen2-vl-2b", "qwen2-vl-2b", PROMPT2, PROMPT2, True, 0, 0.0),
    ("seamless-m4t-medium cross", "seamless-m4t-medium", 1024, PROMPT2,
     False, 0, 0.0),
]
BF16_OPS_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores
FLASH_BAR = (1e-3, 1.6e-2)   # bf16: |kernel - plain| <= a + r |plain|


def attended_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends: query i at key position
    i + Sk - Sq sees keys (i + Sk - Sq - window, i + Sk - Sq] (causal),
    every key otherwise."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(i + off, sk - 1) + 1
               - (max(0, i + off - window + 1) if window else 0)
               for i in range(sq))


def flash_ops_ms(batch, hq, d, sq, sk, causal, window=0) -> float:
    """K3's two products (q k^T and p v over the attended pairs) at the
    bf16 tensor-core rate, in ms."""
    return 1e3 * 4 * d * batch * hq * attended_pairs(sq, sk, causal,
                                                     window) / BF16_OPS_PER_S


def flash_bound(batch, hq, hkv, d, sq, sk, causal, window=0) -> tuple:
    """K3's bound in ms and what sets it: the larger of its operations
    (``flash_ops_ms``) and its bytes (q, k and v read, the output written
    once) at 3.35 TB/s."""
    ops_ms = flash_ops_ms(batch, hq, d, sq, sk, causal, window)
    bytes_ms = 1e3 * 2 * batch * d * (2 * sq * hq + 2 * sk * hkv) \
        / HBM_BYTES_PER_S
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def flash_ptxas(log: str) -> dict:
    """ptxas' report of each bf16 K3 kernel in a build log, by its
    template arguments (``flash_attention_wgmma_kernel<D, fused>``):
    registers, spill bytes and fault lines (``_build.ptxas_kernels``;
    empty for an older checkout without it)."""
    import re
    from repro_torch.kernels import _build
    parse = getattr(_build, "ptxas_kernels", lambda _: {})
    found = []
    for name, k in parse(log).items():
        m = re.search(r"flash_attention_wgmma_kernelILi(\d+)ELb([01])E", name)
        if m:
            found.append(((int(m.group(1)), m.group(2)), k))
    return {f"flash_attention_wgmma_kernel<{d}, "
            f"{'true' if fused == '1' else 'false'}>": k
            for (d, fused), k in sorted(found)}


def flash_sets(hq, hkv, d, sq, sk, seed, dev, batch: int = 2):
    """Enough distinct bf16 (q, k, v) to outgrow the L2, each a
    ``[B, H, S, D]`` view of the model's ``[B, S, H, D]`` layout, as the
    prefill hands them to the kernel."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(copies(2 * batch * d * (sq * hq + 2 * sk * hkv))):
        q = torch.randn((batch, sq, hq, d), generator=gen, device=dev)
        kv = torch.randn((batch, sk, 2 * hkv, d), generator=gen, device=dev)
        k, v = kv.bfloat16().split(hkv, dim=2)
        out.append((q.bfloat16().transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2)))
    return out


def bench_flash(reps: int, dev, batch: int = 2) -> dict:
    """K3 at ``FLASH_SHAPES``: its device time, held to the plain version
    within the bf16 bar; beside it SDPA where the shape has no cap or
    window, and the bound; and ptxas' report of the bf16 kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import attention_plain, mha
    from repro_torch.models.transformer import _attn_scale
    rows = []
    for label, arch, sq, sk, causal, window, cap in FLASH_SHAPES:
        cfg = get_config(arch)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        opts = dict(causal=causal, window=window, logit_cap=cap,
                    scale=_attn_scale(cfg))
        sets = flash_sets(hq, hkv, d, sq, sk, 11, dev, batch)
        kern = lambda q, k, v: mha(q, k, v, **opts)  # noqa: E731
        want = attention_plain(*sets[0], **opts).float()
        a, r = FLASH_BAR
        diff = (kern(*sets[0]).float() - want).abs()
        row = dict(shape=label, B=batch, Hq=hq, Hkv=hkv, D=d, Sq=sq, Sk=sk,
                   causal=causal, window=window, cap=cap, copies=len(sets),
                   max_abs_err=float(diff.max()),
                   bar_share=float((diff / (a + r * want.abs())).max()),
                   ms=graph_ms(kern, sets, reps))
        del want, diff
        if cap == 0.0 and window == 0:
            sdpa_sets = [tuple(x.contiguous() for x in s_) for s_ in sets]
            row["sdpa_ms"] = graph_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=opts["scale"],
                    enable_gqa=True), sdpa_sets, reps)
            del sdpa_sets
        del sets
        torch.cuda.empty_cache()
        row["bound_ms"], row["bound_by"] = flash_bound(
            batch, hq, hkv, d, sq, sk, causal, window)
        rows.append(row)
    return dict(ptxas=flash_ptxas(_build.build_log.get("flash_attention",
                                                        "")),
                rows=rows)


KERNELS = ("queue_booking", "maxplus_scan", "decode_attention", "ssd_scan",
           "flash_attention")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="comma-separated kernels to time, of "
                         + ", ".join(KERNELS))
    ap.add_argument("--ssd-lengths", default="4096",
                    help="comma-separated sequence lengths for K6")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = card()
    only = args.only.split(",")
    unknown = set(only) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    out = dict(label=args.label, card=name,
               **{k: [] for k in KERNELS})
    if "queue_booking" in only:
        out["queue_booking"] = [bench_booking(args.reps, dev)]
    if "maxplus_scan" in only:
        out["maxplus_scan"] = [bench_scan(args.reps, dev)]
    if "decode_attention" in only:
        out["decode_attention"] = bench_decode(args.reps, dev)
    if "ssd_scan" in only:
        out["ssd_scan"] = [bench_ssd(max(2, args.reps // 4), dev, s=int(s))
                           for s in args.ssd_lengths.split(",")]
    if "flash_attention" in only:
        out["flash_attention"] = bench_flash(max(2, args.reps // 4), dev)
    for r in out["queue_booking"]:
        print(f"queue_booking {r['shape']} (T={r['T']}, N={r['N']}, "
              f"W={r['W']}): graph {r['ms']:.5f} ms; event loop "
              f"{r['loop_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms "
              f"(bytes) [{name}]", flush=True)
        for p in r["plans"]:
            print(f"queue_booking plan {p['lanes']} lane(s) x {p['slots']} "
                  f"slots: graph {p['ms']:.5f} ms, bitwise {p['bitwise']}; "
                  f"SASS an event: {p['dependent_per_event']:.2f} "
                  f"dependent, {p['alu_per_event']:.2f} on the ALU pipe "
                  f"[{name}]", flush=True)
    for r in out["maxplus_scan"]:
        print(f"maxplus_scan {r['shape']} (T={r['T']}, nb={r['nb']}, "
              f"W={r['W']}): graph of {BATCH} {r['ms']:.5f} ms (launch "
              f"floor {r['floor_ms']}); graph of one {r['graph1_ms']:.5f} "
              f"ms (floor {r['floor1_ms']}); event loop "
              f"{r['loop_ms']:.5f} ms; bound {r['bound_ms']:.7f} ms "
              f"(bytes) [{name}]", flush=True)
    for row in out["decode_attention"]:
        print(f"decode_attention {row['shape']} (C={row['C']}, "
              f"{row['copies']} caches): graph {row['ms']:.5f} ms "
              f"(cap 0 {row['cap0_ms']:.5f}), SDPA graph "
              f"{row['sdpa_ms']:.5f} ms; event loop {row['loop_ms']:.5f} "
              f"ms, SDPA {row['sdpa_loop_ms']:.5f} ms; bound "
              f"{row['bound_ms']:.5f} ms (bytes) [{name}]", flush=True)
    for r in out["ssd_scan"]:
        print(f"ssd_scan {r['shape']} ({r['copies']} inputs): graph "
              f"{r['ms']:.5f} ms; event loop {r['loop_ms']:.5f} ms; bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}) [{name}]",
              flush=True)
    if out["flash_attention"]:
        fa = out["flash_attention"]
        for kname, k in sorted(fa["ptxas"].items()):
            print(f"flash_attention {kname}: {k['registers']} registers, "
                  f"{k['spill_stores']} / {k['spill_loads']} bytes spill "
                  f"stores / loads, {len(k['faults'])} fault line(s) "
                  + " | ".join(k["faults"]), flush=True)
        for r in fa["rows"]:
            print(f"flash_attention {r['shape']} ({r['Hq']}/{r['Hkv']} heads "
                  f"of {r['D']}, Sq={r['Sq']}, Sk={r['Sk']}, window "
                  f"{r['window']}, cap {r['cap']}): graph {r['ms']:.4f} ms, "
                  f"{r['bar_share']:.3f} of the bar"
                  + (f"; SDPA {r['sdpa_ms']:.4f} ms" if "sdpa_ms" in r
                     else "")
                  + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                  f"[{name}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
