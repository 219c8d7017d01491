#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths (``src/repro_torch``) once each at full width,
after building the six hand-written CUDA kernels from the sources in the
checkout.  The scheduler path: the paper's HA deployment (15 workers over
3 AZs), keygen at load ``high``, fig6's 1,800 s stream (10,658 jobs per
trial) and 32 trials.  The LM serving paths, each with random weights from
seed 0 in bf16 serving 3 batches of 2 prompts with 32 greedy decode steps
each, then one Raptor flight of 2: the dense path, gemma2-9b at full width
(42 layers, d_model 3584, 16 q / 8 kv heads of 256, vocab 256,000; prompts
of 4,608 tokens); the MoE path, granite-moe-3b-a800m at full width (32
layers, d_model 1536, 24 q / 8 kv heads of 64, 40 experts top-8 of ff 512,
vocab 49,155; prompts of 4,096); the hybrid path, zamba2-1.2b at full width
(38 Mamba2 layers, d_model 2048, 64 SSM heads of 64, state 64, and a shared
attention+MLP block of 32 heads of 64 and ff 8,192 after every 6th layer;
prompts of 4,096); the VLM path, qwen2-vl-2b at full width (28 layers,
d_model 1536, 12 q / 2 kv heads of 128, M-RoPE sections 16/24/24, vocab
151,936; prompts of 4,096 embeddings); the encoder-decoder path,
seamless-m4t-medium at full width (12 encoder and 12 decoder layers,
d_model 1024, 16 / 16 heads of 64, vocab 256,206; 4,096 decoder
embeddings over 4,096 encoder frames).  The training path: gemma-2b
trained at full width (18 layers, d_model 2048, 8 q / 1 kv heads of 256,
ff 16,384, vocab 256,000, tied; bf16 weights, float32 AdamW moments) on
the synthetic data of batches of 2 x 2,048 tokens, by ``launch/train.py``.
The sharded path (phase 22): gemma-2b's training steps, granite's serving
and zamba2's prefill with every parameter, moment, batch and cache leaf a
DTensor placed by the sharding Plan, the kernels on each rank's shards.

1. device: name and power limit (nvidia-smi), torch and CUDA versions;
2. build all six kernels (one nvcc per source, in parallel), timed, with
   ptxas' register counts, and any spills or serialised wgmmas by kernel;
   fails if a bf16 ``flash_attention`` kernel spills or has its wgmmas
   serialised (C75xx), and prints each one's registers;
3. ``queue_booking`` against its plain PyTorch version, bitwise, at the
   engine's stock shape, the reference tests' shapes and the edges of its
   lane plan, timed, beside its chain model read from the SASS of the
   built kernel (``cuobjdump``; ``repro_torch.kernels.sass``);
4. ``maxplus_scan`` against its plain version, bitwise, on integer tapes
   with d != 0 and with d = 0, timed (its device time and the pace of an
   event-timed loop of launches) beside the launch floor (an empty
   kernel, timed as the scan is) and ``torch.cummax``, a partial
   yardstick (the inclusive max of ``off`` alone);
5. engine: ``QueueFlightSim`` on cuda — stock through the kernel equals
   the scan substrate, raptor through the log-depth kernel route and the
   default route equal the sequential chain, all bitwise; both kernels'
   launch counts must rise; the ``run_pair`` summary;
6. service: ``SchedulerService`` on the kernel route under MMPP arrivals,
   with the streaming ``oracle_check`` bitwise;
7. ``flash_attention`` against its plain version at the prefill's shapes
   (bf16, B=2, 16 q / 8 kv heads, S=4608, D=256, cap 50; window 4096 and
   0) within the bf16 bar of ``TOL``, and on an f32 reference case within
   2e-5, timed beside ``F.scaled_dot_product_attention`` at cap 0; and at
   granite-moe-3b-a800m's, qwen2-vl-2b's and seamless-m4t-medium's cross
   prefill shapes and gemma-2b's training forward (B=2, 8 / 1 heads of
   256, S=2,048, causal, no cap), each beside SDPA;
8. ``decode_attention`` against its plain version at the decode's shapes
   (bf16, B=2, C=4648 and 4096, the model's ring positions and random
   holes; granite-moe-3b-a800m's, zamba2-1.2b's, qwen2-vl-2b's and
   seamless-m4t-medium's cross decode shapes) within
   the bf16 bar; timed with ``launch/bench_kernels.py`` where the model
   finds its caches cold (distinct caches that outgrow the L2, in turn):
   device time by CUDA-graph replay, at cap 50 and 0, at the five
   models' shapes (seamless-m4t-medium's cross cache among them), beside
   SDPA with a mask;
9. LM serve, gemma2-9b: ``ServingEngine.serve`` and one
   ``generate_flight`` (tokens equal to ``generate``'s) on the card, with
   exactly 42 flash_attention launches per prefill and 42 decode_attention
   launches per decode step; then the wiring at real shapes (prefill and 4
   teacher-forced decode steps): in bf16 every kernel call against its
   plain version on the model's own activations within the bf16 bar, and
   the logits no further (rms) from the plain attention's than bf16
   itself puts them from float32; with the same weights in float32,
   logits within 1e-3 x max |logit| of the plain attention's;
10. ``expert_matmul`` against its plain version at the MoE path's four
   shapes (E=40; prefill C=2048 and decode C=4; D x F = 1536 x 512 and
   512 x 1536), bf16 within the bar of ``TOL`` and float32 within the
   reference's 1e-5 x D, timed beside ``torch.bmm``;
11. ``ssd_scan`` against its plain version at the hybrid path's shape
   (B=2, S=4096, 64 heads, P=N=64, chunk 256), y and the final state
   within the reference's 2e-4 + 2e-4 x |plain|, timed cold as phase 8,
   at S=4096 and at a prompt 8 times as long;
12. LM serve, granite-moe-3b-a800m, as phase 9: exactly 96
   expert_matmul launches (3 per layer) and 32 attention launches per
   prefill and per decode step; the flight; the wiring run with every
   expert_matmul, flash_attention and decode_attention call held to its
   plain version on the model's activations, and with the weights in
   float32 the logits within 1e-3 x max |logit| of the plain versions;
13. LM serve, zamba2-1.2b, likewise: exactly 38 ssd_scan and 6
   flash_attention launches per prefill and 6 decode_attention launches
   per decode step; the flight; every ssd_scan call of the wiring run
   within 2e-4 of its plain version, every attention call within the
   bf16 bar; the float32 logits as phase 12's;
14. fault engine: ``QueueFlightSim`` in fault mode at phase 5's width
   (keygen @ high, 15 workers / 3 AZs, 32 trials) on the first 900 s of
   its stream (5,329 jobs: the whole stream, launch-bound on the host,
   took ~570 s of a 1,049 s smoke on an H100 machine) under one
   correlated brownout process (fault_sweep's: up 24 s, down 6 s, service
   x3), degraded errors (0.05) and worker crashes (every ~30 s, 200 ms
   outages), tables of 256 cycles (coverage checked against twice the
   replay's end), and a timeout / jittered retry / hedge policy: raptor
   through the ``maxplus_scan`` route (log-depth, 16 blocks) and stock
   through its default route at full width; raptor's ``maxplus_scan``
   route against the sequential chain, bitwise at full width, and
   stock's against its default route, bitwise on a 2,000-job stream of
   32 trials (stock's ``maxplus_scan`` route takes ~420 s at full width),
   with ``maxplus_scan``'s launches on each; the run-pair summary with
   fail rates and every wall;
15. fault service: ``SchedulerService`` on the ``maxplus_scan`` route
   under phase 6's MMPP traffic and phase 14's faults, with the streaming
   ``oracle_check`` (the stream's fault tables, runs and traces) bitwise;
16. open-loop engine: ``VectorFlightSim.run_pair`` at 40,000 trials —
   keygen within 0.06 of Table 7's 0.647, rho=0 exponential within 0.05
   of 2/3, ``reliability_vector(2, 0.3)`` and ``(4, 0.2)`` fail rates
   within 0.02 of the closed forms — and fault_sweep's i.i.d. and
   correlated open-loop rows beside ``mixture_speedup_prediction``;
17. the paper's experiments (``repro_torch.sim.experiments``):
   ``fig6_scale_effect()`` at its defaults (the closed-loop load grids of
   the 1-AZ/5-worker and HA deployments, 1,800 s streams of 2,131 and
   6,394 jobs, 32 trials, each grid one batch), paper-shaped (1-AZ medium
   ratio > 0.90, HA medium < 0.75); the HA grid again through
   ``queue_pair_plan`` with stock on ``queue_booking`` and raptor on the
   log-depth ``maxplus_scan`` route, every summary field bitwise equal to
   fig6's default-route numbers and to each load's solo ``run_pair``,
   both kernels launched; ``table7_keygen()`` on the scalar oracle (host)
   within rel 0.08 of fig6's HA medium means, and the oracle's 1-AZ
   medium point (the means of 16 seeds' 1,800 s streams) within rel 0.08
   of fig6's 1-AZ medium means; ``load_sweep_util()``,
   ``sweep_scale(trials=20000)`` (reliability within 0.02 of the exact
   form, Table 7 within 0.06 of 0.647), ``fig7_other_workloads()``,
   ``workflow_bank()`` (streaming ``oracle_check`` bitwise) and
   ``fault_sweep()`` (its closed-loop rows on the ``maxplus_scan``
   summary route) at their defaults, and ``fault_sweep()`` again on the
   default summary route, every row bitwise equal; every wall and each
   kernel's launches;
18. LM serve, qwen2-vl-2b, as phase 12 on ``demo_requests``' embedding
   prompts: exactly 28 flash_attention launches per prefill and 28
   decode_attention launches per decode step; the flight; the wiring run
   on M-RoPE ids with distinct streams (1,024 text positions, then a
   48 x 64 patch grid: Qwen2-VL's layout of an image after text), every
   kernel call within the bf16 bar of its plain version, the bf16 logits
   no further (rms) from plain attention's than bf16 from float32, the
   float32 logits within 1e-3 x max |logit|; flash_attention at its
   prefill shape (12 / 2 heads of 128, S=4,096) timed beside SDPA;
19. LM serve, seamless-m4t-medium, likewise: exactly 36 flash_attention
   launches per prefill (12 encoder, 12 causal self, 12 cross) and 24
   decode_attention launches per decode step (12 self, 12 cross over
   every encoder frame); the wiring run on a decoder prompt of 1,024 over
   4,096 encoder frames, so the cross attention runs Sq != Sk, with
   phase 18's per-call and float32 bars (its bf16 rms is reported, not
   held: here the kernels' and the plain versions' bf16 logits lie as
   far apart as bf16 lies from float32); the logits move when the
   encoder's input does; flash_attention at the
   cross shape (16 / 16 heads of 64, Sq 1,024, Sk 4,096) beside SDPA
   (decode_attention at both paths' decode shapes is timed in phase 8);
20. training: (a) each training kernel's autograd Function (the kernel
   forward; ``attention_vjp``, ``gmm_vjp`` -- two more kernel launches --
   and ``ssd_vjp`` backward) against float32 ``torch.autograd.grad``
   through its plain version, within the bf16 bar of ``TOL`` with atol
   scaled to each gradient's max |element|: flash_attention at
   gemma-2b's training shape (B=2, 8 / 1 heads of 256, S=2,048, causal),
   timed forward and backward beside SDPA and its bound, at a capped,
   windowed shape and a cross attention (Sq != Sk); expert_matmul at
   granite-moe-3b-a800m's training capacity (4,096 tokens, C=1,024);
   ssd_scan at zamba2-1.2b's heads (64 of 64, state 64, chunk 256,
   S=2,048), with cotangents for y and the final state; (b) the wiring
   in float32 at full width and cut depth (gemma-2b and
   granite-moe-3b-a800m with 2 layers, zamba2-1.2b with 6 Mamba2 layers
   and its shared block): the loss within 1e-5 x |loss| and every
   gradient leaf within 1e-3 x its max |grad| of the same model with the
   kernels swapped for their plain versions (the MoE's expert choices
   replayed); (c) ``launch/train.py`` trains gemma-2b at full width (18
   layers, 2.51 B parameters in bf16, float32 moments; B=2, S=2,048, 6
   steps, pod 1 failed at step 3): per step the loss, grad norm, wall
   ms, tokens/s, share of the bf16 peak, exactly 18 flash_attention
   launches; peak memory; the trained weights served (``generate`` and a
   flight of 2, equal tokens); a reduced bf16 state's checkpoint through
   npz and back to cuda, bitwise; (d) granite-moe-3b-a800m and
   zamba2-1.2b at full width and depth, two steps each with remat, the
   loss finite and exactly 64 flash_attention and 384 expert_matmul
   launches (granite) or 76 ssd_scan and 6 flash_attention launches
   (zamba2) per step;
21. distributed, on a one-rank NCCL group (one card holds one rank):
   (a) the flight collectives on CUDA tensors (``core/distops.py``: the
   rank adopts its own value, winner 0; ``masked_mean`` unhealthy gives
   (0, 0); ``k_of_n_mean`` with k=1 its own value); (b)
   granite-moe-3b-a800m at full width served as phase 12 (3 batches of 2
   prompts of 4,096 tokens, 32 greedy steps) through ``moe_block_ep``
   with an ``EPSpec`` over the (data=1, model=1) ``DeviceMesh`` and
   ``Plan.constrain``, and without: the tokens exactly equal, the
   kernels' launches equal, two exchanges a MoE layer a pass, each
   skipped (the identity on the one-rank model group); prefill and
   decode times of both, and the pace of the NCCL exchange that the
   skip saves at decode's buffer beside a copy of it; then a prefill and WIRING_STEPS
   teacher-forced steps under EP with every expert_matmul call held to
   its plain version; (c) qwen2-vl-2b with ``pad_heads=16`` (12 heads):
   its prefill at full width through flash_attention on the padded
   heads, the logits within RMS_K of the plain versions' bf16 spread from
   float32; (d) granite-moe-3b-a800m at full width, depth cut to
   DP_MOE_LAYERS, two steps by batch blocks over the one-rank mesh
   (``batch_blocks=plan``: batch shard, the MoE dispatch over the whole
   batch, gradient mean by NCCL) bitwise equal in loss and grad norm to
   the same two steps without it, and gemma-2b's two steps at full width
   without a plan (phase 22 (a)'s reference); (e) the
   closed-loop load sweep on the kernel routes through the one-rank
   config mesh, bitwise equal to ``devices=None``; (f) the dry run's
   plan of every cell on both production meshes (abstract, ``meta``,
   ``--plan-only``): the cells ok, and llama4-maverick-400b-a17b
   train_4k's per-rank parameter and moment bytes on 2x16x16;
22. the sharding plan run, on a one-rank NCCL group as a (data=1,
   model=1) mesh: (a) gemma-2b at full width, phase 21 (d)'s two steps
   with the parameters, AdamW moments and batch as DTensors
   (``Plan.shard_state``): loss and grad norm bitwise equal to phase
   21's steps without a plan, the warm ms a step beside it; (b)
   granite-moe-3b-a800m, a prefill of 2 prompts of 4,096 tokens and
   SHARD_STEPS greedy steps with the parameters and the cache as
   DTensors (``Plan.shard_params``, ``Plan.init_cache``): the tokens and
   the K3/K4/K5 launches equal to the unsharded path's (the kernels ran
   under ``local_map``, not the plain versions); (c) zamba2-1.2b's
   sharded prefill (K6): its logits bitwise the unsharded ones; (d) K3
   with a query offset (an inner block of a quarter of the sequence,
   whose offset is not the default and, at gemma2-9b's, whose rows cross
   the window's edge) and K4's log-sum-exp at gemma2-9b's and granite's
   shapes against their plain versions, K4's two halves merged by it
   against the whole; (e) after every timed phase, the dry run's
   counting of COUNT_CELLS (gemma-2b train_4k 16x16, granite decode_32k
   16x16, llama4-maverick train_4k 2x16x16), each in a child interpreter
   on a fake group, the three together: FLOPs a device, peak bytes,
   collectives, wall s (counts of fake tensors, not device numbers);
23. one JSON line listing each kernel (launches on its path, error
   against the plain version, times, bound, library time; for
   ``maxplus_scan`` also its launches on the fault paths; for both
   scheduler kernels their launches on the sweep path; for the two
   attention kernels their launches on every LM path).  Every
   kernel's ``ms`` and ``library_ms`` is the device's time: a CUDA graph
   of the calls replayed between CUDA events (``graph_ms``), inputs cold
   (copies that outgrow the L2, in turn) for the LM kernels, and for the
   scheduler's the one tape that the engine has just written; ``loop_ms``
   (``maxplus_scan``, ``decode_attention``, ``ssd_scan``) is the pace of
   an event-timed loop of calls, which the host sets for short kernels,
   and ``plain_ms`` is timed so too; for the three training kernels
   also their launches per training step and their backward times; for
   the kernels of phase 21 their launches on its distributed runs (EP
   serving, the padded heads, the steps by batch blocks, the config
   mesh's sweep; the runs they are held to are counted apart); for
   K3-K6 their launches on phase 22's sharded runs;
24. the last line: ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.  A copy
of the results goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the main path's size: HA deployment, keygen @ high, fig6's stream
WORKERS, AZS, LOAD = 15, 3, "high"
TRIALS = 32
JOBS = 10658                 # 1,800 s at 5.92 Hz
LOGDEPTH_NB = 16             # log-depth route: 16 blocks of the stream
SERVICE_JOBS, SERVICE_MB = 4096, 128
# the LM serving path: gemma2-9b, 3 batches of 2 prompts, 32 decode steps
ARCH = "gemma2-9b"
LM_BATCH, PROMPT, DECODE_STEPS, LM_BATCHES = 2, 4608, 32, 3
MAX_LEN = PROMPT + DECODE_STEPS + 8
WIRING_STEPS = 4
# the MoE and hybrid serving paths: 3 batches of 2 prompts of 4,096 tokens
# (a multiple of the SSD chunk), 32 decode steps each
MOE_ARCH, HYBRID_ARCH = "granite-moe-3b-a800m", "zamba2-1.2b"
PROMPT2 = 4096
MAX_LEN2 = PROMPT2 + DECODE_STEPS + 8
# the VLM and encoder-decoder serving paths, traffic as the MoE path's;
# the VLM's wiring prompt: VLM_TEXT text positions, then a rows x cols
# patch grid; the encoder-decoder's: a decoder prompt of
# ENCDEC_WIRING_PROMPT over PROMPT2 encoder frames
VLM_ARCH, ENCDEC_ARCH = "qwen2-vl-2b", "seamless-m4t-medium"
VLM_TEXT, VLM_GRID = 1024, (48, 64)
ENCDEC_WIRING_PROMPT = 1024
# ssd_scan against plain: the reference kernel test's bar (atol, rtol)
SSD_TOL = (2e-4, 2e-4, math.inf)
# an LM path's wiring run in bf16: the kernels' logits lie no further (rms)
# from the plain versions' float32 logits than RMS_K x the plain versions'
# bf16 logits do.  The kernels round as the plain versions do, within
# their bars, so the two spreads are one bf16 rounding spread: they read
# 0.987-1.026 x on the H100 (phases 12, 13, 18 and 19); a kernel error
# independent of that spread fails the bar from 0.57 x its size on
RMS_K = 1.15
# the fault path: a correlated AZ brownout process (fault_sweep's, with
# degraded errors) plus worker crashes, and a timeout / jittered retry /
# hedge policy; table widths cover the 1,800 s stream's replay (~2,000 s
# with its backlog) at least twice: 256 cycles of ~30 s each
FAULT_PROFILE = dict(az_mtbf_ms=24_000.0, az_mttr_ms=6_000.0,
                     degraded_inflation=3.0, correlated=True,
                     degraded_fail_prob=0.05, crash_mtbf_ms=30_000.0,
                     crash_restart_ms=200.0, max_intervals=256,
                     max_crashes=256)
FAULT_POLICY = dict(timeout_ms=6_000.0, max_retries=1, backoff_ms=50.0,
                    backoff_jitter=0.5, hedge_ms=4_000.0)
# the stock K2 route's block (250 blocks of the 63,948 attempt slots);
# stock's routes are compared on a stream of FAULT_CHECK_JOBS jobs
FAULT_STOCK_BLOCK = 256
FAULT_CHECK_JOBS = 2000
# the fault engine's stream: the first 900 s of fig6's (the phase is
# launch-bound on the host; at 1,800 s it took ~570 s of a 1,049 s smoke
# on an H100 80GB HBM3 machine at 700 W, whose host built the kernels
# 1.2-1.3x slower than other such machines)
FAULT_JOBS = JOBS // 2
OPEN_LOOP_TRIALS = 40_000
ONE_AZ_SEEDS = 16            # scalar-oracle streams beside fig6's 1-AZ point
# the training path: gemma-2b trained at full width by launch/train.py
# (B=2, S=2,048, 6 steps, pod 1 failed at step 3), then served with
# DECODE_STEPS steps on prompts of TRAIN_SERVE_PROMPT; the float32 wiring
# run on B=WIRING_TRAIN_BATCH sequences of TRAIN_SEQ
TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_FAIL_AT = 2, 2048, 6, 3
TRAIN_SERVE_PROMPT = 512
WIRING_TRAIN_BATCH = 1
# phase 21 (d): granite's depth in its steps by batch blocks
DP_MOE_LAYERS = 8
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# kernel against plain: |got - want| <= atol + rtol |want| at every element
# and never above ``cap``, the reference kernel tests' bar.  The plain
# versions compute in float32 and round once, so a bf16 element may be off
# by about two bf16 ulps of itself (rtol) plus a floor for outputs near 0
# (atol: a few percent of a typical output at the path's lengths).
TOL = {"float32": (2e-5, 0.0, 2e-5), "bfloat16": (1e-3, 1.6e-2, 2e-2)}


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_sm_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0].split()[0])


def compare(got, want) -> float:
    """Raise unless ``got`` and ``want`` are bitwise equal (inf and nan
    in the same places); return the largest finite absolute error."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)
                           if g.is_floating_point() else g == w)
        fin = torch.isfinite(g) & torch.isfinite(w) if \
            g.is_floating_point() else torch.ones_like(same)
        if bool(fin.any()):
            err = max(err, float((g[fin].double() - w[fin].double())
                                 .abs().max()))
        if not bool(same.all()):
            raise AssertionError(
                f"kernel disagrees with its plain version at "
                f"{int((~same).sum())} places (max abs err {err})")
    return err


def close(got, want, name: str, bar=None) -> tuple:
    """Raise unless ``got`` is finite and every element is within ``bar``
    = (atol, rtol, cap), by default the ``TOL`` bar of ``want``'s dtype;
    return (the largest absolute error, the largest share of its element's
    bar).  Tuples are compared element by element."""
    import torch
    if isinstance(want, tuple):
        parts = [close(g, w, f"{name}[{i}]", bar)
                 for i, (g, w) in enumerate(zip(got, want))]
        return max(p[0] for p in parts), max(p[1] for p in parts)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: shape/dtype {got.shape}/{got.dtype} "
                             f"vs {want.shape}/{want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    atol, rtol, cap = bar or TOL[str(want.dtype).removeprefix("torch.")]
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    share = float((diff / (atol + rtol * want.double().abs())).max())
    if not (share <= 1.0 and err <= cap):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{err} (bar {cap}), {share:.3f} of atol {atol} + rtol {rtol} "
            f"x |plain|")
    return err, share


def fault_engine_phase(dev, card, jobs=FAULT_JOBS, trials=TRIALS,
                       check_jobs=FAULT_CHECK_JOBS) -> dict:
    """Phase 14: ``QueueFlightSim`` in fault mode on the card.  Raptor
    at full width through the K2 route (log-depth,
    ``summary_backend="kernel"``), held bitwise to the sequential chain at
    the same size, and stock through its default route, with the run-pair
    summary, fail rates and every wall; then stock's K2 route against its
    default route (the auto route), bitwise, on a ``check_jobs``-job
    stream of as many trials.  K2's launches are counted on each fault
    path.  The stock K2 route at full width takes 423 s against the auto
    route's 94 s on an H100 80GB HBM3 at 700 W, so stock's full-width run
    takes the auto route and its K2 route is compared at the cut
    depth."""
    import torch
    from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
    from repro_torch.sim.faults import FaultProfile
    from repro_torch.sim.policies import RecoveryPolicy
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue
    fp = FaultProfile(**FAULT_PROFILE)
    pol = RecoveryPolicy(**FAULT_POLICY)
    wl = keygen_queue(faults=fp, recovery=pol)
    kw = dict(num_workers=WORKERS, num_azs=AZS, load=LOAD, seed=0,
              device=dev)

    def k2(engine, n):
        block = n // LOGDEPTH_NB if engine == "raptor" else FAULT_STOCK_BLOCK
        return QueueFlightSim(wl, scan="logdepth", block=block,
                              summary_backend="kernel", **kw)
    default = {"raptor": QueueFlightSim(wl, scan="seq", **kw),
               "stock": QueueFlightSim(wl, **kw)}
    horizon = jobs * 1000.0 / default["raptor"].rate_hz
    say(f"phase 14 fault engine: keygen @ {LOAD}, {WORKERS} workers / {AZS} "
        f"AZs, {jobs} jobs x {trials} trials; {fp}; {pol}; K2 routes "
        f"raptor {k2('raptor', jobs).engine_config('raptor')}, stock "
        f"{k2('stock', jobs).engine_config('stock')}; default routes raptor "
        f"{default['raptor'].engine_config('raptor')}, stock "
        f"{default['stock'].engine_config('stock')}; table coverage "
        f"{fp.coverage_ms():.0f} ms, arrivals span ~{horizon:.0f} ms")
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    maxplus_entries.launches = 0
    runs = {"raptor": timed("raptor_logdepth_kernel", lambda: k2(
        "raptor", jobs).run(jobs, trials, raptor=True))}
    launches = {"raptor": maxplus_entries.launches}
    seq = timed("raptor_seq", lambda: default["raptor"].run(
        jobs, trials, raptor=True))
    compare((runs["raptor"].response_ms, runs["raptor"].ok),
            (seq.response_ms, seq.ok))
    runs["stock"] = timed("stock_auto", lambda: default["stock"].run(
        jobs, trials, raptor=False))
    for eng, r in runs.items():
        good = r.response_ms[r.ok]
        if r.response_ms.shape != (trials, jobs) or not bool(
                torch.isfinite(good).all()) or not bool((good > 0).all()):
            raise AssertionError(f"{eng}: bad responses")
    # the replay must stay inside the drawn tables, twice over (a stock
    # task whose retry the bounded fixed point left unscheduled ends at
    # inf and counts as failed, as in the reference)
    end = horizon * 1.05 + max(
        float(r.response_ms[torch.isfinite(r.response_ms)].max())
        for r in runs.values())
    if fp.coverage_ms() < 2.0 * end:
        raise AssertionError(f"fault tables cover {fp.coverage_ms()} ms, "
                             f"less than twice the replay's ~{end} ms")
    maxplus_entries.launches = 0
    a = timed(f"stock_logdepth_kernel_{check_jobs}", lambda: k2(
        "stock", check_jobs).run(check_jobs, trials, raptor=False))
    launches[f"stock_{check_jobs}_jobs"] = maxplus_entries.launches
    b = timed(f"stock_auto_{check_jobs}", lambda: default["stock"].run(
        check_jobs, trials, raptor=False))
    compare((a.response_ms, a.ok), (b.response_ms, b.ok))
    say(f"phase 14 fault engine maxplus_scan launches on the K2 routes: "
        f"{launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"maxplus_scan never launched on a fault path: "
                             f"{launches}")
    pair = {"stock": runs["stock"].summary(),
            "raptor": runs["raptor"].summary()}
    pair["mean_ratio"] = pair["raptor"]["mean"] / pair["stock"]["mean"]
    if not (0.0 < pair["raptor"]["fail_rate"] < 0.5
            and 0.0 < pair["stock"]["fail_rate"] < 0.5):
        raise AssertionError(f"fail rates out of range: {pair}")
    say(f"phase 14 fault engine: raptor K2 route == sequential chain, "
        f"bitwise on {jobs} jobs x {trials} trials; stock K2 route == auto "
        f"route, bitwise on {check_jobs} jobs x {trials} trials; replay "
        f"ends by ~{end:.0f} ms, tables cover "
        f"{fp.coverage_ms():.0f} ms")
    for eng in ("stock", "raptor"):
        s = pair[eng]
        say(f"phase 14 run_pair {eng}: mean {s['mean']:.1f} ms, p50 "
            f"{s['median']:.1f} ms, p99 {s['p99']:.1f} ms, fail rate "
            f"{s['fail_rate']:.5f} (n {s['n']}, failed {s['n_failed']})")
    say(f"phase 14 run_pair mean_ratio {pair['mean_ratio']:.4f}; wall s "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" [{card}]")
    return dict(walls_s=walls, run_pair=pair, launches=launches,
                check_jobs=check_jobs, coverage_ms=fp.coverage_ms(),
                replay_end_ms=end)


def fault_service_phase(dev, card, jobs=SERVICE_JOBS) -> dict:
    """Phase 15: ``SchedulerService`` in fault mode on the K2 route under
    phase 6's MMPP traffic; the streaming ``oracle_check`` (with the
    stream's fault tables) bitwise."""
    from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
    from repro_torch.serving.engine import SchedulerService
    from repro_torch.sim.events import MMPPArrivals
    from repro_torch.sim.faults import FaultProfile
    from repro_torch.sim.policies import RecoveryPolicy
    from repro_torch.sim.streaming import oracle_check
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue
    wl = keygen_queue(faults=FaultProfile(**FAULT_PROFILE),
                      recovery=RecoveryPolicy(**FAULT_POLICY))
    sim = QueueFlightSim(wl, num_workers=WORKERS, num_azs=AZS,
                         load="medium", seed=0, device=dev, scan="logdepth",
                         block=64, summary_backend="kernel")
    maxplus_entries.launches = 0
    svc = SchedulerService(sim, microbatch=SERVICE_MB, seed=0)
    rep = svc.run_open_load(
        jobs=jobs, microbatch=SERVICE_MB,
        process=MMPPArrivals(sim.rate_hz, burst_factor=5.0,
                             dwell_s=(20.0, 4.0), seed=0), seed=0)
    launches = maxplus_entries.launches
    if launches < 1 or rep.jobs != jobs:
        raise AssertionError(f"fault service: {launches} maxplus_scan "
                             f"launches, {rep.jobs} jobs")
    if not 0.0 < rep.ok_frac < 1.0:
        raise AssertionError(f"fault service: ok fraction {rep.ok_frac}")
    check = oracle_check(sim, n_steps=6, microbatch=SERVICE_MB, trace=True)
    if not check["bitwise"]:
        raise AssertionError(f"fault streaming oracle_check failed: {check}")
    say(f"phase 15 fault service: {rep.jobs} jobs (MMPP, microbatch "
        f"{SERVICE_MB}, config {sim.engine_config('raptor')}), "
        f"{rep.jobs_per_s:.1f} jobs/s, ok {rep.ok_frac:.4f}, p50 "
        f"{rep.p50_ms:.1f} ms, p99 {rep.p99_ms:.1f} ms, SLO "
        f"{rep.slo_ms:.0f} ms violated {rep.slo_violation_frac:.4f}; "
        f"oracle_check bitwise (runs and traces) {check['bitwise']}; "
        f"maxplus_scan launches {launches} [{card}]")
    return dict(rep.summary(), launches=launches)


def open_loop_phase(dev, card, trials=OPEN_LOOP_TRIALS) -> dict:
    """Phase 16: ``VectorFlightSim.run_pair`` on the card against the
    closed forms (tests/test_sim_vector.py's bars), and fault_sweep's
    open-loop rows beside the independence prediction."""
    from repro_torch.core import analytics as an
    from repro_torch.sim.faults import FaultProfile
    from repro_torch.sim.vector import (VectorFlightSim, exponential_vector,
                                        keygen_vector, reliability_vector)
    out, walls = {}, {}

    def pair(name, wl, **kw):
        t0 = time.perf_counter()
        res = VectorFlightSim(wl, device=dev, **kw).run_pair(trials)
        walls[name] = time.perf_counter() - t0
        out[name] = res
        return res

    checks = []
    r = pair("keygen", keygen_vector(), num_azs=3, flight=2, load="low")
    checks.append(("keygen ratio", r["mean_ratio"], 0.647, 0.06))
    r = pair("exp_rho0", exponential_vector(2, 1000.0), num_azs=3, flight=2,
             rho=0.0, stream_latency_ms=0.0)
    checks.append(("rho=0 exp ratio", r["mean_ratio"],
                   an.response_ratio_paper(), 0.05))
    for n, p in ((2, 0.3), (4, 0.2)):
        r = pair(f"reliability_{n}", reliability_vector(n, p), num_azs=3,
                 flight=n)
        checks.append((f"reliability({n}, {p}) raptor fail",
                       r["raptor"]["fail_rate"],
                       an.raptor_failure_exact(p, n), 0.02))
        checks.append((f"reliability({n}, {p}) stock fail",
                       r["stock"]["fail_rate"], an.forkjoin_failure(p, n),
                       0.02))
    for name, got, want, tol in checks:
        if not abs(got - want) <= tol:
            raise AssertionError(f"open loop {name}: {got} vs {want} +- "
                                 f"{tol}")
    base = dict(az_mtbf_ms=24_000.0, az_mttr_ms=6_000.0,
                degraded_inflation=3.0)
    pi = FaultProfile(**base).stationary_degraded
    pred = an.mixture_speedup_prediction(2, 2, p_deg=pi, inflation=3.0,
                                         n_samples=20_000, seed=0)
    rows = {}
    for tag, corr in (("iid", False), ("correlated", True)):
        wl = exponential_vector(2, 1000.0,
                                faults=FaultProfile(correlated=corr, **base))
        r = pair(f"fault_{tag}", wl, num_azs=3, flight=2, load="low")
        rows[tag] = dict(measured_ratio=r["mean_ratio"],
                         predicted_ratio=pred,
                         rel_err=abs(r["mean_ratio"] - pred) / pred)
    for name, got, want, tol in checks:
        say(f"phase 16 open loop {name}: {got:.4f} (closed form {want:.4f} "
            f"+- {tol})")
    for tag, row in rows.items():
        say(f"phase 16 open loop fault_sweep {tag}: measured ratio "
            f"{row['measured_ratio']:.4f}, independence prediction "
            f"{row['predicted_ratio']:.4f}, rel err {row['rel_err']:.4f}")
    say(f"phase 16 open loop: {trials} trials a run; wall s "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" [{card}]")
    return dict(pairs=out, checks=[list(c) for c in checks],
                fault_sweep=rows, walls_s=walls)


def experiments_phase(dev, card) -> dict:
    """Phase 17: the paper's experiments on the card
    (``repro_torch.sim.experiments``).  fig6 at its defaults (the
    vector engine's load grids on 1,800 s streams, 32 trials); its HA grid
    again through ``queue_pair_plan`` on the kernel routes — stock on
    ``queue_booking``, raptor on the log-depth ``maxplus_scan`` route —
    bitwise equal to fig6's default-route numbers and to each
    configuration's solo ``run_pair``; Table 7 on the scalar oracle beside
    fig6's HA medium point, and the oracle's 1-AZ medium point beside
    fig6's; then ``load_sweep_util``, ``sweep_scale``,
    ``fig7_other_workloads``, ``workflow_bank`` and ``fault_sweep`` at
    their defaults (``fault_sweep``'s closed-loop rows on the
    ``maxplus_scan`` summary route, held bitwise to a second run on the
    default route)."""
    import torch
    from repro_torch.core import analytics as an
    from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
    from repro_torch.kernels.queue_booking.ops import book_stream
    from repro_torch.launch.bench_kernels import booking_stream, graph_ms
    from repro_torch.sim import experiments as X
    from repro_torch.sim.sweeps import queue_pair_plan
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue
    from repro_torch.sim.workloads import keygen_workload
    walls, launches = {}, {}
    loads = ("low", "medium", "high")

    def timed(name, fn):
        book_stream.launches = 0
        maxplus_entries.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = {"queue_booking": book_stream.launches,
                          "maxplus_scan": maxplus_entries.launches}
        return out

    def same(a, b):
        return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)

    # 1. fig6 at its defaults
    fig6 = timed("fig6", lambda: X.fig6_scale_effect(device=dev))
    small = fig6["one_az_5w/medium"]["mean_ratio"]
    large = fig6["three_az_15w/medium"]["mean_ratio"]
    n_small, n_ha = X.fig6_jobs(X.LOW_AVAIL), X.fig6_jobs(X.HA)
    say(f"phase 17 fig6 (vector, 32 trials of {n_small} / {n_ha} jobs): "
        + ", ".join(f"{k} {v['mean_ratio']:.4f}" for k, v in fig6.items()))
    if not (small > 0.90 and large < 0.75 and large < small):
        raise AssertionError(f"fig6 not paper-shaped: 1-AZ/5w medium "
                             f"{small}, HA medium {large}")

    # 2. the HA grid through the kernel routes, one plan
    block = n_ha // LOGDEPTH_NB
    sims = [QueueFlightSim(keygen_queue(), load=load, seed=0, device=dev,
                           booking_backend="kernel", scan="logdepth",
                           block=block, summary_backend="kernel", **X.HA)
            for load in loads]
    kern = timed("ha_grid_kernel_routes",
                 lambda: queue_pair_plan(sims, n_ha, 32).run())
    sweep_launches = launches["ha_grid_kernel_routes"]
    say(f"phase 17 HA grid on the kernel routes (stock queue_booking, "
        f"raptor log-depth block {block} with maxplus_scan): launches "
        f"{sweep_launches} for {len(loads)} configs x 32 trials")
    if min(sweep_launches.values()) < 1:
        raise AssertionError(f"a kernel of the sweep path never launched: "
                             f"{sweep_launches}")
    solo = {}
    for load in loads:
        solo[load] = timed(f"solo_{load}", lambda load=load: QueueFlightSim(
            keygen_queue(), load=load, seed=0, device=dev,
            **X.HA).run_pair(n_ha, 32))
    for load, got in zip(loads, kern):
        if not (same(got, fig6[f"three_az_15w/{load}"])
                and same(got, solo[load])):
            raise AssertionError(
                f"HA {load}: kernel-route sweep {got} != default-route "
                f"sweep {fig6['three_az_15w/' + load]} or solo "
                f"{solo[load]}")
    say("phase 17 HA grid: kernel-route sweep == fig6's default-route "
        "sweep == solo run_pair per load, every summary field bitwise")
    # does a launch of configs x trials rows cost more than one of trials?
    k1_rows = {}
    for T in (32, 32 * len(loads)):
        tape = booking_stream(T, 2 * n_ha, X.HA["num_workers"], 0.45, 0, 0,
                              dev)
        k1_rows[T] = graph_ms(lambda r, s, w: book_stream(r, s, w), [tape],
                              20)
    say(f"phase 17 queue_booking per launch on a stock tape of the grid's "
        f"shape (N={2 * n_ha}, W=15): " + ", ".join(
            f"{T} rows {ms:.4f} ms" for T, ms in k1_rows.items())
        + f" [{card}]")

    # 3. Table 7 on the scalar oracle (host) beside fig6's HA medium point
    t7 = timed("table7_scalar", X.table7_keygen)
    for eng in ("stock", "raptor"):
        v, o = fig6["three_az_15w/medium"][eng]["mean"], t7[eng]["mean"]
        say(f"phase 17 table7 {eng}: scalar oracle mean {o:.1f} ms, "
            f"vector {v:.1f} ms (rel {abs(v - o) / o:.4f})")
        if not abs(v - o) <= 0.08 * o:
            raise AssertionError(f"table7 {eng}: vector {v} vs scalar {o}")
    # the 1-AZ/5-worker medium point on the scalar oracle: the means of
    # ONE_AZ_SEEDS 1,800 s streams (near saturation one stream's raptor
    # mean varies ~8% from seed to seed; fig6 averages 32 streams)
    one_az = timed("one_az_scalar", lambda: [
        X.run_pair(keygen_workload, X.LOW_AVAIL, load="medium",
                   duration_s=1800.0, seed=s) for s in range(ONE_AZ_SEEDS)])
    one_az_means = {}
    for eng in ("stock", "raptor"):
        v = fig6["one_az_5w/medium"][eng]["mean"]
        seeds = [r[eng]["mean"] for r in one_az]
        o = sum(seeds) / len(seeds)
        one_az_means[eng] = dict(vector=v, oracle=o, oracle_seed0=seeds[0])
        say(f"phase 17 1-AZ medium {eng}: scalar oracle mean {o:.1f} ms "
            f"over {ONE_AZ_SEEDS} seeds (seed 0: {seeds[0]:.1f}), vector "
            f"{v:.1f} ms (rel {abs(v - o) / o:.4f})")
        if not abs(v - o) <= 0.08 * o:
            raise AssertionError(f"1-AZ medium {eng}: vector {v} vs "
                                 f"scalar {o}")
    ratio = one_az_means["raptor"]["oracle"] / one_az_means["stock"]["oracle"]
    say(f"phase 17 1-AZ medium ratio: scalar oracle {ratio:.4f}, vector "
        f"{small:.4f}")

    # 4. the other experiments at their defaults
    util = timed("load_sweep_util", lambda: X.load_sweep_util(device=dev))
    scale = timed("sweep_scale", lambda: X.sweep_scale(trials=20_000,
                                                       device=dev))
    fig7 = timed("fig7", lambda: X.fig7_other_workloads(device=dev))
    bank = timed("workflow_bank", lambda: X.workflow_bank(device=dev))
    faults = timed("fault_sweep", lambda: X.fault_sweep(
        device=dev, summary_backend="kernel"))
    # the same rows on the default summary route: K2 at fault_sweep's
    # shapes (1,024 jobs x 16 trials, brownouts, the policy) is held to
    # its plain route bitwise
    faults_default = timed("fault_sweep_default_route",
                           lambda: X.fault_sweep(device=dev))
    if not same(faults, faults_default):
        raise AssertionError(
            "fault_sweep: maxplus_scan summary route != default route: "
            + ", ".join(k for k in faults
                        if not same(faults[k], faults_default[k])))
    say("phase 17 fault_sweep: maxplus_scan summary route == default "
        "route, every row bitwise")
    for key, row in scale["reliability"].items():
        if not abs(row["raptor_fail"] - row["theory_exact"]) <= 0.02:
            raise AssertionError(f"sweep_scale reliability {key}: {row}")
    t7v = scale["table7_keygen"]["mean_ratio"]
    if not abs(t7v - 0.647) <= 0.06:
        raise AssertionError(f"sweep_scale table7 ratio {t7v}")
    for name in ("etl", "mapreduce"):
        if bank[name]["streaming_bitwise_oracle"] is not True:
            raise AssertionError(f"workflow_bank {name}: streaming "
                                 f"oracle_check not bitwise")
    for name in ("wordcount", "thumbnail"):
        if not 0.0 < fig7[name]["mean_ratio"] < 1.05:
            raise AssertionError(f"fig7 {name}: {fig7[name]['mean_ratio']}")
    say("phase 17 load_sweep_util: " + ", ".join(
        f"{k} {v['mean_ratio']:.4f}" for k, v in util.items()))
    say(f"phase 17 sweep_scale: table7 {t7v:.4f} (0.647 +- 0.06); AZ "
        f"sweep {scale['az_sweep']['ratio_by_azs']}; reliability "
        + ", ".join(f"{k} {v['raptor_fail']:.4f} vs {v['theory_exact']:.4f}"
                    for k, v in scale["reliability"].items()))
    say(f"phase 17 fig7: wordcount {fig7['wordcount']['mean_ratio']:.4f}, "
        f"thumbnail {fig7['thumbnail']['mean_ratio']:.4f}; workflow_bank: "
        + ", ".join(f"{k} {v['mean_ratio']:.4f} (streaming "
                    f"{v['streaming']['jobs_per_s']:.1f} jobs/s, oracle "
                    f"bitwise {v['streaming_bitwise_oracle']})"
                    for k, v in bank.items()))
    say("phase 17 fault_sweep: " + ", ".join(
        f"{k} {v.get('measured_ratio', v.get('mean_ratio')):.4f}"
        for k, v in faults.items() if k != "profile")
        + f"; prediction {faults['open_loop/iid']['predicted_ratio']:.4f}")
    say("phase 17 kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if any(v.values())))
    say("phase 17 walls s: " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in walls.items())
        + f"; total {sum(walls.values()):.2f} [{card}]")
    return dict(fig6=fig6, ha_grid_kernel=kern, table7=t7,
                one_az_medium_means=one_az_means,
                load_sweep_util=util, sweep_scale=scale, fig7=fig7,
                workflow_bank=bank, fault_sweep=faults, walls_s=walls,
                launches=launches, sweep_launches=sweep_launches,
                k1_ms_by_rows=k1_rows,
                theory_ratio=an.response_ratio_paper())


def kernel_entries() -> dict:
    """Each LM kernel's (module whose name the model calls, that name,
    wrapper, plain version, bar against it; None: ``TOL``)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain, gqa_decode)
    from repro_torch.kernels.flash_attention.ops import attention_plain, mha
    from repro_torch.kernels.moe_gmm.ops import expert_matmul_plain, gmm
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_plain
    from repro_torch.models import layers, mamba2, moe
    from repro_torch.models import transformer as tfm
    return {"flash_attention": (layers, "mha", mha, attention_plain, None),
            "decode_attention": (tfm, "gqa_decode", gqa_decode,
                                 decode_attention_plain, None),
            "expert_matmul": (moe, "gmm", gmm, expert_matmul_plain, None),
            "ssd_scan": (mamba2, "ssd", ssd, ssd_plain, SSD_TOL)}


def lm_path(dev, card, phase, cfg_, per_prefill, per_step, *,
            wiring_batch=None, rms_bar=False):
    """Serve ``cfg_`` at full width (3 batches of 2 ``demo_requests``
    prompts of PROMPT2, DECODE_STEPS greedy steps each), a flight of 2,
    and the wiring run; ``per_prefill`` and ``per_step`` are the launches
    each kernel of the path must make.  The wiring run (a prefill of
    ``wiring_batch``, by default the first served batch, and WIRING_STEPS
    teacher-forced steps) holds every kernel call to its plain version,
    the bf16 logits within RMS_K of the bf16 rounding spread from the
    plain versions' float32 logits, and with the weights in float32 the
    logits within 1e-3 x max |logit| of the plain versions'; with
    ``rms_bar`` the bf16 logits also lie no further (rms) from the plain
    versions' than bf16 from float32.
    Returns the results and the weights, in float32 now."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                            demo_requests)
    from repro_torch.serving.step import greedy_sample
    entries = kernel_entries()
    walls = {}
    t0 = time.perf_counter()
    params_ = tfm.init_params(cfg_, 0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params_.parameters())
    say(f"phase {phase} {cfg_.name}: {n_par:,} parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card) "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batches_ = [demo_requests(cfg_, LM_BATCH, PROMPT2, seed=i,
                              device=dev) for i in range(LM_BATCHES)]
    eng_ = ServingEngine(cfg_, params_, ServeConfig(
        max_len=MAX_LEN2, decode_steps=DECODE_STEPS), device=dev)
    wrappers = {name: entries[name][2] for name in per_prefill}
    for fn in wrappers.values():
        fn.launches = 0
    stats_ = eng_.serve(batches_)
    got = {name: fn.launches for name, fn in wrappers.items()}
    n_pre, n_step = 2 + LM_BATCHES, 2 + LM_BATCHES * DECODE_STEPS
    want_ = {name: per_prefill[name] * n_pre + per_step[name] * n_step
             for name in per_prefill}
    if got != want_:
        raise AssertionError(f"{cfg_.name} serve launched {got}, "
                             f"expected {want_}")
    walls["serve"] = time.perf_counter() - t0
    summ_ = stats_.summary()
    say(f"phase {phase} serve: {summ_['requests']} requests (B="
        f"{LM_BATCH}, prompt {PROMPT2}, {DECODE_STEPS} decode steps, "
        f"max_len {MAX_LEN2}): prefill {summ_['prefill_s'] * 1e3:.1f} ms,"
        f" decode {summ_['decode_step_s'] * 1e3:.3f} ms/step, "
        f"{LM_BATCH / summ_['decode_step_s']:.1f} decode tokens/s, "
        f"request p50 {summ_['p50_s'] * 1e3:.1f} ms, p99 "
        f"{summ_['p99_s'] * 1e3:.1f} ms; first call "
        f"{summ_['cold_s']:.2f} s, warm {summ_['warm_s']:.2f} s; "
        f"launches {got} ({n_pre} prefills, {n_step} decode steps) "
        f"[{card}]")
    t0 = time.perf_counter()
    fl_eng = ServingEngine(cfg_, params_, ServeConfig(
        max_len=MAX_LEN2, decode_steps=DECODE_STEPS, flight_size=2),
        device=dev)
    fl_eng.warmup(batches_[0])
    flown_ = fl_eng.generate_flight(batches_[0])
    ref_ = eng_.generate(batches_[0])
    if flown_.tokens.shape != (LM_BATCH, DECODE_STEPS) or not (
            flown_.tokens == ref_.tokens).all():
        raise AssertionError(f"{cfg_.name}: the flight's tokens differ "
                             f"from generate's")
    walls["flight"] = time.perf_counter() - t0
    say(f"phase {phase} flight of 2: {flown_.latency_s * 1e3:.1f} ms, "
        f"tokens equal generate's ({ref_.latency_s * 1e3:.1f} ms) "
        f"[{card}]")

    # the wiring: every kernel call of a prefill and WIRING_STEPS
    # teacher-forced steps held to its plain version on its inputs
    t0 = time.perf_counter()
    wiring_batch = batches_[0] if wiring_batch is None else wiring_batch
    forced_ = torch.as_tensor(ref_.tokens[:, :WIRING_STEPS], device=dev)
    calls = {name: [0, 0.0, 0.0] for name in per_prefill}

    def shadowed(name):
        _, _, kernel, plain, bar = entries[name]

        def run(*args, **kw):
            out = kernel(*args, **kw)
            err, share = close(out, plain(*args, **kw),
                               f"{cfg_.name} {name}", bar)
            rec = calls[name]
            rec[:] = rec[0] + 1, max(rec[1], err), max(rec[2], share)
            return out
        return run

    def logits_of(swap, cfg_run=cfg_):
        dt = getattr(torch, cfg_run.dtype)
        batch = {k: (t.to(dt) if t.is_floating_point() else t)
                 for k, t in wiring_batch.items()}
        with contextlib.ExitStack() as swaps:
            for name, fn in swap.items():
                mod, attr = entries[name][:2]
                swaps.enter_context(mock.patch.object(mod, attr, fn))
            logits, cache = tfm.prefill(params_, cfg_run, batch, MAX_LEN2)
            outs = [logits.float()]
            for i in range(WIRING_STEPS):
                logits, cache = tfm.decode_step(params_, cfg_run, cache,
                                                forced_[:, i:i + 1])
                outs.append(logits.float())
            del cache
        out = torch.stack(outs)
        if out.shape != (WIRING_STEPS + 1, LM_BATCH, cfg_.vocab_size) \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{cfg_.name}: logits {out.shape} are "
                                 f"not finite or of the wrong shape")
        return out

    kern_ = logits_of({name: shadowed(name) for name in per_prefill})
    want_calls = {name: per_prefill[name] + WIRING_STEPS * per_step[name]
                  for name in per_prefill}
    if {name: rec[0] for name, rec in calls.items()} != want_calls:
        raise AssertionError(f"{cfg_.name}: the wiring run made {calls} "
                             f"kernel calls, expected {want_calls}")
    plain_ = logits_of({name: entries[name][3] for name in per_prefill})
    diff = (kern_ - plain_).abs()
    wiring_max = float(diff.max())
    wiring_rms = float(diff.square().mean().sqrt())
    agree = float((greedy_sample(kern_) == greedy_sample(plain_))
                  .float().mean())
    say(f"phase {phase} wiring, every kernel call against its plain "
        f"version on the model's activations: "
        + "; ".join(f"{name} {rec[0]} calls, max abs err {rec[1]:.4g}, "
                    f"{rec[2]:.3f} of its bar at worst"
                    for name, rec in calls.items())
        + f"; logits kernels vs plain: max {wiring_max:.4g}, rms "
        f"{wiring_rms:.4g}, greedy tokens agree {agree:.3f} [{card}]")
    del diff
    # the same weights in float32: there the kernels agree with their
    # plain versions to float32 rounding, with no bf16 rounding to
    # flip a router's choice, so the logits are held as gemma2-9b's
    cfg32_ = dataclasses.replace(cfg_, dtype="float32")
    for w_ in params_.parameters():
        w_.data = w_.data.float()
    kern32_ = logits_of({}, cfg32_)
    plain32_ = logits_of({name: entries[name][3] for name in per_prefill},
                         cfg32_)
    err32_ = float((kern32_ - plain32_).abs().max())
    top32_ = float(plain32_.abs().max())
    agree32_ = float((greedy_sample(kern32_) == greedy_sample(plain32_))
                     .float().mean())
    noise_rms = float((plain_ - plain32_).square().mean().sqrt())
    kern_f32_rms = float((kern_ - plain32_).square().mean().sqrt())
    say(f"phase {phase} wiring float32 (prefill + {WIRING_STEPS} "
        f"teacher-forced steps, kernels vs plain versions): max "
        f"|dlogit| {err32_:.4g} against 1e-3 x max |logit| = "
        f"{1e-3 * top32_:.4g}, greedy tokens agree {agree32_:.3f}; bf16 "
        f"vs float32, both plain: rms {noise_rms:.4g}; the kernels' bf16 "
        f"vs float32 plain: rms {kern_f32_rms:.4g} (kernels vs plain in "
        f"bf16: rms {wiring_rms:.4g}) [{card}]")
    if not err32_ <= 1e-3 * top32_:
        raise AssertionError(f"{cfg_.name} float32: kernels and plain "
                             f"versions disagree: max |dlogit| {err32_} "
                             f"> {1e-3 * top32_}")
    if not kern_f32_rms <= RMS_K * noise_rms:
        raise AssertionError(
            f"{cfg_.name} bf16: the kernels' logits lie further from float32 "
            f"(rms {kern_f32_rms}) than {RMS_K} x the plain versions' bf16 "
            f"logits do (rms {noise_rms})")
    if rms_bar and not wiring_rms <= noise_rms:
        raise AssertionError(
            f"{cfg_.name} bf16: the kernels move the logits further from "
            f"the plain versions' (rms {wiring_rms}) than bf16 rounding "
            f"moves them from float32 (rms {noise_rms})")
    walls["wiring"] = time.perf_counter() - t0
    del eng_, fl_eng, kern_, kern32_, plain32_, plain_
    gc.collect()
    torch.cuda.empty_cache()
    return dict(summ_, decode_tokens_per_s=LM_BATCH
                / summ_["decode_step_s"], launches=got, params=n_par,
                flight_s=flown_.latency_s, wiring_calls=calls,
                wiring_logits_max_abs=wiring_max,
                wiring_logits_rms=wiring_rms,
                bf16_vs_f32_rms=noise_rms,
                kernels_bf16_vs_f32_rms=kern_f32_rms,
                greedy_agreement=agree, wiring_f32_max_abs=err32_,
                wiring_f32_bar=1e-3 * top32_,
                greedy_agreement_f32=agree32_, walls_s=walls), params_


def flash_row(dev, name, hq, hkv, sq, sk, d, causal, scale) -> dict:
    """``flash_attention`` at one of a model's shapes (B = LM_BATCH, bf16,
    no cap or window): held to its plain version within the bf16 bar, its
    device time (CUDA graph replay, inputs cold: distinct inputs in the
    model's layout, ``bench_kernels.flash_sets``) beside SDPA's, the plain
    version's pace and the bound (``bench_kernels.flash_bound``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention_plain, mha
    from repro_torch.launch.bench_kernels import (flash_bound, flash_sets,
                                                  graph_ms, loop_ms)
    sets = flash_sets(hq, hkv, d, sq, sk, 17, dev, LM_BATCH)
    q, k, v = sets[0]

    def kern(q_, k_, v_):
        return mha(q_, k_, v_, causal=causal, scale=scale)
    err, share = close(kern(q, k, v), attention_plain(
        q, k, v, causal=causal, scale=scale), f"flash_attention {name}")
    bound, bound_by = flash_bound(LM_BATCH, hq, hkv, d, sq, sk, causal)
    row = {"shape": f"{name}: B={LM_BATCH}, {hq}/{hkv} heads, Sq={sq}, "
                    f"Sk={sk}, D={d}, {'causal' if causal else 'non-causal'}"
                    f", no cap or window",
           "max_abs_err": err, "bar_share": share,
           "ms": graph_ms(kern, sets, 10),
           "plain_ms": loop_ms(lambda: attention_plain(
               q, k, v, causal=causal, scale=scale), [()], 2),
           "bound_ms": bound, "bound_by": bound_by}
    sdpa_sets = [tuple(x.contiguous() for x in s) for s in sets]
    del sets
    row["library_ms"] = graph_ms(
        lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, is_causal=causal, scale=scale, enable_gqa=True),
        sdpa_sets, 10)
    del sdpa_sets, q, k, v
    torch.cuda.empty_cache()
    return row


def cold(*tensors):
    """``tensors`` and enough copies of them to outgrow the L2 twice,
    for ``graph_ms`` to cycle through (a layer finds its inputs cold)."""
    from repro_torch.launch.bench_kernels import copies
    n = copies(sum(t.numel() * t.element_size() for t in tensors))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def vlm_phase(dev, card) -> dict:
    """Phase 18: qwen2-vl-2b served at full width on ``demo_requests``'
    embedding prompts; the wiring run on M-RoPE ids with distinct
    streams (``demo_requests``' equal streams reduce M-RoPE to RoPE):
    VLM_TEXT text positions, then a VLM_GRID patch grid, Qwen2-VL's
    layout of an image after text."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    batch = vlm_wiring_batch(cfg, dev)
    n = cfg.num_layers
    out, params = lm_path(
        dev, card, 18, cfg, {"flash_attention": n, "decode_attention": 0},
        {"flash_attention": 0, "decode_attention": n}, wiring_batch=batch,
        rms_bar=True)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["walls_s"]["phase"] = time.perf_counter() - t_phase
    say("phase 18 walls s " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["walls_s"].items()) + f" [{card}]")
    return out


def encdec_phase(dev, card) -> dict:
    """Phase 19: seamless-m4t-medium served at full width on
    ``demo_requests``' traffic (PROMPT2 decoder embeddings and as many
    encoder frames); the wiring run on a decoder prompt of
    ENCDEC_WIRING_PROMPT over PROMPT2 frames, so cross attention runs
    Sq != Sk; and the logits move when the encoder's input does."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import demo_requests
    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    full = demo_requests(cfg, LM_BATCH, PROMPT2, seed=0, device=dev)
    batch = {"embeddings": full["embeddings"][:, :ENCDEC_WIRING_PROMPT],
             "enc_emb": full["enc_emb"]}
    n = cfg.num_layers
    out, params = lm_path(
        dev, card, 19, cfg,
        {"flash_attention": cfg.num_encoder_layers + 2 * n,
         "decode_attention": 0},
        {"flash_attention": 0, "decode_attention": 2 * n},
        wiring_batch=batch)
    # no ``rms_bar``: in this bf16 model a change in the rounding of a few
    # attention outputs grows into the whole bf16 rounding spread, so the
    # kernels' and the plain versions' bf16 logits lie about as far from
    # each other as each lies from the float32 ones; lm_path's RMS_K bar
    # holds the kernels' bf16 logits to float32 instead
    # the encoder is read: other frames move the prefill's logits (in
    # float32, the weights' dtype after the wiring run)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    other = demo_requests(cfg, LM_BATCH, PROMPT2, seed=1,
                          device=dev)["enc_emb"]
    emb = batch["embeddings"].float()
    a = tfm.prefill(params, cfg32, {"embeddings": emb,
                                    "enc_emb": batch["enc_emb"].float()},
                    ENCDEC_WIRING_PROMPT + 1)[0]
    b = tfm.prefill(params, cfg32, {"embeddings": emb,
                                    "enc_emb": other.float()},
                    ENCDEC_WIRING_PROMPT + 1)[0]
    moved, top = float((a - b).abs().max()), float(a.abs().max())
    say(f"phase 19 encoder read: other encoder frames move the prefill's "
        f"logits by up to {moved:.4g} (max |logit| {top:.4g}) [{card}]")
    if not (bool(torch.isfinite(a).all()) and moved > 1e-3 * top):
        raise AssertionError(f"{ENCDEC_ARCH}: the logits do not move with "
                             f"the encoder's input (max |dlogit| {moved})")
    out.update(encoder_moves_logits=moved, max_logit=top)
    del params, batch, full, other, a, b, emb
    gc.collect()
    torch.cuda.empty_cache()
    out["walls_s"]["phase"] = time.perf_counter() - t_phase
    say("phase 19 walls s " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["walls_s"].items()) + f" [{card}]")
    return out


def grad_bar(want) -> tuple:
    """The bf16 bar of ``TOL`` with atol and the cap scaled to the
    gradient's max |element|."""
    atol, rtol, cap = TOL["bfloat16"]
    top = float(want.abs().max())
    return (atol * top, rtol, cap * top)


def grad_check(name, fn, plain, leaves, cot, dtype) -> tuple:
    """``fn``'s gradient (its autograd Function: the kernel forward, the
    port's backward) on ``leaves`` cast to ``dtype``, against float32
    ``torch.autograd.grad`` through ``plain`` on the same inputs, each
    within :func:`grad_bar`.  Returns (max abs err, max bar share)."""
    import torch
    ins = [t.to(dtype).requires_grad_(True) for t in leaves]
    cots = tuple(c.to(dtype) for c in cot)
    got = torch.autograd.grad(fn(*ins), ins, cots)
    ref = [t.detach().float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(plain(*ref), ref,
                               tuple(c.float() for c in cots))
    parts = [close(g.float(), w, f"{name} d{i}", grad_bar(w))
             for i, (g, w) in enumerate(zip(got, want))]
    return max(p[0] for p in parts), max(p[1] for p in parts)


def reset_counts() -> dict:
    """The training kernels' wrappers, their launch counts set to 0."""
    from repro_torch.launch.train import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0
    return KERNELS


def kernel_grads(dev, card) -> dict:
    """Phase 20 (a): each training Function's gradient against float32
    autograd through its plain version, at the training shapes, with the
    forward's and the backward's device times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        attention_plain, attention_vjp, mha)
    from repro_torch.kernels.moe_gmm.ops import (expert_matmul_plain, gmm,
                                                 gmm_vjp)
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_plain, ssd_vjp
    from repro_torch.launch.bench_kernels import (BF16_OPS_PER_S, flash_bound,
                                                  flash_ops_ms, graph_ms,
                                                  loop_ms)
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=dev).manual_seed(29)
    bf16 = torch.bfloat16
    out = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # ---- flash_attention: gemma-2b's training shape, then a capped,
    # windowed one (gemma2-9b's heads) and a cross attention (seamless's)
    rows = []
    g2 = get_config(TRAIN_ARCH)
    g9, sm = get_config(ARCH), get_config(ENCDEC_ARCH)
    for label, c_, sq, sk, causal, window, cap in (
            (TRAIN_ARCH, g2, TRAIN_SEQ, TRAIN_SEQ, True, 0, 0.0),
            (f"{ARCH}-like, window 1024, cap 50", g9, TRAIN_SEQ, TRAIN_SEQ,
             True, 1024, 50.0),
            (f"{ENCDEC_ARCH} cross", sm, TRAIN_SEQ, TRAIN_SEQ // 4, False,
             0, 0.0)):
        hq, hkv, d = c_.num_heads, c_.num_kv_heads, c_.resolved_head_dim
        opts = dict(causal=causal, window=window, logit_cap=cap,
                    scale=tfm._attn_scale(c_))
        # the model's [B, S, H, D] tensors, handed over as views
        q = randn(TRAIN_BATCH, sq, hq, d)
        k = randn(TRAIN_BATCH, sk, hkv, d)
        v = randn(TRAIN_BATCH, sk, hkv, d)
        dout = randn(TRAIN_BATCH, sq, hq, d)

        def kern(q_, k_, v_):
            return mha(q_.transpose(1, 2), k_.transpose(1, 2),
                       v_.transpose(1, 2), **opts)

        def plain(q_, k_, v_):
            return attention_plain(q_.transpose(1, 2), k_.transpose(1, 2),
                                   v_.transpose(1, 2), **opts)
        err, share = grad_check(f"flash_attention {label}", kern, plain,
                                (q, k, v), (dout.transpose(1, 2),), bf16)
        row = {"shape": f"{label}: B={TRAIN_BATCH}, {hq}/{hkv} heads of "
                        f"{d}, Sq={sq}, Sk={sk}, "
                        f"{'causal' if causal else 'non-causal'}",
               "max_abs_err": err, "bar_share": share}
        if label == TRAIN_ARCH:
            qb, kb, vb, db = (t.to(bf16).transpose(1, 2)
                              for t in (q, k, v, dout))
            with torch.no_grad():
                row["ms"] = graph_ms(lambda: mha(qb, kb, vb, **opts),
                                     [()], 10)
                row["backward_ms"] = graph_ms(lambda: attention_vjp(
                    qb, kb, vb, db, **opts), [()], 5)
            qc, kc, vc = (t.contiguous().requires_grad_(True)
                          for t in (qb, kb, vb))
            dc = db.contiguous()
            with torch.no_grad():
                row["library_ms"] = graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=True, scale=opts["scale"],
                        enable_gqa=True), [()], 10)

            def sdpa_train():
                o = F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, scale=opts["scale"],
                    enable_gqa=True)
                torch.autograd.grad(o, (qc, kc, vc), dc)
            row["library_train_ms"] = loop_ms(sdpa_train, [()], 5)
            row["bound_ms"], row["bound_by"] = flash_bound(
                TRAIN_BATCH, hq, hkv, d, sq, sk, True)
            ops_ms = flash_ops_ms(TRAIN_BATCH, hq, d, sq, sk, True)
            # the backward: five products (the scores again, dV, dP, dQ,
            # dK); q, k, v and dO read, dQ, dK and dV written
            row["backward_bound_ms"] = max(
                2.5 * ops_ms, 2e3 * TRAIN_BATCH * d
                * (3 * sq * hq + 4 * sk * hkv) / HBM_BYTES_PER_S)
            del qb, kb, vb, db, qc, kc, vc, dc
        rows.append(row)
        del q, k, v, dout
        torch.cuda.empty_cache()
    out["flash_attention"] = rows
    k3 = rows[0]
    say(f"phase 20 flash_attention gradients (bf16 against float32 "
        f"autograd through the plain version): "
        + "; ".join(f"{r['shape']}: max abs err {r['max_abs_err']:.4g}, "
                    f"{r['bar_share']:.3f} of the bar" for r in rows)
        + f"; at {TRAIN_ARCH}'s shape forward {k3['ms']:.4f} ms, backward "
        f"(attention_vjp, PyTorch) {k3['backward_ms']:.4f} ms; bound "
        f"{k3['bound_ms']:.4f} / {k3['backward_bound_ms']:.4f} ms "
        f"({k3['bound_by']}); SDPA forward {k3['library_ms']:.4f} ms, forward + "
        f"backward {k3['library_train_ms']:.4f} ms (event-timed loop) "
        f"[{card}]")

    # ---- expert_matmul at granite's training capacity: B x S = 4,096
    # tokens, C = 1,024; the gate/up and the down products
    from repro_torch.models.moe import moe_capacity
    gm = get_config(MOE_ARCH)
    e, d, f = gm.moe.num_experts, gm.d_model, gm.moe.expert_ff
    c = moe_capacity(TRAIN_BATCH * TRAIN_SEQ, gm.moe)
    rows = []
    for dd, ff in ((d, f), (f, d)):
        buf = randn(e, c, dd)
        w = randn(e, dd, ff, scale=0.02)
        dout = randn(e, c, ff)
        err, share = grad_check(f"expert_matmul {dd}x{ff}", gmm,
                                expert_matmul_plain, (buf, w), (dout,),
                                bf16)
        bb, wb, db = buf.to(bf16), w.to(bf16), dout.to(bf16)
        n0 = gmm.launches
        with torch.no_grad():
            gmm_vjp(bb, wb, db)
        if gmm.launches != n0 + 2:
            raise AssertionError("gmm_vjp did not launch the kernel twice")
        ops_ms = 2e3 * e * c * dd * ff / BF16_OPS_PER_S
        bytes_ms = 2e3 * (e * c * dd + e * dd * ff + e * c * ff) \
            / HBM_BYTES_PER_S
        rows.append({
            "shape": f"E={e}, C={c}, D={dd}, F={ff}", "max_abs_err": err,
            "bar_share": share,
            "ms": graph_ms(lambda: gmm(bb, wb), [()], 10),
            "backward_ms": graph_ms(lambda: gmm_vjp(bb, wb, db), [()], 10),
            "library_ms": graph_ms(lambda: torch.bmm(bb, wb), [()], 10),
            "bound_ms": max(ops_ms, bytes_ms),
            # two products of the same size; buf, w and dout read, dbuf
            # and dw written
            "backward_bound_ms": max(
                2 * ops_ms, 2e3 * (2 * e * c * dd + 2 * e * dd * ff
                                   + e * c * ff) / HBM_BYTES_PER_S),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        del buf, w, dout, bb, wb, db
    out["expert_matmul"] = rows
    say("phase 20 expert_matmul gradients (bf16; the backward is two "
        "kernel launches): " + "; ".join(
            f"{r['shape']}: max abs err {r['max_abs_err']:.4g}, "
            f"{r['bar_share']:.3f} of the bar, forward {r['ms']:.4f} ms, "
            f"backward {r['backward_ms']:.4f} ms (bmm {r['library_ms']:.4f}"
            f" ms; bound {r['bound_ms']:.4f} / {r['backward_bound_ms']:.4f}"
            f" ms)" for r in rows) + f" [{card}]")

    # ---- ssd_scan at zamba2's shape
    zc = get_config(HYBRID_ARCH)
    ssm = zc.ssm
    h = ssm.expand * zc.d_model // ssm.head_dim
    p, n, g = ssm.head_dim, ssm.state_dim, ssm.ngroups
    b, s = TRAIN_BATCH, TRAIN_SEQ
    x = randn(b, s, h, p)
    dt = F.softplus(randn(b, s, h)) * 0.1
    A = -torch.exp(randn(h, scale=0.3))
    B = randn(b, s, g, n, scale=0.5)
    C = randn(b, s, g, n, scale=0.5)
    dy, dst = randn(b, s, h, p), randn(b, h, p, n)
    chunk = ssm.chunk_size
    err, share = grad_check(
        "ssd_scan", lambda *a: ssd(*a, chunk=chunk),
        lambda *a: ssd_plain(*a, chunk=chunk), (x, dt, A, B, C), (dy, dst),
        torch.float32)
    with torch.no_grad():
        fwd = graph_ms(lambda: ssd(x, dt, A, B, C, chunk=chunk), [()], 10)
        bwd = graph_ms(lambda: ssd_vjp(x, dt, A, B, C, dy, dst,
                                       chunk=chunk), [()], 5)
    out["ssd_scan"] = {"shape": f"B={b}, S={s}, H={h}, P={p}, N={n}, "
                                f"G={g}, chunk {chunk}",
                       "max_abs_err": err, "bar_share": share, "ms": fwd,
                       "backward_ms": bwd}
    say(f"phase 20 ssd_scan gradients (float32, cotangents for y and the "
        f"final state; {out['ssd_scan']['shape']}): max abs err {err:.4g}, "
        f"{share:.3f} of the bar; forward {fwd:.4f} ms, backward (ssd_vjp, "
        f"PyTorch) {bwd:.4f} ms [{card}]")
    del x, dt, A, B, C, dy, dst
    torch.cuda.empty_cache()
    return out


def train_wiring(dev, card) -> dict:
    """Phase 20 (b): in float32 at full width and cut depth, the loss and
    every gradient leaf through the kernels against the same model with
    the kernels swapped for their plain versions (``mock.patch.object``,
    as ``lm_path`` does).  An MoE's plain run replays the kernel run's
    expert choices, so that a router tie broken the other way by a
    float32 rounding does not move a token to another expert; the tokens
    whose choice would have differed are counted."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.training.step import batch_to
    entries = kernel_entries()
    out = {}
    for name, layers in ((TRAIN_ARCH, 2), (MOE_ARCH, 2), (HYBRID_ARCH, 6)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), num_layers=layers,
                                  dtype="float32")
        params = tfm.init_params(cfg, 0, device=dev).requires_grad_(True)
        leaves = list(params.parameters())
        batch = batch_to(cfg, make_batch(cfg, ShapeConfig(
            "wiring", TRAIN_SEQ, WIRING_TRAIN_BATCH, "train"), 0), dev)
        chosen, flips = [], [0]
        real_top_k = moe.top_k

        def recording(x, k):
            vals, idx = real_top_k(x, k)
            chosen.append(idx)
            return vals, idx

        def replaying(x, k):
            idx = chosen[len(chosen) - replaying.left]
            replaying.left -= 1
            mine = real_top_k(x, k)[1].sort(-1).values
            flips[0] += int((mine != idx.sort(-1).values).any(-1).sum())
            return x.gather(-1, idx), idx

        def run(swap):
            with contextlib.ExitStack() as swaps:
                for mod, attr, fn in swap:
                    swaps.enter_context(mock.patch.object(mod, attr, fn))
                loss, _ = tfm.loss_fn(params, cfg, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            return loss.detach(), grads

        kernels = reset_counts()
        loss_k, g_k = run([(moe, "top_k", recording)])
        launches = {k: fn.launches for k, fn in kernels.items()
                    if fn.launches}
        replaying.left = len(chosen)
        loss_p, g_p = run([(mod, attr, plain) for mod, attr, _, plain, _ in
                           entries.values()] + [(moe, "top_k", replaying)])
        loss_err = abs(float(loss_k) - float(loss_p))
        share = 0.0
        for (pname, _), gk, gp in zip(params.named_parameters(), g_k, g_p):
            top = float(gp.abs().max())
            err = float((gk - gp).abs().max())
            if not (bool(torch.isfinite(gk).all()) and err <= 1e-3 * top):
                raise AssertionError(
                    f"{name} float32 wiring: d{pname} through the kernels "
                    f"is {err} from the plain versions' (bar 1e-3 x "
                    f"{top})")
            share = max(share, err / (1e-3 * top) if top else 0.0)
        if not loss_err <= 1e-5 * abs(float(loss_p)):
            raise AssertionError(f"{name} float32 wiring: loss {loss_k} "
                                 f"vs {loss_p}")
        out[name] = {"layers": layers, "loss": float(loss_k),
                     "loss_abs_err": loss_err, "grad_bar_share": share,
                     "launches": launches, "router_flips": flips[0],
                     "wall_s": time.perf_counter() - t0}
        say(f"phase 20 wiring float32 {name} ({layers} layers, B="
            f"{WIRING_TRAIN_BATCH}, S={TRAIN_SEQ}): loss {float(loss_k):.6f}"
            f", kernels vs plain |dloss| {loss_err:.3g}; every gradient "
            f"leaf within {share:.3f} of 1e-3 x its max |grad| at worst; "
            f"kernel launches {launches}; tokens whose expert choice the "
            f"plain run would have flipped: {flips[0]} [{card}]")
        del params, leaves, batch, g_k, g_p, chosen
        gc.collect()
        torch.cuda.empty_cache()
    return out


def trainer_run(dev, card) -> dict:
    """Phase 20 (c): ``launch/train.py`` trains gemma-2b at full width
    with a simulated pod failure; its weights are served (``generate``
    and a flight of 2, equal tokens); a reduced bf16 state's checkpoint
    round-trips on the card bitwise."""
    import shutil
    import torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch import train
    from repro_torch.launch.bench_kernels import BF16_OPS_PER_S
    from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                            demo_requests)
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import init_train_state, make_train_step
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_counts()
    res = {}
    t0 = time.perf_counter()
    rc = train.main(["--arch", TRAIN_ARCH, "--device", dev.type,
                     "--steps", str(TRAIN_STEPS),
                     "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                     "--simulate-failure-at", str(TRAIN_FAIL_AT)],
                    result=res)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, hist, cfg = res["state"], res["history"], res["cfg"]
    n_par = sum(p.numel() for p in state["params"].parameters())
    if rc != 0 or len(hist) != TRAIN_STEPS:
        raise AssertionError(f"the trainer returned {rc} after "
                             f"{len(hist)} steps")
    for rec in hist:
        rec["peak_share"] = 6 * n_par * tokens / (rec["ms"] / 1e3) \
            / BF16_OPS_PER_S
        say(f"phase 20 train {TRAIN_ARCH} step {rec['step']}: loss "
            f"{rec['loss']:.4f}, grad norm {rec['grad_norm']:.4f}, "
            f"{rec['ms']:.1f} ms, {rec['tokens_per_s']:.0f} tokens/s, "
            f"{rec['peak_share']:.4f} of the bf16 peak (6 x {n_par:,} x "
            f"{tokens} / step / 989e12), launches {rec['launches']}"
            + (" (pod 1 failed: its samples weigh 0)"
               if rec["step"] == TRAIN_FAIL_AT else "") + f" [{card}]")
        if not math.isfinite(rec["loss"]) or \
                rec["launches"]["flash_attention"] != cfg.num_layers or \
                rec["launches"]["expert_matmul"] or \
                rec["launches"]["ssd_scan"]:
            raise AssertionError(f"{TRAIN_ARCH} step {rec['step']}: loss "
                                 f"{rec['loss']}, launches "
                                 f"{rec['launches']}")
    if launches["flash_attention"] != TRAIN_STEPS * cfg.num_layers:
        raise AssertionError(f"the trainer launched {launches}")
    warm = [r["ms"] for r in hist[1:]]
    say(f"phase 20 train {TRAIN_ARCH}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_par:,} parameters ({cfg.dtype}, moments "
        f"{cfg.optimizer_state_dtype}), B={TRAIN_BATCH}, S={TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps in {wall:.1f} s wall (init included); warm "
        f"steps mean {sum(warm) / len(warm):.1f} ms, peak memory "
        f"{peak_gb:.2f} GB; launches {launches} [{card}]")

    # serve the trained weights: generate and a flight of 2
    t0 = time.perf_counter()
    req = demo_requests(cfg, LM_BATCH, TRAIN_SERVE_PROMPT, seed=0,
                        device=dev)
    eng = ServingEngine(cfg, state["params"], ServeConfig(
        max_len=TRAIN_SERVE_PROMPT + DECODE_STEPS + 8,
        decode_steps=DECODE_STEPS, flight_size=2), device=dev)
    ref = eng.generate(req)
    flown = eng.generate_flight(req)
    if flown.tokens.shape != (LM_BATCH, DECODE_STEPS) or not (
            flown.tokens == ref.tokens).all():
        raise AssertionError("the trained weights' flight tokens differ "
                             "from generate's")
    serve_s = time.perf_counter() - t0
    say(f"phase 20 serve the trained {TRAIN_ARCH}: generate "
        f"{ref.latency_s * 1e3:.1f} ms, flight of 2 "
        f"{flown.latency_s * 1e3:.1f} ms, tokens equal ({LM_BATCH} prompts "
        f"of {TRAIN_SERVE_PROMPT}, {DECODE_STEPS} steps) [{card}]")
    del eng, state, res
    gc.collect()
    torch.cuda.empty_cache()

    # the checkpoint round trip on the card at reduced size, in bf16 (a
    # head dim the attention kernel takes)
    cfg_r = dataclasses.replace(reduced_config(get_config(TRAIN_ARCH)),
                                head_dim=32, dtype="bfloat16")
    oc = OptConfig(total_steps=4, state_dtype="bfloat16")
    st = init_train_state(cfg_r, oc, 0, device=dev)
    st, _ = make_train_step(cfg_r, oc, device=dev)(
        st, make_batch(cfg_r, ShapeConfig("ckpt", 64, 2, "train"), 0))
    where = ROOT / "build" / "phase20_ckpt"
    shutil.rmtree(where, ignore_errors=True)
    try:
        ckpt_io.save(str(where), 1, st)
        back, _ = ckpt_io.restore(str(where), init_train_state(
            cfg_r, oc, 1, device=dev))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    want, got = dict(ckpt_io._flatten(st)), dict(ckpt_io._flatten(back))
    for key, t in want.items():
        g = got[key]
        if g.device != t.device or g.dtype != t.dtype or \
                not torch.equal(g.detach(), t.detach()):
            raise AssertionError(f"checkpoint round trip: {key} differs")
    say(f"phase 20 checkpoint: a reduced bf16 {TRAIN_ARCH} state ({len(want)}"
        f" leaves, bf16 moments) through npz and back to "
        f"{dev.type}, bitwise "
        f"[{card}]")
    return {"arch": TRAIN_ARCH, "params": n_par, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": hist, "launches": launches,
            "peak_memory_gb": peak_gb, "wall_s": wall,
            "serve_generate_s": ref.latency_s,
            "serve_flight_s": flown.latency_s, "serve_wall_s": serve_s}


def full_depth_steps(dev, card) -> dict:
    """Phase 20 (d): granite-moe-3b-a800m and zamba2-1.2b at full width
    and depth, two steps each through ``make_train_step`` with remat on;
    the loss finite and every kernel's launches exact per step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import (StepOptions, init_train_state,
                                           make_train_step)
    out = {}
    for name in (MOE_ARCH, HYBRID_ARCH):
        cfg = get_config(name)
        n = cfg.num_layers
        if cfg.moe:        # forward and recomputed; two per product back
            want = {"flash_attention": 2 * n, "expert_matmul": 12 * n,
                    "ssd_scan": 0}
        else:              # the shared block is not rematerialised
            want = {"flash_attention": n // cfg.hybrid_attn_every,
                    "expert_matmul": 0, "ssd_scan": 2 * n}
        oc = OptConfig(warmup_steps=5, total_steps=2,
                       state_dtype=cfg.optimizer_state_dtype)
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, oc, 0, device=dev)
        step = make_train_step(cfg, oc, options=StepOptions(remat=True),
                               device=dev)
        steps = []
        for i in range(2):
            batch = make_batch(cfg, ShapeConfig("full", TRAIN_SEQ,
                                                TRAIN_BATCH, "train"), i)
            kernels = reset_counts()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: fn.launches for k, fn in kernels.items()}
            loss = float(m["loss"])
            if got != want or not math.isfinite(loss):
                raise AssertionError(f"{name} step {i}: loss {loss}, "
                                     f"launches {got}, expected {want}")
            steps.append({"loss": loss, "aux": float(m["aux"]),
                          "grad_norm": float(m["grad_norm"]), "ms": ms,
                          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                          / (ms / 1e3), "launches": got})
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_par = sum(p.numel() for p in state["params"].parameters())
        out[name] = {"params": n_par, "steps": steps,
                     "peak_memory_gb": peak}
        say(f"phase 20 train {name} (full depth, remat, B={TRAIN_BATCH}, "
            f"S={TRAIN_SEQ}, {n_par:,} parameters): " + "; ".join(
                f"step {i}: loss {s['loss']:.4f}, {s['ms']:.1f} ms, "
                f"{s['tokens_per_s']:.0f} tokens/s"
                for i, s in enumerate(steps))
            + f"; launches per step {want}; peak memory {peak:.2f} GB "
            f"[{card}]")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def training_phase(dev, card) -> dict:
    """Phase 20: the training path (see the module docstring)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    walls = {}
    out = {}
    for key, fn in (("kernel_grads", kernel_grads),
                    ("wiring", train_wiring), ("trainer", trainer_run),
                    ("full_depth", full_depth_steps)):
        t0 = time.perf_counter()
        out[key] = fn(dev, card)
        walls[key] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    say("phase 20 walls s " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()) + f" [{card}]")
    return out

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def flight_collectives(dev, card) -> dict:
    """Phase 21 (a): the flight collectives on CUDA tensors over the
    one-rank NCCL group: the rank adopts its own value (winner 0), is the
    whole mean when healthy and (0, 0) when not, and is the k=1 mean."""
    import torch
    from repro_torch.core import distops
    v = torch.arange(1, 7, dtype=torch.float32, device=dev)
    adopted, winner = distops.first_finisher({"v": v, "h": v.bfloat16()},
                                             2.5)
    m0, n0 = distops.masked_mean(v, 0.0)
    m1, n1 = distops.masked_mean(v, 1.0)
    km = distops.k_of_n_mean(v, 1.0, 1)
    got = dict(winner=int(winner), n_unhealthy=float(n0),
               mean_unhealthy=float(m0.abs().max()), n_healthy=float(n1))
    if not (got == dict(winner=0, n_unhealthy=0.0, mean_unhealthy=0.0,
                        n_healthy=1.0) and torch.equal(adopted["v"], v)
            and torch.equal(adopted["h"], v.bfloat16())
            and torch.equal(m1, v) and torch.equal(km, v)):
        raise AssertionError(f"flight collectives on one rank: {got}")
    say(f"phase 21 flight collectives (NCCL, 1 rank, CUDA tensors): "
        f"first_finisher adopts its own value (winner 0, a bf16 leaf too),"
        f" masked_mean unhealthy (0, 0) and healthy (v, 1), k_of_n_mean "
        f"k=1 its own value [{card}]")
    return got


def ep_serve(dev, card) -> dict:
    """Phase 21 (b): granite-moe-3b-a800m served at full width through
    ``moe_block_ep`` (``EPSpec`` over the (data=1, model=1) mesh and
    ``Plan.constrain``) and without, phase 12's traffic: the greedy
    tokens equal, the kernel launches equal, two exchanges a MoE layer a
    step, each skipped (the identity over the one-rank model group); then
    a prefill and WIRING_STEPS teacher-forced steps under EP with every
    expert_matmul call held to its plain version."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import functional as dfn
    from repro_torch.distributed.sharding import Plan
    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                            demo_requests)
    entries = kernel_entries()
    cfg = get_config(MOE_ARCH)
    mesh = make_host_mesh(1, 1)
    plan = Plan(mesh, cfg)
    ep = moe.EPSpec(mesh, batch_axes(mesh))
    params = tfm.init_params(cfg, 0, device=dev)
    batches = [demo_requests(cfg, LM_BATCH, PROMPT2, seed=i, device=dev)
               for i in range(LM_BATCHES)]
    wrappers = {name: entries[name][2] for name in
                ("expert_matmul", "flash_attention", "decode_attention")}
    runs = {}
    for tag, kw in (("plain", {}), ("ep", dict(constrain=plan.constrain,
                                               ep=ep))):
        eng = ServingEngine(cfg, params, ServeConfig(
            max_len=MAX_LEN2, decode_steps=DECODE_STEPS), device=dev, **kw)
        eng.warmup(batches[0])
        before = {n: fn.launches for n, fn in wrappers.items()}
        a2a, skip = dfn.all_to_all.calls, dfn.all_to_all.skipped
        res = [eng.generate(b) for b in batches]
        runs[tag] = dict(
            tokens=np.stack([r.tokens for r in res]),
            launches={n: fn.launches - before[n]
                      for n, fn in wrappers.items()},
            all_to_all=dfn.all_to_all.calls - a2a,
            all_to_all_skipped=dfn.all_to_all.skipped - skip,
            prefill_ms=[r.prefill_s * 1e3 for r in res],
            decode_ms_per_step=[r.decode_s * 1e3 / DECODE_STEPS
                                for r in res])
        del eng
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    passes = LM_BATCHES * (1 + DECODE_STEPS)
    plain, epr = runs["plain"], runs["ep"]
    if not np.array_equal(plain["tokens"], epr["tokens"]):
        raise AssertionError(f"{MOE_ARCH}: EP tokens differ from the "
                             f"non-EP path's")
    if epr["launches"] != plain["launches"] or \
            plain["launches"]["expert_matmul"] != 3 * n_moe * passes or \
            epr["all_to_all_skipped"] != 2 * n_moe * passes or \
            epr["all_to_all"] or plain["all_to_all"] or \
            plain["all_to_all_skipped"]:
        raise AssertionError(f"{MOE_ARCH}: launches EP {epr['launches']} "
                             f"vs {plain['launches']}, all-to-alls made "
                             f"{epr['all_to_all']}, skipped "
                             f"{epr['all_to_all_skipped']}")
    say(f"phase 21 {MOE_ARCH} under EP ((data=1, model=1) DeviceMesh, "
        f"NCCL): {LM_BATCHES} batches of {LM_BATCH} x {PROMPT2} prompts, "
        f"{DECODE_STEPS} greedy steps: tokens equal the non-EP path's; "
        f"launches {epr['launches']} (non-EP {plain['launches']}); "
        f"{epr['all_to_all_skipped']} exchanges, each skipped on the "
        f"one-rank model group ({epr['all_to_all']} made); prefill ms EP "
        + ", ".join(f"{t:.1f}" for t in epr["prefill_ms"]) + " vs "
        + ", ".join(f"{t:.1f}" for t in plain["prefill_ms"])
        + "; decode ms/step EP "
        + ", ".join(f"{t:.3f}" for t in epr["decode_ms_per_step"]) + " vs "
        + ", ".join(f"{t:.3f}" for t in plain["decode_ms_per_step"])
        + f" [{card}]")

    # what the skip saves: one NCCL exchange on the one-rank group at
    # decode's buffer (C=4), beside a copy of it, a call's pace in an
    # event-timed loop
    import torch.distributed as dist
    from repro_torch.launch.bench_kernels import loop_ms
    small = torch.zeros((cfg.moe.num_experts, 4, cfg.d_model),
                        dtype=torch.bfloat16, device=dev)
    recv = torch.empty_like(small)
    group = mesh.get_group(ep.model_axis)
    a2a_ms = loop_ms(lambda b: dist.all_to_all_single(recv, b, group=group),
                     [(small,)], 200)
    copy_ms = loop_ms(lambda b: b.clone(), [(small,)], 200)
    say(f"phase 21 an NCCL all_to_all_single on the one-rank model group "
        f"(the exchange the EP path skips there), decode's "
        f"[{cfg.moe.num_experts}, 4, {cfg.d_model}] bf16 buffer: "
        f"{a2a_ms:.4f} ms a call (event-timed loop; a clone of it "
        f"{copy_ms:.4f} ms) [{card}]")

    # the wiring under EP: every expert_matmul call against its plain version
    _, _, kernel, plain_fn, _ = entries["expert_matmul"]
    rec = [0, 0.0, 0.0]

    def shadowed(buf, w):
        out = kernel(buf, w)
        err, share = close(out, plain_fn(buf, w), f"{MOE_ARCH} EP gmm")
        rec[:] = rec[0] + 1, max(rec[1], err), max(rec[2], share)
        return out
    forced = torch.as_tensor(epr["tokens"][0][:, :WIRING_STEPS], device=dev)
    with mock.patch.object(moe, "gmm", shadowed), torch.inference_mode():
        a2a = dfn.all_to_all.skipped
        _, cache = tfm.prefill(params, cfg, batches[0], MAX_LEN2,
                               constrain=plan.constrain, ep=ep)
        for i in range(WIRING_STEPS):
            _, cache = tfm.decode_step(params, cfg, cache,
                                       forced[:, i:i + 1],
                                       constrain=plan.constrain, ep=ep)
        wiring_a2a = dfn.all_to_all.skipped - a2a
        del cache
    if rec[0] != 3 * n_moe * (1 + WIRING_STEPS) or \
            wiring_a2a != 2 * n_moe * (1 + WIRING_STEPS):
        raise AssertionError(f"EP wiring made {rec[0]} expert_matmul calls "
                             f"and skipped {wiring_a2a} exchanges")
    say(f"phase 21 EP wiring (prefill + {WIRING_STEPS} teacher-forced "
        f"steps): expert_matmul {rec[0]} calls on [E_loc, tp*C, D] "
        f"buffers, each against its plain version: max abs err "
        f"{rec[1]:.4g}, {rec[2]:.3f} of its bar at worst [{card}]")
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(plain={k: v for k, v in plain.items() if k != "tokens"},
                ep={k: v for k, v in epr.items() if k != "tokens"},
                all_to_all_ms=a2a_ms, clone_ms=copy_ms,
                wiring_calls=rec[0], wiring_max_abs_err=rec[1],
                wiring_share=rec[2], wiring_all_to_all=wiring_a2a)


def vlm_wiring_batch(cfg, dev) -> dict:
    """qwen2-vl-2b's wiring prompt: ``demo_requests``' embeddings of
    PROMPT2 with M-RoPE ids of VLM_TEXT text positions, then a VLM_GRID
    patch grid (Qwen2-VL's layout of an image after text)."""
    import torch
    from repro_torch.serving.engine import demo_requests
    text, (rows, cols) = VLM_TEXT, VLM_GRID
    if text + rows * cols != PROMPT2:
        raise AssertionError("the wiring prompt must be PROMPT2 long")
    r = torch.arange(rows * cols, device=dev) // cols
    c = torch.arange(rows * cols, device=dev) % cols
    t_ids = torch.arange(text, device=dev)
    thw = torch.stack([torch.cat([t_ids, torch.full_like(r, text)]),
                       torch.cat([t_ids, text + r]),
                       torch.cat([t_ids, text + c])]).to(torch.int32)
    batch = demo_requests(cfg, LM_BATCH, PROMPT2, seed=0, device=dev)
    batch["positions"] = thw[:, None].expand(3, LM_BATCH, PROMPT2)
    return batch


def padded_heads(dev, card) -> dict:
    """Phase 21 (c): qwen2-vl-2b with ``pad_heads=16`` (12 heads), its
    prefill at full width through flash_attention on the padded heads;
    the logits lie within RMS_K of the bf16 rounding spread from the
    plain versions' float32 logits, as phase 18 holds the unpadded
    ones."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    entries = kernel_entries()
    cfg = get_config(VLM_ARCH)
    cfg16 = dataclasses.replace(cfg, pad_heads=16)
    params = tfm.init_params(cfg, 0, device=dev)
    batch = vlm_wiring_batch(cfg, dev)
    mha, plain = entries["flash_attention"][2], entries["flash_attention"][3]

    def logits(c, b, swap=None):
        with contextlib.ExitStack() as st, torch.inference_mode():
            if swap is not None:
                st.enter_context(mock.patch.object(layers, "mha", swap))
            out = tfm.prefill(params, c, b, PROMPT2 + 8)[0].float()
        torch.cuda.synchronize()
        return out
    logits(cfg16, batch)                        # warm
    n0 = mha.launches
    t0 = time.perf_counter()
    padded = logits(cfg16, batch)
    padded_ms = (time.perf_counter() - t0) * 1e3
    launches = mha.launches - n0
    t0 = time.perf_counter()
    unpadded = logits(cfg, batch)
    unpadded_ms = (time.perf_counter() - t0) * 1e3
    plain16 = logits(cfg, batch, plain)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for w in params.parameters():
        w.data = w.data.float()
    b32 = {k: (t.float() if t.is_floating_point() else t)
           for k, t in batch.items()}
    plain32 = logits(cfg32, b32, plain)
    del params

    def rms(a, b):
        return float((a - b).square().mean().sqrt())
    noise, pad_rms = rms(plain16, plain32), rms(padded, plain32)
    kern_rms, pad_vs_unpad = rms(unpadded, plain32), rms(padded, unpadded)
    if padded.shape != (LM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(padded).all()):
        raise AssertionError(f"padded logits {padded.shape} not finite")
    if launches != cfg.num_layers:
        raise AssertionError(f"padded prefill launched flash_attention "
                             f"{launches} times")
    if not pad_rms <= RMS_K * noise:
        raise AssertionError(
            f"{VLM_ARCH} pad_heads=16: the logits lie further from float32 "
            f"(rms {pad_rms}) than {RMS_K} x the plain versions' bf16 "
            f"logits do (rms {noise})")
    say(f"phase 21 {VLM_ARCH} pad_heads=16 ({cfg.num_heads} heads, "
        f"{cfg.num_kv_heads} KV heads repeated and padded): prefill of "
        f"{LM_BATCH} x {PROMPT2} through flash_attention on 16 heads "
        f"({launches} launches) {padded_ms:.1f} ms (unpadded "
        f"{unpadded_ms:.1f} ms); logits rms from the plain float32: padded "
        f"{pad_rms:.4g}, unpadded {kern_rms:.4g}, plain bf16 {noise:.4g} "
        f"(bar {RMS_K} x); padded vs unpadded "
        f"rms {pad_vs_unpad:.4g} [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, padded_ms=padded_ms,
                unpadded_ms=unpadded_ms, padded_rms=pad_rms,
                unpadded_rms=kern_rms, bf16_rms=noise,
                padded_vs_unpadded_rms=pad_vs_unpad)


def dp_steps(dev, card) -> dict:
    """Phase 21 (d): data parallelism over batch blocks
    (``make_train_step(..., batch_blocks=plan)``: replicated weights, the
    batch shard, the MoE dispatch over the whole batch, the gradient mean
    over the batch axes by NCCL) on granite-moe-3b-a800m at full width,
    depth cut to DP_MOE_LAYERS: two steps through a plan over the
    one-rank (data=1, model=1) mesh and the same two steps without it,
    from the same seed, loss and grad norm bitwise equal; and gemma-2b's
    two steps at full width without a plan, which phase 22 (a)'s sharded
    steps are held to."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.sharding import Plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import (StepOptions, init_train_state,
                                           make_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    wrappers = {n: e[2] for n, e in kernel_entries().items()
                if n in ("flash_attention", "expert_matmul")}

    def two_steps(cfg, **kw):
        oc = OptConfig(warmup_steps=5, total_steps=TRAIN_STEPS,
                       state_dtype=cfg.optimizer_state_dtype)
        shape = ShapeConfig("dp", TRAIN_SEQ, TRAIN_BATCH, "train")
        state = init_train_state(cfg, oc, 0, device=dev)
        step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                               device=dev, **kw)
        before = {n: fn.launches for n, fn in wrappers.items()}
        recs = []
        for i in range(2):
            batch = make_batch(cfg, shape, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            recs.append(dict(loss=m["loss"].item(),
                             grad_norm=m["grad_norm"].item(),
                             ms=(time.perf_counter() - t0) * 1e3))
        launches = {n: fn.launches - before[n] for n, fn in wrappers.items()}
        del state, step, m
        gc.collect()
        torch.cuda.empty_cache()
        return recs, launches
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  num_layers=DP_MOE_LAYERS)
    plan = Plan(make_host_mesh(1, 1), moe_cfg)
    runs, launches = {}, {}
    for tag, kw in (("plain", {}), ("blocks", dict(batch_blocks=plan))):
        runs[tag], launches[tag] = two_steps(moe_cfg, **kw)
    for a, b in zip(runs["plain"], runs["blocks"]):
        if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
            raise AssertionError(f"{MOE_ARCH} batch-block steps differ "
                                 f"from the plain steps: {runs}")
    say(f"phase 21 {MOE_ARCH} ({DP_MOE_LAYERS} of "
        f"{get_config(MOE_ARCH).num_layers} layers) data-parallel steps by "
        f"batch blocks (batch_blocks=plan, 1-rank mesh, B={TRAIN_BATCH} x "
        f"{TRAIN_SEQ}; {held_gb:.1f} GB held before): loss and grad norm "
        f"bitwise equal to the steps without it: " + "; ".join(
            f"step {i + 1} loss {a['loss']:.6f} grad norm "
            f"{a['grad_norm']:.6f}, {a['ms']:.1f} ms (plain {p['ms']:.1f})"
            for i, (a, p) in enumerate(zip(runs["blocks"], runs["plain"])))
        + f"; launches {launches['blocks']} [{card}]")
    gemma, gemma_launches = two_steps(get_config(TRAIN_ARCH))
    say(f"phase 21 {TRAIN_ARCH} two steps without a plan (B={TRAIN_BATCH} "
        f"x {TRAIN_SEQ}, phase 22 (a)'s reference): " + "; ".join(
            f"step {i + 1} loss {a['loss']:.6f} grad norm "
            f"{a['grad_norm']:.6f}, {a['ms']:.1f} ms"
            for i, a in enumerate(gemma)) + f" [{card}]")
    return dict(moe=runs, gemma=gemma, launches=launches["blocks"],
                plain_launches=launches["plain"],
                gemma_launches=gemma_launches)


DIST_SWEEP_JOBS, DIST_SWEEP_TRIALS = 2048, 16


def config_mesh_sweep(dev, card) -> dict:
    """Phase 21 (e): the closed-loop load sweep (HA, keygen, three loads)
    on the kernel routes through the one-rank config mesh, bitwise equal
    to ``devices=None``."""
    import torch
    from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
    from repro_torch.kernels.queue_booking.ops import book_stream
    from repro_torch.launch.mesh import make_config_mesh
    from repro_torch.sim import experiments as X
    from repro_torch.sim.vector_queue import keygen_queue, load_sweep
    kw = dict(jobs=DIST_SWEEP_JOBS, trials=DIST_SWEEP_TRIALS, seed=0,
              device=dev, booking_backend="kernel", scan="logdepth",
              block=DIST_SWEEP_JOBS // LOGDEPTH_NB, summary_backend="kernel",
              **X.HA)
    mesh = make_config_mesh()
    b0, m0 = book_stream.launches, maxplus_entries.launches
    t0 = time.perf_counter()
    got = load_sweep(keygen_queue(), devices=mesh, **kw)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = {"queue_booking": book_stream.launches - b0,
                "maxplus_scan": maxplus_entries.launches - m0}
    t0 = time.perf_counter()
    want = load_sweep(keygen_queue(), devices=None, **kw)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    if json.dumps(got, sort_keys=True) != json.dumps(want, sort_keys=True):
        raise AssertionError(f"the config-mesh sweep {got} != {want}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the sweep never launched: "
                             f"{launches}")
    say(f"phase 21 load sweep over the config mesh (1 rank, HA, "
        f"{DIST_SWEEP_JOBS} jobs x {DIST_SWEEP_TRIALS} trials x 3 loads, "
        f"kernel routes): bitwise equal to devices=None; launches "
        f"{launches}; {mesh_s:.2f} s (devices=None {solo_s:.2f} s); ratios "
        + ", ".join(f"{k} {v['mean_ratio']:.4f}" for k, v in got.items())
        + f" [{card}]")
    return dict(launches=launches, mesh_s=mesh_s, solo_s=solo_s)


def dry_run(card) -> dict:
    """Phase 21 (f): the dry run of every cell on both production meshes
    (abstract, ``meta`` tensors)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = dryrun.run_all(meshes=(False, True), echo=lambda m: None,
                          count=False)
    wall = time.perf_counter() - t0
    ok = sum(r["ok"] for r in recs)
    if ok != len(recs):
        raise AssertionError(f"dry run: {[r for r in recs if not r['ok']]}")
    big = next(r for r in recs if r["arch"] == "llama4-maverick-400b-a17b"
               and r["shape"] == "train_4k" and r["mesh"] == "2x16x16")
    say(f"phase 21 dry run: {ok}/{len(recs)} cells ok on 16x16 and "
        f"2x16x16 in {wall:.2f} s; llama4-maverick-400b-a17b train_4k on "
        f"2x16x16: {big['param_bytes_per_device']:,} parameter bytes and "
        f"{big['opt_bytes_per_device']:,} moment bytes per rank "
        f"({big['params']:,} parameters) [{card}]")
    return dict(cells=len(recs), ok=ok, wall_s=wall,
                llama4_train_4k_2x16x16={
                    k: big[k] for k in ("param_bytes_per_device",
                                        "opt_bytes_per_device", "params")})


def distributed_phase(dev, card) -> dict:
    """Phase 21: the distributed slice on a one-rank NCCL group (see the
    module docstring)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.maxplus_scan.ops import maxplus_entries
    from repro_torch.kernels.queue_booking.ops import book_stream
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    walls, out = {}, {}
    entries = kernel_entries()
    counted = {"queue_booking": book_stream,
               "maxplus_scan": maxplus_entries,
               **{k: entries[k][2] for k in ("flash_attention",
                                             "decode_attention",
                                             "expert_matmul")}}
    try:
        for fn in counted.values():
            fn.launches = 0
        for key, fn in (("collectives", flight_collectives),
                        ("ep_serve", ep_serve),
                        ("padded_heads", padded_heads),
                        ("dp_steps", dp_steps),
                        ("sweep", config_mesh_sweep)):
            t0 = time.perf_counter()
            out[key] = fn(dev, card)
            walls[key] = time.perf_counter() - t0
        every = {k: fn.launches for k, fn in counted.items()}
    finally:
        dist.destroy_process_group()
    # the distributed runs alone: EP serving, the padded heads' prefill,
    # the steps by batch blocks and the sweep over the config mesh; the
    # rest (the runs they are held to, warm-ups, the EP wiring) apart
    out["launches"] = {k: 0 for k in counted}
    for part in (out["ep_serve"]["ep"]["launches"],
                 {"flash_attention": out["padded_heads"]["launches"]},
                 out["dp_steps"]["launches"], out["sweep"]["launches"]):
        for k, n in part.items():
            out["launches"][k] += n
    out["comparison_launches"] = {k: every[k] - out["launches"][k]
                                  for k in counted}
    t0 = time.perf_counter()
    out["dry_run"] = dry_run(card)
    walls["dry_run"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"a kernel of the distributed path never "
                             f"launched: {out['launches']}")
    say(f"phase 21 launches on the distributed runs: {out['launches']}; "
        f"in the runs they are held to, warm-ups and wiring: "
        f"{out['comparison_launches']}; walls s "
        + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()) + f" [{card}]")
    return out


# phase 22: granite's greedy steps, sharded and not; the dry run's counted
# cells (arch, shape, multi-pod), each in a child interpreter on a fake
# group of the mesh's ranks
SHARD_STEPS = 8
COUNT_CELLS = (("gemma-2b", "train_4k", False),
               ("granite-moe-3b-a800m", "decode_32k", False),
               ("llama4-maverick-400b-a17b", "train_4k", True))
# K4's log-sum-exp against its plain version's (float32): atol, rtol, cap
LSE_TOL = (1e-3, 1e-5, 1e-2)


def one_rank_mesh():
    """A (data=1, model=1) DeviceMesh over a one-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    return make_host_mesh(1, 1)


def counted(names):
    """The named LM kernels' wrappers, their launch counts set to 0."""
    entries = kernel_entries()
    wrappers = {n: entries[n][2] for n in names}
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def sharded_train(dev, card, mesh, plain_runs) -> dict:
    """Phase 22 (a): gemma-2b at full width, phase 21 (d)'s two steps
    through the plan with the parameters, AdamW moments and batch as
    DTensors over the one-rank mesh (``Plan.shard_state``): loss and grad
    norm bitwise equal to phase 21's two steps without a plan."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.sharding import Plan
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import (StepOptions, init_train_state,
                                           make_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    oc = OptConfig(warmup_steps=5, total_steps=TRAIN_STEPS,
                   state_dtype=cfg.optimizer_state_dtype)
    shape = ShapeConfig("dp", TRAIN_SEQ, TRAIN_BATCH, "train")
    batches = [make_batch(cfg, shape, i) for i in range(2)]
    plan = Plan(mesh, cfg)
    state = plan.shard_state(init_train_state(cfg, oc, 0, device=dev))
    step = make_train_step(cfg, oc, plan=plan,
                           options=StepOptions(remat=False), device=dev)
    wrappers = counted(("flash_attention",))
    recs = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        recs.append(dict(loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(),
                         ms=(time.perf_counter() - t0) * 1e3))
    launches = {n: fn.launches for n, fn in wrappers.items()}
    local = sum(p.to_local().numel() * p.element_size()
                for p in state["params"].parameters())
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    for a, b in zip(recs, plain_runs):
        if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
            raise AssertionError(f"{TRAIN_ARCH} sharded steps differ from "
                                 f"phase 21's steps without a plan: {recs} "
                                 f"vs {plain_runs}")
    say(f"phase 22 (a) {TRAIN_ARCH} sharded steps (DTensor parameters, "
        f"moments and batch over the (1, 1) mesh, B={TRAIN_BATCH} x "
        f"{TRAIN_SEQ}): loss and grad norm bitwise equal to phase 21's "
        f"steps without a plan: " + "; ".join(
            f"step {i + 1} loss {a['loss']:.6f} grad norm "
            f"{a['grad_norm']:.6f}, {a['ms']:.1f} ms (phase 21 "
            f"{p['ms']:.1f})" for i, (a, p) in enumerate(zip(recs,
                                                            plain_runs)))
        + f"; launches {launches}; {local:,} parameter bytes on the rank "
        f"[{card}]")
    return dict(steps=recs, launches=launches, param_bytes=local)


def sharded_serve(dev, card, mesh, arch, steps) -> dict:
    """Phase 22 (b, c): ``arch`` at full width, a prefill of LM_BATCH
    prompts of PROMPT2 tokens and ``steps`` greedy steps, unsharded and
    then with the parameters and the cache as DTensors over the one-rank
    mesh (``Plan.shard_params``, ``Plan.init_cache``): the logits of the
    prefill and the tokens, and each LM kernel's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Plan
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import demo_requests
    from repro_torch.serving.step import (greedy_sample, make_decode_step,
                                          make_prefill_step)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    plan = Plan(mesh, cfg)
    params = tfm.init_params(cfg, 0, device=dev)
    batch = demo_requests(cfg, LM_BATCH, PROMPT2, seed=0, device=dev)
    runs = {}
    for tag in ("unsharded", "sharded"):
        kw = {"plan": plan} if tag == "sharded" else {}
        if tag == "sharded":
            plan.shard_params(params)
        prefill = make_prefill_step(cfg, MAX_LEN2, **kw)
        decode = make_decode_step(cfg, **kw)
        wrappers = counted(("flash_attention", "decode_attention",
                            "expert_matmul", "ssd_scan"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        if tag == "sharded":
            logits = logits.full_tensor()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        first, toks = logits.clone(), []
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = greedy_sample(logits)
            toks.append(tok)
            logits, cache = decode(params, cache, tok[:, None])
            if tag == "sharded":
                logits = logits.full_tensor()
        torch.cuda.synchronize()
        runs[tag] = dict(
            logits=first, tokens=torch.stack(toks, 1) if toks else None,
            launches={n: fn.launches for n, fn in wrappers.items()},
            prefill_ms=prefill_ms,
            decode_ms=(time.perf_counter() - t0) * 1e3 / max(steps, 1))
        del cache
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def kernel_interfaces(dev, card) -> dict:
    """Phase 22 (d): K3 with a query offset and K4's log-sum-exp at
    gemma2-9b's and granite's shapes, each against its plain version; K4
    over the two halves of a cache merged by their log-sum-exp against
    the plain version over the whole.  K3's queries are an inner block of
    a quarter of the sequence, its keys whole: the block ends a quarter
    of a block before the last key, so that the offset differs from the
    default (keys - queries, the last block's) and, with gemma2-9b's
    window, the window's edge falls inside the block."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain, gqa_decode, merge_parts)
    from repro_torch.kernels.flash_attention.ops import attention_plain, mha
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for arch, s in ((ARCH, PROMPT), (MOE_ARCH, PROMPT2)):
        cfg = get_config(arch)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        scale, cap = tfm._attn_scale(cfg), cfg.attn_logit_softcap
        window = cfg.window_size if cfg.attn_pattern != "global" else 0

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)
        blk = s // 4
        off = s - blk - blk // 4
        if off == s - blk or (window and off + blk - 1 < window):
            raise AssertionError(f"{arch}: q_offset {off} is the default "
                                 f"or misses the window's edge")
        q, k, v = rand(LM_BATCH, blk, hq, d), rand(LM_BATCH, s, hkv, d), \
            rand(LM_BATCH, s, hkv, d)
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(causal=True, window=window, logit_cap=cap, scale=scale,
                  q_offset=off)
        got = mha(*args, **kw)
        k3_err, k3_share = close(got, attention_plain(*args, **kw),
                                 f"{arch} K3 q_offset")
        c = s + 40
        qd = rand(LM_BATCH, hq, d)
        kc, vc = rand(LM_BATCH, c, hkv, d), rand(LM_BATCH, c, hkv, d)
        pos = tfm.decode_positions(s + 20, c, 0, dev)
        out, lse = gqa_decode(qd, kc, vc, pos, scale=scale, logit_cap=cap,
                              return_lse=True)
        w_out, w_lse = decode_attention_plain(qd, kc, vc, pos, scale=scale,
                                              logit_cap=cap,
                                              return_lse=True)
        k4_err, _ = close(out, w_out, f"{arch} K4")
        lse_err, lse_share = close(lse, w_lse, f"{arch} K4 lse", LSE_TOL)
        h = c // 2
        parts = [gqa_decode(qd, kc[:, a:b], vc[:, a:b], pos[a:b],
                            scale=scale, logit_cap=cap, return_lse=True)
                 for a, b in ((0, h), (h, c))]
        merged = merge_parts(torch.stack([p[0] for p in parts]),
                             torch.stack([p[1] for p in parts]))
        m_err, m_share = close(merged, w_out, f"{arch} K4 halves merged")
        rows.append(dict(arch=arch, k3_shape=[LM_BATCH, blk, hq, hkv, s, d],
                         q_offset=off, window=window, cap=cap,
                         k3_err=k3_err, k3_share=k3_share,
                         k4_shape=[LM_BATCH, hq, hkv, c, d], k4_err=k4_err,
                         lse_err=lse_err, lse_share=lse_share,
                         merged_err=m_err, merged_share=m_share))
        say(f"phase 22 (d) {arch}: K3 with q_offset {off} (rows {off}-"
            f"{off + blk - 1} of {s}, the default offset {s - blk}; window "
            f"{window}, cap {cap}) max abs err {k3_err:.3g}"
            f" ({k3_share:.3f} of the bar); K4 C={c}: out {k4_err:.3g}, "
            f"lse {lse_err:.3g} ({lse_share:.3f} of atol {LSE_TOL[0]} + "
            f"rtol {LSE_TOL[1]}), two halves merged by lse {m_err:.3g} "
            f"({m_share:.3f}) [{card}]")
    return dict(rows=rows)


def count_cells_in_children() -> list:
    """Phase 22 (e): COUNT_CELLS counted by the dry run, each in its own
    child interpreter on a fake group (host cores, no device), the three
    run together and joined; after every timed phase, so that no time is
    taken beside them.  Each record with its wall s."""
    import threading
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    results = [None] * len(COUNT_CELLS)

    def one(i, arch, shape, mp):
        t0 = time.perf_counter()
        sizes, names = PRODUCTION_SHAPES[mp]
        rec = dryrun.count_in_child(sizes, names, [{"arch": arch,
                                                    "shape": shape}],
                                    timeout=600)[0]
        rec["wall_s"] = time.perf_counter() - t0
        results[i] = rec
    threads = [threading.Thread(target=one, args=(i, *cell))
               for i, cell in enumerate(COUNT_CELLS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def sharded_phase(dev, card, plain_runs) -> dict:
    """Phase 22: the sharding plan run (see the module docstring);
    ``plain_runs``: phase 21 (d)'s gemma-2b steps without a plan."""
    import torch
    import torch.distributed as dist
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev.index or 0)
    mesh = one_rank_mesh()
    out, walls = {}, {}
    try:
        t0 = time.perf_counter()
        out["train"] = sharded_train(dev, card, mesh, plain_runs)
        walls["train"] = time.perf_counter() - t0
        for key, arch, steps in (("serve", MOE_ARCH, SHARD_STEPS),
                                 ("ssd", HYBRID_ARCH, 0)):
            t0 = time.perf_counter()
            runs = sharded_serve(dev, card, mesh, arch, steps)
            walls[key] = time.perf_counter() - t0
            a, b = runs["unsharded"], runs["sharded"]
            if key == "serve":
                same = torch.equal(a["tokens"], b["tokens"])
                what = f"{steps} greedy tokens"
            else:
                same = torch.equal(a["logits"], b["logits"])
                what = "prefill logits bitwise"
            if not same or a["launches"] != b["launches"]:
                raise AssertionError(
                    f"{arch} sharded: {what} equal {same}; launches "
                    f"{b['launches']} vs unsharded {a['launches']}")
            used = [n for n, c in b["launches"].items() if c]
            say(f"phase 22 ({'b' if key == 'serve' else 'c'}) {arch} "
                f"sharded (DTensor parameters and cache over the (1, 1) "
                f"mesh), {LM_BATCH} x {PROMPT2} prompt: {what} equal the "
                f"unsharded path's; launches {b['launches']} (unsharded "
                f"equal); prefill {b['prefill_ms']:.1f} ms (unsharded "
                f"{a['prefill_ms']:.1f})" + (
                    f", decode {b['decode_ms']:.2f} ms a step (unsharded "
                    f"{a['decode_ms']:.2f})" if steps else "")
                + f"; kernels used {used} [{card}]")
            out[key] = {t: {k: v for k, v in r.items()
                            if k not in ("logits", "tokens")}
                        for t, r in runs.items()}
        t0 = time.perf_counter()
        out["interfaces"] = kernel_interfaces(dev, card)
        walls["interfaces"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    walls["on_card"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    counts = count_cells_in_children()
    walls["counts"] = time.perf_counter() - t0
    for cell, rec in zip(COUNT_CELLS, counts):
        if not (rec and rec.get("ok")):
            raise AssertionError(f"dry-run count of {cell}: {rec}")
        mesh_name = "2x16x16" if cell[2] else "16x16"
        say(f"phase 22 (e) dry run counted {cell[0]} {cell[1]} {mesh_name} "
            f"(child interpreter, fake group; counts of fake tensors, not "
            f"device numbers): flops/device {rec['flops_per_device']:.4g}, "
            f"peak {rec['peak_bytes_per_device'] / 2**30:.2f} GiB, "
            f"collectives {rec['n_collectives']} "
            + ", ".join(f"{k} {v:.4g} B" for k, v in
                        rec["collective_bytes"].items() if v)
            + f"; {rec['wall_s']:.1f} s wall (the three cells together)")
    out["counts"] = [dict(arch=c[0], shape=c[1], multi_pod=c[2], **r)
                     for c, r in zip(COUNT_CELLS, counts)]
    out["launches"] = {k: out["train"]["launches"].get(k, 0)
                       + out["serve"]["sharded"]["launches"].get(k, 0)
                       + out["ssd"]["sharded"]["launches"].get(k, 0)
                       for k in ("flash_attention", "decode_attention",
                                 "expert_matmul", "ssd_scan")}
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"a kernel of the sharded path never "
                             f"launched: {out['launches']}")
    walls["phase"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    say(f"phase 22 launches on the sharded runs: {out['launches']}; walls "
        f"s " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" [{card}]")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain, gqa_decode)
    from repro_torch.kernels.flash_attention.ops import (
        HEAD_DIMS, attention_plain, mha)
    from repro_torch.kernels import sass
    from repro_torch.kernels.maxplus_scan.ops import (
        maxplus_entries, maxplus_entries_plain)
    from repro_torch.kernels.moe_gmm.ops import expert_matmul_plain, gmm
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_plain
    from repro_torch.kernels.queue_booking.ops import (
        book_stream, book_stream_plain, booking_plan, events_per_pass)
    from repro_torch.launch.bench_kernels import (
        BATCH, BF16_OPS_PER_S, DECODE_SHAPES, bench_decode, bench_ssd,
        booking_bound_ms, booking_stream, decode_sets, flash_bound,
        flash_ptxas, graph_ms, launch_floor_ms, loop_ms, operator_tape,
        scan_bound_ms)
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import (SchedulerService, ServeConfig,
                                            ServingEngine, demo_requests)
    from repro_torch.serving.step import greedy_sample
    from repro_torch.sim.events import MMPPArrivals
    from repro_torch.sim.streaming import oracle_check
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 device: {card} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    results = {"card": card, "kind": kind}

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    for stem in sorted(paths):
        log = _build.build_log.get(stem, "")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        say(f"phase 2 build {stem}: {paths[stem].name} "
            f"({_build.build_seconds.get(stem, 0.0):.1f} s) "
            f"{' | '.join(regs)}")
        # ptxas' spills and serialised wgmmas, by kernel
        for kernel, ln in _build.ptxas_faults(log):
            say(f"phase 2 ptxas {stem}: {kernel}: {ln}")
    say(f"phase 2 build: {len(paths)} kernels in {build_s:.1f} s wall "
        f"[{card}]")
    results["build_s"] = build_s
    # flash_attention's bf16 kernels must build clean: no spill, no wgmma
    # serialised (every D, fused or capped)
    k3_ptxas = flash_ptxas(_build.build_log.get("flash_attention", ""))
    for name, k in k3_ptxas.items():
        say(f"phase 2 {name}: {k['registers']} registers, "
            f"{k['spill_stores']} / {k['spill_loads']} bytes spill stores / "
            f"loads, {len(k['faults'])} fault line(s)")
    results["flash_attention_ptxas"] = k3_ptxas
    bad = {n: k["faults"] for n, k in k3_ptxas.items() if k["faults"]}
    if bad or len(k3_ptxas) != 2 * len(HEAD_DIMS):
        raise AssertionError(f"flash_attention's bf16 kernels did not build "
                             f"clean: {len(k3_ptxas)} of "
                             f"{2 * len(HEAD_DIMS)} reported, faults {bad}")

    # ---- 3. queue_booking vs plain -------------------------------------
    W = WORKERS
    N = 2 * JOBS                       # keygen's stock stream: K=2 tasks
    for T, n, w, block, dead in [(2, 128, 15, 64, 0), (4, 200, 15, 64, 30),
                                 (1, 96, 4, 16, 0), (3, 256, 31, 128, 10),
                                 (33, 203, 15, 1, 9), (2, 150, 100, 4096, 7),
                                 (3, 64, 256, 64, 5)]:
        args = booking_stream(T, n, w, 0.8, dead, 0, dev)
        compare(book_stream(*args, block=block), book_stream_plain(*args))
    say("phase 3 queue_booking: bitwise equal to plain at the reference "
        "test shapes and the lane plan's edges (W = 4, 15, 31, 100, 256)")
    args = booking_stream(TRIALS, N, W, 0.75, 0, 1, dev)
    got = book_stream(*args, block=64)
    want = book_stream_plain(*args)
    k1_err = compare(got, want)
    # the one stream, as the engine hands it over just written
    k1_ms = graph_ms(lambda: book_stream(*args, block=64), [()], 20)
    k1_plain_ms = loop_ms(lambda: book_stream_plain(*args), [()], 1,
                          warmup=False)
    k1_bound = booking_bound_ms(TRIALS, N, W)
    # Two models of its pace, read from the built kernel's SASS at this
    # shape's instantiation (its main loop books events_per_pass() events):
    # the chain (each event's booking depends on the previous one: the
    # dependent instructions a pass adds to the longest chain, each at
    # least 4 cycles) and the ALU pipe (its compares, selects and logic,
    # at one warp instruction every second cycle), both at the card's
    # maximum SM clock.  Beside them, the chain model of the warp-per-trial
    # design this kernel replaced: 21 dependent instructions an event (key,
    # five shuffle-compare-select levels, max, add, select).
    lanes, slots = booking_plan(W)
    loop = sass.hottest_loop(sass.function(
        sass.disassemble("queue_booking"),
        f"queue_booking_kernelILi{lanes}ELi{slots}ELb{int(N % 4 == 0)}E"))
    per_pass = events_per_pass()
    k1_sass = dict(
        instructions_per_event=len(loop) / per_pass,
        dependent_per_event=sass.chain(loop) / per_pass,
        alu_per_event=sass.alu_count(loop) / per_pass,
        local_memory_per_pass=sum(ins.op.startswith(("LDL", "STL"))
                                  for ins in loop))
    hz = max_sm_mhz() * 1e6
    k1_chain = 1e3 * N * k1_sass["dependent_per_event"] * 4 / hz
    k1_alu = 1e3 * N * k1_sass["alu_per_event"] * 2 / hz
    k1_sass.update(chain_model_ms=k1_chain, alu_model_ms=k1_alu,
                   old_chain_model_ms=1e3 * N * 21 * 4 / hz)
    say(f"phase 3 queue_booking (T={TRIALS}, N={N}, W={W}; {lanes} lane(s) "
        f"of {slots} slots a trial): bitwise, kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.1f} ms, bound {k1_bound:.6f} ms (bytes); SASS of "
        f"its main loop ({per_pass} events a pass): "
        f"{k1_sass['instructions_per_event']:.2f} instructions an event, "
        f"{k1_sass['dependent_per_event']:.2f} of them dependent, "
        f"{k1_sass['alu_per_event']:.2f} on the ALU pipe, "
        f"{k1_sass['local_memory_per_pass']} local-memory accesses a pass; "
        f"chain model {k1_chain:.4f} ms (4 cycles each), ALU model "
        f"{k1_alu:.4f} ms (2 cycles each), at {hz / 1e6:.0f} MHz; the "
        f"warp-per-trial design's chain model "
        f"{k1_sass['old_chain_model_ms']:.4f} ms [{card}]")
    results["queue_booking_sass"] = k1_sass

    # ---- 4. maxplus_scan vs plain --------------------------------------
    nb = LOGDEPTH_NB
    for T, b, w in [(2, 1, 15), (2, 8, 15), (3, 5, 15), (4, 13, 7),
                    (1, 32, 1), (2, 48, 31), (2, 700, 3), (1, 1025, 2)]:
        for diag_free in (True, False):
            tape = operator_tape(T, b, w, diag_free, 0, dev)
            compare(maxplus_entries(*tape), maxplus_entries_plain(*tape))
    k2_err = 0.0
    for diag_free in (True, False):
        tape = operator_tape(TRIALS, nb, W, diag_free, 2, dev)
        k2_err = max(k2_err, compare(maxplus_entries(*tape),
                                     maxplus_entries_plain(*tape)))
    tape0 = operator_tape(TRIALS, nb, W, False, 3, dev)
    # the device's time (the calls replayed as a CUDA graph, on the one
    # tape, as the engine hands it over just written) and the event loop's
    # pace, which also holds the host's work between launches
    # device time: BATCH calls captured in one graph, run back to back;
    # beside it one call a replay, where the replay's own cost can exceed
    # the kernel's; each beside an empty kernel launched and timed the same
    # way (the launch floor)
    k2_call = lambda: maxplus_entries(*tape0)  # noqa: E731
    k2_ms = graph_ms(k2_call, [()] * BATCH, 20)
    k2_floor = launch_floor_ms(20, BATCH)
    k2_graph1 = graph_ms(k2_call, [()], 200)
    k2_floor1 = launch_floor_ms(200)
    k2_loop_ms = loop_ms(k2_call, [()], 200)
    k2_plain_ms = loop_ms(lambda: maxplus_entries_plain(*tape0), [()], 50)
    cummax_ms = graph_ms(lambda: torch.cummax(tape0[1], dim=1),
                         [()] * BATCH, 20)
    k2_bound = scan_bound_ms(TRIALS, nb, W)
    say(f"phase 4 maxplus_scan (T={TRIALS}, nb={nb}, W={W}): bitwise on "
        f"d!=0 and d=0 tapes; device {k2_ms:.5f} ms a call ({BATCH} in a "
        f"graph), {k2_ms / k2_floor:.2f}x the launch floor (an empty "
        f"kernel so timed: {k2_floor:.5f} ms); one call a graph replay "
        f"{k2_graph1:.5f} ms, floor {k2_floor1:.5f} ms; {k2_loop_ms:.4f} "
        f"ms a launch in an event-timed loop, plain {k2_plain_ms:.4f} ms, "
        f"torch.cummax {cummax_ms:.5f} ms, bound {k2_bound:.7f} ms (bytes) "
        f"[{card}]")

    # ---- 5. engine -------------------------------------------------------
    wl = keygen_queue()
    block = JOBS // nb
    sims = {
        "auto": QueueFlightSim(wl, num_workers=W, num_azs=AZS, load=LOAD,
                               seed=0, device=dev),
        "stock_kernel": QueueFlightSim(wl, num_workers=W, num_azs=AZS,
                                       load=LOAD, seed=0, device=dev,
                                       booking_backend="kernel"),
        "raptor_kernel": QueueFlightSim(wl, num_workers=W, num_azs=AZS,
                                        load=LOAD, seed=0, device=dev,
                                        scan="logdepth", block=block,
                                        summary_backend="kernel"),
        "raptor_seq": QueueFlightSim(wl, num_workers=W, num_azs=AZS,
                                     load=LOAD, seed=0, device=dev,
                                     scan="seq"),
    }
    say(f"phase 5 engine: keygen @ {LOAD}, {W} workers / {AZS} AZs, "
        f"{JOBS} jobs x {TRIALS} trials; auto config "
        f"raptor={sims['auto'].engine_config('raptor')} "
        f"stock={sims['auto'].engine_config('stock')}; seq config "
        f"{sims['raptor_seq'].engine_config('raptor')}; log-depth block "
        f"{block} (nb={JOBS // block}, tail {JOBS % block})")
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    book_stream.launches = 0
    maxplus_entries.launches = 0
    stock_k = timed("stock_kernel", lambda: sims["stock_kernel"].run(
        JOBS, TRIALS, raptor=False))
    rap_k = timed("raptor_logdepth_kernel", lambda: sims["raptor_kernel"].run(
        JOBS, TRIALS, raptor=True))
    launches = {"queue_booking": book_stream.launches,
                "maxplus_scan": maxplus_entries.launches}
    say(f"phase 5 engine launches on the kernel routes: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    stock_a = timed("stock_auto", lambda: sims["auto"].run(
        JOBS, TRIALS, raptor=False))
    rap_a = timed("raptor_auto", lambda: sims["auto"].run(
        JOBS, TRIALS, raptor=True))
    rap_s = timed("raptor_seq", lambda: sims["raptor_seq"].run(
        JOBS, TRIALS, raptor=True))
    for name, a, b in (("stock", stock_k, stock_a), ("raptor", rap_k, rap_s),
                       ("raptor auto", rap_a, rap_s)):
        compare((a.response_ms, a.ok), (b.response_ms, b.ok))
        if a.response_ms.shape != (TRIALS, JOBS) or not bool(
                torch.isfinite(a.response_ms).all()):
            raise AssertionError(f"{name}: bad responses")
    pair = {"stock": stock_a.summary(), "raptor": rap_a.summary()}
    pair["mean_ratio"] = pair["raptor"]["mean"] / pair["stock"]["mean"]
    if not 0.3 < pair["mean_ratio"] < 1.0:
        raise AssertionError(f"raptor/stock mean ratio {pair['mean_ratio']}")
    say("phase 5 engine: stock kernel == substrate, raptor log-depth "
        "kernel == seq, raptor auto == seq, bitwise")
    for eng in ("stock", "raptor"):
        s = pair[eng]
        say(f"phase 5 run_pair {eng}: mean {s['mean']:.1f} ms, p99 "
            f"{s['p99']:.1f} ms, n {s['n']}")
    say(f"phase 5 run_pair mean_ratio {pair['mean_ratio']:.4f}; wall s "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" [{card}]")
    results.update(engine_walls_s=walls, run_pair=pair, launches=launches)

    # ---- 6. service ------------------------------------------------------
    svc_sim = QueueFlightSim(wl, num_workers=W, num_azs=AZS, load="medium",
                             seed=0, device=dev, scan="logdepth", block=64,
                             summary_backend="kernel")
    maxplus_entries.launches = 0
    svc = SchedulerService(svc_sim, microbatch=SERVICE_MB, seed=0)
    rep = svc.run_open_load(
        jobs=SERVICE_JOBS, microbatch=SERVICE_MB,
        process=MMPPArrivals(svc_sim.rate_hz, burst_factor=5.0,
                             dwell_s=(20.0, 4.0), seed=0), seed=0)
    svc_launches = maxplus_entries.launches
    if svc_launches < 1 or rep.jobs != SERVICE_JOBS:
        raise AssertionError(f"service: {svc_launches} maxplus_scan "
                             f"launches, {rep.jobs} jobs")
    check = oracle_check(svc_sim, n_steps=6, microbatch=SERVICE_MB)
    if not check["bitwise"]:
        raise AssertionError(f"streaming oracle_check failed: {check}")
    say(f"phase 6 service: {rep.jobs} jobs (MMPP, microbatch "
        f"{SERVICE_MB}, config {svc_sim.engine_config('raptor')}), "
        f"{rep.jobs_per_s:.1f} jobs/s, p50 {rep.p50_ms:.1f} ms, p99 "
        f"{rep.p99_ms:.1f} ms, SLO {rep.slo_ms:.0f} ms violated "
        f"{rep.slo_violation_frac:.4f}; oracle_check bitwise "
        f"{check['bitwise']}; maxplus_scan launches {svc_launches} "
        f"[{card}]")
    results["service"] = rep.summary()

    # ---- 7. flash_attention vs plain -----------------------------------
    cfg = get_config(ARCH)
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = tfm._attn_scale(cfg)
    cap = cfg.attn_logit_softcap
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16

    def heads(b, s, h, dtype):
        """[B, H, S, D] views of a [B, S, H, D] tensor, the model's
        layout, as the prefill hands them to the kernel."""
        x = torch.randn((b, s, h, hd), generator=gen, device=dev)
        return x.to(dtype).transpose(1, 2)

    q = heads(LM_BATCH, PROMPT, hq, bf16)
    k = heads(LM_BATCH, PROMPT, hkv, bf16)
    v = heads(LM_BATCH, PROMPT, hkv, bf16)
    k3 = {"err": 0.0, "share": 0.0, "rms": {}, "ms": {}, "plain_ms": {},
          "bound_ms": {}}
    for window in (cfg.window_size, 0):
        def kern(window=window):
            return mha(q, k, v, window=window, logit_cap=cap, scale=scale)

        def plain(window=window):
            return attention_plain(q, k, v, window=window, logit_cap=cap,
                                   scale=scale)
        want = plain()
        err, share = close(kern(), want, f"flash_attention window {window}")
        k3["err"], k3["share"] = max(k3["err"], err), max(k3["share"], share)
        k3["rms"][window] = float(want.float().square().mean().sqrt())
        del want
        k3["ms"][window] = graph_ms(
            lambda q_, k_, v_, w_=window: mha(q_, k_, v_, window=w_,
                                             logit_cap=cap, scale=scale),
            cold(q, k, v), 5)
        k3["plain_ms"][window] = loop_ms(plain, [()], 2)
        k3["bound_ms"][window] = flash_bound(LM_BATCH, hq, hkv, hd, PROMPT,
                                             PROMPT, True, window)[0]
    b, h32, g32, s32, d32 = 2, 4, 2, 256, 64   # test_kernels_flash CASES[1]
    q32 = torch.randn((b, h32, s32, d32), generator=gen, device=dev)
    k32 = torch.randn((b, g32, s32, d32), generator=gen, device=dev)
    v32 = torch.randn((b, g32, s32, d32), generator=gen, device=dev)
    k3_err32, _ = close(mha(q32, k32, v32), attention_plain(q32, k32, v32),
                        "flash_attention float32")
    # like for like with SDPA: no logit cap (SDPA has none), no window
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    k3_cap0_ms = graph_ms(lambda q_, k_, v_: mha(q_, k_, v_, scale=scale),
                          cold(q, k, v), 5)
    sdpa_ms = graph_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, scale=scale, enable_gqa=True),
        cold(qc, kc, vc), 5)
    k3_ms = sum(k3["ms"].values()) / 2
    k3_plain_ms = sum(k3["plain_ms"].values()) / 2
    k3_bound = sum(k3["bound_ms"].values()) / 2
    del q, k, v, qc, kc, vc
    # the served paths' other prefill shapes (no cap, no window), each
    # beside SDPA: granite-moe-3b-a800m's (D=64, where the scalar work per
    # score weighs most), qwen2-vl-2b's (a GQA group of 6) and
    # seamless-m4t-medium's cross attention (non-causal, Sq != Sk); and
    # gemma-2b's training forward (a group of 8 at D=256)
    k3["rows"] = []
    for label, name, sq, sk, causal in (
            (MOE_ARCH, MOE_ARCH, PROMPT2, PROMPT2, True),
            (VLM_ARCH, VLM_ARCH, PROMPT2, PROMPT2, True),
            (f"{ENCDEC_ARCH} cross", ENCDEC_ARCH, ENCDEC_WIRING_PROMPT,
             PROMPT2, False),
            (f"{TRAIN_ARCH} training", TRAIN_ARCH, TRAIN_SEQ, TRAIN_SEQ,
             True)):
        c_ = get_config(name)
        row = flash_row(dev, label, c_.num_heads, c_.num_kv_heads, sq, sk,
                        c_.resolved_head_dim, causal, tfm._attn_scale(c_))
        k3["err"] = max(k3["err"], row["max_abs_err"])
        k3["share"] = max(k3["share"], row["bar_share"])
        k3["rows"].append(row)
    say(f"phase 7 flash_attention (bf16, B={LM_BATCH}, {hq}/{hkv} heads, "
        f"S={PROMPT}, D={hd}, cap {cap}): max abs err {k3['err']:.3g}, "
        f"{k3['share']:.3f} of the bf16 bar at worst (rms |plain| "
        + ", ".join(f"window {w}: {r:.4f}" for w, r in k3["rms"].items())
        + f"; f32 case {k3_err32:.3g}); kernel ms "
        + ", ".join(f"window {w}: {t:.4f}" for w, t in k3["ms"].items())
        + "; plain ms "
        + ", ".join(f"window {w}: {t:.3f}" for w, t in
                    k3["plain_ms"].items())
        + "; bound ms (operations) "
        + ", ".join(f"window {w}: {t:.4f}" for w, t in
                    k3["bound_ms"].items())
        + f"; at cap 0, window 0: kernel {k3_cap0_ms:.4f} ms, SDPA "
        f"{sdpa_ms:.4f} ms; "
        + "; ".join(f"{r['shape']}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.4f} "
                    f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                    f"max abs err {r['max_abs_err']:.3g}"
                    for r in k3["rows"])
        + f" [{card}]")

    # ---- 8. decode_attention vs plain ----------------------------------
    idx = PROMPT + DECODE_STEPS - 12           # a step late in the decode
    k4 = {"err": 0.0, "share": 0.0, "rms": 0.0, "plain_ms": {}}
    caches = {MAX_LEN: 0, min(cfg.window_size, MAX_LEN): cfg.window_size}
    qd = torch.randn((LM_BATCH, hq, hd), generator=gen, device=dev).to(bf16)
    for c_len, window in caches.items():
        kd = torch.randn((LM_BATCH, c_len, hkv, hd), generator=gen,
                         device=dev).to(bf16)
        vd = torch.randn((LM_BATCH, c_len, hkv, hd), generator=gen,
                         device=dev).to(bf16)
        pos = tfm.decode_positions(idx, c_len, window, dev)
        holes = torch.where(torch.rand(c_len, generator=gen, device=dev)
                            < 0.3, -1, pos).to(torch.int32)
        for p_ in (pos, holes):
            want = decode_attention_plain(qd, kd, vd, p_, scale=scale,
                                          logit_cap=cap)
            err, share = close(gqa_decode(qd, kd, vd, p_, scale=scale,
                                          logit_cap=cap), want,
                               f"decode_attention C={c_len}")
            k4["err"], k4["share"] = (max(k4["err"], err),
                                      max(k4["share"], share))
            k4["rms"] = max(k4["rms"],
                            float(want.float().square().mean().sqrt()))
        k4["plain_ms"][c_len] = loop_ms(lambda: decode_attention_plain(
            qd, kd, vd, pos, scale=scale, logit_cap=cap), [()], 10)
    del qd, kd, vd
    # granite's, zamba2's, qwen2-vl's and seamless's cross decode shapes
    # (3, 1, 6 and 1 query heads per kv head), against the plain version
    # as well
    for name, hq_, hkv_, hd_, c_, window_, cap_, prompt_ in \
            DECODE_SHAPES[2:]:
        (q_, k_, v_, p_), = decode_sets(hq_, hkv_, hd_, c_, window_, prompt_,
                                        LM_BATCH, 9, dev, count=1)[0]
        holes = torch.where(torch.rand(c_, generator=gen, device=dev) < 0.3,
                            -1, p_).to(torch.int32)
        for pp in (p_, holes):
            err, share = close(
                gqa_decode(q_, k_, v_, pp, logit_cap=cap_),
                decode_attention_plain(q_, k_, v_, pp, logit_cap=cap_),
                f"decode_attention {name}")
            k4["err"], k4["share"] = (max(k4["err"], err),
                                      max(k4["share"], share))
        del q_, k_, v_
    torch.cuda.empty_cache()
    # the kernel where the model finds it: each timing cycles through
    # distinct caches that outgrow the L2, at the served shapes (gemma2-9b's
    # two caches, granite's and zamba2's), beside SDPA with the slot mask
    k4["rows"] = bench_decode(20, dev, LM_BATCH)
    gem = [r for r in k4["rows"] if r["shape"].startswith("gemma2-9b")]
    k4_ms = sum(r["ms"] for r in gem) / len(gem)
    k4_loop_ms = sum(r["loop_ms"] for r in gem) / len(gem)
    k4_plain_ms = sum(k4["plain_ms"].values()) / 2
    k4_bound = sum(r["bound_ms"] for r in gem) / len(gem)
    k4_sdpa_ms = sum(r["sdpa_ms"] for r in gem) / len(gem)
    k4_cap0_ms = sum(r["cap0_ms"] for r in gem) / len(gem)
    say(f"phase 8 decode_attention (bf16, B={LM_BATCH}, {hq}/{hkv} heads, "
        f"D={hd}, index {idx}): max abs err {k4['err']:.3g}, "
        f"{k4['share']:.3f} of the bf16 bar at worst (rms |plain| up to "
        f"{k4['rms']:.4f}); plain ms "
        + ", ".join(f"C={c}: {t:.4f}" for c, t in k4["plain_ms"].items())
        + "; device ms (CUDA graph replay, caches cold): "
        + "; ".join(f"{r['shape']} C={r['C']}: kernel {r['ms']:.5f} "
                    f"(cap 0 {r['cap0_ms']:.5f}), SDPA (mask) "
                    f"{r['sdpa_ms']:.5f}, bound (bytes) "
                    f"{r['bound_ms']:.5f}; event loop kernel "
                    f"{r['loop_ms']:.5f}, SDPA {r['sdpa_loop_ms']:.5f}"
                    for r in k4["rows"])
        + f" [{card}]")
    results["attention_kernels"] = {"flash_attention": k3,
                                    "decode_attention": k4,
                                    "flash_attention_cap0_ms": k3_cap0_ms,
                                    "sdpa_prefill_ms": sdpa_ms}

    # ---- 9. LM serve: gemma2-9b at full width ---------------------------
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say(f"phase 9 {ARCH}: {n_params:,} parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card) drawn "
        f"in {time.perf_counter() - t0:.1f} s")
    batches = [demo_requests(cfg, LM_BATCH, PROMPT, seed=i, device=dev)
               for i in range(LM_BATCHES)]
    eng = ServingEngine(cfg, params, ServeConfig(
        max_len=MAX_LEN, decode_steps=DECODE_STEPS), device=dev)
    mha.launches = 0
    gqa_decode.launches = 0
    stats = eng.serve(batches)
    lm_launches = {"flash_attention": mha.launches,
                   "decode_attention": gqa_decode.launches}
    prefills = 2 + LM_BATCHES                 # warmup runs two
    steps = 2 + LM_BATCHES * DECODE_STEPS     # and one step after each
    want = {"flash_attention": cfg.num_layers * prefills,
            "decode_attention": cfg.num_layers * steps}
    if lm_launches != want:
        raise AssertionError(f"LM serve launched {lm_launches}, expected "
                             f"{want} ({cfg.num_layers} per prefill and per "
                             f"decode step)")
    summ = stats.summary()
    tok_s = LM_BATCH / summ["decode_step_s"]
    say(f"phase 9 serve: {summ['requests']} requests (B={LM_BATCH}, prompt "
        f"{PROMPT}, {DECODE_STEPS} decode steps, max_len {MAX_LEN}): "
        f"prefill {summ['prefill_s'] * 1e3:.1f} ms, decode "
        f"{summ['decode_step_s'] * 1e3:.3f} ms/step, {tok_s:.1f} decode "
        f"tokens/s, request p50 {summ['p50_s'] * 1e3:.1f} ms, p99 "
        f"{summ['p99_s'] * 1e3:.1f} ms; first call {summ['cold_s']:.2f} s, "
        f"warm {summ['warm_s']:.2f} s; launches {lm_launches} "
        f"({prefills} prefills, {steps} decode steps) [{card}]")
    flight_eng = ServingEngine(cfg, params, ServeConfig(
        max_len=MAX_LEN, decode_steps=DECODE_STEPS, flight_size=2),
        device=dev)
    flight_eng.warmup(batches[0])
    n3, n4 = mha.launches, gqa_decode.launches
    flown = flight_eng.generate_flight(batches[0])
    plain_run = eng.generate(batches[0])
    if not (flown.tokens == plain_run.tokens).all():
        raise AssertionError("the flight's tokens differ from generate's")
    if flown.tokens.shape != (LM_BATCH, DECODE_STEPS):
        raise AssertionError(f"flight tokens {flown.tokens.shape}")
    frep = flown.flight_report
    say(f"phase 9 flight of 2: {flown.latency_s * 1e3:.1f} ms, tokens equal "
        f"generate's ({plain_run.latency_s * 1e3:.1f} ms); executed "
        f"{[e.executed for e in frep.executors]}, pre-empted "
        f"{[e.preempted for e in frep.executors]}; launches "
        f"flash_attention {mha.launches - n3}, decode_attention "
        f"{gqa_decode.launches - n4} (generate's included) [{card}]")

    # the wiring at real shapes: the same weights and tokens with each
    # attention entry of the model swapped for another function
    batch = batches[0]
    forced = torch.as_tensor(plain_run.tokens[:, :WIRING_STEPS],
                             device=dev)
    shadow = {"flash_attention": [0, 0.0, 0.0],
              "decode_attention": [0, 0.0, 0.0]}   # calls, max err, share

    def shadowed(name, kernel, plain):
        """``kernel``, each call also held to ``plain`` on its inputs."""
        def run(*args, **kw):
            got = kernel(*args, **kw)
            err, share = close(got, plain(*args, **kw), f"model {name}")
            rec = shadow[name]
            rec[:] = rec[0] + 1, max(rec[1], err), max(rec[2], share)
            return got
        return run

    def logits_with(cfg_, prefill_attn=None, decode_attn=None):
        """Prefill and WIRING_STEPS teacher-forced decode steps, with
        ``layers.mha`` and ``tfm.gqa_decode`` swapped where given: the
        logits, float32 [WIRING_STEPS + 1, B, V]."""
        with contextlib.ExitStack() as swaps:
            if prefill_attn is not None:
                swaps.enter_context(mock.patch.object(layers, "mha",
                                                      prefill_attn))
            if decode_attn is not None:
                swaps.enter_context(mock.patch.object(tfm, "gqa_decode",
                                                      decode_attn))
            logits, cache = tfm.prefill(params, cfg_, batch, MAX_LEN)
            outs = [logits.float()]
            for i in range(WIRING_STEPS):
                logits, cache = tfm.decode_step(params, cfg_, cache,
                                                forced[:, i:i + 1])
                outs.append(logits.float())
        del cache
        out = torch.stack(outs)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("LM logits are not finite")
        return out

    def gap(a, b):
        """(max, rms) of |a - b|, and the greedy tokens' agreement."""
        d = (a - b).abs()
        agree = float((greedy_sample(a) == greedy_sample(b)).float().mean())
        return float(d.max()), float(d.square().mean().sqrt()), agree

    kern16 = logits_with(
        cfg, shadowed("flash_attention", mha, attention_plain),
        shadowed("decode_attention", gqa_decode, decode_attention_plain))
    want_calls = {"flash_attention": cfg.num_layers,
                  "decode_attention": cfg.num_layers * WIRING_STEPS}
    calls = {name: rec[0] for name, rec in shadow.items()}
    if calls != want_calls:
        raise AssertionError(f"the wiring run made {calls} attention "
                             f"calls, expected {want_calls}")
    say("phase 9 wiring bf16, every kernel call against its plain version "
        "on the model's activations: "
        + "; ".join(f"{name} {rec[0]} calls, max abs err {rec[1]:.4g}, "
                    f"{rec[2]:.3f} of the bf16 bar at worst"
                    for name, rec in shadow.items()) + f" [{card}]")
    plain16 = logits_with(cfg, attention_plain, decode_attention_plain)
    # the same weights in float32 (37 GB): the kernels agree with the plain
    # versions to float32 rounding there, and the plain attention's
    # float32 logits measure how far bf16 rounding alone moves them
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for w in params.parameters():
        w.data = w.data.float()
    kern32 = logits_with(cfg32)
    plain32 = logits_with(cfg32, attention_plain, decode_attention_plain)
    err16, rms16, agree16 = gap(kern16, plain16)
    noise16, noise_rms16, _ = gap(plain16, plain32)
    err32, rms32, agree32 = gap(kern32, plain32)
    top32 = float(plain32.abs().max())
    say(f"phase 9 wiring (prefill + {WIRING_STEPS} teacher-forced steps, "
        f"kernels vs plain attention): bf16 max |dlogit| {err16:.4g} (rms "
        f"{rms16:.4g}), greedy tokens agree {agree16:.3f}; bf16 vs float32, "
        f"both plain: max {noise16:.4g} (rms {noise_rms16:.4g}); float32 "
        f"max |dlogit| {err32:.4g} (rms {rms32:.4g}) against 1e-3 x max "
        f"|logit| = {1e-3 * top32:.4g}, greedy tokens agree {agree32:.3f} "
        f"[{card}]")
    # rms over all B x V logits of every step, not the max: the max is one
    # extreme draw of the rounding, the rms a stable measure of it
    if not rms16 <= noise_rms16:
        raise AssertionError(
            f"bf16: the kernels move the logits further from the plain "
            f"attention's (rms {rms16}) than bf16 rounding moves them from "
            f"float32 (rms {noise_rms16})")
    if not err32 <= 1e-3 * top32:
        raise AssertionError(f"float32: kernel and plain attention "
                             f"disagree: max |dlogit| {err32} > "
                             f"{1e-3 * top32}")
    results["lm_serve"] = dict(summ, decode_tokens_per_s=tok_s,
                               launches=lm_launches, params=n_params,
                               flight_s=flown.latency_s,
                               wiring_calls=shadow,
                               wiring_bf16_max_abs=err16,
                               wiring_bf16_rms=rms16,
                               bf16_vs_f32_max_abs=noise16,
                               bf16_vs_f32_rms=noise_rms16,
                               greedy_agreement=agree16,
                               wiring_f32_max_abs=err32,
                               greedy_agreement_f32=agree32)
    # the engines and the flight's closures hold the weights in reference
    # cycles, which only the collector frees
    del params, eng, flight_eng, flown, frep, plain_run
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. expert_matmul vs plain ---------------------------------
    mcfg = get_config(MOE_ARCH)
    n_exp, d_model, e_ff = (mcfg.moe.num_experts, mcfg.d_model,
                            mcfg.moe.expert_ff)
    cap_prefill = moe.moe_capacity(LM_BATCH * PROMPT2, mcfg.moe)
    cap_decode = moe.moe_capacity(LM_BATCH, mcfg.moe)
    # (C, D, F, launches of that shape per forward): gate and up, then down
    k5_shapes = [(c, d_, f_, n) for c in (cap_prefill, cap_decode)
                 for d_, f_, n in ((d_model, e_ff, 2), (e_ff, d_model, 1))]
    k5 = {"err": 0.0, "share": 0.0, "err32": 0.0, "rows": []}
    for c, d_, f_, n in k5_shapes:
        # the path's operands: normed activations against N(0, 0.02)
        # weights, so the outputs have the model's scale
        buf = torch.randn((n_exp, c, d_), generator=gen, device=dev)
        w = torch.randn((n_exp, d_, f_), generator=gen, device=dev) * 0.02
        want32 = expert_matmul_plain(buf, w)
        got32 = gmm(buf, w)
        err32 = float((got32 - want32).abs().max())
        if not bool(((got32 - want32).abs()
                     <= 1e-5 * d_ + 1e-5 * want32.abs()).all()):
            raise AssertionError(f"expert_matmul float32 C={c} D={d_}: max "
                                 f"abs err {err32} over 1e-5 x D")
        del got32, want32
        b16, w16 = buf.to(bf16), w.to(bf16)
        err, share = close(gmm(b16, w16), expert_matmul_plain(b16, w16),
                           f"expert_matmul C={c} D={d_}")
        ops_ms = 1e3 * 2 * n_exp * c * d_ * f_ / BF16_OPS_PER_S
        bytes_ms = 1e3 * 2 * n_exp * (c * d_ + d_ * f_ + c * f_) \
            / HBM_BYTES_PER_S
        row = {"C": c, "D": d_, "F": f_, "per_forward": n,
               "ms": graph_ms(gmm, cold(b16, w16), 20),
               "plain_ms": loop_ms(lambda: expert_matmul_plain(b16, w16),
                                   [()], 3),
               "bmm_ms": graph_ms(torch.bmm, cold(b16, w16), 20),
               "ms_f32": graph_ms(gmm, cold(buf, w), 5),
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}
        k5["rows"].append(row)
        k5.update(err=max(k5["err"], err), share=max(k5["share"], share),
                  err32=max(k5["err32"], err32))
        del buf, w, b16, w16
    say(f"phase 10 expert_matmul (E={n_exp}; bf16 within the bar of TOL, "
        f"float32 within 1e-5 x D): max abs err bf16 "
        f"{k5['err']:.3g} ({k5['share']:.3f} of the bar at worst), float32 "
        f"{k5['err32']:.3g}; "
        + "; ".join(f"C={r['C']} D={r['D']} F={r['F']}: kernel "
                    f"{r['ms']:.4f} ms (float32 {r['ms_f32']:.4f}), plain "
                    f"{r['plain_ms']:.4f} ms, torch.bmm {r['bmm_ms']:.4f} ms, "
                    f"bound {r['bound_ms']:.4f} ms" for r in k5["rows"])
        + f" [{card}]")

    # ---- 11. ssd_scan vs plain -------------------------------------------
    hcfg = get_config(HYBRID_ARCH)
    ssm = hcfg.ssm
    n_heads = ssm.expand * hcfg.d_model // ssm.head_dim
    shape = (LM_BATCH, PROMPT2, n_heads, ssm.head_dim)
    # the reference kernel test's input law
    xs = torch.randn(shape, generator=gen, device=dev)
    dts = F.softplus(torch.randn(shape[:3], generator=gen, device=dev))
    A = -torch.exp(torch.randn((n_heads,), generator=gen, device=dev) * 0.3)
    Bs = torch.randn((LM_BATCH, PROMPT2, ssm.ngroups, ssm.state_dim),
                     generator=gen, device=dev) * 0.5
    Cs = torch.randn(Bs.shape, generator=gen, device=dev) * 0.5
    ssd_args = (xs, dts, A, Bs, Cs)
    k6_err, k6_share = close(ssd(*ssd_args, chunk=ssm.chunk_size),
                             ssd_plain(*ssd_args, chunk=ssm.chunk_size),
                             "ssd_scan", SSD_TOL)
    k6_plain_ms = loop_ms(lambda: ssd_plain(*ssd_args, chunk=ssm.chunk_size),
                          [()], 2)
    del ssd_args, xs, dts, A, Bs, Cs
    # the kernel where the model finds it: distinct inputs that outgrow
    # the L2, in turn; the bound is the larger of the bytes (inputs once,
    # outputs once) and the plain recurrence's 5 P N operations per step
    # and head at the rate of the tensor cores' 3xTF32 that run them.  And
    # at a prompt 8 times as long, where the chunks' states outgrow the L2.
    k6, k6_long = (bench_ssd(5, dev, LM_BATCH, s_, n_heads, ssm.head_dim,
                             ssm.state_dim, ssm.chunk_size)
                   for s_ in (PROMPT2, 8 * PROMPT2))
    say(f"phase 11 ssd_scan (B={LM_BATCH}, S={PROMPT2}, H={n_heads}, "
        f"P={ssm.head_dim}, N={ssm.state_dim}, chunk {ssm.chunk_size}): max "
        f"abs err {k6_err:.3g} ({k6_share:.3f} of 2e-4 + 2e-4 x |plain| at "
        f"worst), kernel {k6['ms']:.4f} ms on the device (CUDA graph "
        f"replay), {k6['loop_ms']:.4f} ms a call in an event-timed loop, "
        f"plain {k6_plain_ms:.4f} ms, bound {k6['bound_ms']:.4f} ms "
        f"({k6['bound_by']}); at S={k6_long['S']}: kernel "
        f"{k6_long['ms']:.4f} ms, bound {k6_long['bound_ms']:.4f} ms "
        f"({k6_long['bound_by']}) [{card}]")
    results["ssd_scan"] = [k6, k6_long]

    # ---- 12-13. LM serve: the MoE and hybrid paths ---------------------
    n_moe = mcfg.num_layers
    results["moe_serve"] = lm_path(
        dev, card, 12, mcfg,
        {"expert_matmul": 3 * n_moe, "flash_attention": n_moe,
         "decode_attention": 0},
        {"expert_matmul": 3 * n_moe, "flash_attention": 0,
         "decode_attention": n_moe})[0]
    n_shared = hcfg.num_layers // hcfg.hybrid_attn_every
    gc.collect()
    torch.cuda.empty_cache()
    results["hybrid_serve"] = lm_path(
        dev, card, 13, hcfg,
        {"ssd_scan": hcfg.num_layers, "flash_attention": n_shared,
         "decode_attention": 0},
        {"ssd_scan": 0, "flash_attention": 0,
         "decode_attention": n_shared})[0]
    gc.collect()
    torch.cuda.empty_cache()
    # the kernel's time, bound, plain and library time per launch, averaged
    # over the MoE path's launches (prefill and decode shapes as served)
    n_pre2, n_step2 = 2 + LM_BATCHES, 2 + LM_BATCHES * DECODE_STEPS

    def k5_mean(key, rows=None):
        weight = {cap_prefill: n_pre2, cap_decode: n_step2}
        rows = k5["rows"] if rows is None else rows
        tot = sum(weight[r["C"]] * r["per_forward"] for r in k5["rows"])
        return sum(weight[r["C"]] * r["per_forward"] * r[key]
                   for r in rows) / tot

    # the bound of the launches that weigh most in the mean
    k5_bound_by = max(("bytes", "operations"), key=lambda kind: k5_mean(
        "bound_ms", [r for r in k5["rows"] if r["bound_by"] == kind]))

    # ---- 14-16. fault mode and the open-loop engine -----------------------
    results["fault_engine"] = fault_engine_phase(dev, card)
    results["fault_service"] = fault_service_phase(dev, card)
    results["open_loop"] = open_loop_phase(dev, card)

    # ---- 17. the paper's experiments ---------------------------------------
    results["experiments"] = experiments_phase(dev, card)
    sweep = results["experiments"]["sweep_launches"]

    # ---- 18-19. LM serve: the VLM and encoder-decoder paths ---------------
    results["vlm_serve"] = vlm_phase(dev, card)
    results["encdec_serve"] = encdec_phase(dev, card)

    # ---- 20. training ------------------------------------------------------
    results["training"] = training_phase(dev, card)
    grads = results["training"]["kernel_grads"]
    depth = results["training"]["full_depth"]
    trained = results["training"]["trainer"]

    def train_launches(kernel):
        """The kernel's launches per training step on each path: the
        trainer's (gemma-2b, no remat) and the full-depth remat steps."""
        out = {TRAIN_ARCH: trained["steps"][0]["launches"][kernel]}
        out.update({name: d["steps"][0]["launches"][kernel]
                    for name, d in depth.items()})
        return {name: n for name, n in out.items() if n}
    paths = {ARCH: lm_launches, **{
        name: results[key]["launches"] for name, key in (
            (MOE_ARCH, "moe_serve"), (HYBRID_ARCH, "hybrid_serve"),
            (VLM_ARCH, "vlm_serve"), (ENCDEC_ARCH, "encdec_serve"))}}

    def path_launches(kernel):
        """The kernel's launches in each LM path's serve run."""
        return {name: got[kernel] for name, got in paths.items()
                if kernel in got}

    # ---- 21. distributed ---------------------------------------------------
    results["distributed"] = distributed_phase(dev, card)
    dist_launches = results["distributed"]["launches"]

    # ---- 22. the sharding plan run -----------------------------------------
    results["sharded"] = sharded_phase(
        dev, card, results["distributed"]["dp_steps"]["gemma"])
    shard_launches = results["sharded"]["launches"]

    # ---- 23. kernels line --------------------------------------------------
    kernels = [
        {"name": "queue_booking", "route": "cuda",
         "source": "src/repro_torch/csrc/queue_booking.cu",
         "replaces": "src/repro/kernels/queue_booking/kernel.py:80",
         "launches": launches["queue_booking"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None,
         "chain_model_ms": k1_chain, "alu_model_ms": k1_alu,
         "sweep_launches": sweep["queue_booking"],
         "distributed_launches": dist_launches["queue_booking"]},
        {"name": "maxplus_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/maxplus_scan.cu",
         "replaces": "src/repro/kernels/maxplus_scan/kernel.py:57",
         "launches": launches["maxplus_scan"], "max_abs_err": k2_err,
         "ms": k2_ms, "loop_ms": k2_loop_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": None,
         "floor_ms": k2_floor, "graph1_ms": k2_graph1,
         "floor1_ms": k2_floor1, "yardstick_ms": cummax_ms,
         "fault_launches": results["fault_engine"]["launches"],
         "fault_service_launches": results["fault_service"]["launches"],
         "sweep_launches": sweep["maxplus_scan"],
         "distributed_launches": dist_launches["maxplus_scan"],
         "fault_sweep_launches":
             results["experiments"]["launches"]["fault_sweep"][
                 "maxplus_scan"],
         "yardstick": "torch.cummax of off alone (the inclusive max "
                      "prefix): no PyTorch call computes the kernel's "
                      "exclusive entries and exit vector"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
         "launches": lm_launches["flash_attention"],
         "max_abs_err": k3["err"], "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": "operations",
         "library_ms": sdpa_ms, "ms_like_library": k3_cap0_ms,
         "library_call": "scaled_dot_product_attention, causal, GQA; "
                         "it has no logit cap, so it and ms_like_library "
                         "are at cap 0, window 0",
         "path_launches": path_launches("flash_attention"),
         "distributed_launches": dist_launches["flash_attention"],
         "sharded_launches": shard_launches["flash_attention"],
         "shapes": k3["rows"],
         "train_launches_per_step": train_launches("flash_attention"),
         "trainer_launches": trained["launches"]["flash_attention"],
         "backward_ms": grads["flash_attention"][0]["backward_ms"],
         "train_shapes": grads["flash_attention"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:67",
         "launches": lm_launches["decode_attention"],
         "max_abs_err": k4["err"], "ms": k4_ms, "loop_ms": k4_loop_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": "bytes",
         "library_ms": k4_sdpa_ms, "ms_like_library": k4_cap0_ms,
         "library_call": "scaled_dot_product_attention with a kv_pos "
                         "mask, GQA; it has no logit cap, so it and "
                         "ms_like_library are at cap 0; ms and library_ms "
                         "are device times (CUDA graph replay), caches "
                         "cold",
         "path_launches": path_launches("decode_attention"),
         "distributed_launches": dist_launches["decode_attention"],
         "sharded_launches": shard_launches["decode_attention"],
         "shapes": k4["rows"]},
        {"name": "expert_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/expert_matmul.cu",
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:40",
         "launches": results["moe_serve"]["launches"]["expert_matmul"],
         "max_abs_err": k5["err"], "ms": k5_mean("ms"),
         "plain_ms": k5_mean("plain_ms"), "bound_ms": k5_mean("bound_ms"),
         "bound_by": k5_bound_by, "library_ms": k5_mean("bmm_ms"),
         "library_call": "torch.bmm; every time is the mean per launch over "
                         "the MoE path's served launches (prefill C=2048, "
                         "bound by operations, and decode C=4, by bytes)",
         "shapes": k5["rows"],
         "distributed_launches": dist_launches["expert_matmul"],
         "sharded_launches": shard_launches["expert_matmul"],
         "train_launches_per_step": train_launches("expert_matmul"),
         "train_shapes": grads["expert_matmul"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
         "launches": results["hybrid_serve"]["launches"]["ssd_scan"],
         "max_abs_err": k6_err, "ms": k6["ms"], "loop_ms": k6["loop_ms"],
         "plain_ms": k6_plain_ms, "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": None,
         "train_launches_per_step": train_launches("ssd_scan"),
         "sharded_launches": shard_launches["ssd_scan"],
         "train_shape": grads["ssd_scan"]},
    ]
    results["kernels"] = kernels
    results["expert_matmul"] = k5
    results["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    say(f"total {results['total_s']:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
