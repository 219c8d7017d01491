"""Batched LM serving with Raptor flights, and the live Raptor
scheduling service.

The port of ``repro/serving/engine.py``.  :class:`ServingEngine` groups
requests into batches; each invocation (prefill, then N decode steps) is
an ActionManifest run by the Raptor engine (``core/scheduler.py``).  With
``flight_size > 1`` the whole invocation is replicated across executor
threads, with per-member latency jitter standing in for independent
hosts: the first finisher wins and its peers are pre-empted.  The model
runs on ``device``, the CUDA card unless the caller asks for the CPU;
prefill attention (an encoder's and a decoder's cross attention too)
goes through the ``flash_attention`` kernel, decode attention (cross
attention too) through ``decode_attention``, expert MLPs through
``expert_matmul`` and prefill Mamba2 scans through ``ssd_scan``.  PyTorch has no jit, so
``warmup`` pays the kernels' first build and load instead of a compile,
and timed windows end with ``torch.cuda.synchronize()`` on the card.
Prefill and decode run under ``torch.inference_mode()``, which each step
enters in the thread that calls it (``serving/step.py``): a trained
model's weights, which require grad, build no autograd graph here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.manifest import ActionManifest, FunctionSpec
from repro_torch.core.scheduler import Flight
from repro_torch.models.transformer import DTYPES, clone_cache
from repro_torch.serving.step import (greedy_sample, make_decode_step,
                                      make_prefill_step)
from repro_torch.sim.streaming import StreamingScheduler, run_open_load


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 128
    decode_steps: int = 16
    flight_size: int = 1
    # per-group latency jitter model (independent "hosts"): exp(mean_jitter)
    mean_jitter_s: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.decode_steps < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {self.decode_steps}")
        if self.decode_steps >= self.max_len:
            raise ValueError(
                f"decode_steps={self.decode_steps} leaves no room for a "
                f"prompt inside max_len={self.max_len}")
        if self.flight_size < 1:
            raise ValueError(
                f"flight_size must be >= 1, got {self.flight_size}")
        if not self.mean_jitter_s >= 0.0:
            raise ValueError(
                f"mean_jitter_s must be >= 0, got {self.mean_jitter_s}")


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray              # [B, decode_steps]
    latency_s: float                # warm wall time of THIS call
    flight_report: Optional[Any] = None
    cold_s: Optional[float] = None  # first-call (kernel build and load)
    #                                 time, when this call triggered the
    #                                 warmup (else None)
    latencies_s: Optional[np.ndarray] = None   # per-request [B] latencies
    prefill_s: Optional[float] = None          # prefill wall time
    decode_s: Optional[float] = None           # all decode steps' wall time


@dataclasses.dataclass
class ServeStats:
    """Per-request latency accounting over a sequence of serve calls."""
    latencies_s: np.ndarray         # one entry per request (flattened)
    cold_s: float                   # first-call time, kernel build included
    warm_s: float                   # post-warmup single-call reference
    prefill_s: Optional[np.ndarray] = None      # per batch (plain path)
    decode_step_s: Optional[np.ndarray] = None  # per batch (plain path)

    @property
    def p50_s(self) -> float:
        return float(np.percentile(self.latencies_s, 50))

    @property
    def p99_s(self) -> float:
        return float(np.percentile(self.latencies_s, 99))

    def summary(self) -> dict:
        out = {"requests": int(self.latencies_s.size),
               "mean_s": float(self.latencies_s.mean()),
               "p50_s": self.p50_s, "p99_s": self.p99_s,
               "cold_s": self.cold_s, "warm_s": self.warm_s}
        if self.prefill_s is not None and self.decode_step_s is not None:
            out["prefill_s"] = float(self.prefill_s.mean())
            out["decode_step_s"] = float(self.decode_step_s.mean())
        return out


def _prompt_len(batch: Dict[str, Any]) -> int:
    for name in ("tokens", "embeddings"):
        if name in batch:
            return int(batch[name].shape[1])
    raise ValueError("batch carries neither 'tokens' nor 'embeddings'")


class ServingEngine:
    """Batched generation on ``device`` (the CUDA card unless given);
    ``constrain`` and ``ep`` go to the steps (``serving/step.py``)."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig, *,
                 device=None, constrain=None, ep=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sc = sc
        self._prefill = make_prefill_step(cfg, sc.max_len, constrain, ep)
        self._decode = make_decode_step(cfg, constrain, ep)
        self.params = params.to(self.device)
        self._rng = np.random.default_rng(sc.seed)
        self._warmed = set()        # batch signatures already run once
        self.cold_s: Optional[float] = None   # first-call wall time
        self.warm_s: Optional[float] = None   # warm reference (same shapes)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_budget(self, batch: Dict[str, Any]) -> None:
        p = _prompt_len(batch)
        if p + self.sc.decode_steps > self.sc.max_len:
            raise ValueError(
                f"prompt_len={p} + decode_steps={self.sc.decode_steps} "
                f"overflows the max_len={self.sc.max_len} cache budget")

    def _signature(self, batch: Dict[str, Any]):
        return tuple(sorted((k, tuple(v.shape)) for k, v in batch.items()))

    def _on_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v.to(self.device) for k, v in batch.items()}

    def warmup(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """Run prefill and one decode step for this batch shape twice;
        report the first (cold: the kernels' build and load) and second
        (warm) wall times.  Both ``generate`` paths call it lazily, so a
        measured ``latency_s`` never includes the first call.  It draws
        no random numbers, so it cannot shift the jitter stream."""
        self._check_budget(batch)
        sig = self._signature(batch)
        if sig in self._warmed:
            return {"cold_s": 0.0, "warm_s": self.warm_s or 0.0}
        batch = self._on_device(batch)

        def once():
            logits, cache = self._prefill(self.params, batch)
            tok = greedy_sample(logits)[:, None]
            self._decode(self.params, cache, tok)
            self._sync()

        t0 = time.monotonic()
        once()
        cold = time.monotonic() - t0
        t0 = time.monotonic()
        once()
        warm = time.monotonic() - t0
        self._warmed.add(sig)
        if self.cold_s is None:
            self.cold_s, self.warm_s = cold, warm
        return {"cold_s": cold, "warm_s": warm}

    def _decode_loop(self, cache, logits, checkpoint=None) -> np.ndarray:
        """``decode_steps`` greedy steps from the prefill's logits; the
        sampled tokens stay on the device until the end."""
        toks = []
        tok = greedy_sample(logits)[:, None]
        for _ in range(self.sc.decode_steps):
            if checkpoint is not None:
                checkpoint()          # preemption point per decode step
            toks.append(tok[:, 0])
            logits, cache = self._decode(self.params, cache, tok)
            tok = greedy_sample(logits)[:, None]
        return torch.stack(toks, dim=1).cpu().numpy()

    # ---- plain (stock) path ------------------------------------------
    def generate(self, batch: Dict[str, Any]) -> ServeResult:
        self._check_budget(batch)
        cold = None
        if self._signature(batch) not in self._warmed:
            cold = self.warmup(batch)["cold_s"]
        batch = self._on_device(batch)
        self._sync()
        t0 = time.monotonic()
        logits, cache = self._prefill(self.params, batch)
        self._sync()
        t1 = time.monotonic()
        out = self._decode_loop(cache, logits)
        self._sync()
        t2 = time.monotonic()
        return ServeResult(out, t2 - t0, cold_s=cold,
                           latencies_s=np.full(out.shape[0], t2 - t0),
                           prefill_s=t1 - t0, decode_s=t2 - t1)

    # ---- Raptor flight path ------------------------------------------
    def generate_flight(self, batch: Dict[str, Any]) -> ServeResult:
        """Speculatively replicate the invocation across flight members.
        Each member that reaches the decode stage decodes into its own
        copy of the winning prefill's cache."""
        self._check_budget(batch)
        cold = None
        if self._signature(batch) not in self._warmed:
            cold = self.warmup(batch)["cold_s"]
        batch = self._on_device(batch)
        sc = self.sc
        jitters = self._rng.exponential(
            max(sc.mean_jitter_s, 1e-9), size=(sc.flight_size, 2))

        def make_stage(stage: str):
            def fn(ctx):
                member = ctx.follower_index
                # independent host variance (queue/NIC/entropy analogue)
                if sc.mean_jitter_s:
                    ctx.sleep(float(jitters[member % sc.flight_size,
                                            0 if stage == "prefill" else 1]))
                if stage == "prefill":
                    logits, cache = self._prefill(self.params, batch)
                    self._sync()
                    return {"logits": logits, "cache": cache}
                pre = ctx.inputs["prefill"]
                return self._decode_loop(clone_cache(pre["cache"]),
                                         pre["logits"], ctx.checkpoint)
            return fn

        manifest = ActionManifest((
            FunctionSpec("prefill", make_stage("prefill")),
            FunctionSpec("decode", make_stage("decode"),
                         dependencies=("prefill",)),
        ), concurrency=sc.flight_size, name="generate")
        self._sync()
        t0 = time.monotonic()
        report = Flight(manifest).run(timeout=600.0)
        if not report.ok:
            raise RuntimeError("flight failed")
        self._sync()
        dt = time.monotonic() - t0
        out = report.outputs["decode"]
        return ServeResult(out, dt, report, cold_s=cold,
                           latencies_s=np.full(out.shape[0], dt))

    def serve(self, batches, *, raptor: bool = None) -> ServeStats:
        """Serve a sequence of request batches; per-request latency stats.

        Warmup is paid once up front (first batch's shapes), so the
        returned latency distribution is pure serve time; the cold and
        warm reference times ride along separately.  The plain path also
        records each batch's prefill time and mean decode-step time.
        """
        batches = list(batches)
        if not batches:
            raise ValueError("serve needs at least one batch")
        if raptor is None:
            raptor = self.sc.flight_size > 1
        wu = self.warmup(batches[0])
        lat, pre, step = [], [], []
        for b in batches:
            res = (self.generate_flight(b) if raptor else self.generate(b))
            lat.append(res.latencies_s)
            if res.prefill_s is not None:
                pre.append(res.prefill_s)
                step.append(res.decode_s / self.sc.decode_steps)
        return ServeStats(np.concatenate(lat),
                          cold_s=(self.cold_s
                                  if self.cold_s is not None
                                  else wu["cold_s"]),
                          warm_s=self.warm_s or wu["warm_s"],
                          prefill_s=np.array(pre) if pre else None,
                          decode_step_s=np.array(step) if step else None)


class SchedulerService:
    """Open job arrivals booked on the streaming engine's persistent
    W-state on ``sim.device`` (the CUDA card unless the sim was built for
    the CPU).

    The service face of :class:`repro_torch.sim.streaming
    .StreamingScheduler`: the launcher (``python -m
    repro_torch.launch.serve``) drives sustained open load through it.
    ``submit``/``drain`` mirror the engine; ``run_open_load`` is the
    sustained-load run.
    """

    def __init__(self, sim, *, microbatch: int = 64,
                 pipeline_depth: int = 2, seed: Optional[int] = None):
        self.sim = sim
        self.engine = StreamingScheduler(
            sim, microbatch=microbatch, pipeline_depth=pipeline_depth,
            seed=seed)

    def submit(self, arrivals_ms) -> None:
        self.engine.submit(arrivals_ms)

    def drain(self):
        return self.engine.drain()

    def run_open_load(self, **kw):
        return run_open_load(self.sim, **kw)


def demo_requests(cfg: ModelConfig, batch: int, prompt_len: int, seed=0, *,
                  device=None) -> Dict[str, Any]:
    """Random prompts, the same numpy draws in the same order as the
    reference's ``demo_requests``, on ``device`` (the card unless given):
    {"tokens": [batch, prompt_len] int32}, or for a model with
    ``embedding_inputs`` {"embeddings": [batch, prompt_len, D]}, N(0, 1)
    in the model dtype times 0.02 (the product rounded once in that
    dtype, as the reference's); an encoder-decoder's "enc_emb" of the
    same shape, drawn next; M-RoPE's "positions" [3, batch, prompt_len]
    int32, ``arange`` in every stream."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]

    def embeddings():
        x = torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model))).to(dt)
        return (x * torch.tensor(0.02, dtype=dt)).to(dev)

    out: Dict[str, Any] = {}
    if cfg.embedding_inputs:
        out["embeddings"] = embeddings()
    else:
        out["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
            dtype=torch.int32, device=dev)
    if cfg.is_encoder_decoder:
        out["enc_emb"] = embeddings()
    if cfg.mrope:
        out["positions"] = torch.arange(
            prompt_len, dtype=torch.int32, device=dev)[None, None].expand(
                3, batch, prompt_len).contiguous()
    return out
