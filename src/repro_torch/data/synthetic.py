"""Deterministic synthetic LM data pipeline, shardable by host.

The port of ``repro/data/synthetic.py``, numpy only, so a batch is bitwise
the reference's for every architecture (tokens, labels, the embedding
inputs, an encoder-decoder's ``enc_emb`` and M-RoPE ``positions``).  Each
host materialises only its shard of the global batch (``host_slice``);
the Raptor redundant-DP layer (``training.raptor_dp``) reuses the same
indexing to hand the same microbatch to several flight members.  Batches
are numpy arrays: the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # markov-ish synthetic text: token t+1 = f(token t) + noise, so models
    # have signal to learn
    structure: float = 0.7


def _batch_tokens(cfg: ModelConfig, batch: int, seq: int, step: int,
                  dc: DataConfig, host_slice: slice) -> np.ndarray:
    rng = np.random.default_rng((dc.seed, step))
    b = host_slice.stop - host_slice.start
    base = rng.integers(0, cfg.vocab_size, size=(b, seq + 1), dtype=np.int64)
    # learnable structure: with prob `structure`, next = (prev*7+3)%V
    follow = (base[:, :-1] * 7 + 3) % cfg.vocab_size
    mask = rng.random((b, seq)) < dc.structure
    nxt = np.where(mask, follow, base[:, 1:])
    return np.concatenate([base[:, :1], nxt], axis=1).astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               dc: Optional[DataConfig] = None,
               host_slice: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """One global (or host-sliced) training batch for any architecture."""
    dc = dc or DataConfig()
    b, s = shape.global_batch, shape.seq_len
    host_slice = host_slice or slice(0, b)
    bsz = host_slice.stop - host_slice.start
    toks = _batch_tokens(cfg, b, s, step, dc, host_slice)
    batch: Dict[str, np.ndarray] = {"labels": toks[:, 1:]}
    if cfg.embedding_inputs:
        rng = np.random.default_rng((dc.seed, step, 7))
        batch["embeddings"] = rng.standard_normal(
            (bsz, s, cfg.d_model)).astype(np.float32) * 0.02
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng((dc.seed, step, 11))
        batch["enc_emb"] = rng.standard_normal(
            (bsz, s // 4, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (bsz, s))
        batch["positions"] = np.broadcast_to(pos[None], (3, bsz, s)).copy()
    return batch


def data_iterator(cfg: ModelConfig, shape: ShapeConfig,
                  dc: Optional[DataConfig] = None,
                  start_step: int = 0,
                  host_slice: Optional[slice] = None) -> Iterator[Dict]:
    """Resumable: restart from any step index after a checkpoint restore."""
    step = start_step
    while True:
        yield make_batch(cfg, shape, step, dc, host_slice)
        step += 1
