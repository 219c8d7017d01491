"""Input stand-ins for every (arch x shape) cell: tensors on the ``meta``
device, the counterpart of the reference's ``ShapeDtypeStruct``s.

The port of ``repro/launch/specs.py``; the dry run reads them.  Nothing
is allocated.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

ENC_RATIO = 4  # audio frames per decoder token for enc-dec shapes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=_DTYPES[dtype], device="meta")


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, torch.Tensor] = {}
    if cfg.embedding_inputs:
        batch["embeddings"] = sds((b, s, cfg.d_model), cfg.dtype)
    else:
        batch["tokens"] = sds((b, s), "int32")
    if cfg.mrope:
        batch["positions"] = sds((3, b, s), "int32")
    if cfg.is_encoder_decoder:
        batch["enc_emb"] = sds((b, s // ENC_RATIO, cfg.d_model), cfg.dtype)
    return batch


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    return {"labels": sds((b, s), "int32"),
            **prefill_batch_specs(cfg, shape)}


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    """[B, 1] int32: generated tokens re-enter through the embedding table
    (an embedding-input model's too)."""
    return sds((shape.global_batch, 1), "int32")


def enc_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.seq_len // ENC_RATIO if cfg.is_encoder_decoder else 0
