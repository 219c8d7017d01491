"""Configuration dataclasses for models, shapes, meshes and runs.

Every assigned architecture is a ``ModelConfig``; every assigned input shape
is a ``ShapeConfig``.  The dry-run iterates the cross product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    shared_expert_ff: int = 0          # llama4: one always-on shared expert
    every_n_layers: int = 1            # llama4: MoE every 2nd layer
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128               # N (d_state)
    head_dim: int = 64                 # P (headdim)
    expand: int = 2                    # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256              # SSD chunk length
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    # --- activation / norm flavour ---
    mlp_variant: str = "swiglu"        # swiglu | geglu
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # --- attention flavour ---
    rope_theta: float = 10000.0
    mrope: bool = False                # qwen2-vl multimodal rope (sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_pattern: str = "global"       # global | local_global_1_1 | local_global_5_1
    window_size: int = 4096            # local-attn sliding window
    attn_logit_softcap: float = 0.0    # gemma2: 50.0
    final_logit_softcap: float = 0.0   # gemma2: 30.0
    query_pre_attn_scalar: Optional[float] = None
    # --- optional subsystems ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every N mamba layers
    hybrid_attn_every: int = 0
    # enc-dec (seamless)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    embedding_inputs: bool = False
    # which layers are SSM in a hybrid stack: "all" for pure ssm
    # --- dtypes ---
    dtype: str = "bfloat16"
    # training memory knob: bf16 adam moments for very large models (llama4)
    optimizer_state_dtype: str = "float32"
    # sharding knob (§Perf): pad attention heads up to this count so they
    # divide the model axis (kills the seq<->heads resharding ping-pong for
    # 40/24/12/8-head archs); 0 = off.  Padded head compute is wasted
    # (pad/heads ratio) but replaces per-layer [B,S,D] all-gathers.
    pad_heads: int = 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, i: int) -> str:
        """Return 'attn' | 'local_attn' | 'ssm' for layer i of the stack."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            # zamba2: mamba everywhere; shared attention block interleaved
            return "ssm"
        if self.attn_pattern == "local_global_1_1":
            return "local_attn" if i % 2 == 0 else "attn"
        if self.attn_pattern == "local_global_5_1":
            return "attn" if (i % 6) == 5 else "local_attn"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every_n_layers) == (self.moe.every_n_layers - 1)

    # ---- parameter counting (used for 6ND roofline cross-check) ----
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.num_heads * hd * 2 + d * self.num_kv_heads * hd * 2
        dense_mlp = 0
        if self.d_ff:
            n_mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
            dense_mlp = n_mats * d * self.d_ff
        ssm = 0
        if self.ssm is not None:
            din = self.ssm.expand * d
            nheads = din // self.ssm.head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            ssm = d * (2 * din + 2 * self.ssm.ngroups * self.ssm.state_dim + nheads)
            ssm += din * d + self.ssm.conv_width * (din + 2 * self.ssm.ngroups * self.ssm.state_dim)
            ssm += 2 * nheads
        total = 0
        active = 0
        n_stack = self.num_layers
        for i in range(n_stack):
            kind = self.layer_kind(i)
            if kind == "ssm":
                total += ssm
                active += ssm
                if self.family == "ssm":
                    continue
                if self.family == "hybrid":
                    continue
            if self.family in ("dense", "moe", "vlm", "audio"):
                total += attn
                active += attn
            if self.is_moe_layer(i):
                m = self.moe
                router = d * m.num_experts
                experts = m.num_experts * 3 * d * m.expert_ff
                shared = 3 * d * m.shared_expert_ff
                total += router + experts + shared
                active += router + m.top_k * 3 * d * m.expert_ff + shared
            elif self.family in ("dense", "moe", "vlm", "audio"):
                total += dense_mlp
                active += dense_mlp
        # zamba2 shared attention+mlp block counted once
        if self.family == "hybrid" and self.hybrid_attn_every:
            shared_block = attn + dense_mlp
            total += shared_block
            n_inv = self.num_layers // self.hybrid_attn_every
            active += shared_block * 0 + (attn + dense_mlp)  # active per fwd ~= n_inv uses of same weights
        if self.is_encoder_decoder:
            # decoder layers add cross-attention
            total += self.num_layers * attn  # cross-attn per decoder layer
            active += self.num_layers * attn
            total += self.num_encoder_layers * (attn + dense_mlp)
            active += self.num_encoder_layers * (attn + dense_mlp)
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def long_context_capable(cfg: ModelConfig) -> bool:
    """long_500k is defined for sub-quadratic archs: SSM/hybrid, and
    local-window archs whose local layers cap their KV at the window."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.attn_pattern in ("local_global_1_1", "local_global_5_1")


def applicable_shapes(cfg: ModelConfig):
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if long_context_capable(cfg):
        out.append(LONG_500K)
    return out
