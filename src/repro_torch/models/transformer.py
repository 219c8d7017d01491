"""The LM of the port: parameters, cache, prefill and decode.

The port of ``repro/models/transformer.py`` for the dense family
(gemma-2b, gemma2-9b, gemma3-27b, phi3-mini), the MoE family
(granite-moe-3b-a800m, llama4-maverick), the SSM family (mamba2-1.3b),
the hybrid family (zamba2-1.2b), the VLM backbone (qwen2-vl-2b) and the
encoder-decoder (seamless-m4t-medium): GQA attention with RoPE or
qwen2-vl's M-RoPE over ``[3, B, S]`` (t, h, w) positions, global or local
(sliding-window) layers, attention and final logit caps, a SwiGLU or
GeGLU MLP or a Mixture-of-Experts block, Mamba2 layers and zamba2's one
shared attention+MLP block applied after every ``hybrid_attn_every``-th
layer, a bidirectional encoder and cross attention, RMS norms.  A model
with ``embedding_inputs`` takes ``[B, S, D]`` embeddings (the modality
frontends are stubs, as in the reference) and token ids after the
prompt.  The parameter pytree keeps the reference's names and
orientation (``x @ wq`` with ``wq [d, hq*hd]``) as a module,
:class:`ParamTree`: ``embed``, ``final_norm``, ``lm_head`` (untied heads
only), ``layers.{i}.attn.{wq,wk,wv,wo}``, ``layers.{i}.mlp.{w_gate,w_up,
w_down}`` or ``layers.{i}.moe.{router,w_gate,w_up,w_down[,shared]}``,
``layers.{i}.ssm.*`` (Mamba2 layers), ``layers.{i}.ln1``, ``ln2``,
``shared_block.*`` (hybrid); an encoder-decoder's decoder layers add
``ln_cross`` and ``cross.{wq,wk,wv,wo}``, and ``encoder.layers.{i}``
(``ln1``, ``attn``, ``ln2``, ``mlp``) and ``encoder.final_norm`` hold its
encoder.

Prefill attention goes through the ``flash_attention`` kernel (the
encoder's and the cross attention with ``causal=False``), decode
attention through ``decode_attention`` (cross attention over every slot
of the encoder's keys), every expert MLP product through
``expert_matmul`` and every prefill Mamba2 scan through ``ssd_scan``.
The decode cache is a dict ``{"index": int, "layer_{i}": {"k": [B, C, Hkv,
hd], "v": ...} or a Mamba2 layer's {"conv_x", "conv_B", "conv_C",
"state"} or an encoder-decoder layer's {"self": {"k", "v"}, "cross_k":
[B, Se, Hkv, hd], "cross_v"}, "shared_{j}": {"k", "v"}}``; unlike the
reference's functional update, prefill and :func:`decode_step` write it
IN PLACE (a step would otherwise copy the whole cache), so a caller that
decodes twice from one prefill clones it first (:func:`clone_cache`).

The encoder-decoder's prefill computes each layer's cross K/V from the
encoder's output and keeps them in the cache.  The reference's
``prefill`` allocates that cache zero-filled and then reads it as if it
were computed, so its decoder never sees the encoder; the port follows
the reference's own branch that computes them (``_decoder_block_apply``
with a cache that holds no ``cross_k``).

Training: ``mode="train"`` is a prefill without a cache, and
:func:`loss_fn` is the reference's loss (per-token cross entropy, the
Raptor ``loss_weight`` renormalisation, ``ce + 0.01 * aux`` with the MoE
layers' load-balancing loss).  Its backward runs through the three
kernels' autograd Functions (``flash_attention``, ``expert_matmul`` and
``ssd_scan``); ``apply_stack(..., remat=True)`` recomputes each layer of
the stack in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does.

Sharding: ``constrain(t, role)`` (``distributed.sharding.Plan.constrain``)
is called at the reference's roles (``act_heads``, ``act_kv_heads``,
``act_ff_out``, ``act_resid``, ``logits``, ``ssm_inner``,
``moe_tokens``); it redistributes a ``DTensor`` and passes the port's
plain tensors through.  ``ep`` (``models.moe.EPSpec``) sends every MoE
layer through ``moe_block_ep``.  ``cfg.pad_heads`` (a head count the
model axis divides) makes the train and prefill attention repeat K/V to
the full query heads and zero-pad q, k and v to ``pad_heads`` heads;
``flash_attention`` runs on the padded heads and the output is sliced
back (padded heads meet only padded heads).  The cache keeps the
unpadded K/V heads.  ``shard`` (``distributed.functional.BatchShard``,
the data-parallel step's) says that the batch is this rank's block of a
larger one: :func:`loss_fn` then returns this block's share of the whole
batch's loss (the ranks' mean is the whole batch's loss), and the MoE
layers without ``ep`` dispatch and take their aux loss as over the
whole batch.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from torch.distributed.tensor import Replicate, Shard

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import functional as dfn
from repro_torch.distributed.local import (coord, heads_weight, is_dtensor,
                                           linear, settle, shard_dims,
                                           sharded_decode, write_slots)
from repro_torch.kernels.decode_attention.ops import gqa_decode
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (attention, mlp_block, mrope_tables,
                                       rms_norm, rope_tables, rotate,
                                       softcap)
from repro_torch.models.moe import init_moe_params, moe_block, moe_mlp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_FULL_PASS = ("prefill", "train")


def _ID(t, role):
    """The default ``constrain``: no sharding hint."""
    return t


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A parameter pytree as a module.  Dict keys become attribute names
    (so ``state_dict`` names follow the pytree: ``layers.0.attn.wq``),
    lists become ``nn.ModuleList``s, and ``tree["key"]`` reads like the
    reference's dicts.  Parameters are made with ``requires_grad=False``
    (serving needs no gradient); the training state turns gradients on
    (``training.step.init_train_state``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(t)
                                                    for t in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                generator: torch.Generator | None = None) -> ParamTree:
    """Random parameters as the reference draws them: every matrix
    N(0, 0.02) in the model dtype, every norm scale 0 (float32), the MoE
    router in float32, the Mamba2 constants as the reference sets them,
    from a seeded ``torch.Generator`` on ``device`` (the card unless
    given; ``device="meta"`` allocates nothing).  The numbers differ from
    the reference's threefry draws; the tests share weights through
    :func:`params_from_numpy` instead."""
    dev = resolve_device(device)
    gen = generator
    if gen is None and dev.type != "meta":     # meta: shapes only
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = DTYPES[cfg.dtype]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    def normal(*shape):
        if dev.type == "meta":                 # shapes only: no draws
            return torch.empty(shape, dtype=dt, device=dev)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dt).mul_(0.02)

    def zeros():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    def proj():
        return {"wq": normal(d, hq * hd), "wk": normal(d, hkv * hd),
                "wv": normal(d, hkv * hd), "wo": normal(hq * hd, d)}

    def attn():
        return {"ln1": zeros(), "attn": proj(), "ln2": zeros()}

    def mlp():
        return {"w_gate": normal(d, cfg.d_ff), "w_up": normal(d, cfg.d_ff),
                "w_down": normal(cfg.d_ff, d)}

    def block(i):
        if cfg.layer_kind(i) == "ssm":
            return {"ln1": zeros(),
                    "ssm": m2.init_mamba2_params(d, cfg.ssm, dt,
                                                 generator=gen, device=dev)}
        if cfg.is_moe_layer(i):
            return dict(attn(), moe=init_moe_params(
                d, cfg.moe, dt, generator=gen, device=dev))
        return dict(attn(), mlp=mlp())

    tree: Dict[str, Any] = {"embed": normal(cfg.vocab_size, d),
                            "final_norm": zeros()}
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal(d, cfg.vocab_size)
    if cfg.is_encoder_decoder:
        tree["encoder"] = {
            "layers": [dict(attn(), mlp=mlp())
                       for _ in range(cfg.num_encoder_layers)],
            "final_norm": zeros()}
        tree["layers"] = [dict(attn(), mlp=mlp(), ln_cross=zeros(),
                               cross=proj())
                          for _ in range(cfg.num_layers)]
        return ParamTree(tree)
    tree["layers"] = [block(i) for i in range(cfg.num_layers)]
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        tree["shared_block"] = dict(attn(), mlp=mlp())
    return ParamTree(tree)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":              # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, *, device=None) -> ParamTree:
    """The reference's parameter pytree (``repro.models.init_params``
    output, or any nest of dicts and lists of arrays), converted leaf by
    leaf with ``np.asarray``, as the port's module on ``device``."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _to_tensor(t, dev)

    return ParamTree(conv(tree))


# --------------------------------------------------------------------------
# attention block with cache handling
# --------------------------------------------------------------------------

def _attn_scale(cfg: ModelConfig) -> float:
    base = cfg.query_pre_attn_scalar or cfg.resolved_head_dim
    return float(base) ** -0.5


def _project_qkv(x, p, cfg: ModelConfig, rope, constrain=_ID):
    """q, k, v [B, S, H, hd], q and k rotated by ``rope`` = (cos, sin),
    the RoPE or M-RoPE tables of the pass (:func:`_rope`)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    def proj(name, h):
        return linear(x, heads_weight(p[name], h)).reshape(b, s, h, hd)
    q = constrain(proj("wq", hq), "act_heads")
    k = constrain(proj("wk", hkv), "act_kv_heads")
    v = constrain(proj("wv", hkv), "act_kv_heads")
    return rotate(q, *rope), rotate(k, *rope), v


def _wo(p, cfg: ModelConfig):
    """The output projection, its head blocks whole on a sharded step."""
    return heads_weight(p["wo"], cfg.num_heads, 0)


def _pad_heads(t, hq: int, target: int):
    """[B, S, H, hd] repeated to ``hq`` heads (each K/V head serves its
    group of queries, in order) and zero-padded to ``target``."""
    b, s, h, hd = t.shape
    if h != hq:
        t = t[:, :, :, None].expand(b, s, h, hq // h, hd).reshape(
            b, s, hq, hd)
    return torch.nn.functional.pad(t, (0, 0, 0, target - hq))


def decode_positions(idx: int, cache_len: int, window: int, device):
    """Absolute position of every cache slot at decode index ``idx``, -1
    where the slot is empty or outside the window.  A global cache
    (``window == 0``) holds position ``s`` in slot ``s``; a local ring
    holds ``idx - ((idx - s) mod C)`` in slot ``s``."""
    slots = torch.arange(cache_len, dtype=torch.int32, device=device)
    if window:
        kv_pos = idx - torch.remainder(idx - slots, cache_len)
        valid = (kv_pos >= 0) & (kv_pos > idx - window) & (kv_pos <= idx)
    else:
        kv_pos = slots
        valid = slots <= idx
    return torch.where(valid, kv_pos, -1).to(torch.int32)


def _decoder(scale: float, cap: float):
    """The decode kernel as :func:`~repro_torch.distributed.local
    .sharded_decode` calls it on each rank's block."""
    def decode(q, k, v, kv_pos, return_lse):
        return gqa_decode(q, k, v, kv_pos, scale=scale, logit_cap=cap,
                          return_lse=return_lse)
    return decode


def attention_block(x, p, cfg: ModelConfig, *, kind: str, mode: str,
                    rope, cache=None, constrain=_ID):
    """The attention sublayer with its cache write.  x: [B, S, D]; rope:
    the (cos, sin) tables of the pass's positions (:func:`rope_tables`).

    ``mode="prefill"`` attends over the prompt (``flash_attention``) and
    writes its keys into ``cache``: a global layer at slots ``0..S-1``, a
    local layer its last ``min(window, S)`` keys into the ring.
    ``mode="decode"`` writes the one new key at ``min(idx, C-1)`` (global)
    or ``idx mod C`` (local) and attends over the cache
    (``decode_attention``) with ``cache["kv_pos"]``.  ``mode="train"`` is
    a prefill without a cache; with ``cfg.pad_heads`` both attend over
    padded heads (see the module docstring).
    """
    b, s, _ = x.shape
    scale = _attn_scale(cfg)
    cap = cfg.attn_logit_softcap
    local = kind == "local_attn"
    window = cfg.window_size if local else 0
    q, k, v = _project_qkv(x, p, cfg, rope, constrain)

    if mode == "decode":
        idx = cache["index"]
        cache_len = cache["k"].shape[1]
        slot = idx % cache_len if local else min(idx, cache_len - 1)
        write_slots(cache["k"], k, slot)
        write_slots(cache["v"], v, slot)
        kv_pos = cache.get("kv_pos")
        if kv_pos is None:
            kv_pos = decode_positions(idx, cache_len, window, x.device)
        if is_dtensor(q):
            out = sharded_decode(q[:, 0], cache["k"], cache["v"], kv_pos,
                                 _decoder(scale, cap))
        else:
            out = gqa_decode(q[:, 0], cache["k"], cache["v"], kv_pos,
                             scale=scale, logit_cap=cap)
        return linear(out.reshape(b, 1, -1), _wo(p, cfg)), cache
    if mode not in _FULL_PASS:
        raise ValueError(f"unknown mode {mode!r}")

    hq = cfg.num_heads
    if cfg.pad_heads and cfg.pad_heads > hq:
        qp, kp, vp = (constrain(_pad_heads(t, hq, cfg.pad_heads),
                                "act_heads") for t in (q, k, v))
        out = attention(qp, kp, vp, window=window, logit_cap=cap,
                        scale=scale)[:, :, :hq]
    else:
        out = attention(q, k, v, window=window, logit_cap=cap, scale=scale)
    out = constrain(out, "act_heads")
    if cache is not None:      # a local layer keeps its last window
        keep = min(window, s) if local else s
        write_slots(cache["k"], k[:, s - keep:], s - keep)
        write_slots(cache["v"], v[:, s - keep:], s - keep)
    return linear(out.reshape(b, s, -1), _wo(p, cfg)), cache


def cross_attention_block(x, p, cfg: ModelConfig, *, mode: str, cache,
                          enc_out=None):
    """An encoder-decoder layer's cross attention: q from ``x`` (no
    rotation), keys and values from the encoder.  ``mode="prefill"``
    computes them from ``enc_out`` [B, Se, D] (``enc_out @ wk``, ``@ wv``)
    and writes them into ``cache["cross_k"]`` / ``["cross_v"]`` when a
    cache is given; the attention runs through ``flash_attention`` with
    ``causal=False`` (Sq may differ from Se).  ``mode="decode"`` attends
    over the cached ones through ``decode_attention``, every slot valid
    (``cache["cross_kv_pos"]``, ``arange(Se)``).  ``mode="train"`` is a
    prefill without a cache."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    scale = _attn_scale(cfg)
    cap = cfg.attn_logit_softcap
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = linear(x, heads_weight(p["wq"], hq)).reshape(b, s, hq, hd)
    if mode == "decode":
        if is_dtensor(q):
            out = sharded_decode(q[:, 0], cache["cross_k"],
                                 cache["cross_v"], cache["cross_kv_pos"],
                                 _decoder(scale, cap))
        else:
            out = gqa_decode(q[:, 0], cache["cross_k"], cache["cross_v"],
                             cache["cross_kv_pos"], scale=scale,
                             logit_cap=cap)
        return linear(out.reshape(b, 1, -1), _wo(p, cfg))
    if mode not in _FULL_PASS:
        raise ValueError(f"unknown mode {mode!r}")
    se = enc_out.shape[1]
    k = linear(enc_out, heads_weight(p["wk"], hkv)).reshape(b, se, hkv, hd)
    v = linear(enc_out, heads_weight(p["wv"], hkv)).reshape(b, se, hkv, hd)
    if cache is not None:
        write_slots(cache["cross_k"], k, 0)
        write_slots(cache["cross_v"], v, 0)
    out = attention(q, k, v, causal=False, logit_cap=cap, scale=scale)
    return linear(out.reshape(b, s, -1), _wo(p, cfg))


# --------------------------------------------------------------------------
# block and stack
# --------------------------------------------------------------------------

def _block_apply(x, p, cfg: ModelConfig, i: int, *, mode, rope,
                 cache=None, constrain=_ID, ep=None, shard=None):
    """One layer of the stack; returns (x, cache, aux loss).  The MoE
    layers' load-balancing loss is a training term: ``mode="train"``
    returns it, serving does not compute it and returns 0."""
    kind = cfg.layer_kind(i)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y, cache = m2.mamba2_block(h, p["ssm"], cfg.ssm, mode=mode,
                                   cache=cache, constrain=constrain)
        return x + y, cache, 0.0
    y, cache = attention_block(h, p["attn"], cfg, kind=kind, mode=mode,
                               rope=rope, cache=cache, constrain=constrain)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = 0.0
    if "moe" in p and mode == "train":
        y, aux = moe_block(h, p["moe"], cfg.moe, cfg.mlp_variant, ep=ep,
                           constrain=constrain, shard=shard)
    elif "moe" in p:
        y, _ = moe_mlp(h, p["moe"], cfg.moe, cfg.mlp_variant, ep=ep,
                       constrain=constrain)
    else:
        y = constrain(mlp_block(h, p["mlp"], cfg.mlp_variant), "act_ff_out")
    return x + y, cache, aux


def _shared_block_apply(x, p, cfg: ModelConfig, *, mode, rope, cache,
                        constrain=_ID):
    """zamba2's shared attention+MLP block (global attention)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, cache = attention_block(h, p["attn"], cfg, kind="attn", mode=mode,
                               rope=rope, cache=cache, constrain=constrain)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(h, p["mlp"], cfg.mlp_variant), cache


def _decoder_block_apply(x, p, cfg: ModelConfig, *, mode, rope, cache,
                         enc_out, constrain=_ID):
    """An encoder-decoder's decoder layer: causal self-attention (cache
    ``cache["self"]``), cross attention over the encoder, the MLP."""
    self_cache = cache.get("self") if cache else None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, self_cache = attention_block(h, p["attn"], cfg, kind="attn",
                                    mode=mode, rope=rope, cache=self_cache,
                                    constrain=constrain)
    x = x + y
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    x = x + cross_attention_block(h, p["cross"], cfg, mode=mode,
                                  cache=cache, enc_out=enc_out)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(h, p["mlp"], cfg.mlp_variant), cache


def _rope(cfg: ModelConfig, positions):
    """The (cos, sin) tables of a pass: M-RoPE for ``positions`` [3, B, S]
    when ``cfg.mrope``, else RoPE for [B, S]; None without positions."""
    if positions is None:
        return None
    hd = cfg.resolved_head_dim
    if cfg.mrope:
        return mrope_tables(positions, hd, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_tables(positions, hd, cfg.rope_theta)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy (the reference's
    ``dots_with_no_batch_dims_saveable``): keep every 2-D matmul's output
    (``x @ W`` is one ``aten.mm``), recompute the rest."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(remat_policy: Optional[str]) -> dict:
    """``torch.utils.checkpoint.checkpoint``'s arguments for a remat
    policy: non-reentrant, and for ``"dots"`` a selective checkpoint that
    saves the matmuls' outputs."""
    if remat_policy not in (None, "dots"):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    kw = {"use_reentrant": False}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    return kw


def apply_stack(params, cfg: ModelConfig, x, *, mode, positions,
                caches=None, enc_out=None, remat: bool = False,
                remat_policy: Optional[str] = None, constrain=_ID, ep=None,
                shard=None):
    """x: [B, S, D] embeddings; positions: [B, S], or [3, B, S] for
    M-RoPE (None for an attention-free stack); ``enc_out``: the encoder's
    output [B, Se, D] at an encoder-decoder's prefill or train pass.
    Returns (hidden, new_caches, aux_loss), the aux loss the MoE layers'
    sum in ``mode="train"`` (0 otherwise).  With ``remat`` and
    ``mode="train"`` each layer's ``_block_apply`` is recomputed in the
    backward, as in the reference (zamba2's shared block and an
    encoder-decoder's layers are not).  ``constrain``, ``ep`` and
    ``shard``: see the module docstring."""
    rope = _rope(cfg, positions)
    new_caches: Dict[str, Any] = {}
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    aux_total = 0.0
    remat_kw = _remat_kwargs(remat_policy) if remat and mode == "train" \
        else None
    for i in range(cfg.num_layers):
        c = caches.get(f"layer_{i}") if caches else None
        p = params["layers"][i]
        aux = 0.0
        if cfg.is_encoder_decoder:
            x, c = _decoder_block_apply(x, p, cfg, mode=mode, rope=rope,
                                        cache=c, enc_out=enc_out,
                                        constrain=constrain)
        elif remat_kw is not None:
            x, c, aux = ckpt.checkpoint(functools.partial(
                _block_apply, p=p, cfg=cfg, i=i, mode="train", rope=rope,
                constrain=constrain, ep=ep, shard=shard), x, **remat_kw)
        else:
            x, c, aux = _block_apply(x, p, cfg, i, mode=mode, rope=rope,
                                     cache=c, constrain=constrain, ep=ep,
                                     shard=shard)
        aux_total = aux_total + aux
        if c is not None:
            new_caches[f"layer_{i}"] = c
        x = constrain(x, "act_resid")
        if every and (i + 1) % every == 0:
            name = f"shared_{(i + 1) // every - 1}"
            sc = caches.get(name) if caches else None
            x, sc = _shared_block_apply(x, params["shared_block"], cfg,
                                        mode=mode, rope=rope, cache=sc,
                                        constrain=constrain)
            if sc is not None:
                new_caches[name] = sc
    return x, new_caches, aux_total


def encode(params, cfg: ModelConfig, enc_emb, constrain=_ID):
    """The bidirectional encoder over precomputed frame embeddings
    ``enc_emb`` [B, Se, D]: RoPE at ``arange(Se)``, self-attention through
    ``flash_attention`` with ``causal=False`` and no cap, the MLP, and the
    final encoder norm."""
    x = enc_emb
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    scale = _attn_scale(cfg)
    for p in params["encoder"]["layers"]:
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(h, p["attn"], cfg, rope, constrain)
        out = attention(q, k, v, causal=False, scale=scale)
        x = x + linear(out.reshape(b, s, -1), _wo(p["attn"], cfg))
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = constrain(x + mlp_block(h, p["mlp"], cfg.mlp_variant),
                      "act_resid")
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


# --------------------------------------------------------------------------
# heads and entry points
# --------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, inputs):
    """Token ids [B, S] looked up in the table (in the model dtype), or,
    for a model with ``embedding_inputs``, [B, S, D] embeddings used as
    they are."""
    if cfg.embedding_inputs and inputs.dim() == 3:
        return inputs
    table = params["embed"]
    if is_dtensor(table):
        return _embed_sharded(table, inputs).to(DTYPES[cfg.dtype])
    return table[inputs].to(DTYPES[cfg.dtype])


def _embed_sharded(table, ids):
    """DTensor ids [B, S] looked up in a DTensor table [V, D] on each
    rank's block: where the vocabulary is sharded, each rank looks up the
    ids its rows hold (0 for the others) and the partial sums are summed
    over the vocabulary's mesh dims (replicated there)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    vdims = shard_dims(table, 0)
    v_idx, n_v = coord(mesh, vdims)
    v_l = table.shape[0] // n_v
    id_pl = [p if p.is_shard(0) else Replicate() for p in ids.placements]
    out_pl, t_grad = [], []
    for i, p in enumerate(table.placements):
        if i in vdims:
            out_pl.append(Partial())
            t_grad.append(p)
        elif id_pl[i].is_shard(0):
            out_pl.append(Shard(0))
            t_grad.append(Partial())
        elif p.is_shard(1):
            out_pl.append(Shard(2))
            t_grad.append(p)
        else:
            out_pl.append(Replicate())
            t_grad.append(p)

    def local(tl, il):
        if not vdims:
            return tl[il]
        loc = il.long() - v_idx * v_l
        mine = (loc >= 0) & (loc < v_l)
        return tl[loc.clamp(0, v_l - 1)] * mine[..., None].to(tl.dtype)

    fn = local_map(local, out_placements=out_pl,
                   in_placements=(tuple(table.placements), tuple(id_pl)),
                   in_grad_placements=(tuple(t_grad), tuple(id_pl)),
                   device_mesh=mesh)
    out = fn(table, ids.redistribute(mesh, id_pl))
    if not vdims:
        return out
    return out.redistribute(mesh, [Replicate() if i in vdims else p
                                   for i, p in enumerate(out_pl)])


def _logits_layout(h, head):
    """h [B, S, D] placed for the plan's ``logits`` spec before the head's
    product, so that no rank computes logits it does not keep: the whole
    sequence where the head is vocab-sharded (h gathered where the
    residual is sequence-sharded, not the logits), else each rank's block
    of the sequence over the model axis where it divides."""
    mesh = h.device_mesh
    if shard_dims(head, 1):
        want = [Replicate() if p.is_shard(1) else p for p in h.placements]
    else:
        m = mesh.mesh_dim_names.index("model")
        if not (h.placements[m].is_replicate()
                and h.shape[1] % mesh.size(m) == 0):
            return h
        want = list(h.placements)
        want[m] = Shard(1)
    return h.redistribute(mesh, want)


def _logits(params, cfg: ModelConfig, h, constrain=_ID):
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    if is_dtensor(h):
        h = _logits_layout(h, head)
    logits = linear(h, head)
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(),
                         cfg.final_logit_softcap).to(h.dtype)
    return constrain(logits, "logits")


def cross_entropy(logits, labels):
    """Per-token cross entropy [B, S] of ``logits`` [B, S, V] (the model
    dtype) at ``labels`` [B, S], as the reference computes it: the
    max-shifted log-sum-exp in float32 (the max taken without a
    gradient), the label's logit picked by ``gather``, no one-hot."""
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels)
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = (logits - m).float()
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0].float()
    picked = shifted.gather(-1, labels[..., None].long())[..., 0]
    return lse - (picked + m[..., 0].float())


def _cross_entropy_sharded(logits, labels):
    """:func:`cross_entropy` of DTensor logits, on each rank's block:
    where the vocabulary is sharded, the max, the sum of exponentials and
    the label's logit (0 on the ranks that do not hold it) are each
    reduced over the vocabulary's mesh dims ([B, S] each, no gather of
    the logits), and the loss is replicated over them."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    logits = settle(logits)
    mesh = logits.device_mesh
    vdims = [i for i, p in enumerate(logits.placements) if p.is_shard(2)]
    v_idx, n_v = 0, 1
    for i in vdims:
        v_idx = v_idx * mesh.size(i) + mesh.get_local_rank(i)
        n_v *= mesh.size(i)
    groups = [mesh.get_group(i) for i in vdims]
    pl = [Replicate() if i in vdims else p
          for i, p in enumerate(logits.placements)]
    lab_pl = [p if p.is_shard() and p.dim < 2 else Replicate() for p in pl]
    v_l = logits.shape[-1] // n_v

    def local(lg, lab):
        m = lg.detach().amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        shifted = (lg - m).float()
        se = torch.exp(shifted).sum(dim=-1)
        if not groups:
            picked = shifted.gather(-1, lab[..., None].long())[..., 0]
        else:
            loc = lab.long() - v_idx * v_l
            mine = (loc >= 0) & (loc < v_l)
            picked = torch.where(mine, shifted.gather(
                -1, loc.clamp(0, v_l - 1)[..., None])[..., 0], 0.0)
            se = dfn.sum_replicated(se, groups)
            picked = dfn.sum_replicated(picked, groups)
        lse = torch.log(se) + m[..., 0].float()
        return lse - (picked + m[..., 0].float())

    fn = local_map(local, out_placements=list(lab_pl),
                   in_placements=(tuple(logits.placements), tuple(lab_pl)),
                   device_mesh=mesh)
    return fn(logits, labels.redistribute(mesh, lab_pl))


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = False,
            remat_policy: Optional[str] = None, constrain=_ID, ep=None,
            shard=None):
    """The training loss.  batch: {"tokens" [B, S] or "embeddings" [B, S,
    D], "labels" [B, S], optional "positions", "enc_emb" (an
    encoder-decoder) and "loss_weight" [B] (Raptor's per-sample weights:
    0 drops a failed or pre-empted flight member's samples and the mean
    renormalises over the rest)}.  Returns (ce + 0.01 * aux, {"ce",
    "aux"}), float32 scalars.  With ``shard`` the batch is this rank's
    block: ``ce`` is the block's weighted sum over the whole batch's
    weight sum, times the number of blocks, so that the blocks' mean is
    the whole batch's ``ce`` (a block whose weights are all 0 gives 0),
    and ``aux`` is the whole batch's."""
    enc_out = (encode(params, cfg, batch["enc_emb"], constrain)
               if cfg.is_encoder_decoder else None)
    x = _embed(params, cfg, batch["tokens"] if "tokens" in batch
               else batch["embeddings"])
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None and not cfg.attention_free:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if cfg.mrope:
            positions = positions[None].expand(3, b, s)
    h, _, aux = apply_stack(params, cfg, x, mode="train",
                            positions=positions, enc_out=enc_out,
                            remat=remat, remat_policy=remat_policy,
                            constrain=constrain, ep=ep, shard=shard)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    per_tok = cross_entropy(_logits(params, cfg, h, constrain),
                            batch["labels"])
    w = batch.get("loss_weight")
    blocks = 1 if shard is None else shard.size
    if w is not None:
        wt = w.float()[:, None]
        total = wt.sum()
        if blocks > 1:
            total = dfn.all_reduce_sum(total.detach(), shard.groups)
        ce = (per_tok * wt).sum() / torch.clamp(total * per_tok.shape[1],
                                                min=1.0)
        if blocks > 1:
            ce = ce * blocks
    else:
        ce = per_tok.mean()
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               *, device=None) -> Dict[str, Any]:
    """Preallocated decode cache (all zeros): a global attention layer
    holds ``max_len`` slots, a local layer ``min(window, max_len)``, a
    Mamba2 layer its conv tails and state, each of the hybrid's shared
    block applications ``max_len`` slots, an encoder-decoder layer
    ``max_len`` slots of its own keys and ``enc_len`` of the encoder's."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    hd = cfg.resolved_head_dim

    def zeros(c_len):
        return torch.zeros((batch, c_len, cfg.num_kv_heads, hd), dtype=dt,
                           device=dev)

    def kv(c_len):
        return {"k": zeros(c_len), "v": zeros(c_len)}

    caches: Dict[str, Any] = {"index": 0}
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            caches[f"layer_{i}"] = m2.init_ssm_cache(
                batch, cfg.d_model, cfg.ssm, dt, device=dev)
        elif cfg.is_encoder_decoder:
            caches[f"layer_{i}"] = {"self": kv(max_len),
                                    "cross_k": zeros(enc_len),
                                    "cross_v": zeros(enc_len)}
        else:
            caches[f"layer_{i}"] = kv(min(cfg.window_size, max_len)
                                      if kind == "local_attn" else max_len)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        for j in range(cfg.num_layers // cfg.hybrid_attn_every):
            caches[f"shared_{j}"] = kv(max_len)
    return caches


def clone_cache(caches: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a decode cache that can be decoded into independently."""
    if isinstance(caches, dict):
        return {name: clone_cache(c) for name, c in caches.items()}
    return caches.clone() if isinstance(caches, torch.Tensor) else caches


def prefill(params, cfg: ModelConfig, batch, max_len: int, *,
            constrain=_ID, ep=None, cache_fn=None):
    """Run the full prompt; return (last-position logits [B, V], filled
    cache).  ``batch``: {"tokens": [B, S] int or "embeddings": [B, S, D],
    optional "positions" ([B, S], or [3, B, S] for M-RoPE), and for an
    encoder-decoder "enc_emb": [B, Se, D]}.  ``cache_fn``: allocates the
    cache, :func:`init_cache`'s arguments (a sharded step's
    ``Plan.init_cache``)."""
    enc_out = (encode(params, cfg, batch["enc_emb"], constrain)
               if cfg.is_encoder_decoder else None)
    x = _embed(params, cfg, batch["tokens"] if "tokens" in batch
               else batch["embeddings"])
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None and not cfg.attention_free:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if cfg.mrope:
            positions = positions[None].expand(3, b, s)
    caches = (cache_fn or init_cache)(
        cfg, b, max_len, enc_out.shape[1] if enc_out is not None else 0,
        device=x.device)
    h, new_caches, _ = apply_stack(params, cfg, x, mode="prefill",
                                   positions=positions, caches=caches,
                                   enc_out=enc_out, constrain=constrain,
                                   ep=ep)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h[:, -1:], constrain)
    new_caches["index"] = s
    return logits[:, 0], new_caches


def _window(cfg: ModelConfig, name: str) -> int:
    """The attention window of cache ``name`` (0: global)."""
    if name.startswith("layer_") and \
            cfg.layer_kind(int(name[6:])) == "local_attn":
        return cfg.window_size
    return 0


_STEP_KEYS = ("index", "kv_pos", "cross_kv_pos")


def decode_step(params, cfg: ModelConfig, caches, tokens, *,
                constrain=_ID, ep=None):
    """One decode step.  tokens: [B, 1] int (or [B, 1, D] embeddings for
    a model with ``embedding_inputs``).  Writes the new keys and the
    Mamba2 states into ``caches`` in place; returns (logits [B, V], caches
    with index + 1)."""
    x = _embed(params, cfg, tokens)
    b = x.shape[0]
    idx = int(caches["index"])
    positions = None
    if not cfg.attention_free:
        positions = torch.full((3, b, 1) if cfg.mrope else (b, 1), idx,
                               dtype=torch.int32, device=x.device)
    # one kv_pos per (cache length, window), shared by the layers; the
    # cross attention's (every slot valid) one per encoder length
    kv_pos: Dict[tuple, torch.Tensor] = {}

    def positions_of(c_len, window):
        key = (c_len, window)
        if key not in kv_pos:
            kv_pos[key] = decode_positions(idx, c_len, window, x.device)
        return kv_pos[key]

    def cross_positions(c_len):
        key = (c_len, "cross")
        if key not in kv_pos:
            kv_pos[key] = torch.arange(c_len, dtype=torch.int32,
                                       device=x.device)
        return kv_pos[key]

    run_caches = {}
    for name, c in caches.items():
        if name == "index":
            continue
        if "self" in c:                      # an encoder-decoder layer
            sc = c["self"]
            run_caches[name] = dict(
                c, self=dict(sc, index=idx,
                             kv_pos=positions_of(sc["k"].shape[1], 0)),
                cross_kv_pos=cross_positions(c["cross_k"].shape[1]))
        elif "k" in c:
            run_caches[name] = dict(c, index=idx, kv_pos=positions_of(
                c["k"].shape[1], _window(cfg, name)))
        else:                                # a Mamba2 layer's cache
            run_caches[name] = c
    h, new_caches, _ = apply_stack(params, cfg, x, mode="decode",
                                   positions=positions, caches=run_caches,
                                   constrain=constrain, ep=ep)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h, constrain)

    def strip(c):
        return {k: strip(t) if isinstance(t, dict) else t
                for k, t in c.items() if k not in _STEP_KEYS}
    out = {name: strip(c) for name, c in new_caches.items()}
    out["index"] = idx + 1
    return logits[:, 0], out
