"""Sharding plan: logical roles -> specs -> DTensor placements, with
divisibility fallbacks.

The port of ``repro/distributed/sharding.py``.  Baseline parallelism:

- batch           -> ("pod", "data")    data parallelism (+ flight axis)
- weight dim0/in  -> "data"             ZeRO-3/FSDP parameter sharding
- weight out/TP   -> "model"            tensor parallelism (heads/ff/vocab)
- experts         -> "model"            expert parallelism
- activations     -> constrained at key points via ``plan.constrain``

A *spec* is a tuple with one entry per tensor dim: ``None``, a mesh-axis
name, or a tuple of names (major to minor) -- the structure of a
``jax.sharding.PartitionSpec``, normalised as it normalises (a one-name
tuple is the name, an empty one ``None``).  :meth:`Plan.placements` maps
a spec to DTensor placements, one per mesh dim (``Shard(d)`` where a dim
names that mesh dim, else ``Replicate()``).  Every rule checks
divisibility and degrades to replication, so all ten architectures fit
the fixed 16x16 and 2x16x16 meshes.

The plan reads only the mesh's names and sizes, so it takes an
:class:`~repro_torch.launch.mesh.AbstractMesh` (the spec tests) as well
as a ``DeviceMesh``; :meth:`Plan.distribute` and :meth:`Plan.constrain`
of a ``DTensor`` need the latter.

Running the plan (the counterpart of the reference's ``in_shardings``):
:meth:`Plan.shard_state` turns the train state's parameters and AdamW
moments into ``DTensor``s placed by :meth:`param_spec` (ZeRO-3 over the
data axes, tensor parallel over ``model``) and :meth:`shard_batch` /
:meth:`init_cache` the batch and the decode cache.  The steps read the
parameters through :meth:`gathered`, which gathers each weight over the
data axes where a layer reads it (ZeRO-3: under remat the backward
gathers it again, and its gradient comes back reduce-scattered) and
keeps its ``model`` placement; the activations follow ``constrain``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.functional import BatchShard
from repro_torch.launch.mesh import (axis_index, axis_sizes, batch_axes,
                                    is_abstract)

Spec = tuple


def _entry(axes):
    """One spec entry as a ``PartitionSpec`` keeps it."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def P(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def entry_axes(entry) -> tuple:
    """The mesh-axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def param_path(name: str) -> str:
    """A port parameter name (``layers.0.attn.wq``) as the reference's
    pytree path string (``layers/0/attn/wq``)."""
    return name.replace(".", "/")


class Gathered:
    """A parameter tree read through ``gather``: indexing it gives each
    tensor as ``gather(tensor)`` and each subtree as a ``Gathered``, so
    the model's ``p["wq"]`` reads a weight where the layer uses it."""

    def __init__(self, tree, gather):
        self._tree, self._gather = tree, gather

    def _wrap(self, v):
        if isinstance(v, torch.Tensor):
            return self._gather(v)
        return Gathered(v, self._gather)

    def __getitem__(self, key):
        return self._wrap(self._tree[key])

    def __contains__(self, key) -> bool:
        return key in self._tree

    def __iter__(self):
        return (self._wrap(v) for v in self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def named_tensors(tree, prefix: str = ""):
    """(name, tensor) of a ``ParamTree`` (its parameter names) or a nest
    of dicts of tensors (dotted names); other leaves (a cache's index)
    are skipped."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters()
        return
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from named_tensors(val, name + ".")
        elif isinstance(val, torch.Tensor):
            yield name, val


@dataclasses.dataclass
class Plan:
    mesh: Any
    cfg: ModelConfig
    data: Any = None          # the batch axes, filled in __post_init__
    model: str = "model"
    zero3: bool = True        # shard params + opt state over the data axes
    seq_parallel: Optional[bool] = None  # residual sharded over model on
    # seq; None = auto: on where the head count does not divide the model
    # axis (the reference's hill-climb result)
    moe_token_align: bool = False  # pre-shard tokens to the EP layout

    def __post_init__(self):
        self._sizes = axis_sizes(self.mesh)
        self.data = batch_axes(self.mesh)
        if self.seq_parallel is None:
            tp = self._axes_size(self.model)
            self.seq_parallel = bool(self.cfg.num_heads
                                     and self.cfg.num_heads % tp != 0)

    # -- helpers ------------------------------------------------------------
    def _axes_size(self, axes) -> int:
        n = 1
        for a in entry_axes(axes):
            n *= self._sizes[a]
        return n

    def _ok(self, dim: int, axes) -> bool:
        n = self._axes_size(axes)
        return n > 1 and dim % n == 0

    def _pick(self, shape, rules) -> Spec:
        """rules: (dim index, axes) applied where divisible and unused."""
        spec = [None] * len(shape)
        used = set()
        for d, axes in rules:
            if axes is None:
                continue
            key = (axes,) if isinstance(axes, str) else tuple(axes)
            if any(a in used for a in key):
                continue
            if self._ok(shape[d], axes) and spec[d] is None:
                spec[d] = axes
                used.update(key)
        return P(*spec)

    # -- parameters ---------------------------------------------------------
    def param_spec(self, path: str, shape) -> Spec:
        """The spec of a parameter, keyed by its pytree path string."""
        name = path.split("/")[-1]
        fsdp = self.data if self.zero3 else None
        m = self.model
        if name == "embed":
            return self._pick(shape, [(0, m), (1, fsdp)])
        if name == "lm_head":
            return self._pick(shape, [(1, m), (0, fsdp)])
        if name == "router":
            return self._pick(shape, [(0, fsdp)])
        if name in ("w_gate", "w_up") and len(shape) == 3:   # experts [E,D,F]
            return self._pick(shape, [(0, m), (1, fsdp), (2, m)])
        if name == "w_down" and len(shape) == 3:             # [E,F,D]
            return self._pick(shape, [(0, m), (1, m), (2, fsdp)])
        if name in ("wq", "wk", "wv", "w_gate", "w_up",
                    "in_z", "in_x", "in_B", "in_C", "in_dt"):
            return self._pick(shape, [(0, fsdp), (1, m)])
        if name in ("wo", "w_down", "out_proj"):
            return self._pick(shape, [(0, m), (1, fsdp)])
        if name in ("conv_x_w", "conv_B_w", "conv_C_w"):
            return self._pick(shape, [(1, m)])
        return P()  # norms, biases, A_log, dt_bias, D: replicated

    def param_specs(self, params) -> Dict[str, Spec]:
        """{parameter name: spec} of a ``ParamTree`` or a {name: tensor}
        map (the AdamW moments)."""
        return {name: self.param_spec(param_path(name), tuple(t.shape))
                for name, t in named_tensors(params)}

    # -- activations --------------------------------------------------------
    def act_spec(self, role: str, shape) -> Optional[Spec]:
        b, m = self.data, self.model
        if role == "act_resid":                              # [B,S,D]
            if self.seq_parallel and self._ok(shape[1], m):
                return P(b, m, None)
            return P(b, None, None)
        if role == "moe_tokens":                             # [T,D] pre-EP
            if not self.moe_token_align:
                return None
            axes = (*b, m)
            if self._ok(shape[0], axes):
                return P(axes, None)
            return P(b, None)
        if role == "act_heads":                              # [B,S,H,hd]
            rules = [(0, b), (2, m) if self._ok(shape[2], m) else (1, m)]
            return self._pick(shape, rules)
        if role == "act_kv_heads":
            rules = [(0, b)]
            if self._ok(shape[2], m):
                rules.append((2, m))
            return self._pick(shape, rules)
        if role == "act_ff_out":
            return P(b, None, None)
        if role == "logits":                                 # [B,S,V]
            if self._ok(shape[-1], m):
                return P(b, None, m)
            return self._pick(shape, [(0, b), (1, m)])
        if role == "moe_logits":                             # [T,E]
            return P(b, None)
        if role == "moe_buffer":                             # [E,C,D]
            rules = [(0, m)] if self._ok(shape[0], m) else []
            rules.append((1, b))
            return self._pick(shape, rules)
        if role == "moe_w_in":                               # [E,D,F]
            if self._ok(shape[0], m):
                return P(m, None, None)
            return self._pick(shape, [(2, m)])
        if role == "moe_w_out":                              # [E,F,D]
            if self._ok(shape[0], m):
                return P(m, None, None)
            return self._pick(shape, [(1, m)])
        if role == "ssm_inner":                              # [B,S,din]
            return self._pick(shape, [(0, b), (2, m)])
        if role == "kv_cache":                               # [B,C,hkv,hd]
            rules = [(0, b)] if shape[0] > 1 else [(1, b)]   # B=1: the seq
            # kv heads that do not divide the model axis shard the seq dim
            # (head_dim sharding would gather the whole cache per step)
            rules.append((2, m) if self._ok(shape[2], m) else (1, m))
            return self._pick(shape, rules)
        if role == "ssm_state":                              # [B,H,P,N]
            rules = [(0, b)] if shape[0] > 1 else []
            if self._ok(shape[1], m):
                rules.append((1, m))
            return self._pick(shape, rules)
        if role == "conv_cache":                             # [B,K-1,C]
            rules = [(0, b)] if shape[0] > 1 else []
            if self._ok(shape[2], m):
                rules.append((2, m))
            return self._pick(shape, rules)
        return None

    # -- batches / caches ---------------------------------------------------
    def batch_spec(self, name: str, shape) -> Spec:
        b = self.data
        if name == "positions" and len(shape) == 3:          # mrope [3,B,S]
            return P(None, b, None)
        spec = [None] * len(shape)
        if shape and shape[0] > 1 and self._ok(shape[0], b):
            spec[0] = b
        return P(*spec)

    def batch_specs(self, batch) -> Any:
        """{name: spec} of a batch dict, or the spec of a bare tensor (the
        decode step's tokens)."""
        if isinstance(batch, torch.Tensor):
            return self.batch_spec("", tuple(batch.shape))
        return {name: self.batch_spec(name, tuple(t.shape))
                for name, t in batch.items()}

    def cache_spec(self, name: str, shape) -> Spec:
        if name in ("k", "v", "cross_k", "cross_v"):
            role = "kv_cache"
        elif name == "state":
            role = "ssm_state"
        elif name.startswith("conv"):
            role = "conv_cache"
        else:
            return P()
        return self.act_spec(role, shape) or P()

    def cache_specs(self, cache) -> Dict[str, Spec]:
        """{dotted cache name (``layer_0.k``): spec}; the index is a host
        int and has none."""
        return {name: self.cache_spec(name.split(".")[-1], tuple(t.shape))
                for name, t in named_tensors(cache)}

    # -- placements ---------------------------------------------------------
    def placements(self, spec: Spec) -> tuple:
        """DTensor placements of ``spec``, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self._sizes:
            dims = [d for d, e in enumerate(spec) if name in entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local_shape(self, spec: Spec, shape) -> tuple:
        """The per-rank block of a tensor of ``shape`` under ``spec``;
        raises where a sharded dim does not divide."""
        out = []
        for d, n in enumerate(shape):
            k = self._axes_size(spec[d]) if d < len(spec) else 1
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {spec[d]} ({k})")
            out.append(n // k)
        return tuple(out)

    def param_shardings(self, params) -> Dict[str, tuple]:
        return {n: self.placements(s)
                for n, s in self.param_specs(params).items()}

    def batch_shardings(self, batch) -> Any:
        specs = self.batch_specs(batch)
        if isinstance(specs, tuple):
            return self.placements(specs)
        return {n: self.placements(s) for n, s in specs.items()}

    def cache_shardings(self, cache) -> Dict[str, tuple]:
        return {n: self.placements(s)
                for n, s in self.cache_specs(cache).items()}

    def distribute(self, tree, kind: str = "params") -> Dict[str, Any]:
        """{name: DTensor} of ``tree``'s tensors (``kind``: ``"params"``, a
        ``ParamTree`` or a {name: tensor} map; ``"batch"``; ``"cache"``),
        each placed by its spec with ``distribute_tensor`` on the plan's
        ``DeviceMesh``.  Every rank passes the same full tensors."""
        if is_abstract(self.mesh):
            raise ValueError("distribute needs a DeviceMesh; this plan's "
                             "mesh is abstract")
        specs = {"params": self.param_specs, "batch": self.batch_specs,
                 "cache": self.cache_specs}[kind](tree)
        tensors = dict(named_tensors(tree))
        return {name: self._place(tensors[name].detach(), spec)
                for name, spec in specs.items()}

    def _place(self, t, spec):
        """``t`` (the same whole tensor on every rank) as a DTensor under
        ``spec``: each rank keeps its block, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements(spec),
                                 src_data_rank=None)

    def constrain(self, t, role: str):
        """Redistribute a ``DTensor`` to ``role``'s spec; a plain tensor
        (the port's eager activations) passes through unchanged -- in the
        reference too this is a layout hint with no effect on values.
        A dim the spec shards but whose size its mesh dims do not divide
        (``act_resid``'s batch of one) stays replicated: XLA pads such a
        shard, DTensor could not reshape it."""
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(t, DTensor):
            return t
        spec = self.act_spec(role, tuple(t.shape))
        if spec is None:
            return t
        pl = list(self.placements(spec))
        for d, size in enumerate(t.shape):
            dims = [i for i, p in enumerate(pl) if p.is_shard(d)]
            if size % self._axes_size(tuple(
                    self.mesh.mesh_dim_names[i] for i in dims)):
                for i in dims:
                    pl[i] = Replicate()
        return t.redistribute(self.mesh, pl)

    # -- data parallelism -----------------------------------------------------
    def local_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's block of a global batch along the batch axes (a leaf
        whose batch dim does not divide stays whole on every rank)."""
        idx = axis_index(self.mesh, self.data)
        out = {}
        for name, t in batch.items():
            spec = self.batch_spec(name, tuple(t.shape))
            for d, e in enumerate(spec):
                if e is not None:
                    n = t.shape[d] // self._axes_size(e)
                    t = t.narrow(d, idx * n, n)
            out[name] = t
        return out

    def batch_groups(self) -> list:
        """The process groups of the batch axes, one per axis."""
        return [self.mesh.get_group(a) for a in self.data]

    def batch_size(self) -> int:
        return self._axes_size(self.data)

    def batch_shard(self, rows: int) -> Optional[BatchShard]:
        """This rank's block of a global batch of ``rows`` over the batch
        axes (:meth:`local_batch`), or None where the rows do not divide:
        the batch spec then leaves the batch whole on every rank."""
        if self.batch_size() > 1 and not self._ok(rows, self.data):
            return None
        return BatchShard(tuple(self.batch_groups()), self.batch_size(),
                          axis_index(self.mesh, self.data))

    # -- running the plan -----------------------------------------------------
    def gather(self, t):
        """A parameter as a layer reads it: a ``DTensor`` sharded over the
        data axes is gathered over them (ZeRO-3), its ``model`` placement
        kept; anything else passes through."""
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        want = tuple(Replicate() if n in self.data else p
                     for n, p in zip(names, t.placements))
        if want == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)

    def gathered(self, params) -> Gathered:
        """``params`` read through :meth:`gather`."""
        return Gathered(params, self.gather)

    def shard_params(self, params):
        """Every parameter of ``params`` (a ``ParamTree``) made, in place,
        a ``DTensor`` parameter placed by its spec; returns ``params``."""
        for mod_name, mod in params.named_modules():
            for name, p in list(mod._parameters.items()):
                full = f"{mod_name}.{name}" if mod_name else name
                spec = self.param_spec(param_path(full), tuple(p.shape))
                mod._parameters[name] = torch.nn.Parameter(
                    self._place(p.detach(), spec),
                    requires_grad=p.requires_grad)
        return params

    def shard_state(self, state):
        """The train state ``{"params", "opt": {"mu", "nu", "step"}}`` with
        the parameters and both moments as DTensors placed by the
        parameters' specs (the step count stays a plain scalar)."""
        params = self.shard_params(state["params"])
        opt = dict(state["opt"])
        for m in ("mu", "nu"):
            opt[m] = self.distribute(opt[m], "params")
        return {**state, "params": params, "opt": opt}

    def shard_batch(self, batch):
        """A batch dict (or the decode step's bare tokens) as DTensors
        placed by :meth:`batch_spec`."""
        if isinstance(batch, torch.Tensor):
            return self._place(batch, self.batch_spec("", tuple(
                batch.shape)))
        return {n: self._place(t, self.batch_spec(n, tuple(t.shape)))
                for n, t in batch.items()}

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   enc_len: int = 0, *, device=None):
        """The decode cache of ``transformer.init_cache`` as DTensor zeros
        placed by :meth:`cache_spec`, each rank allocating its block on
        the mesh's device (``device``, ``init_cache``'s, is not read)."""
        from torch.distributed.tensor import zeros
        from torch.utils._python_dispatch import _disable_current_modes
        from repro_torch.models import transformer as tfm
        with _disable_current_modes():   # shapes only, seen by no mode
            shapes = tfm.init_cache(cfg, batch, max_len, enc_len,
                                    device="meta")

        def build(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = build(v)
                elif isinstance(v, torch.Tensor):
                    out[k] = zeros(tuple(v.shape), dtype=v.dtype,
                                   device_mesh=self.mesh,
                                   placements=self.placements(
                                       self.cache_spec(k, tuple(v.shape))))
                else:
                    out[k] = v
            return out
        return build(shapes)
