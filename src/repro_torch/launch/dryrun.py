"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, planned and then run sharded on fake tensors.

The port of ``repro/launch/dryrun.py``.  Two parts:

- :func:`plan_cell` (in-process, no process group): the cell's
  parameters, AdamW moments, batch and decode cache as ``meta`` tensors,
  each leaf given its spec and DTensor placements by the
  :class:`~repro_torch.distributed.sharding.Plan` over an
  :class:`~repro_torch.launch.mesh.AbstractMesh` of 16x16 or 2x16x16
  ranks; every sharded dim must divide; the per-rank bytes of each part.
- :func:`count_cell`: the cell's sharded step (``make_train_step``,
  ``make_prefill_step`` or ``make_decode_step`` with ``plan=``, the state
  placed by ``Plan.shard_state`` / ``shard_params`` / ``init_cache``) run
  once over a ``DeviceMesh`` and counted from rank 0's view.  The
  counterpart of the reference's ``lower_cell`` + ``analyze``.  The
  command line runs it in a child interpreter (:func:`count_in_child`)
  whose default group is a ``"fake"`` process group of 256 or 512 ranks
  (collectives return at once, nothing is sent) and whose tensors are
  fake (``FakeTensorMode``: shapes, no storage); the pytest process never
  creates a group.  On real tensors over a gloo group it counts the same
  step the same way (the tests hold the two to each other).

The record keeps the reference's keys; in eager PyTorch they mean:

- ``flops_per_device``: the floating-point operations of the local
  (per-rank) tensor ops of the step, by ``torch.utils.flop_counter``'s
  formulas (matmuls, attention's products), the four kernels by their
  own counts (K3: 4 B Hq D x the (query, key) pairs its causal mask and
  window leave, the kernel skips the rest; K4: 4 B Hq D C; K5: 2 E C D F
  per product; K6: the chunked scan's four products, 2 b s (L g n + L h p
  + 2 h p n) with L the chunk).  XLA's count includes elementwise ops;
  this one does not.
- ``bytes_per_device``: each local op's input and output bytes summed
  (views excluded), with no fusion: an upper bound of the HBM traffic.
- ``arg_bytes``: the local bytes of the step's inputs (the train state
  and batch; the parameters and batch; the parameters, cache and
  tokens); ``out_bytes``: of its outputs that are not inputs updated in
  place (the cache and the state are); ``peak_bytes_per_device``: the
  most bytes live at once during the step (inputs included), tracked by
  ``torch.distributed._tools.mem_tracker.MemTracker`` (a peak below
  args + outputs raises: the tracker missed storages); ``temp_bytes`` =
  peak - args - outputs, so that peak = arg + temp + out as in the
  reference.
- ``collective_bytes``: per op, under the reference's names, the bytes
  of each collective's result on this rank (what the reference sums from
  the HLO's result shapes); ``n_collectives``: the collectives issued
  (``CommDebugMode``'s count, the ``wait`` of an async one not counted).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --multi-pod --json out.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --plan-only
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.configs import (ARCH_NAMES, applicable_shapes, get_config,
                                 reduced_config, shape_by_name)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import Plan, named_tensors
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, batch_axes,
                                    make_mesh, make_production_mesh)
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import EPSpec
from repro_torch.training.optimizer import OptConfig, init_opt_state

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute"}


def _bytes(plan: Plan, specs: Dict[str, tuple], tensors) -> int:
    """Per-rank bytes of ``tensors`` ({name: meta tensor}) under their
    specs; every spec's placements are built (and its dims divide)."""
    total = 0
    for name, spec in specs.items():
        t = tensors[name]
        plan.placements(spec)
        local = plan.local_shape(spec, tuple(t.shape))
        total += math.prod(local) * t.element_size()
    return total


def _opt_config(cfg: ModelConfig) -> OptConfig:
    return OptConfig(state_dtype=cfg.optimizer_state_dtype)


@functools.lru_cache(maxsize=16)
def _meta_state(cfg: ModelConfig):
    """The parameters and AdamW moments of ``cfg`` on ``meta``, built once
    per config (drawing on ``meta`` is slow, not free)."""
    params = tfm.init_params(cfg, device="meta")
    return params, init_opt_state(params, _opt_config(cfg))


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """The sharding of one (arch, shape) cell on ``mesh``: per-rank bytes
    of each part and the EP layout."""
    plan = Plan(mesh, cfg)
    ep = EPSpec(mesh, batch_axes(mesh)) if cfg.moe is not None else None
    params, opt = _meta_state(cfg)
    named = dict(params.named_parameters())
    rec: Dict[str, Any] = {
        "params": sum(p.numel() for p in named.values()),
        "param_bytes_per_device": _bytes(plan, plan.param_specs(params),
                                         named),
        "opt_bytes_per_device": 0, "batch_bytes_per_device": 0,
        "cache_bytes_per_device": 0}
    if ep is not None:
        rec["ep"] = {"dp": ep.dp, "tp": ep.tp,
                     "e_pad": ep.e_pad(cfg.moe.num_experts)}
    if shape.kind == "train":
        rec["opt_bytes_per_device"] = sum(
            _bytes(plan, plan.param_specs(opt[m]), opt[m])
            for m in ("mu", "nu"))
        batch = S.train_batch_specs(cfg, shape)
    elif shape.kind == "prefill":
        batch = S.prefill_batch_specs(cfg, shape)
    else:
        cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               S.enc_len_for(cfg, shape), device="meta")
        rec["cache_bytes_per_device"] = _bytes(
            plan, plan.cache_specs(cache), dict(named_tensors(cache)))
        batch = {"tokens": S.decode_token_specs(cfg, shape)}
    rec["batch_bytes_per_device"] = _bytes(plan, plan.batch_specs(batch),
                                           batch)
    return rec


# --------------------------------------------------------------------------
# counting the sharded step
# --------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors of a nest of tuples, lists, dicts and modules (their
    parameters)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        for _, p in x.named_parameters():
            yield p
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _local_tensors(x):
    """The local tensors of ``x``'s tensors (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    for t in _tensors(x):
        yield t.to_local() if isinstance(t, DTensor) else t


def _counter_class():
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        """FLOPs (``torch.utils.flop_counter``'s formulas), bytes and
        collectives of the local tensor ops: a DTensor op is passed on
        (``NotImplemented``) to the DTensor, whose local ops come back
        here."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.collective_bytes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if func.namespace in ("_c10d_functional", "c10d_functional",
                                  "c10d"):
                op = _COLLECTIVE_OPS.get(func._opname)
                if op is not None:
                    res = out if func.namespace != "c10d" else args[0]
                    self.collective_bytes[op] += sum(
                        _nbytes(t) for t in _tensors(res))
                return out
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in _tensors(args))
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
            return out
    return Counter


def _attention_pairs(sq: int, sk: int, causal: bool, window: int,
                     q_offset: int) -> int:
    """The (query, key) pairs that the causal mask and the window leave."""
    pos = np.arange(sq, dtype=np.int64) + q_offset      # not a tensor:
    hi = np.minimum(pos, sk - 1) if causal else np.full_like(  # no fake
        pos, sk - 1)                                     # mode here
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _kernel_counts():
    """{ops module: (the FLOPs of one call of its ``_forward``, the
    (shape, dtype) of each of its outputs)}."""
    from repro_torch.kernels.decode_attention import ops as k4
    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.moe_gmm import ops as k5
    from repro_torch.kernels.ssd_scan import ops as k6
    f32 = torch.float32

    def attn(q, k, v, causal, window, cap, scale, q_offset):
        b, hq, sq, d = q.shape
        pairs = _attention_pairs(sq, k.shape[2], causal, window, q_offset)
        return 4 * b * hq * d * pairs, [(q.shape, q.dtype)]

    def decode(q, k, v, kv_pos, scale, cap, lse):
        b, hq, d = q.shape
        outs = [(q.shape, q.dtype)] + ([((b, hq), f32)] if lse else [])
        return 4 * b * hq * d * k.shape[1], outs

    def gmm(buf, w):
        e, c, d = buf.shape
        return 2 * e * c * d * w.shape[2], [((e, c, w.shape[2]), buf.dtype)]

    def ssd(x, dt, A, B, C, chunk):
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        L = min(chunk, s)
        return (2 * b * s * (L * g * n + L * h * p + 2 * h * p * n),
                [(x.shape, x.dtype), ((b, h, p, n), f32)])
    return {k3: attn, k4: decode, k5: gmm, k6: ssd}


# the torch versions (major.minor) whose private hooks below were checked:
# ``counting_hooks`` refuses any other, so that an upgrade fails loudly
HOOKED_TORCH = ("2.11", "2.13")
_HOOKS = {"installed": False, "counter": None}


def _hook_kernels():
    """Each kernel's ``_forward`` counted as the kernel while a step is
    counted (``_HOOKS["counter"]`` set): its FLOPs are the kernel's count,
    its inputs' bytes are read, and its outputs are fresh tensors made
    under the counting modes (the kernel's allocation); on real tensors
    the plain version (the CPU path) fills them, unseen by the modes, on
    fake ones nothing runs.  Outside a counted step it is the kernel.
    Returns the originals."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import _disable_current_modes

    def wrap(orig, count):
        def counted(*args):
            counter = _HOOKS["counter"]
            if counter is None:
                return orig(*args)
            flops, shapes = count(*args)
            counter.flops += flops
            counter.bytes += sum(_nbytes(t) for t in _tensors(args))
            dev = args[0].device
            outs = [torch.empty(tuple(sh), dtype=dt, device=dev)
                    for sh, dt in shapes]
            if not isinstance(args[0], FakeTensor):
                with _disable_current_modes():
                    got = orig(*args)
                    got = got if isinstance(got, tuple) else (got,)
                    for o, g in zip(outs, got):
                        o.copy_(g)
            return tuple(outs) if len(outs) > 1 else outs[0]
        return counted
    saved = {}
    for mod, count in _kernel_counts().items():
        saved[mod] = mod._forward
        mod._forward = wrap(mod._forward, count)
    return saved


@contextlib.contextmanager
def counting_hooks():
    """The two process-wide hooks that :func:`count_step` needs, for the
    length of the block: each kernel's ``_forward`` counted
    (:func:`_hook_kernels`), and DTensor's sharding propagation, which
    runs each op once more on fake tensors of the global shapes to learn
    the output's shape (not the step's work), hidden from the counting
    modes (it patches ``ShardingPropagator._propagate_tensor_meta_non_
    cached``, a private method).  Enter it only in a process of its own:
    the child interpreter's entry (``--child``) or a test's rank worker.
    Raises on a torch outside ``HOOKED_TORCH``."""
    version = ".".join(torch.__version__.split(".")[:2])
    if version not in HOOKED_TORCH:
        raise RuntimeError(f"the dry run's counting hooks were written for "
                           f"torch {HOOKED_TORCH}, not {torch.__version__}")
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def unseen(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)
    setattr(ShardingPropagator, name, unseen)
    saved = _hook_kernels()
    _HOOKS["installed"] = True
    try:
        yield
    finally:
        _HOOKS["installed"] = False
        for mod, fn in saved.items():
            mod._forward = fn
        setattr(ShardingPropagator, name, orig)


def _fill(t: torch.Tensor, device) -> torch.Tensor:
    """A tensor of ``t``'s shape and dtype on ``device`` (zeros)."""
    return torch.zeros(tuple(t.shape), dtype=t.dtype, device=device)


def cell_inputs(cfg: ModelConfig, shape: ShapeConfig, plan: Plan):
    """(step, args) of the cell's sharded step on the CPU, its state
    placed by ``plan``: parameters drawn from seed 0, inputs zero (token
    0)."""
    from repro_torch.serving.step import make_decode_step, make_prefill_step
    from repro_torch.training.step import StepOptions, make_train_step
    device = "cpu"
    params = tfm.init_params(cfg, 0, device=device)
    if shape.kind == "train":
        oc = _opt_config(cfg)
        params.requires_grad_(True)
        state = plan.shard_state({"params": params,
                                  "opt": init_opt_state(params, oc)})
        batch = {k: _fill(v, device)
                 for k, v in S.train_batch_specs(cfg, shape).items()}
        step = make_train_step(cfg, oc, plan=plan, options=StepOptions(),
                               device=device)
        return step, (state, plan.shard_batch(batch))
    params = plan.shard_params(params)
    if shape.kind == "prefill":
        batch = {k: _fill(v, device)
                 for k, v in S.prefill_batch_specs(cfg, shape).items()}
        step = make_prefill_step(cfg, shape.seq_len, plan=plan)
        return step, (params, plan.shard_batch(batch))
    cache = plan.init_cache(cfg, shape.global_batch, shape.seq_len,
                            S.enc_len_for(cfg, shape), device=device)
    cache["index"] = shape.seq_len - 1
    tokens = plan.shard_batch(_fill(S.decode_token_specs(cfg, shape),
                                    device))
    return make_decode_step(cfg, plan=plan), (params, cache, tokens)


def count_step(step, args) -> Dict[str, Any]:
    """Run ``step(*args)`` once under the counters (module docstring);
    inside :func:`counting_hooks` only."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    if not _HOOKS["installed"]:
        raise RuntimeError("count_step runs inside counting_hooks()")
    counter = _counter_class()()
    local_args = list(_local_tensors(args))
    arg_ids = {t.untyped_storage()._cdata for t in local_args}
    arg_bytes = sum(_nbytes(t) for t in local_args)
    tracker = MemTracker()
    tracker.track_external(*local_args)
    t0 = time.perf_counter()
    _HOOKS["counter"] = counter
    try:
        with CommDebugMode() as comms, tracker, counter:
            out = step(*args)
    finally:
        _HOOKS["counter"] = None
    wall = time.perf_counter() - t0
    out_bytes = sum(_nbytes(t) for t in _local_tensors(out)
                    if t.untyped_storage()._cdata not in arg_ids)
    peak = max(v["Total"] for v in tracker.get_tracker_snapshot(
        "peak").values())
    if peak < arg_bytes + out_bytes:
        raise RuntimeError(f"the tracked peak, {peak} B, is below the "
                           f"inputs' and outputs' {arg_bytes} + "
                           f"{out_bytes} B: the tracker missed storages")
    colls = {op: float(counter.collective_bytes.get(op, 0))
             for op in COLLECTIVES}
    return {"flops_per_device": float(counter.flops),
            "bytes_per_device": float(counter.bytes),
            "arg_bytes": int(arg_bytes), "out_bytes": int(out_bytes),
            "temp_bytes": int(peak - arg_bytes - out_bytes),
            "peak_bytes_per_device": int(peak),
            "collective_bytes": colls,
            "n_collectives": int(comms.get_total_counts()),
            "step_s": wall}


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               fake: bool = True) -> Dict[str, Any]:
    """The counts of the cell's sharded step over ``mesh`` (a
    ``DeviceMesh``), on fake tensors or (``fake=False``) real ones."""
    plan = Plan(mesh, cfg)
    mode = contextlib.nullcontext()
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return count_step(*cell_inputs(cfg, shape, plan))


# --------------------------------------------------------------------------
# the child interpreter on a fake group
# --------------------------------------------------------------------------

def cell_shape(cell) -> ShapeConfig:
    """A cell's shape: a shape's name or (name, seq, batch, kind)."""
    if isinstance(cell["shape"], str):
        return shape_by_name(cell["shape"])
    name, seq, batch, kind = cell["shape"]
    return ShapeConfig(name, seq, batch, kind)


def cell_config(cell) -> ModelConfig:
    """A cell's config: ``cell["arch"]``, reduced with ``"reduced"``."""
    cfg = get_config(cell["arch"])
    return reduced_config(cfg) if cell.get("reduced") else cfg


def _child(spec_path: str, out_path: str) -> int:
    """Count ``spec["cells"]`` on a fake group of the mesh's size; one
    JSON record a line in ``out_path``, written as each cell ends."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    spec = json.loads(open(spec_path).read())
    shape, names = tuple(spec["mesh"][0]), tuple(spec["mesh"][1])
    dist.init_process_group("fake", rank=0, world_size=math.prod(shape))
    try:
        mesh = make_mesh(shape, names)
        with open(out_path, "w") as out, counting_hooks():
            for cell in spec["cells"]:
                t0 = time.perf_counter()
                try:
                    rec = count_cell(cell_config(cell), cell_shape(cell),
                                     mesh)
                    rec["ok"] = True
                except Exception as e:  # noqa: BLE001 - report, go on
                    rec = {"ok": False, "error": repr(e)[:500]}
                rec["count_s"] = time.perf_counter() - t0
                out.write(json.dumps(rec) + "\n")
                out.flush()
    finally:
        dist.destroy_process_group()
    return 0


def count_in_child(mesh_shape: Sequence[int], mesh_names: Sequence[str],
                   cells: Sequence[dict], *, timeout: float = 3600.0
                   ) -> list:
    """The counts of ``cells`` ({"arch", "shape": a shape name or (name,
    seq, batch, kind), "reduced": bool}) on a fake group of
    ``prod(mesh_shape)`` ranks in a child interpreter; one record a cell
    (``ok`` False with the error where one failed)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.json")
        out = os.path.join(tmp, "out.jsonl")
        with open(spec, "w") as f:
            json.dump({"mesh": [list(mesh_shape), list(mesh_names)],
                       "cells": list(cells)}, f)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--child",
             spec, out], env=env, capture_output=True, text=True,
            timeout=timeout)
        recs = []
        if os.path.exists(out):
            recs = [json.loads(ln) for ln in open(out) if ln.strip()]
        if proc.returncode != 0 or len(recs) != len(cells):
            err = (proc.stderr or proc.stdout)[-800:]
            recs += [{"ok": False, "error": f"child rc {proc.returncode}: "
                      f"{err}"}] * (len(cells) - len(recs))
        return recs


# --------------------------------------------------------------------------
# cells and the command line
# --------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "x".join(str(s) for s in PRODUCTION_SHAPES[bool(multi_pod)][0])


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """One cell's plan (in this process, no group)."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod)}
    t0 = time.perf_counter()
    rec.update(plan_cell(cfg, shape, mesh))
    rec["plan_s"] = time.perf_counter() - t0
    rec["ok"] = True
    return rec


def _say(rec, tag, echo) -> None:
    if not rec["ok"]:
        echo(f"[FAIL] {tag}: {rec.get('error', '')[:300]}")
        return
    msg = (f"[ok] {tag}: params/dev "
           f"{rec['param_bytes_per_device'] / 2**30:.3f} GiB opt/dev "
           f"{rec['opt_bytes_per_device'] / 2**30:.3f} GiB batch/dev "
           f"{rec['batch_bytes_per_device']:,} B cache/dev "
           f"{rec['cache_bytes_per_device'] / 2**30:.3f} GiB")
    if "flops_per_device" in rec:
        msg += (f" | flops/dev {rec['flops_per_device']:.3e} peak "
                f"{rec['peak_bytes_per_device'] / 2**30:.2f} GiB colls "
                f"{rec['n_collectives']} "
                + " ".join(f"{k} {v:.3e}" for k, v in
                           rec["collective_bytes"].items() if v)
                + f" ({rec['count_s']:.1f} s)")
    echo(msg)


def run_all(archs=None, shape=None, meshes=(False,), echo=print, *,
            count: bool = True):
    """Every cell of ``archs`` (all) x their applicable shapes (or
    ``shape``) x ``meshes`` (multi_pod flags): planned here and, with
    ``count``, counted in one child interpreter a mesh; a failing cell is
    recorded with ``ok`` False and its error."""
    results = []
    for mp in meshes:
        cells = []
        for arch in archs or ARCH_NAMES:
            cfg = get_config(arch)
            shapes = ([shape_by_name(shape)] if shape
                      else applicable_shapes(cfg))
            for sh in shapes:
                try:
                    rec = run_cell(arch, sh.name, mp)
                except Exception as e:  # noqa: BLE001 - report and go on
                    rec = {"arch": arch, "shape": sh.name,
                           "mesh": _mesh_name(mp), "ok": False,
                           "error": repr(e)[:500]}
                cells.append(rec)
        if count:
            sizes, names = PRODUCTION_SHAPES[bool(mp)]
            todo = [r for r in cells if r["ok"]]
            got = count_in_child(sizes, names, [
                {"arch": r["arch"], "shape": r["shape"]} for r in todo])
            for r, g in zip(todo, got):
                r.update(g)
        for rec in cells:
            _say(rec, f"{rec['arch']} x {rec['shape']} x {rec['mesh']}",
                 echo)
        results += cells
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--plan-only", action="store_true",
                    help="the specs' per-rank bytes only, no counted step")
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(*args.child)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    results = run_all([args.arch] if args.arch else None, args.shape,
                      meshes, echo=lambda m: print(m, flush=True),
                      count=not args.plan_only)
    failures = sum(not r["ok"] for r in results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"done: {len(results) - failures}/{len(results)} cells ok "
          f"({time.perf_counter() - t0:.1f} s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
