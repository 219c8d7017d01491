"""Multi-pod dry run: the sharding of every (architecture x input shape)
cell on the production meshes, on the ``meta`` device.

The port of ``repro/launch/dryrun.py``.  Each cell builds the model's
parameters, AdamW moments, batch and decode cache as ``meta`` tensors (no
device memory), the :class:`~repro_torch.distributed.sharding.Plan` and
the :class:`~repro_torch.models.moe.EPSpec` over an
:class:`~repro_torch.launch.mesh.AbstractMesh` of 16x16 or 2x16x16
ranks (no process group), gives every leaf its spec and DTensor
placements, checks that every sharded dim divides, and reports the
per-rank bytes of parameters, moments, batch and cache.  The reference
lowers and compiles each cell with XLA on 512 forced host devices; its
compiled FLOPs, ``memory_analysis`` and the HLO's collective bytes have
no eager counterpart and are recorded as "not reckoned".

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --multi-pod --json out.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time
from typing import Any, Dict

from repro_torch.configs import (ARCH_NAMES, applicable_shapes, get_config,
                                 shape_by_name)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import Plan, named_tensors
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import EPSpec
from repro_torch.training.optimizer import OptConfig, init_opt_state

NOT_RECKONED = ("not reckoned: XLA's compiled FLOPs, memory_analysis and "
                "the HLO's collective bytes have no eager counterpart")


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


@functools.lru_cache(maxsize=16)
def _meta_state(cfg: ModelConfig):
    """The parameters and AdamW moments of ``cfg`` on ``meta``, built once
    per config (drawing on ``meta`` is slow, not free)."""
    params = tfm.init_params(cfg, device="meta")
    return params, init_opt_state(params, OptConfig(
        state_dtype=cfg.optimizer_state_dtype))


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


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "x".join(str(s) for s in mesh.axis_sizes)}
    t0 = time.perf_counter()
    rec.update(plan_cell(cfg, shape, mesh))
    rec["plan_s"] = time.perf_counter() - t0
    rec["flops_per_device"] = rec["peak_bytes_per_device"] = \
        rec["collective_bytes"] = NOT_RECKONED
    rec["ok"] = True
    return rec


def run_all(archs=None, shape=None, meshes=(False,), echo=print):
    """Every cell of ``archs`` (all) x their applicable shapes (or
    ``shape``) x ``meshes`` (multi_pod flags); a failing cell is recorded
    with ``ok`` False and its error."""
    results = []
    for arch in archs or ARCH_NAMES:
        cfg = get_config(arch)
        shapes = ([shape_by_name(shape)] if shape
                  else applicable_shapes(cfg))
        for sh in shapes:
            for mp in meshes:
                tag = f"{arch} x {sh.name} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, sh.name, mp)
                    echo(f"[ok] {tag}: params/dev "
                         f"{rec['param_bytes_per_device'] / 2**30:.3f} GiB "
                         f"opt/dev {rec['opt_bytes_per_device'] / 2**30:.3f}"
                         f" GiB batch/dev {rec['batch_bytes_per_device']:,} B"
                         f" cache/dev "
                         f"{rec['cache_bytes_per_device'] / 2**30:.3f} GiB")
                except Exception as e:  # noqa: BLE001 - report and go on
                    rec = {"arch": arch, "shape": sh.name, "multi_pod": mp,
                           "ok": False, "error": repr(e)[:500]}
                    echo(f"[FAIL] {tag}: {repr(e)[:300]}")
                results.append(rec)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = run_all([args.arch] if args.arch else None, args.shape,
                      meshes, echo=lambda m: print(m, flush=True))
    failures = sum(not r["ok"] for r in results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"done: {len(results) - failures}/{len(results)} cells ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
