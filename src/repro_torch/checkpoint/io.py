"""Sharded checkpointing with crash-safe commit, in the reference's layout.

The port of ``repro/checkpoint/io.py``: ``<dir>/step_<N>/shard_<host>.npz``
plus ``manifest_<host>.json`` written LAST (the commit point: a restore
only considers directories with a manifest, so a crash mid-write leaves
no corrupt restore target).  Keys are the tree's path joined by ``/``, as
the reference's ``_flatten`` makes them (``params/layers/0/attn/wq``,
``opt/mu/layers/0/attn/wq``, ``opt/step``); a module's parameter names
(``layers.0.attn.wq``) and the moments' keys split at their dots.

Float32 and integer leaves are written as they are; bf16 leaves are
widened to float32, which is lossless, so the reference's ``restore`` can
read a checkpoint of the port and a bf16 state round-trips exactly (the
reference writes bf16 as an opaque ``|V2`` array that it cannot cast
back; this module reads such an array as bf16 bits).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of a nest of dicts, lists, modules and leaves."""
    if isinstance(tree, nn.Module):
        return [(prefix + name.replace(".", "/"), p)
                for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}{str(k).replace('.', '/')}/")
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()                        # lossless
        return t.cpu().numpy().copy()
    return np.array(leaf)


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:    # bf16 bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, state, *, host_id: int = 0,
         keep: int = 3, block: bool = True) -> threading.Thread:
    """Write one host's shard of ``state``; the manifest commits the
    step.  The tensors are copied to the host before this returns, so a
    non-blocking save (``block=False``) may overlap the next step."""
    arrays = {k: _to_numpy(v) for k, v in _flatten(state)}

    def _write():
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, f"shard_{host_id}.npz"), **arrays)
        manifest = {"step": step, "host_id": host_id,
                    "keys": sorted(arrays), "format": 1}
        with open(os.path.join(d, f"manifest_{host_id}.json"), "w") as f:
            json.dump(manifest, f)
        _gc(ckpt_dir, keep)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if block:
        t.join()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            d = os.path.join(ckpt_dir, name)
            if any(f.startswith("manifest_") for f in os.listdir(d)):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def _fill(tree, arrays, prefix: str = ""):
    """``tree`` with every tensor leaf (module parameters too) set from
    ``arrays`` in place."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for key, p in _flatten(tree, prefix):
                p.copy_(_to_tensor(_get(arrays, key), p))
        return tree
    if isinstance(tree, dict):
        return {k: _fill(v, arrays, f"{prefix}{str(k).replace('.', '/')}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, arrays, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"{prefix[:-1]}: restore fills tensors, not "
                        f"{type(tree).__name__}")
    with torch.no_grad():
        tree.copy_(_to_tensor(_get(arrays, prefix[:-1]), tree))
    return tree


def _get(arrays, key):
    if key not in arrays:
        raise KeyError(f"checkpoint missing {key}")
    return arrays[key]


def restore(ckpt_dir: str, state_like, *, step: Optional[int] = None,
            host_id: int = 0):
    """Restore into ``state_like``: its tensors and module parameters are
    overwritten IN PLACE (each keeps its dtype and device), as the train
    step updates them.  Returns (state, step).  Raises FileNotFoundError
    when no committed checkpoint exists."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, f"shard_{host_id}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return _fill(state_like, arrays), step
