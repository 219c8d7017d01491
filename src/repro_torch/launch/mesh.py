"""Meshes over ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  Functions, not module-level
constants: importing this module creates no process group and reads no
environment.  A mesh is either

- a :class:`~torch.distributed.device_mesh.DeviceMesh` over an
  initialized process group (:func:`make_mesh`; the caller creates the
  group with ``torch.distributed.init_process_group``: NCCL on the card,
  gloo on the CPU, or the ``"fake"`` backend, whose collectives send
  nothing, for the dry run's 256 and 512 ranks in one process), or
- an :class:`AbstractMesh`, a record of dim names and sizes with no
  group and no devices, the counterpart of ``jax.sharding.AbstractMesh``:
  the sharding plan and the dry run reason about the 512-rank production
  mesh with it.

The single-pod mesh is (data=16, model=16) = 256 ranks; the multi-pod
mesh adds a leading pod axis: (pod=2, data=16, model=16) = 512.  The
``pod`` axis doubles as the Raptor *flight* axis: a serving invocation
flown at concurrency 2 runs one member per pod.

:func:`batch_axes`, :func:`tp_size`, :func:`dp_size` and
:func:`axis_sizes` read only names and sizes, so they take either kind.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Dim sizes and names without a process group or devices."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} names")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def axis_sizes(mesh) -> Dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def is_abstract(mesh) -> bool:
    return isinstance(mesh, AbstractMesh)


def _device_type() -> str:
    """A mesh's device type follows the group's backend: NCCL meshes
    hold CUDA tensors, gloo and fake meshes CPU ones."""
    return "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"


def _require_group(what: str) -> int:
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialized process group: call "
            f"torch.distributed.init_process_group(backend, "
            f"init_method='tcp://localhost:<port>' or store=..., rank=, "
            f"world_size=) first (NCCL on the card, gloo on the CPU)")
    return torch.distributed.get_world_size()


def make_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` with dim ``names`` over the ranks of
    the initialized group (``init_device_mesh``); the product of
    ``shape`` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _require_group("make_mesh")
    shape, names = tuple(int(s) for s in shape), tuple(names)
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the group "
                         f"has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = True):
    """The 16x16 (or 2x16x16) production mesh: abstract by default (no
    host holds 256 ranks), or a ``DeviceMesh`` over a group of that many
    ranks with ``abstract=False``."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    if abstract:
        return AbstractMesh(shape, names)
    return make_mesh(shape, names)


def make_config_mesh(devices=None):
    """1-D ``("config",)`` mesh, the sweeps' axis, over every rank
    of the initialized group (``devices`` None) or the group's size given
    as an int (which must then equal it)."""
    world = _require_group("make_config_mesh")
    n = world if devices is None else int(devices)
    return make_mesh((n,), ("config",))


def make_host_mesh(data: int = 1, model: int = 1):
    """A small (data, model) mesh over the ranks that exist: ``data`` is
    cut to the world size and ``model`` to what is left of it; the
    product must then be the world size (a ``DeviceMesh`` spans the
    group)."""
    n = _require_group("make_host_mesh")
    data = min(data, n)
    model = max(1, min(model, n // data))
    return make_mesh((data, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in batch_axes(mesh):
        out *= sizes[a]
    return out


def axis_index(mesh, axes) -> int:
    """This rank's flat coordinate over ``axes`` (a name or a tuple of
    names, major to minor) of a ``DeviceMesh``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx
