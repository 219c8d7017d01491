"""The sharding plan, the input specs and the dry run against the JAX
reference on the CPU.

* ``Plan``: for all ten reduced architectures on the 16x16 and 2x16x16
  abstract meshes (``jax.sharding.AbstractMesh`` on the reference's side:
  no devices), the port's spec equals the reference's ``PartitionSpec``
  (as a tuple) for every parameter, every activation role at the shapes
  the model gives it, and every batch and decode-cache leaf; with the
  plan's knobs (``zero3``, ``seq_parallel``, ``moe_token_align``) at
  their defaults and turned.
* ``Plan.distribute`` and ``full_tensor`` round trip every parameter, a
  batch and a cache on a (2, 2) gloo mesh, each local block of the shape
  its spec gives; ``constrain`` moves a ``DTensor`` to its role's
  placements and passes a plain tensor through.
* ``launch/specs.py``: every input stand-in of every (arch x shape) cell
  is a ``meta`` tensor of the reference's ``ShapeDtypeStruct``'s shape and
  dtype.
* The dry run: every cell of both meshes is ok, and its per-rank
  parameter and moment bytes equal the sums taken from the reference's
  specs over the reference's full-size ``eval_shape`` trees.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import ARCH_NAMES as J_ARCHS  # noqa: E402
from repro.configs import applicable_shapes as j_shapes  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.distributed.sharding import Plan as JPlan  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving.step import cache_shape as j_cache_shape  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training.step import train_state_shape as j_state  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import Plan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

MESHES = {"16x16": False, "2x16x16": True}
ROLES = ("act_resid", "moe_tokens", "act_heads", "act_kv_heads",
         "act_ff_out", "logits", "moe_logits", "moe_buffer", "moe_w_in",
         "moe_w_out", "ssm_inner", "kv_cache", "ssm_state", "conv_cache",
         "no_such_role")
KNOBS = ({}, {"zero3": False}, {"seq_parallel": True},
         {"seq_parallel": False, "moe_token_align": True})


def _meshes(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    return mesh, jax.sharding.AbstractMesh(mesh.axis_sizes, mesh.axis_names)


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _spec(s):
    return None if s is None else tuple(s)


def _role_shapes(cfg, b, s):
    """Shapes each role meets at batch b, sequence s (the model's own)."""
    d, hd, v = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size
    hq, hkv = max(cfg.num_heads, 1), max(cfg.num_kv_heads, 1)
    e = cfg.moe.num_experts if cfg.moe else 8
    ff = cfg.moe.expert_ff if cfg.moe else cfg.d_ff or 32
    shapes = [(b, s, d), (b * s, d), (b, s, hq, hd), (b, s, hkv, hd),
              (b, s, v), (b * s, e), (e, 2 * s, d), (e, d, ff), (e, ff, d),
              (b, s, 2 * d), (b, s, hkv, hd), (b, 4, 16, 16), (b, 3, 2 * d),
              (1, s, hkv, hd), (1, 4, 16, 16), (1, 3, 2 * d)]
    if cfg.pad_heads:
        shapes.append((b, s, cfg.pad_heads, hd))
    return shapes


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", J_ARCHS)
def test_plan_specs_equal_reference(name, mesh_name):
    assert ARCH_NAMES == J_ARCHS
    mesh, jmesh = _meshes(MESHES[mesh_name])
    jcfg = j_reduced(j_get_config(name))
    cfg = reduced_config(get_config(name))
    jparams = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.key(0)))
    params = tt.init_params(cfg, device="meta")
    for knobs in KNOBS:
        plan, jplan = Plan(mesh, cfg, **knobs), JPlan(jmesh, jcfg, **knobs)
        assert plan.data == jplan.data
        assert plan.seq_parallel == jplan.seq_parallel
        want = {_path(p): tuple(jplan.param_spec(_path(p), leaf.shape))
                for p, leaf in jax.tree_util.tree_flatten_with_path(
                    jparams)[0]}
        got = {n.replace(".", "/"): s
               for n, s in plan.param_specs(params).items()}
        assert got == want, knobs
        for b, s in ((32, 64), (1, 64), (3, 48)):
            for shape in _role_shapes(cfg, b, s):
                for role in ROLES:
                    if len(shape) != {"moe_tokens": 2, "moe_logits": 2,
                                      "conv_cache": 3, "ssm_inner": 3,
                                      "act_resid": 3, "act_ff_out": 3,
                                      "logits": 3, "moe_buffer": 3,
                                      "moe_w_in": 3, "moe_w_out": 3
                                      }.get(role, 4):
                        continue
                    assert plan.act_spec(role, shape) == _spec(
                        jplan.act_spec(role, shape)), (role, shape, knobs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", J_ARCHS)
def test_batch_and_cache_specs_equal_reference(name, mesh_name):
    mesh, jmesh = _meshes(MESHES[mesh_name])
    jcfg = j_reduced(j_get_config(name))
    cfg = reduced_config(get_config(name))
    plan, jplan = Plan(mesh, cfg), JPlan(jmesh, jcfg)
    for b, s in ((32, 64), (1, 64), (48, 16)):
        shape = ShapeConfig("t", s, b, "train")
        for make, jmake in ((TS.train_batch_specs, JS.train_batch_specs),
                            (TS.prefill_batch_specs,
                             JS.prefill_batch_specs)):
            jb = jplan.batch_shardings(jmake(jcfg, shape))
            assert plan.batch_specs(make(cfg, shape)) == {
                k: tuple(v.spec) for k, v in jb.items()}
        tok = TS.decode_token_specs(cfg, shape)
        assert plan.batch_specs(tok) == tuple(jplan.batch_shardings(
            JS.decode_token_specs(jcfg, shape)).spec)
        enc = TS.enc_len_for(cfg, shape)
        jcache = jplan.cache_shardings(j_cache_shape(jcfg, b, s, enc))
        want = {_path(p).replace("/", "."): tuple(v.spec)
                for p, v in jax.tree_util.tree_flatten_with_path(jcache)[0]
                if _path(p) != "index"}
        cache = tt.init_cache(cfg, b, s, enc, device="meta")
        assert plan.cache_specs(cache) == want
    # placements by name: Shard(d) on each mesh dim a spec's dim d names
    from torch.distributed.tensor import Replicate, Shard
    batch = TS.train_batch_specs(cfg, shape)
    params = tt.init_params(cfg, device="meta")
    for specs, placed in (
            (plan.cache_specs(cache), plan.cache_shardings(cache)),
            (plan.param_specs(params), plan.param_shardings(params)),
            (plan.batch_specs(batch), plan.batch_shardings(batch))):
        assert specs.keys() == placed.keys()
        for n, spec in specs.items():
            assert len(placed[n]) == len(mesh.axis_names)
            for axis, p in zip(mesh.axis_names, placed[n]):
                dims = [d for d, e in enumerate(spec)
                        if e == axis or (isinstance(e, tuple) and axis in e)]
                assert p == (Shard(dims[0]) if dims else Replicate()), n


@pytest.mark.parametrize("name", J_ARCHS)
def test_input_specs_are_the_references_on_meta(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    for shape, jshape in zip(dryrun.applicable_shapes(cfg), j_shapes(jcfg)):
        assert shape.name == jshape.name
        pairs = [(TS.train_batch_specs(cfg, shape),
                  JS.train_batch_specs(jcfg, jshape)),
                 (TS.prefill_batch_specs(cfg, shape),
                  JS.prefill_batch_specs(jcfg, jshape)),
                 ({"t": TS.decode_token_specs(cfg, shape)},
                  {"t": JS.decode_token_specs(jcfg, jshape)})]
        for got, want in pairs:
            assert set(got) == set(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), k
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
        assert TS.enc_len_for(cfg, shape) == JS.enc_len_for(jcfg, jshape)
    assert TS.ENC_RATIO == JS.ENC_RATIO == 4


def test_distribute_round_trips_on_a_2x2_gloo_mesh(tmp_path):
    out = run_ranks("plan_distribute", 4, tmp_path,
                    {"arch": "gemma2-9b", "shape": (2, 2)})
    for r in out:
        assert r == out[0]
        assert r["sharded"] > 0 and r["checked"] > r["sharded"]
        assert r["placements"] == ["S(0)", "R"]


def _ref_bytes(jplan, tree) -> int:
    total = 0
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = jplan.param_spec(_path(p), leaf.shape)
        n = np.dtype(leaf.dtype).itemsize
        for d, size in enumerate(leaf.shape):
            k = 1
            entry = spec[d] if d < len(spec) else None
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                k *= jplan.mesh.shape[a]
            assert size % k == 0
            n *= size // k
        total += n
    return total


@pytest.mark.parametrize("name", J_ARCHS)
def test_dry_run_bytes_equal_the_reference_specs(name):
    jcfg = j_get_config(name)
    oc = j_opt.OptConfig(state_dtype=jcfg.optimizer_state_dtype)
    state = j_state(jcfg, oc)
    for mesh_name, multi_pod in MESHES.items():
        rec = dryrun.run_cell(name, "train_4k", multi_pod)
        assert rec["ok"] and rec["mesh"] == mesh_name
        jplan = JPlan(_meshes(multi_pod)[1], jcfg)
        assert rec["param_bytes_per_device"] == _ref_bytes(
            jplan, state["params"])
        assert rec["opt_bytes_per_device"] == _ref_bytes(
            jplan, state["opt"]["mu"]) + _ref_bytes(jplan,
                                                    state["opt"]["nu"])
        assert "not reckoned" in rec["flops_per_device"]


def test_dry_run_cli_covers_every_cell(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--both-meshes", "--json", str(out)]) == 0
    cells = json.loads(out.read_text())
    want = sum(2 * len(j_shapes(j_get_config(n))) for n in J_ARCHS)
    assert len(cells) == want and all(c["ok"] for c in cells)
    assert f"done: {want}/{want} cells ok" in capsys.readouterr().out
    one = dryrun.run_cell("gemma-2b", "decode_32k", False)
    assert one["cache_bytes_per_device"] > 0
