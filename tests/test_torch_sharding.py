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
* The dry run: every cell of both meshes is planned (``--plan-only``:
  the counted steps of all 68 cells take minutes; PERF.md records that
  run), and its per-rank parameter and moment bytes equal the sums taken
  from the reference's specs over the reference's full-size
  ``eval_shape`` trees.  The counting: on the reduced gemma-2b, granite
  and zamba2 train, prefill and decode cells (B=8, S=64) over a fake 2x2
  group in a child interpreter, ``arg_bytes`` equals the reference's
  ``analyze`` on a forced 4-device 2x2 host mesh (a ``python -c``
  subprocess; the decode cache's ``index`` is a host int in the port, a
  4-byte int32 there), and the FLOPs per device, the collectives' count
  and bytes equal what the same counters count in the real 4-rank gloo
  run of the same cells, and so does the tracked peak (within 1e-4: the
  fake run frees one 0-dim int32 of MoE granite's step an op sooner);
  the reference's FLOPs, collective bytes and peak are printed beside
  the port's, not compared (GSPMD partitions the step its own way).
"""
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from _torch_ranks import ROOT, run_ranks  # noqa: E402
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
        assert not any("not reckoned" in str(v) for v in rec.values())


def test_dry_run_cli_covers_every_cell(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--both-meshes", "--plan-only", "--json",
                        str(out)]) == 0
    cells = json.loads(out.read_text())
    want = sum(2 * len(j_shapes(j_get_config(n))) for n in J_ARCHS)
    assert len(cells) == want and all(c["ok"] for c in cells)
    assert f"done: {want}/{want} cells ok" in capsys.readouterr().out
    one = dryrun.run_cell("gemma-2b", "decode_32k", False)
    assert one["cache_bytes_per_device"] > 0


COUNT_ARCHS = ("gemma-2b", "granite-moe-3b-a800m", "zamba2-1.2b")
COUNT_CELLS = [{"arch": a, "shape": ["t", 64, 8, kind], "reduced": True}
               for a in COUNT_ARCHS for kind in ("train", "prefill",
                                                 "decode")]
JAX_ANALYZE = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from repro.configs import get_config, reduced_config
    from repro.configs.base import ShapeConfig
    from repro.launch.dryrun import analyze, lower_cell
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=2)
    out = []
    for cell in json.loads(sys.argv[1]):
        cfg = reduced_config(get_config(cell["arch"]))
        name, seq, batch, kind = cell["shape"]
        with mesh:
            out.append(analyze(lower_cell(cfg, ShapeConfig(
                name, seq, batch, kind), mesh)))
    print("ANALYZE " + json.dumps(out))
""")


def _reference_analyze(cells):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_ANALYZE,
                           json.dumps(cells)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("ANALYZE ")][-1]
    return json.loads(line[len("ANALYZE "):])


def test_dry_run_counts_equal_a_gloo_run_and_the_reference_args(tmp_path):
    got = {}

    def in_thread(key, fn):
        def run():
            try:
                got[key] = fn()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                got[key] = e
        t = threading.Thread(target=run)
        t.start()
        return t
    threads = [
        in_thread("ref", lambda: _reference_analyze(COUNT_CELLS)),
        in_thread("fake", lambda: dryrun.count_in_child(
            (2, 2), ("data", "model"), COUNT_CELLS, timeout=600))]
    real = run_ranks("count_cells", 4, tmp_path,
                     {"shape": (2, 2), "cells": COUNT_CELLS}, timeout=600)
    for t in threads:
        t.join()
    for key in ("ref", "fake"):
        if isinstance(got[key], BaseException):
            raise got[key]
    for cell, fake, ref, *ranks in zip(COUNT_CELLS, got["fake"], got["ref"],
                                        *real):
        tag = f"{cell['arch']} {cell['shape'][3]}"
        assert fake["ok"], (tag, fake.get("error"))
        print(f"{tag}: port flops/dev {fake['flops_per_device']:.4g} "
              f"collectives {fake['n_collectives']} "
              f"{fake['collective_bytes']} | reference flops/dev "
              f"{ref['flops_per_device']:.4g} {ref['collective_bytes']} "
              f"n {ref['n_collectives']}")
        # the decode cache's index: 4 bytes of int32 in the reference
        index = 4 if cell["shape"][3] == "decode" else 0
        assert fake["arg_bytes"] + index == ref["arg_bytes"], tag
        real0 = ranks[0]
        assert real0["arg_bytes"] == fake["arg_bytes"], tag
        assert real0["flops_per_device"] == fake["flops_per_device"], tag
        assert real0["n_collectives"] == fake["n_collectives"], tag
        assert real0["collective_bytes"] == fake["collective_bytes"], tag
        assert fake["n_collectives"] > 0 and fake["flops_per_device"] > 0
        # the tracked peak, unclamped (count_step raises where it falls
        # below the inputs and outputs), is the real run's: within 1e-4,
        # since on fake tensors MoE granite's step frees a 0-dim int32
        # (4 B on one rank) one op sooner than on real ones
        assert fake["peak_bytes_per_device"] == pytest.approx(
            real0["peak_bytes_per_device"], rel=1e-4), tag
        assert fake["temp_bytes"] == fake["peak_bytes_per_device"] - (
            fake["arg_bytes"] + fake["out_bytes"]) and fake["temp_bytes"] > 0
        print(f"{tag}: peak {fake['peak_bytes_per_device']} (real "
              f"{real0['peak_bytes_per_device']}, reference "
              f"{ref['peak_bytes_per_device']})")
