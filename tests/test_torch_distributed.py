"""The port's distributed runtime on gloo ranks, against the JAX reference
on the CPU.

Every multi-rank case runs in fresh interpreters (``tests/_torch_ranks.py``:
one process a rank, a gloo group joined through a ``FileStore`` in
``tmp_path``); the reference's multi-device runs are subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=N``, as
tests/test_jaxops_multidevice.py runs them.  No test sets that flag or
creates a process group in the pytest process.

* Flight collectives: ``first_finisher``, ``masked_mean`` and
  ``k_of_n_mean`` on 4 ranks against ``repro.core.jaxops`` over the pod
  axis of a (4, 2) mesh of 8 devices, on the cases of
  tests/test_jaxops_multidevice.py (latencies [3, 1, 2, 5], health
  [1, 0, 1, 1], k=2), a latency tie with no healthy member, and a k=3 tie;
  a dict value with a bf16 leaf (rtol 1e-6).  ``speculative_apply`` over a
  (pod, model) mesh.
* Meshes: the abstract production meshes' batch axes and sizes as the
  reference's; building a mesh without a group raises and says what to
  pass.
* Sweeps: the open- and closed-loop plans over a config mesh of 1, 2
  and 4 ranks are bit-identical to ``devices=None`` (and so to each
  other); ``devices=2`` without a group raises
  (tests/test_torch_sweeps.py).
* Data-parallel step: on 2 and 4 ranks (data axis), one
  ``make_train_step`` step on a batch split over data (the dense cases
  through ``plan=`` on a ``plan.shard_state`` state, ZeRO-3 over data;
  the MoE case through ``batch_blocks=``, replicated weights) gives
  the gradients, metrics and parameters of the reference's single-device
  step on the whole batch (gradients 1e-5 x max |g|, metrics 1e-5
  relative; parameters as tests/test_torch_training.py holds Adam
  steps): dense gemma-2b; gemma-2b with a ``loss_weight`` that zeroes
  one rank's whole block (the renormalisation over the survivors); and
  MoE granite with a dead block, whose batch overflows an expert's
  capacity (the dispatch and the aux loss of the whole batch).  The
  step refuses the reference's unread options, an abstract plan, the
  batch-block path for a dense config and both paths at once.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ranks import ROOT, run_ranks  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import step as j_step  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.training.raptor_dp import signals_to_weights  # noqa: E402

VALS = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
CASES = [([3.0, 1.0, 2.0, 5.0], [1.0, 0.0, 1.0, 1.0], 2),
         ([2.0, 1.0, 1.0, 5.0], [0.0, 0.0, 0.0, 0.0], 2),
         ([1.0, 2.0, 1.0, 3.0], [1.0, 1.0, 1.0, 1.0], 3)]

JAX_FLIGHT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core.jaxops import first_finisher, k_of_n_mean, masked_mean
    from repro.launch.mesh import make_mesh
    from repro.models.moe import shard_map

    mesh = make_mesh((4, 2), ("pod", "model"))
    vals = jnp.asarray(np.arange(24, dtype=np.float32).reshape(4, 6))
    row = P("pod", None)

    def member(lat, h, val):
        tree = {"a": val, "b": val[:, :2].astype(jnp.bfloat16)}
        adopted, winner = first_finisher(tree, lat[0], "pod")
        m, n = masked_mean(val, h[0], "pod")
        km = k_of_n_mean(val, lat[0], K, "pod")
        return (adopted, jnp.broadcast_to(winner, (1,)), m,
                jnp.broadcast_to(n, (1,)), km)

    out = {}
    for i, (lats, health, k) in enumerate(%(cases)r):
        K = k
        f = shard_map(member, mesh, in_specs=(P("pod"), P("pod"), row),
                      out_specs=({"a": row, "b": row}, P("pod"), row,
                                 P("pod"), row))
        adopted, winner, m, n, km = jax.jit(f)(
            jnp.asarray(lats), jnp.asarray(health), vals)
        out.update({f"{i}_adopted": adopted["a"],
                    f"{i}_adopted_b": adopted["b"].astype(jnp.float32),
                    f"{i}_winner": winner, f"{i}_masked": m, f"{i}_n": n,
                    f"{i}_k_of_n": km})
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
    print("FLIGHT_OK")
""") % dict(cases=CASES)


def test_flight_collectives_match_reference_on_4_ranks(tmp_path):
    dst = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", JAX_FLIGHT, str(dst)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    ours = run_ranks("collectives", 4, tmp_path,
                     {"vals": VALS, "cases": CASES})
    log, _ = ref.communicate(timeout=240)
    assert "FLIGHT_OK" in log, log
    want = np.load(dst)
    for i, (lats, health, k) in enumerate(CASES):
        for r, rank in enumerate(ours):
            got = rank[i]
            assert got["winner"] == int(want[f"{i}_winner"][r]) \
                == int(np.argmin(lats))
            assert got["n"] == float(want[f"{i}_n"][r]) == sum(health)
            for key in ("adopted", "adopted_b", "masked", "k_of_n"):
                np.testing.assert_allclose(got[key], want[f"{i}_{key}"][r],
                                           rtol=1e-6, err_msg=f"{i} {key}")
    # the reference test's expectations, and the ties' owners
    np.testing.assert_array_equal(ours[0][0]["adopted"], VALS[1])
    np.testing.assert_array_equal(ours[0][0]["k_of_n"], VALS[[1, 2]].mean(0))
    np.testing.assert_array_equal(ours[0][1]["masked"], np.zeros(6))
    np.testing.assert_array_equal(ours[0][2]["k_of_n"],
                                  VALS[[0, 2, 1]].mean(0))


def test_speculative_apply_adopts_the_first_finisher(tmp_path):
    """Pods race on a (pod=2, model=2) mesh: every rank adopts pod 1's
    value for its own model coordinate."""
    out = run_ranks("speculative", 4, tmp_path,
                    {"shape": (2, 2), "lats": [3.0, 1.0]})
    for r in out:
        assert r["winner"] == 1
        np.testing.assert_array_equal(r["value"],
                                      np.full(3, 10.0 + r["model"]))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_abstract_meshes_read_as_the_reference(multi_pod):
    mesh = t_mesh.make_production_mesh(multi_pod=multi_pod)
    shape, names = t_mesh.PRODUCTION_SHAPES[multi_pod]
    jmesh = jax.sharding.AbstractMesh(shape, names)
    assert t_mesh.axis_sizes(mesh) == dict(jmesh.shape)
    assert mesh.size() == int(np.prod(shape))
    for fn in ("batch_axes", "tp_size", "dp_size"):
        assert getattr(t_mesh, fn)(mesh) == getattr(j_mesh, fn)(jmesh), fn


def test_meshes_need_a_process_group():
    assert not torch.distributed.is_initialized()
    for build in (lambda: t_mesh.make_mesh((2,), ("data",)),
                  lambda: t_mesh.make_host_mesh(2, 1),
                  lambda: t_mesh.make_config_mesh(2),
                  lambda: t_mesh.make_production_mesh(abstract=False)):
        with pytest.raises(RuntimeError, match="init_process_group"):
            build()


# --------------------------------------------------------------------------
# sweeps over a config mesh
# --------------------------------------------------------------------------

SWEEP_ARGS = {"configs": [dict(flight=f, num_azs=a) for f in (2, 3, 4)
                          for a in (1, 3, 5)],
              "trials": 64, "rates": [2.0, 3.0, 4.0, 5.0, 6.0], "jobs": 32}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sweeps_are_bit_identical_across_rank_counts(world, tmp_path):
    out = run_ranks("sweeps", world, tmp_path, SWEEP_ARGS, timeout=240)
    solo = out[0]["solo"]
    assert len(solo["open"]) == 9 and len(solo["closed"]) == 5
    for r in out:
        np.testing.assert_equal(r["mesh"], solo)
        np.testing.assert_equal(r["count"], solo)
        np.testing.assert_equal(r["solo"], solo)


# --------------------------------------------------------------------------
# the data-parallel step
# --------------------------------------------------------------------------

DP_SHAPE = ShapeConfig("dp", 16, 4, "train")
DP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# (arch, the data rank whose whole block gets loss_weight 0 or None)
DP_CASES = {"dense": ("gemma-2b", None),
            "dead-block": ("gemma-2b", 0),
            "moe-dead-block": ("granite-moe-3b-a800m", 1)}


def _dp_batch(cfg, world, dead):
    batch = make_batch(cfg, DP_SHAPE, 0)
    if dead is not None:
        health = np.ones(world, np.float32)
        health[dead] = 0.0
        batch["loss_weight"] = signals_to_weights(DP_SHAPE.global_batch,
                                                  world, health=health)
    return batch


def test_dp_cases_drop_slots_and_blocks(monkeypatch):
    """The MoE case's whole batch overflows an expert's capacity (the
    dispatch drops slots, so the blocks must rank them as the whole batch
    does), and a dead block's weights are all 0."""
    arch, dead = DP_CASES["moe-dead-block"]
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced_config(get_config(arch))
    params = tt.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu")
    batch = _dp_batch(cfg, 2, dead)
    kept = []
    dispatch = tmoe._dispatch_local

    def spy(*a, **kw):
        buf, routing = dispatch(*a, **kw)
        kept.append((int(routing[2].sum()), routing[2].numel()))
        return buf, routing
    monkeypatch.setattr(tmoe, "_dispatch_local", spy)
    with torch.no_grad():
        tt.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    assert len(kept) == cfg.num_layers
    assert any(n < slots for n, slots in kept), kept
    w = batch["loss_weight"].reshape(2, -1)
    assert not w[dead].any() and w[1 - dead].all()


@pytest.mark.parametrize("options", [
    dict(grad_compression="int8"), dict(raptor_k_of_n=(2, "pod")),
    dict(plan="abstract"), dict(batch_blocks="dense"),
    dict(plan="both")])
def test_step_refuses_what_it_would_drop(options):
    """The reference's unread step options are refused, not dropped, and
    so are a data-parallel step over an abstract mesh, the batch-block
    path for a dense config and both data-parallel paths at once."""
    from repro_torch.distributed.sharding import Plan
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import StepOptions, make_train_step
    cfg = reduced_config(get_config("gemma-2b"))
    plan = Plan(t_mesh.make_production_mesh(), cfg)
    if options.get("plan") == "abstract":
        kw = dict(plan=plan)
        match = "DeviceMesh"
    elif "batch_blocks" in options:
        kw = dict(batch_blocks=plan)
        match = "pass plan= and a state from plan.shard_state"
    elif "plan" in options:
        kw = dict(plan=plan, batch_blocks=plan)
        match = "not both"
    else:
        kw = dict(options=StepOptions(**options))
        match = "grad_transform=compress_grads"
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, OptConfig(), device="cpu", **kw)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(DP_CASES))
def test_data_parallel_step_matches_reference_single_device(case, world,
                                                            tmp_path):
    arch, dead = DP_CASES[case]
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    batch = _dp_batch(cfg, world, dead)
    out = run_ranks("dp_step", world, tmp_path, {
        "arch": arch, "shape": (world, 1), "params": nparams,
        "opt": DP_OPT, "batch": batch})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    joc = j_opt.OptConfig(**DP_OPT)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_step.make_loss_fn(jcfg, remat=False), has_aux=True))(
            jparams, jbatch)
    jstate, jm = jax.jit(j_step.make_train_step(
        jcfg, joc, options=j_step.StepOptions(remat=False)))(
            {"params": jparams, "opt": j_opt.init_opt_state(jparams, joc)},
            jbatch)

    def leaf(tree, name):
        for part in name.split("."):
            tree = tree[int(part)] if isinstance(tree, list) else tree[part]
        return np.asarray(tree)
    for r in out[1:]:                 # every rank holds the same state
        np.testing.assert_equal(r["params"], out[0]["params"])
        assert r["metrics"] == out[0]["metrics"]
    got = out[0]
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert got["metrics"][k] == pytest.approx(float(jm[k]), rel=1e-5,
                                                  abs=1e-7), k
    assert got["metrics"]["loss"] == pytest.approx(float(jloss), rel=1e-5)
    for name, g in got["grads"].items():
        want = leaf(jgrads, name)
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    diffs = np.concatenate([
        np.abs(p - leaf(jstate["params"], n)).ravel()
        for n, p in got["params"].items()])
    assert diffs.max() <= 2 * DP_OPT["lr"]
    assert (diffs > 1e-7).mean() <= 1e-3
