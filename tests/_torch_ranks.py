"""Run a scenario of the port on N gloo ranks, each a fresh interpreter
that imports neither jax nor the reference.

``run_ranks(name, world, tmp_path, args)`` starts ``world`` processes of
this file; each joins a gloo group through a ``FileStore`` in
``tmp_path`` (no port is opened), runs ``SCENARIOS[name](args)`` and
pickles what it returns (numpy arrays, numbers, dicts and lists of them)
for the caller, which gets one result per rank.  ``args`` travels as a
pickle too.  Every process has its own timeout.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(name: str, world: int, tmp_path, args=None, *,
              timeout: float = 120.0) -> list:
    tmp = Path(tmp_path) / f"ranks_{name}_{world}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    (tmp / "args.pkl").write_bytes(pickle.dumps(args))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, name, str(r), str(world), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out = f"timed out after {timeout} s\n{out}"
        outs.append(out)
        failed |= p.returncode != 0
    if failed:
        raise AssertionError("a rank failed:\n" + "\n---\n".join(
            f"rank {r} (rc {p.returncode}):\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _np(t):
    import torch
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_np(v) for v in t)
    return t


# --------------------------------------------------------------------------
# scenarios (run on every rank)
# --------------------------------------------------------------------------

def collectives(args):
    """The flight collectives over the world group on each case of
    ``args["cases"]``: (lats, health, k) per member; value = the member's
    row of ``args["vals"]``, also as a dict (a pytree)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distops
    r = dist.get_rank()
    vals = torch.as_tensor(args["vals"])
    out = []
    for lats, health, k in args["cases"]:
        v = vals[r]
        adopted, winner = distops.first_finisher(
            {"a": v, "b": v[:2].to(torch.bfloat16)}, lats[r])
        m, n = distops.masked_mean(v, torch.tensor(health[r]))
        km = distops.k_of_n_mean(v, float(lats[r]), k)
        out.append({"adopted": _np(adopted["a"]),
                    "adopted_b": _np(adopted["b"]),
                    "winner": int(winner), "masked": _np(m), "n": float(n),
                    "k_of_n": _np(km)})
    return out


def speculative(args):
    """``speculative_apply`` over the (pod, model) mesh, the flight axis
    ``pod``: member i's value is ``base + 10 * i + model rank``, its
    latency ``args["lats"][i]``."""
    import torch
    from repro_torch.core.distops import speculative_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(args["shape"], ("pod", "model"))
    m = mesh.get_local_rank("model")

    def member(i, base):
        return base + 10.0 * i + m, args["lats"][i]

    value, winner = speculative_apply(member, mesh, "pod", (None,))(
        torch.zeros(3))
    return {"value": _np(value), "winner": int(winner), "model": m}


def plan_distribute(args):
    """``Plan.distribute`` and ``full_tensor`` on a (data, model) mesh:
    every parameter, a batch and a cache round trip, each local block of
    the shape its spec gives; ``constrain`` moves a DTensor to its role's
    placements and passes a plain tensor through."""
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import Plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt
    from torch.distributed.tensor import DTensor, distribute_tensor
    cfg = reduced_config(get_config(args["arch"]))
    mesh = make_host_mesh(*args["shape"])
    plan = Plan(mesh, cfg)
    params = tt.init_params(cfg, 0, device="cpu")
    cache = tt.init_cache(cfg, 4, 16, device="cpu")
    for c in cache.values():
        if isinstance(c, dict):
            for t in c.values():
                t.normal_(generator=torch.Generator().manual_seed(1))
    batch = {"tokens": torch.arange(64).reshape(4, 16),
             "labels": torch.arange(64).reshape(4, 16) + 1}
    checked, sharded = 0, 0
    for kind, tree, specs in (
            ("params", params, plan.param_specs(params)),
            ("batch", batch, plan.batch_specs(batch)),
            ("cache", cache, plan.cache_specs(cache))):
        full = dict(tree.named_parameters()) if kind == "params" else {
            n: t for n, t in _walk(tree)}
        for name, d in plan.distribute(tree, kind).items():
            assert isinstance(d, DTensor), name
            assert torch.equal(d.full_tensor(), full[name]), name
            want = plan.local_shape(specs[name], tuple(full[name].shape))
            assert tuple(d.to_local().shape) == want, (name, want)
            checked += 1
            sharded += want != tuple(full[name].shape)
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    assert plan.constrain(x, "act_resid") is x
    dx = distribute_tensor(x, mesh, plan.placements(()))
    moved = plan.constrain(dx, "act_resid")
    assert tuple(moved.placements) == plan.placements(
        plan.act_spec("act_resid", tuple(x.shape)))
    assert torch.equal(moved.full_tensor(), x)
    return {"checked": checked, "sharded": sharded,
            "placements": [str(p) for p in moved.placements]}


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}.")
        elif hasattr(v, "shape"):
            yield f"{prefix}{k}", v


def moe_ep(args):
    """``moe_block_ep`` over a (data, model) mesh on this rank's block of
    ``args["x"]``: y, aux and the gradients of ``sum(y * cot) + aux_w *
    aux / dp`` (summed over the data ranks, the reference's loss) with
    respect to x and every MoE parameter."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    from repro_torch.models import moe as tm
    from repro_torch.distributed import functional as dfn
    mesh = make_host_mesh(*args["shape"])
    ep = tm.EPSpec(mesh, batch_axes(mesh))
    moe = MoEConfig(**args["moe"])
    d = mesh.get_local_rank("data")
    b = args["x"].shape[0] // ep.dp
    x = torch.as_tensor(args["x"][d * b:(d + 1) * b]).requires_grad_(True)
    cot = torch.as_tensor(args["cot"][d * b:(d + 1) * b])
    p = {k: torch.as_tensor(v).requires_grad_(True)
         for k, v in args["params"].items() if k != "shared"}
    if "shared" in args["params"]:
        p["shared"] = {k: torch.as_tensor(v).requires_grad_(True)
                       for k, v in args["params"]["shared"].items()}
    calls, skipped = dfn.all_to_all.calls, dfn.all_to_all.skipped
    y, aux = tm.moe_block_ep(x, p, moe, args["variant"], ep)
    loss = (y * cot).sum() + args["aux_w"] * aux / ep.dp
    leaves = [x] + [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    grads = torch.autograd.grad(loss, leaves)
    names = ("x", "router", "w_gate", "w_up", "w_down")
    return {"y": _np(y), "aux": float(aux), "data": d,
            "model": mesh.get_local_rank("model"),
            "all_to_all": dfn.all_to_all.calls - calls,
            "all_to_all_skipped": dfn.all_to_all.skipped - skipped,
            "grads": dict(zip(names, _np(list(grads))))}


def dp_step(args):
    """One data-parallel ``make_train_step`` step over a (data, model)
    mesh on the global batch ``args["batch"]``: a dense config's through
    ``plan=`` on a ``plan.shard_state`` state, an MoE config's through
    ``batch_blocks=``; the metrics, the updated parameters and the
    gradients that reach ``grad_transform`` (each whole)."""
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import Plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import StepOptions, make_train_step
    cfg = reduced_config(get_config(args["arch"]))
    plan = Plan(make_host_mesh(*args["shape"]), cfg)
    params = tt.params_from_numpy(args["params"], device="cpu")
    params.requires_grad_(True)
    oc = opt.OptConfig(**args["opt"])
    seen = {}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def record(grads):
        seen.update(_np({k: whole(g).clone() for k, g in grads.items()}))
        return grads
    state = {"params": params, "opt": opt.init_opt_state(params, oc)}
    if cfg.moe is None:
        kw = dict(plan=plan)
        state = plan.shard_state(state)
    else:
        kw = dict(batch_blocks=plan)
    step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                           grad_transform=record, device="cpu", **kw)
    state, m = step(state, args["batch"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {n: _np(whole(t)) for n, t in
                       state["params"].named_parameters()},
            "grads": seen}


def sweeps(args):
    """The open- and closed-loop sweep plans over a config mesh of the
    whole group, and (every rank) the same plans with ``devices=None``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_config_mesh
    from repro_torch.sim import vector as PV
    from repro_torch.sim import vector_queue as PQ
    mesh = make_config_mesh()
    out = {}
    for devices, tag in ((mesh, "mesh"), (None, "solo"),
                         (dist.get_world_size(), "count")):
        out[tag] = {
            "open": PV.sweep_pairs(PV.keygen_vector(), args["configs"],
                                   trials=args["trials"], seed=3,
                                   devices=devices, device="cpu"),
            "closed": PQ.rate_sweep(PQ.keygen_queue(), args["rates"],
                                    jobs=args["jobs"], trials=2, seed=1,
                                    devices=devices, device="cpu")}
    return out


def _cfg(args):
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config(args["arch"]))
    return dataclasses.replace(cfg, **args.get("overrides", {}))


def _refusal(fn):
    """The message of the ``ValueError`` that ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def sharded_step(args):
    """The plan run sharded on a (data, model) mesh of
    ``args["shape"]``: one ``make_train_step(..., plan=)`` step on a
    ``plan.shard_state`` state (the metrics, every gradient whole, this
    rank's local bytes of parameters and moments), then a sharded prefill
    of ``args["prompt"]`` (the last logits whole) and ``args["steps"]``
    greedy decode steps (the tokens)."""
    import torch
    from repro_torch.distributed.sharding import Plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.serving.step import (greedy_sample, make_decode_step,
                                          make_prefill_step)
    from repro_torch.training import optimizer as opt
    from repro_torch.training.step import StepOptions, make_train_step
    cfg = _cfg(args)
    mesh = make_host_mesh(*args["shape"])
    plan = Plan(mesh, cfg)
    ep = None
    if cfg.moe is not None and "capacity_factor" in args:
        from repro_torch.models.moe import EPSpec
        ep = EPSpec(mesh, plan.data, capacity_factor=args["capacity_factor"])
    out = {}
    if "batch" in args:
        params = tt.params_from_numpy(args["params"], device="cpu")
        params.requires_grad_(True)
        oc = opt.OptConfig(**args["opt"])
        state = plan.shard_state({"params": params,
                                  "opt": opt.init_opt_state(params, oc)})
        out["local_bytes"] = sum(
            t.to_local().numel() * t.element_size()
            for tree in (dict(state["params"].named_parameters()),
                         state["opt"]["mu"], state["opt"]["nu"])
            for t in tree.values())
        seen = {}

        def record(grads):
            seen.update({k: _np(g.full_tensor()) for k, g in grads.items()})
            return grads
        step = make_train_step(cfg, oc, plan=plan,
                               options=StepOptions(remat=args.get("remat",
                                                                  False)),
                               grad_transform=record, ep=ep,
                               device="cpu")
        state, m = step(state, args["batch"])
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["grads"] = seen
    if "prompt" in args:
        plain = tt.params_from_numpy(args["params"], device="cpu")
        prompt = {k: torch.as_tensor(v) for k, v in args["prompt"].items()}
        s = next(iter(prompt.values())).shape[1]
        # a plan's steps refuse plain parameters and a plain state
        oc = opt.OptConfig(**args["opt"])
        out["refused"] = [_refusal(fn) for fn in (
            lambda: make_prefill_step(cfg, s + 1, plan=plan)(plain, prompt),
            lambda: make_decode_step(cfg, plan=plan)(plain, None, None),
            lambda: make_train_step(cfg, oc, plan=plan, device="cpu")(
                {"params": plain, "opt": opt.init_opt_state(plain, oc)},
                args.get("batch")))]
        params = plan.shard_params(plain)
        logits, cache = make_prefill_step(cfg, s + args["steps"], ep=ep,
                                          plan=plan)(params, prompt)
        logits = logits.full_tensor()
        out["logits"] = _np(logits)
        decode = make_decode_step(cfg, ep=ep, plan=plan)
        toks = []
        for _ in range(args["steps"]):
            tok = greedy_sample(logits)
            toks.append(_np(tok))
            logits, cache = decode(params, cache, tok[:, None])
            logits = logits.full_tensor()
        out["tokens"] = toks
        out["decode_logits"] = _np(logits)
    return out


def count_cells(args):
    """``dryrun.count_cell`` on real tensors over a (data, model) mesh of
    ``args["shape"]``, for each cell of ``args["cells"]``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*args["shape"])
    with dryrun.counting_hooks():
        return [dryrun.count_cell(dryrun.cell_config(c),
                                  dryrun.cell_shape(c), mesh, fake=False)
                for c in args["cells"]]


SCENARIOS = {f.__name__: f for f in (collectives, speculative,
                                     plan_distribute, moe_ep, dp_step,
                                     sweeps, sharded_step, count_cells)}


def _main(name, rank, world, tmp):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), int(world)),
        rank=int(rank), world_size=int(world))
    try:
        args = pickle.loads((tmp / "args.pkl").read_bytes())
        out = SCENARIOS[name](args)
        bad = sorted(m for m in sys.modules if m == "jax" or
                     m.startswith("jax.") or m == "repro" or
                     m.startswith("repro."))
        assert not bad, bad
        (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:5])
