"""Configuration sweeps: every config-grid sweep through ONE plan.

The paper's claims are sweep-shaped — delay ratio and failure rate vs
load, AZ count, flight size.  A :class:`SweepPlan` is the declarative
form of a sweep: a config grid, a set of static-shape *buckets* (grouped
with :func:`repro_torch.sim.vector.bucket_by_pad` so ragged axes like
flight size share one batch), and one core per bucket that runs every
configuration of the bucket at once.

The configuration axis is pure batching.  Every configuration of a
bucket reads the same draws, from a generator seeded as a solo run seeds
its own, and the per-configuration knobs (arrival rate, AZ count, rho,
the Table-6 overhead lognormal) broadcast over them; the closed-loop
cores stack the configurations as more rows of the one booking batch, so
one ``queue_booking`` launch books ``configs x trials`` rows and one
``maxplus_scan`` launch scans that many columns.  Each configuration's
summary (:func:`repro_torch.sim.vector.summary_row`) is reduced on the
device by the same function a solo run uses, and the whole plan comes to
the host in one transfer: a closed-loop sweep equals each configuration's
``QueueFlightSim.run_pair``, and an open-loop configuration whose flight
and AZ count equal its bucket's pads its ``VectorFlightSim.run_pair``,
bit for bit (tests/test_torch_sweeps.py).

``run(devices=...)`` spreads the configuration axis over the ranks of a
1-D ``("config",)`` mesh (``launch.mesh.make_config_mesh``): each bucket's
axis is padded with replicas of its first configuration, each rank runs
its slice with the bucket's generator seeded as every rank seeds it, and
an all-gather hands every rank the whole grid.  The axis is pure
batching, so the result is bit-identical for any rank count
(tests/test_torch_distributed.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.launch.mesh import make_config_mesh
from repro_torch.sim.cluster import OverheadModel, lognormal_params
from repro_torch.sim.vector import (SUMMARY_KEYS, VectorWorkload,
                                    _raptor_sweep_core, _stock_sweep_core,
                                    bucket_by_pad, host_summary,
                                    summary_row)


def _summary_rows(resp, ok) -> torch.Tensor:
    """``(C, len(SUMMARY_KEYS))`` summaries of a ``(C, ...)`` batch, one
    :func:`summary_row` per configuration."""
    return torch.stack([summary_row(resp[c], ok[c])
                        for c in range(resp.shape[0])])


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepTask:
    """One static-shape bucket of a plan.

    ``core(gen, cfg, shared)`` runs every configuration of the bucket:
    ``cfg`` holds one sequence per knob with one value per configuration,
    ``shared`` the arguments common to all; it returns the
    configurations' summary rows ``(len(idxs), len(SUMMARY_KEYS))`` on the
    device.  ``key`` seeds the bucket's generator.
    """
    tag: str                      # output slot ("raptor" / "stock")
    idxs: Tuple[int, ...]         # plan-level config indices in this bucket
    core: Callable
    key: int                      # generator seed
    cfg: tuple                    # per-config values, len(idxs) each
    shared: tuple                 # arguments common to the bucket


class SweepPlan:
    """A config grid plus the bucketed runners for it.

    ``run(devices=...)`` executes every bucket on the plan's device
    (``None``: the CUDA card) and hands each config's per-tag summaries to
    ``finalize(config, parts) -> dict``.  ``devices``: ``None`` or 1 (this
    process alone), a 1-D ``DeviceMesh``, or a rank count (a config mesh
    over the initialized group, which must have that many ranks); every
    rank of the mesh calls ``run`` and gets the whole grid.
    """

    def __init__(self, name: str, configs, tasks, finalize, device=None):
        self.name = name
        self.configs = list(configs)
        self.tasks = list(tasks)
        self.finalize = finalize
        self.device = device
        self.validate()

    def validate(self) -> None:
        """Bucketing must partition the grid per output tag: every config
        index in exactly one bucket — a plan can never silently drop (or
        double-run) grid points."""
        for tag in {t.tag for t in self.tasks}:
            seen = sorted(i for t in self.tasks if t.tag == tag
                          for i in t.idxs)
            if seen != list(range(len(self.configs))):
                raise ValueError(
                    f"plan {self.name!r}: tag {tag!r} buckets cover "
                    f"{len(set(seen))}/{len(self.configs)} grid points")

    def _sharded(self, task, gen, mesh, dev) -> torch.Tensor:
        """The bucket's rows over the config mesh: rank r runs configs
        ``[r * per, (r + 1) * per)`` of the padded axis, and never a local
        batch of one (except a one-config bucket), as in the reference."""
        world, me = mesh.size(), mesh.get_local_rank()
        n = len(task.idxs)
        d = 1 if n == 1 else max(1, min(world, n // 2))
        per = -(-n // d)
        cfg = tuple(list(v) + [v[0]] * (per * d - n) for v in task.cfg)
        if me < d:
            local = task.core(gen, tuple(v[me * per:(me + 1) * per]
                                         for v in cfg), task.shared)
        else:                       # no configs here: zeros to the gather
            local = torch.zeros((per, len(SUMMARY_KEYS)),
                                dtype=torch.float64, device=dev)
        out = torch.empty((world * per,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=dev)
        dist.all_gather_into_tensor(out, local.contiguous(),
                                    group=mesh.get_group())
        return out[:n]

    def run(self, devices=None) -> List[dict]:
        mesh = None
        if devices is not None and not (isinstance(devices, int)
                                        and devices == 1):
            mesh = (make_config_mesh(devices) if isinstance(devices, int)
                    else devices)
        dev = resolve_device(self.device)
        rows = []
        for task in self.tasks:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(task.key))
            rows.append(task.core(gen, task.cfg, task.shared)
                        if mesh is None else
                        self._sharded(task, gen, mesh, dev))
        # ONE host transfer for the whole plan
        host = torch.cat(rows).cpu()
        parts: List[Dict[str, dict]] = [{} for _ in self.configs]
        off = 0
        for task in self.tasks:
            for j, i in enumerate(task.idxs):
                parts[i][task.tag] = host_summary(host[off + j])
            off += len(task.idxs)
        return [self.finalize(c, p) for c, p in zip(self.configs, parts)]


def _pair(parts) -> dict:
    res = {"stock": parts["stock"], "raptor": parts["raptor"]}
    res["mean_ratio"] = res["raptor"]["mean"] / res["stock"]["mean"]
    return res


# --------------------------------------------------------------------------
# open-loop pairs (the sim/vector.py family): pad-and-mask over flight size
# --------------------------------------------------------------------------

def _open_raptor_core(trials, f_pad, num_tasks, a_pad, dist, fail_prob,
                      faults, policy):
    def core(gen, cfg, shared):
        flight, num_azs, rho, oh_mu, oh_sigma = cfg
        mean, offset, cv, stage_oh, slat = shared
        t, ok, _ = _raptor_sweep_core(
            gen, flight, num_azs, rho, mean, offset, cv, stage_oh, slat,
            oh_mu, oh_sigma, trials=trials, flight_max=f_pad,
            num_tasks=num_tasks, azs_max=a_pad, dist=dist,
            fail_prob=fail_prob, faults=faults, policy=policy)
        return _summary_rows(t, ok)
    return core


def _open_stock_core(trials, num_tasks, dist, fail_prob, faults, policy):
    def core(gen, cfg, shared):
        rho, oh_mu, oh_sigma = cfg
        mean, offset, cv = shared
        t, ok, _ = _stock_sweep_core(
            gen, rho, mean, offset, cv, oh_mu, oh_sigma, trials=trials,
            num_tasks=num_tasks, dist=dist, fail_prob=fail_prob,
            faults=faults, policy=policy)
        return _summary_rows(t, ok)
    return core


def open_loop_pair_plan(wl: VectorWorkload, configs, *, trials: int = 20_000,
                        seed: int = 0, device=None) -> SweepPlan:
    """``sweep_pairs`` as a plan: many (flight, num_azs, rho, load) points,
    stock + raptor, raptor bucketed by pow2-padded flight size so every
    bucket shares one batch with masked-member waste under 2x."""
    cfgs = [dict(flight=int(c["flight"]), num_azs=int(c["num_azs"]),
                 rho=float(c.get("rho", 0.95)),
                 load=c.get("load", "medium")) for c in configs]

    # Table-6 overhead regimes are keyed by (ha, load) — a 1-AZ config in
    # the same sweep as HA configs must NOT inherit the HA overhead row
    def oh_of(c):
        return lognormal_params(
            *OverheadModel.TABLE[(c["num_azs"] > 1, c["load"])])

    tasks = []
    for f_pad, idxs in sorted(
            bucket_by_pad(c["flight"] for c in cfgs).items()):
        sub = [cfgs[i] for i in idxs]
        a_pad = max(c["num_azs"] for c in sub)
        tasks.append(SweepTask(
            "raptor", tuple(idxs),
            _open_raptor_core(int(trials), f_pad, wl.num_tasks, a_pad,
                              wl.dist, wl.fail_prob, wl.faults,
                              wl.recovery),
            seed * 2 + 1,
            ([c["flight"] for c in sub], [c["num_azs"] for c in sub],
             [c["rho"] for c in sub], [oh_of(c)[0] for c in sub],
             [oh_of(c)[1] for c in sub]),
            (wl.mean_ms, wl.offset_ms, wl.cv, wl.stage_overhead_ms, 0.5)))
    tasks.append(SweepTask(
        "stock", tuple(range(len(cfgs))),
        _open_stock_core(int(trials), wl.num_tasks, wl.dist, wl.fail_prob,
                         wl.faults, wl.recovery),
        seed * 2,
        ([c["rho"] for c in cfgs], [oh_of(c)[0] for c in cfgs],
         [oh_of(c)[1] for c in cfgs]),
        (wl.mean_ms, wl.offset_ms, wl.cv)))

    def finalize(cfg, parts):
        return dict(cfg, **_pair(parts))

    return SweepPlan("open-loop-pairs", cfgs, tasks, finalize, device)


# --------------------------------------------------------------------------
# closed-loop pairs (the sim/vector_queue.py family): per-config rate and
# overhead
# --------------------------------------------------------------------------

def _queue_raptor_core(sim, jobs: int, trials: int):
    def core(gen, cfg, shared):
        trial = sim._raptor_fn(jobs)
        rate, oh_mu, oh_sigma = cfg
        rho, means, offset, cv, stage_oh, slat = shared
        resp, ok = trial(gen, trials, rate, rho, means, offset, cv,
                         stage_oh, slat, oh_mu, oh_sigma)
        return _summary_rows(resp, ok)
    return core


def _queue_stock_core(sim, jobs: int, trials: int):
    def core(gen, cfg, shared):
        trial = sim._stock_fn(jobs)
        rate, oh_mu, oh_sigma = cfg
        rho, means, extras, offset, cv, stage_oh = shared
        resp, ok = trial(gen, trials, rate, rho, means, extras, offset, cv,
                         stage_oh, oh_mu, oh_sigma)
        return _summary_rows(resp, ok)
    return core


def queue_pair_plan(sims, jobs: int, trials: int) -> SweepPlan:
    """A list of same-deployment ``QueueFlightSim``s as ONE closed-loop
    plan: arrival rate and the Table-6 overhead lognormal are the
    per-configuration knobs, stock and raptor each a single batch of
    ``len(sims) x trials`` rows.  The fig6/fig7 load and utilisation
    grids run through it.

    Everything else comes from the first sim, so the sims of one plan must
    agree on the substrate (block, resolver, scan, backends), the fault
    profile and recovery policy, and the device."""
    s0 = sims[0]
    r_cfg, s_cfg = s0.engine_config("raptor"), s0.engine_config("stock")
    for s in sims[1:]:
        if (s.engine_config("raptor") != r_cfg
                or s.engine_config("stock") != s_cfg
                or s.booking_backend != s0.booking_backend
                or s.summary_backend != s0.summary_backend):
            raise ValueError("sims in one queue plan must share the "
                             "substrate (block, resolver, scan, backend) "
                             "config — it is part of the bucket key")
        if s._fp != s0._fp or s._policy != s0._policy:
            raise ValueError("sims in one queue plan must share the "
                             "fault profile and recovery policy — they "
                             "are statics of the bucket's core")
        if s.device != s0.device:
            raise ValueError("sims in one queue plan must share a device")
    cfg = ([s.rate_hz for s in sims], [s.oh_mu for s in sims],
           [s.oh_sigma for s in sims])
    wl = s0.wl
    all_idx = tuple(range(len(sims)))
    tasks = [
        SweepTask(
            "raptor", all_idx, _queue_raptor_core(s0, int(jobs), int(trials)),
            s0.seed * 2 + 1, cfg,
            (s0.rho, wl.task_means, wl.offset_ms, wl.cv, wl.raptor_stage_ms,
             s0.slat)),
        SweepTask(
            "stock", all_idx, _queue_stock_core(s0, int(jobs), int(trials)),
            s0.seed * 2, cfg,
            (s0.rho, s0._smeans, s0._sextras, wl.offset_ms, wl.cv,
             wl.stock_stage_ms)),
    ]

    def finalize(cfg, parts):
        return _pair(parts)

    configs = [dict(rate_hz=s.rate_hz, load=s.load) for s in sims]
    return SweepPlan("queue-pairs", configs, tasks, finalize, s0.device)
