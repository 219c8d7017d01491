"""The evaluation workload bank: declarative specs, service-time models
and load targets.

Every workload is ONE compiled :class:`repro_torch.core.workflow
.WorkflowGraph` (the manifest compiler's IR) consumed by every engine:
the scalar oracle (:mod:`repro_torch.sim.flights`) binds it to its numpy
draws through the :class:`SimWorkload` factories here, the closed-loop
engines (:mod:`repro_torch.sim.vector_queue`) through ``QueueWorkload``.  The service-time constants are fit so
the STOCK path reproduces the "w/o Raptor" column of Table 7 on the HA
3-AZ cluster at moderate load; the Raptor path is then prediction, not
fit.

Beyond the paper's three workloads the bank seeds deeper graphs:
:func:`etl_graph` (a ``validate`` guard whose outcome routes poison jobs
to quarantine — the conditional mask-select path of the IR) and
:func:`mapreduce_graph` (ranked maps, an explicit barrier, ranked
reduces).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.workflow import (WorkflowGraph, barrier, branch, chain,
                                       compile_spec, conditional, fanout,
                                       task)
from repro_torch.sim.cluster import Cluster
from repro_torch.sim.faults import FaultProfile
from repro_torch.sim.flights import SimWorkload
from repro_torch.sim.policies import RecoveryPolicy

# load levels as utilisation targets of the flight variant's capacity
UTIL = {"low": 0.18, "medium": 0.45, "high": 0.75}


def arrival_rate_hz(work_est_ws: float, num_workers: int, load: str) -> float:
    """Poisson arrival rate hitting the UTIL[load] utilisation target."""
    if load not in UTIL:
        raise ValueError(
            f"unknown load {load!r}: expected one of {sorted(UTIL)} "
            f"(utilisation targets {UTIL})")
    if work_est_ws <= 0.0:
        raise ValueError(f"work_est_ws must be positive, got {work_est_ws}")
    if num_workers <= 0:
        raise ValueError(f"num_workers must be positive, got {num_workers}")
    return UTIL[load] * num_workers / work_est_ws


# ---- ssh-keygen: two entropy-bound tasks, flight of 2 (Table 8) ----------
# lognormal(mean 875 ms, cv 1.45) + 40 ms offset: fit to the STOCK column of
# Table 7 (gives 1399/936/2885 vs paper 1335/939/2887); heavy tail matches
# the paper's med/mean = 0.70, p90/mean = 2.16 better than an exponential.
KEYGEN_MEAN_MS = 875.0
KEYGEN_CV = 1.45
KEYGEN_OFFSET_MS = 40.0


def keygen_graph() -> WorkflowGraph:
    return compile_spec(branch(task("keygen_a", KEYGEN_MEAN_MS),
                               task("keygen_b", KEYGEN_MEAN_MS)),
                        name="ssh-keygen")


def keygen_workload(fail_prob: float = 0.0,
                    faults: Optional[FaultProfile] = None,
                    recovery: Optional[RecoveryPolicy] = None) -> SimWorkload:
    return SimWorkload(
        graph=keygen_graph(),
        concurrency=2,
        make_draws=lambda cl: cl.draws(KEYGEN_MEAN_MS, KEYGEN_OFFSET_MS,
                                       "lognorm", cv=KEYGEN_CV),
        stock_stage_overhead=0.0,
        fail_prob=fail_prob,
        work_est_ws=1.9,
        faults=faults,
        recovery=recovery,
    )


def _graph_draws(graph: WorkflowGraph, cl: Cluster, dist: str,
                 cv: float = 1.0):
    """Unit draws scaled by the graph's per-task mean bindings — the
    scalar engine's view of the IR's service model."""
    means = dict(zip(graph.tasks, graph.means))
    base = cl.draws(1.0, 0.0, dist, cv=cv)
    draw0 = base.draw

    def draw(t, worker):
        return draw0(t, worker) * means[t]
    base.draw = draw
    return base


# ---- word count: serverless map-reduce (AWS-style ad-hoc pipeline) --------
WC_SPLIT_MS = 300.0
WC_MAP_MS = 700.0
WC_REDUCE_MS = 420.0
WC_STORAGE_HOP_MS = 800.0      # S3/GCS round-trip on the stock control path


def wordcount_graph() -> WorkflowGraph:
    return compile_spec(chain(task("split", WC_SPLIT_MS),
                              fanout(task("map", WC_MAP_MS), 4),
                              task("reduce", WC_REDUCE_MS)),
                        name="wordcount")


def wordcount_workload(fail_prob: float = 0.0,
                       faults: Optional[FaultProfile] = None,
                       recovery: Optional[RecoveryPolicy] = None
                       ) -> SimWorkload:
    g = wordcount_graph()
    return SimWorkload(
        graph=g,
        concurrency=2,
        make_draws=lambda cl: _graph_draws(g, cl, "exp"),
        stock_stage_overhead=WC_STORAGE_HOP_MS,
        fail_prob=fail_prob,
        work_est_ws=4.2,
        faults=faults,
        recovery=recovery,
    )


# ---- thumbnails: download stage + 4 resize tasks, flight of 4 -------------
# Paper §4.2.2: the source image is downloaded, then four thumbnails of
# different sizes are generated and uploaded.  STOCK functions are
# self-contained (each re-downloads the source: task = download + resize);
# Raptor's manifest factors the download out and the state-sharing stream
# hands the bytes to every member — the data-path short-circuit that gives
# the paper's "muted but still positive" ~11% win on this deterministic
# workload.
THUMB_DOWNLOAD_MS = 480.0
THUMB_RESIZE_MS = 800.0
THUMB_CV = 0.22


def thumbnail_graph() -> WorkflowGraph:
    return compile_spec(chain(task("download", THUMB_DOWNLOAD_MS),
                              fanout(task("thumb", THUMB_RESIZE_MS), 4)),
                        name="thumbnail")


def thumbnail_stock_graph() -> WorkflowGraph:
    """Stock functions are self-contained: four dep-free resize tasks
    (each pays the re-download as a second service component)."""
    return compile_spec(fanout(task("thumb", THUMB_RESIZE_MS), 4),
                        name="thumbnail")


def thumbnail_workload(fail_prob: float = 0.0,
                       faults: Optional[FaultProfile] = None,
                       recovery: Optional[RecoveryPolicy] = None
                       ) -> SimWorkload:
    g = thumbnail_graph()
    means = dict(zip(g.tasks, g.means))

    def make_draws(cl: Cluster):
        base = cl.draws(1.0, 0.0, "lognorm", cv=THUMB_CV)
        draw0 = base.draw

        def draw(t, worker):
            svc = draw0(t, worker) * means[t]
            if t.startswith("thumb") and not getattr(base, "raptor", False):
                # stock path: self-contained function re-downloads source
                svc += draw0(t + "_dl", worker) * THUMB_DOWNLOAD_MS
            return svc
        base.draw = draw
        return base

    return SimWorkload(
        graph=g,
        concurrency=4,
        make_draws=make_draws,
        stock_stage_overhead=0.0,
        fail_prob=fail_prob,
        work_est_ws=5.6,
        faults=faults,
        recovery=recovery,
        stock=thumbnail_stock_graph(),      # stock fns are self-contained
    )


# ---- workload bank: deeper graphs through the manifest compiler -----------
# ETL pipeline (job -> stage -> task): ingest, a validation guard whose
# OUTCOME routes the job — clean jobs fan out over `rank` transforms and
# load, poison jobs detour to quarantine — and a commit that joins both
# arms.  `fail_prob` doubles as the poison rate: the guard's deciding
# attempt fails with that probability and the conditional selects the
# quarantine branch (plus ordinary per-task error/retry dynamics on the
# rest of the graph).
ETL_INGEST_MS = 220.0
ETL_VALIDATE_MS = 140.0
ETL_XFORM_MS = 420.0
ETL_LOAD_MS = 260.0
ETL_QUARANTINE_MS = 300.0
ETL_COMMIT_MS = 180.0


def etl_graph(rank: int = 6) -> WorkflowGraph:
    spec = chain(
        task("ingest", ETL_INGEST_MS),
        conditional(
            task("validate", ETL_VALIDATE_MS),
            then=chain(fanout(task("xform", ETL_XFORM_MS), rank),
                       task("load", ETL_LOAD_MS)),
            orelse=task("quarantine", ETL_QUARANTINE_MS)),
        task("commit", ETL_COMMIT_MS))
    return compile_spec(spec, name=f"etl{rank}")


def _etl_work_ws(rank: int) -> float:
    happy = (ETL_INGEST_MS + ETL_VALIDATE_MS + rank * ETL_XFORM_MS
             + ETL_LOAD_MS + ETL_COMMIT_MS)
    return happy / 1000.0


def etl_workload(rank: int = 6, fail_prob: float = 0.08,
                 faults: Optional[FaultProfile] = None,
                 recovery: Optional[RecoveryPolicy] = None) -> SimWorkload:
    g = etl_graph(rank)
    return SimWorkload(
        graph=g,
        concurrency=3,
        make_draws=lambda cl: _graph_draws(g, cl, "exp"),
        stock_stage_overhead=WC_STORAGE_HOP_MS,
        fail_prob=fail_prob,
        work_est_ws=_etl_work_ws(rank),
        faults=faults,
        recovery=recovery,
    )


# ---- reliability probe: N parallel 100ms busy-waits (Figure 8) ------------
RELIABILITY_MEAN_MS = 100.0
RELIABILITY_CV = 0.05


def reliability_graph(n_tasks: int) -> WorkflowGraph:
    return compile_spec(fanout(task("busy", RELIABILITY_MEAN_MS), n_tasks),
                        name=f"busy{n_tasks}")


def reliability_workload(n_tasks: int, fail_prob: float,
                         faults: Optional[FaultProfile] = None,
                         recovery: Optional[RecoveryPolicy] = None
                         ) -> SimWorkload:
    return SimWorkload(
        graph=reliability_graph(n_tasks),
        concurrency=n_tasks,
        make_draws=lambda cl: cl.draws(RELIABILITY_MEAN_MS, 0.0, "lognorm",
                                       cv=RELIABILITY_CV),
        fail_prob=fail_prob,
        work_est_ws=0.1 * n_tasks * 2,
        faults=faults,
        recovery=recovery,
    )


# Ranked map-reduce with a sync barrier: scatter -> rank maps -> BARRIER ->
# `reducers` reduces (each joined on every map by the barrier) -> publish.
MR_SCATTER_MS = 250.0
MR_MAP_MS = 600.0
MR_REDUCE_MS = 480.0
MR_PUBLISH_MS = 150.0


def mapreduce_graph(rank: int = 4, reducers: int = 2) -> WorkflowGraph:
    spec = chain(
        task("scatter", MR_SCATTER_MS),
        fanout(task("map", MR_MAP_MS), rank),
        barrier(),
        fanout(task("reduce", MR_REDUCE_MS), reducers),
        task("publish", MR_PUBLISH_MS))
    return compile_spec(spec, name=f"mapreduce{rank}x{reducers}")



def _mapreduce_work_ws(rank: int, reducers: int) -> float:
    return (MR_SCATTER_MS + rank * MR_MAP_MS + reducers * MR_REDUCE_MS
            + MR_PUBLISH_MS) / 1000.0


def mapreduce_workload(rank: int = 4, reducers: int = 2,
                       fail_prob: float = 0.0,
                       faults: Optional[FaultProfile] = None,
                       recovery: Optional[RecoveryPolicy] = None
                       ) -> SimWorkload:
    g = mapreduce_graph(rank, reducers)
    return SimWorkload(
        graph=g,
        concurrency=3,
        make_draws=lambda cl: _graph_draws(g, cl, "exp"),
        stock_stage_overhead=WC_STORAGE_HOP_MS,
        fail_prob=fail_prob,
        work_est_ws=_mapreduce_work_ws(rank, reducers),
        faults=faults,
        recovery=recovery,
    )
