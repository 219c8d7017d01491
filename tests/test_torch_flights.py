"""The port's scalar oracle against the reference's, bit for bit.

The reference's event-driven ``FlightSim`` is numpy only, and so is the
port's copy (``repro_torch.sim.flights``): given the same seeds, every
draw, every ``set`` iteration and every shuffle happen in the same
order, so the job records must be identical — compared with
``np.array_equal``, no tolerance.  The pieces are held the same way: the
event queue's pop order (ties included), the cluster's overhead,
placement and service draws, and the numpy interval and chain-fold
helpers on seeded tables with ``inf`` edges.  Last, the port's
closed-loop vector engine agrees with the port's oracle as
tests/test_sim_queue.py holds the reference's engines.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores

from repro.sim import cluster as RC  # noqa: E402
from repro.sim import events as RE  # noqa: E402
from repro.sim import faults as RFa  # noqa: E402
from repro.sim import flights as RF  # noqa: E402
from repro.sim import policies as RP  # noqa: E402
from repro.sim import workloads as RW  # noqa: E402
from repro_torch.sim import cluster as PC  # noqa: E402
from repro_torch.sim import events as PE  # noqa: E402
from repro_torch.sim import faults as PFa  # noqa: E402
from repro_torch.sim import flights as PF  # noqa: E402
from repro_torch.sim import policies as PP  # noqa: E402
from repro_torch.sim import workloads as PW  # noqa: E402

HA = dict(num_workers=15, num_azs=3)
LOW_AVAIL = dict(num_workers=5, num_azs=1)
FAULT_KW = dict(az_mtbf_ms=20_000.0, az_mttr_ms=5_000.0,
                degraded_inflation=3.0, degraded_fail_prob=0.1,
                crash_mtbf_ms=40_000.0, crash_restart_ms=2_000.0)
POLICY_KW = dict(timeout_ms=4_000.0, max_retries=2, backoff_ms=40.0,
                 backoff_jitter=0.5, hedge_ms=2_500.0)


# ------------------------------------------------------------------
# the pieces
# ------------------------------------------------------------------

def _pop_order(mod, seed):
    rng = np.random.default_rng(seed)
    q = mod.EventQueue()
    popped = []
    eids = []
    for i in range(200):
        # integer times: many exact ties, popped in scheduling order
        eids.append(q.schedule(float(rng.integers(0, 40)),
                               lambda i=i: popped.append((q.now, i))))
    for eid in rng.choice(eids, 30, replace=False):
        q.cancel(int(eid))
    # a callback that schedules at the current time and earlier
    q.schedule(5.0, lambda: q.schedule(q.now, lambda: popped.append(
        (q.now, "nested"))))
    q.run(until=30.0)
    return popped, q.now


def test_event_queue_pops_in_reference_order():
    for seed in range(3):
        assert _pop_order(PE, seed) == _pop_order(RE, seed)


def test_cluster_draws_equal_reference():
    for dep in (HA, LOW_AVAIL, dict(num_workers=8, num_azs=4)):
        r, p = RC.Cluster(seed=3, **dep), PC.Cluster(seed=3, **dep)
        for load in ("low", "medium", "high"):
            assert np.array_equal(r.sample_overhead(load, 50),
                                  p.sample_overhead(load, 50))
        for size, busy in ((2, None), (4, {0, 1}), (3, {2, 5, 7}),
                           (dep["num_workers"], None)):
            assert r.place_flight(size, busy) == p.place_flight(size, busy)
        for dist, cv in (("exp", 1.0), ("lognorm", 1.45), ("lognorm", 0.05)):
            rd = r.draws(875.0, 40.0, dist, cv)
            pd = p.draws(875.0, 40.0, dist, cv)
            for task in ("a", "b", "a", "c"):
                for w in range(dep["num_workers"]):
                    assert rd.draw(task, w) == pd.draw(task, w)
        assert r.rng.random() == p.rng.random()


def _tables(rng, rows, width):
    """Sorted disjoint interval tables with inf-padded tails, as drawn."""
    up = rng.exponential(300.0, (rows, width))
    down = rng.exponential(80.0, (rows, width))
    ends = np.cumsum(up + down, axis=1)
    starts = ends - down
    cut = rng.integers(1, width + 1, rows)
    for i, c in enumerate(cut):
        starts[i, c:] = np.inf
        ends[i, c:] = np.inf
    return starts, ends


def test_np_interval_helpers_equal_reference():
    rng = np.random.default_rng(0)
    starts, ends = _tables(rng, 6, 12)
    sentinel = np.full(1, np.inf)
    rows = list(zip(starts, ends)) + [(sentinel, sentinel)]
    for s_row, e_row in rows:
        qs = np.concatenate([rng.uniform(0.0, 6_000.0, 40),
                             s_row[np.isfinite(s_row)][:3],
                             e_row[np.isfinite(e_row)][:3], [0.0, np.inf]])
        for t in qs:
            assert (PFa.interval_active_np(t, s_row, e_row)
                    == RFa.interval_active_np(t, s_row, e_row))
            assert (PFa.push_out_np(t, s_row, e_row)
                    == RFa.push_out_np(t, s_row, e_row))
            for e in (t + 100.0, t + 2_000.0, np.inf):
                assert (PFa.first_start_in_np(t, e, s_row)
                        == RFa.first_start_in_np(t, e, s_row))


@pytest.mark.parametrize("with_faults", [False, True])
def test_np_chain_folds_equal_reference(with_faults):
    rng = np.random.default_rng(1)
    bs, be = _tables(rng, 1, 8)
    cs, ce = _tables(rng, 1, 8)
    fp = (RFa.FaultProfile(**FAULT_KW), PFa.FaultProfile(**FAULT_KW))
    pols = (RP.RecoveryPolicy(**POLICY_KW), PP.RecoveryPolicy(**POLICY_KW))
    for i in range(200):
        t0 = float(rng.uniform(0.0, 4_000.0))
        z = float(rng.exponential(900.0))
        u = float(rng.random())
        got = []
        for mod, f, pol in ((RP, fp[0], pols[0]), (PP, fp[1], pols[1])):
            f = f if with_faults else None
            out = mod.attempt_outcome_np(t0, z, u, bs[0], be[0], cs[0],
                                         ce[0], policy=pol, faults=f,
                                         base_fail=0.2)
            chain = mod.fold_chain_np(t0, z, np.random.default_rng(i),
                                      bs[0], be[0], cs[0], ce[0],
                                      policy=pol, faults=f, base_fail=0.2)
            got.append((out, chain))
        assert got[0] == got[1]


# ------------------------------------------------------------------
# FlightSim: identical job records
# ------------------------------------------------------------------

WORKLOADS = {
    "keygen": lambda m, **kw: m.keygen_workload(**kw),
    "wordcount": lambda m, **kw: m.wordcount_workload(**kw),
    "thumbnail": lambda m, **kw: m.thumbnail_workload(**kw),
    "reliability": lambda m, **kw: m.reliability_workload(2, 0.3, **kw),
    "etl": lambda m, **kw: m.etl_workload(**kw),
    "mapreduce": lambda m, **kw: m.mapreduce_workload(**kw),
}


def _records(wl_name, raptor, *, dep=HA, rotate=True, faults=False,
             load="medium", duration_s=120.0):
    out = []
    for C, F, W, Fa, P in ((RC, RF, RW, RFa, RP), (PC, PF, PW, PFa, PP)):
        kw = {}
        if faults:
            kw = dict(faults=Fa.FaultProfile(**FAULT_KW),
                      recovery=P.RecoveryPolicy(**POLICY_KW))
        wl = WORKLOADS[wl_name](W, **kw)
        hz = W.arrival_rate_hz(wl.work_est_ws, dep["num_workers"], load)
        sim = F.FlightSim(C.Cluster(seed=5, **dep), wl, raptor=raptor,
                          arrival_rate_hz=hz, duration_s=duration_s,
                          load=load, seed=5, rotate=rotate)
        jobs = sim.run()
        out.append({f: np.array([getattr(j, f) for j in jobs])
                    for f in ("t_arrive", "t_done", "ok", "work_ms")})
    return out


def _assert_identical(ref, got):
    assert len(ref["t_arrive"]) > 10
    for f in ref:
        assert np.array_equal(ref[f], got[f]), f


@pytest.mark.parametrize("raptor", [False, True])
@pytest.mark.parametrize("wl_name", sorted(WORKLOADS))
def test_flight_sim_records_equal_reference(wl_name, raptor):
    _assert_identical(*_records(wl_name, raptor))


@pytest.mark.parametrize("raptor", [False, True])
@pytest.mark.parametrize("case", ["low_avail", "no_rotate", "faults"])
def test_flight_sim_variants_equal_reference(case, raptor):
    kw = {"low_avail": dict(dep=LOW_AVAIL), "no_rotate": dict(rotate=False),
          "faults": dict(faults=True)}[case]
    _assert_identical(*_records("keygen", raptor, **kw))


# ------------------------------------------------------------------
# the port's closed-loop engine vs the port's scalar oracle
# ------------------------------------------------------------------

@pytest.mark.parametrize("wl_name", ["wordcount", "thumbnail"])
def test_queue_engine_agrees_with_port_oracle(wl_name):
    """tests/test_sim_queue.py::test_dag_agrees_with_scalar's bars (rel
    0.08 on the mean, abs 0.02 on the fail rate) at low load, both sides
    the port's."""
    from repro_torch.sim import vector_queue as PQ
    qwl = {"wordcount": PQ.wordcount_queue,
           "thumbnail": PQ.thumbnail_queue}[wl_name]()
    vec = PQ.QueueFlightSim(qwl, load="low", seed=0, device="cpu", **HA)
    for raptor in (True, False):
        wl = WORKLOADS[wl_name](PW)
        sim = PF.FlightSim(
            PC.Cluster(seed=7, **HA), wl, raptor=raptor,
            arrival_rate_hz=PW.arrival_rate_hz(wl.work_est_ws, 15, "low"),
            duration_s=1800.0, load="low", seed=7)
        jobs = sim.run()
        resp = np.array([j.response for j in jobs])
        fail = float(np.mean([not j.ok for j in jobs]))
        v = vec.run(1024, 16, raptor=raptor)
        assert v.summary()["mean"] == pytest.approx(resp.mean(), rel=0.08), (
            raptor, v.summary()["mean"], resp.mean())
        assert v.fail_rate() == pytest.approx(fail, abs=0.02)
