"""The port's sweep plans (``repro_torch.sim.sweeps``).

* The bucketing helpers and the plan's grid checks are the reference's
  (tests/test_sweeps.py's grids).
* Closed-loop sweeps are pure batching: every configuration of
  ``load_sweep``/``rate_sweep`` equals that configuration's solo
  ``QueueFlightSim.run_pair``, every summary field bit for bit, faults on
  and off — and inside one plan the kernel routes' plain versions
  (``booking_backend="kernel"``, the log-depth prefix with
  ``summary_backend="kernel"``) equal the default routes.
* Open-loop sweeps: a configuration whose flight and AZ count equal its
  bucket's pads is bitwise its solo ``VectorFlightSim.run_pair``; the
  grid matches the reference's one-device ``sweep_pairs`` statistically.
* A plan runs on one device: more raise ``NotImplementedError``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores

from repro_torch.sim import sweeps as PS  # noqa: E402
from repro_torch.sim import vector as PV  # noqa: E402
from repro_torch.sim import vector_queue as PQ  # noqa: E402
from repro_torch.sim.faults import FaultProfile  # noqa: E402
from repro_torch.sim.policies import RecoveryPolicy  # noqa: E402

JOBS, TRIALS = 512, 8
FAULTS = FaultProfile(az_mtbf_ms=24_000.0, az_mttr_ms=6_000.0,
                      degraded_inflation=3.0, crash_mtbf_ms=60_000.0,
                      crash_restart_ms=2_000.0)
POLICY = RecoveryPolicy(timeout_ms=6_000.0, max_retries=1, backoff_ms=50.0)


def _same(a, b):
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ------------------------------------------------------------------
# bucketing
# ------------------------------------------------------------------

def test_pad_helpers_equal_reference():
    from repro.sim import vector as JV
    for n in range(0, 70):
        assert PV.pow2_pad(n) == JV.pow2_pad(n)
    rng = np.random.default_rng(0)
    for _ in range(20):
        sizes = rng.integers(1, 33, rng.integers(1, 25)).tolist()
        assert PV.bucket_by_pad(sizes) == JV.bucket_by_pad(sizes)


GRIDS = [
    ([2], [3]),
    ([2, 3, 4, 5, 8, 16], [1, 2, 3, 4, 6, 8]),
    ([7, 7, 7], [1, 1, 8]),
    ([16, 2, 9, 2, 16], [8, 1, 3, 1, 8]),
]


@pytest.mark.parametrize("flights,azs", GRIDS)
def test_plan_bucketing_covers_grid(flights, azs):
    configs = [dict(flight=f, num_azs=a) for f, a in zip(flights, azs)]
    plan = PS.open_loop_pair_plan(PV.exponential_vector(2, 1000.0), configs,
                                  trials=16, seed=0, device="cpu")
    for tag in ("raptor", "stock"):
        idxs = sorted(i for t in plan.tasks if t.tag == tag
                      for i in t.idxs)
        assert idxs == list(range(len(configs))), (
            f"{tag} buckets cover {idxs} of {len(configs)} grid points")
    for t in plan.tasks:
        if t.tag == "raptor":
            pads = {PV.pow2_pad(configs[i]["flight"]) for i in t.idxs}
            assert len(pads) == 1, f"mixed pads {pads} in one bucket"
    assert len(plan.run()) == len(configs)


def test_plan_rejects_dropped_grid_points():
    plan = PS.open_loop_pair_plan(PV.exponential_vector(2, 1000.0),
                                  [dict(flight=2, num_azs=3),
                                   dict(flight=4, num_azs=3)],
                                  trials=16, seed=0, device="cpu")
    broken = [t if t.tag != "stock"
              else type(t)(t.tag, t.idxs[:-1], t.core, t.key,
                           tuple(a[:-1] for a in t.cfg), t.shared)
              for t in plan.tasks]
    with pytest.raises(ValueError, match="buckets cover"):
        PS.SweepPlan(plan.name, plan.configs, broken, plan.finalize)


def test_plan_refuses_more_than_one_device():
    """Without a process group a plan runs on this process alone:
    ``devices=1`` is ``devices=None`` bit for bit, and ``devices=2`` raises
    and says what to call first.  Over a config mesh of 1, 2 and 4 gloo
    ranks the plans are held bitwise in tests/test_torch_distributed.py."""
    sims = [PQ.QueueFlightSim(PQ.keygen_queue(), load=load, device="cpu")
            for load in ("low", "high")]
    plan = PS.queue_pair_plan(sims, 16, 2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        plan.run(devices=2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        PV.sweep_pairs(PV.keygen_vector(), [dict(flight=2, num_azs=3)],
                       trials=16, devices=2, device="cpu")
    np.testing.assert_equal(plan.run(devices=1), plan.run(devices=None))
    assert len(plan.run(devices=1)) == 2


def test_queue_plan_refuses_mixed_statics():
    a = PQ.QueueFlightSim(PQ.keygen_queue(), device="cpu")
    with pytest.raises(ValueError, match="substrate"):
        PS.queue_pair_plan([a, PQ.QueueFlightSim(
            PQ.keygen_queue(), block=1, device="cpu")], 16, 2)
    with pytest.raises(ValueError, match="fault profile"):
        PS.queue_pair_plan([a, PQ.QueueFlightSim(
            PQ.keygen_queue(), faults=FAULTS, device="cpu")], 16, 2)


# ------------------------------------------------------------------
# closed loop: a sweep IS its per-configuration runs
# ------------------------------------------------------------------

def _solo(wl, jobs=JOBS, **kw):
    return PQ.QueueFlightSim(wl, device="cpu", **kw).run_pair(jobs, TRIALS)


@pytest.mark.parametrize("case", ["keygen", "wordcount", "keygen_faults"])
def test_load_sweep_equals_solo_runs(case):
    wl = {"keygen": PQ.keygen_queue(), "wordcount": PQ.wordcount_queue(),
          "keygen_faults": PQ.keygen_queue(faults=FAULTS,
                                           recovery=POLICY)}[case]
    # the fault engine is launch-bound: half the stream keeps it cheap
    jobs = JOBS // 2 if case == "keygen_faults" else JOBS
    res = PQ.load_sweep(wl, jobs=jobs, trials=TRIALS, seed=3, device="cpu")
    assert list(res) == ["low", "medium", "high"]
    for load, pair in res.items():
        solo = _solo(wl, jobs, load=load, seed=3)
        assert _same(pair, solo), (case, load, pair, solo)


@pytest.mark.parametrize("wl_fn", [PQ.keygen_queue, PQ.wordcount_queue])
def test_rate_sweep_equals_solo_runs(wl_fn):
    rates = [1.7, 3.0, 4.4]
    loads = ["low", "medium", "high"]
    res = PQ.rate_sweep(wl_fn(), rates, loads=loads, num_workers=5,
                        num_azs=1, jobs=JOBS, trials=TRIALS, device="cpu")
    for r, load, pair in zip(rates, loads, res):
        solo = _solo(wl_fn(), load=load, arrival_rate_hz=r, num_workers=5,
                     num_azs=1)
        assert _same(pair, solo), (r, pair, solo)


def test_kernel_routes_plain_versions_equal_default_routes():
    """The sweep path of chip_smoke.py's phase 17 on the CPU: stock on
    ``booking_backend="kernel"``, raptor on the log-depth prefix with
    ``summary_backend="kernel"`` (their plain versions here) equal the
    default routes inside one plan, and the solo runs."""
    loads = ("low", "medium", "high")
    kernel = PQ.load_sweep(PQ.keygen_queue(), jobs=JOBS, trials=TRIALS,
                           device="cpu", booking_backend="kernel",
                           scan="logdepth", summary_backend="kernel")
    default = PQ.load_sweep(PQ.keygen_queue(), jobs=JOBS, trials=TRIALS,
                            device="cpu")
    assert _same(kernel, default)
    for load in loads:
        assert _same(kernel[load], _solo(PQ.keygen_queue(), load=load))


# ------------------------------------------------------------------
# open loop
# ------------------------------------------------------------------

@pytest.mark.parametrize("faulty", [False, True])
def test_open_loop_sweep_bitwise_where_pads_match(faulty):
    wl = (PV.exponential_vector(2, 1000.0, faults=FAULTS, recovery=POLICY)
          if faulty else PV.keygen_vector(fail_prob=0.1))
    # bucket 4 pads to F=4 and A=3; bucket 2 to F=2 and A=3
    grid = [dict(flight=4, num_azs=1), dict(flight=4, num_azs=3),
            dict(flight=3, num_azs=2), dict(flight=2, num_azs=3),
            dict(flight=2, num_azs=2, load="low")]
    res = PV.sweep_pairs(wl, grid, trials=2000, seed=1, device="cpu")
    for c, r in zip(grid, res):
        if c["flight"] in (2, 4) and c["num_azs"] == 3:
            solo = PV.VectorFlightSim(wl, seed=1, device="cpu",
                                      **c).run_pair(2000)
            assert _same({k: r[k] for k in solo}, solo), c
        assert {k: r[k] for k in ("flight", "num_azs")} == {
            k: c[k] for k in ("flight", "num_azs")}


def test_open_loop_sweep_matches_reference():
    from repro.sim import vector as JV
    grid = ([dict(flight=4, num_azs=a) for a in (1, 2, 3)]
            + [dict(flight=f, num_azs=8) for f in (2, 8)]
            + [dict(flight=2, num_azs=1, load="low", rho=0.5)])
    got = PV.sweep_pairs(PV.exponential_vector(2, 1000.0), grid,
                         trials=4000, seed=0, device="cpu")
    ref = JV.sweep_pairs(JV.exponential_vector(2, 1000.0), grid,
                         trials=4000, seed=0, devices=1)
    for c, g, r in zip(grid, got, ref):
        assert g["mean_ratio"] == pytest.approx(r["mean_ratio"],
                                                abs=0.02), c
        for eng in ("stock", "raptor"):
            assert g[eng]["mean"] == pytest.approx(r[eng]["mean"],
                                                   rel=0.05), (c, eng)
