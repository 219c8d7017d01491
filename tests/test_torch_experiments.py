"""The paper's experiments on the port (``repro_torch.sim.experiments``).

* The scalar experiments run the port's numpy oracle and must return the
  reference's output exactly: equal ``json.dumps(..., sort_keys=True)``.
* The vector experiments run on the CPU (``device="cpu"``) at a small
  ``jobs``/``trials`` and must be paper-shaped, with the assertions of
  tests/test_sim_repro.py; the closed-loop engine agrees with the port's
  scalar oracle within tests/test_sim_queue.py's tolerances (rel 0.08 on
  the mean, abs 0.02 on the fail rate).
* ``fault_sweep``'s closed-loop rows run at 1,024 jobs x 16 trials in the
  reference, about a minute here; the test runs them at a named smaller
  size, and ``chip_smoke.py`` runs it at its defaults on the card.  On
  the route the card takes (raptor's fixpoint blocks of 64 through the
  log-depth prefix), the ``maxplus_scan`` summary route's plain version
  equals the default route, every row bitwise.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores

from repro.sim import experiments as RX  # noqa: E402
from repro.sim import workloads as RW  # noqa: E402
from repro_torch.sim import experiments as PX  # noqa: E402
from repro_torch.sim import vector_queue as PQ  # noqa: E402
from repro_torch.sim import workloads as PW  # noqa: E402

SCALAR_CASES = {
    "table6": lambda X, W: X.table6_overhead(),
    "table7": lambda X, W: X.table7_keygen(duration_s=150.0),
    "run_pair_reliability": lambda X, W: X.run_pair(
        lambda: W.reliability_workload(2, 0.3), X.HA, load="low",
        duration_s=150.0, seed=0),
    "fig6": lambda X, W: X.fig6_scale_effect(duration_s=150.0,
                                             engine="scalar"),
    "fig7": lambda X, W: X.fig7_other_workloads(duration_s=150.0,
                                                engine="scalar"),
    "workflow_bank": lambda X, W: X.workflow_bank(duration_s=150.0,
                                                  engine="scalar"),
    "fig8": lambda X, W: X.fig8_reliability(n_jobs_s=100.0),
}


@pytest.mark.parametrize("case", sorted(SCALAR_CASES))
def test_scalar_experiments_equal_reference(case):
    ref = SCALAR_CASES[case](RX, RW)
    got = SCALAR_CASES[case](PX, PW)
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_run_pair_reports_failures_separately():
    res = PX.run_pair(lambda: PW.reliability_workload(2, 0.3), PX.HA,
                      load="low", duration_s=300.0, seed=0)
    for side in ("stock", "raptor"):
        s = res[side]
        assert s["n_failed"] > 0
        assert s["fail_rate"] == pytest.approx(
            s["n_failed"] / (s["n"] + s["n_failed"]))


def test_unknown_engine_is_refused():
    with pytest.raises(ValueError, match="unknown engine"):
        PX.fig6_scale_effect(engine="numpy", device="cpu")


# ------------------------------------------------------------------
# vector experiments on the CPU
# ------------------------------------------------------------------

def test_fig6_vector_is_paper_shaped_and_agrees_with_oracle():
    out = PX.fig6_scale_effect(jobs=1024, trials=8, device="cpu")
    assert set(out) == {f"{d}/{ld}" for d in ("one_az_5w", "three_az_15w")
                        for ld in ("low", "medium", "high")}
    small = out["one_az_5w/medium"]["mean_ratio"]
    large = out["three_az_15w/medium"]["mean_ratio"]
    assert small > 0.90, f"small scale should show ~no benefit, got {small}"
    assert large < 0.75, f"HA scale should show ~2/3 ratio, got {large}"
    assert large < small
    # the port's scalar oracle on the same deployment and load
    oracle = PX.run_pair(PW.keygen_workload, PX.HA, load="medium",
                         duration_s=1800.0, seed=7)
    for eng in ("stock", "raptor"):
        v = out["three_az_15w/medium"][eng]
        assert v["mean"] == pytest.approx(oracle[eng]["mean"], rel=0.08), (
            eng, v["mean"], oracle[eng]["mean"])
        assert v["fail_rate"] == pytest.approx(oracle[eng]["fail_rate"],
                                               abs=0.02)


def test_one_az_medium_vector_agrees_with_oracle():
    """fig6's 1-AZ/5-worker medium point (one 1,800 s stream a trial)
    against the port's scalar oracle, which is bitwise the reference's:
    both engines' means within rel 0.08, and so the ratio, which is above
    1 in both (five workers run flights of 2 near saturation).  The oracle
    runs one stream a seed; near saturation one stream's raptor mean
    varies ~8% from seed to seed, so it averages 16."""
    n = PX.fig6_jobs(PX.LOW_AVAIL)
    vec = PQ.QueueFlightSim(PQ.keygen_queue(), load="medium", seed=0,
                            device="cpu", **PX.LOW_AVAIL).run_pair(n, 8)
    runs = [PX.run_pair(PW.keygen_workload, PX.LOW_AVAIL, load="medium",
                        duration_s=1800.0, seed=s) for s in range(16)]
    means = {}
    for eng in ("stock", "raptor"):
        means[eng] = sum(r[eng]["mean"] for r in runs) / len(runs)
        assert vec[eng]["mean"] == pytest.approx(means[eng], rel=0.08), (
            eng, vec[eng]["mean"], means[eng])
        assert vec[eng]["fail_rate"] == pytest.approx(
            sum(r[eng]["fail_rate"] for r in runs) / len(runs), abs=0.02)
    oracle_ratio = means["raptor"] / means["stock"]
    assert vec["mean_ratio"] == pytest.approx(oracle_ratio, rel=0.08)
    assert min(vec["mean_ratio"], oracle_ratio) > 1.0


def test_fig7_vector_is_paper_shaped():
    out = PX.fig7_other_workloads(jobs=512, trials=4, device="cpu")
    wc = out["wordcount"]["mean_ratio"]
    th = out["thumbnail"]["mean_ratio"]
    assert wc < 0.60, f"wordcount should be >40% faster, got {wc}"
    assert 0.85 < th < 1.02, f"thumbnail muted-but-positive, got {th}"


def test_workflow_bank_vector_streams_bitwise():
    out = PX.workflow_bank(jobs=96, trials=2, device="cpu")
    ref = RX.workflow_bank(duration_s=150.0, engine="scalar")
    for name in ("etl", "mapreduce"):
        assert out[name]["streaming_bitwise_oracle"] is True
        assert out[name]["manifest_hash"] == ref[name]["manifest_hash"]
        assert 0.0 < out[name]["mean_ratio"] < 1.0
        assert out[name]["streaming"]["ok_frac"] > 0.5


def test_load_sweep_util_grid():
    utils = (0.15, 0.45, 0.9)
    out = PX.load_sweep_util(utils=utils, jobs=256, trials=4, device="cpu")
    assert list(out) == [f"{d}/util{u:.2f}"
                         for d in ("one_az_5w", "three_az_15w")
                         for u in utils]
    # independence emerges only at HA scale
    assert out["three_az_15w/util0.45"]["mean_ratio"] < 0.75
    assert (out["three_az_15w/util0.45"]["mean_ratio"]
            < out["one_az_5w/util0.45"]["mean_ratio"])


def test_sweep_scale_reliability_and_table7():
    out = PX.sweep_scale(trials=20_000, device="cpu")
    for key, row in out["reliability"].items():
        assert row["raptor_fail"] == pytest.approx(row["theory_exact"],
                                                   abs=0.02), key
    assert out["table7_keygen"]["mean_ratio"] == pytest.approx(0.647,
                                                                abs=0.06)
    ratios = out["az_sweep"]["ratio_by_azs"]
    assert ratios[1] > 0.9 > ratios[2] > ratios[4]
    # the F >> K plateau: the ratio falls with the flight, but stays
    # above the K*E[min_F]/E[max_K] prediction
    fl = out["flight_sweep"]
    assert fl[2]["mean_ratio"] > fl[16]["mean_ratio"] > fl[16]["theory"]


def test_fault_sweep_holds_and_breaks_independence():
    out = PX.fault_sweep(trials=20_000, mc_samples=20_000, jobs=128,
                         queue_trials=2, device="cpu")
    iid, corr = out["open_loop/iid"], out["open_loop/correlated"]
    assert iid["rel_err"] < 0.05 < corr["rel_err"]
    assert corr["measured_ratio"] > iid["measured_ratio"]
    for tag in ("closed_loop/iid", "closed_loop/correlated",
                "closed_loop_policy/iid", "closed_loop_policy/correlated"):
        assert out[tag]["stock"]["n"] + out[tag]["stock"]["n_failed"] == 256


def test_fault_sweep_summary_routes_agree():
    """``fault_sweep``'s closed-loop rows on the route the card takes for
    raptor (fixpoint blocks of 64 through the log-depth prefix): the
    ``maxplus_scan`` summary route (its plain version here) equals the
    default summary route, every row bitwise."""
    kw = dict(trials=2000, mc_samples=2000, jobs=128, queue_trials=2,
              device="cpu", block=64, resolver="fixpoint", scan="logdepth")
    kernel = PX.fault_sweep(summary_backend="kernel", **kw)
    default = PX.fault_sweep(**kw)
    assert json.dumps(kernel, sort_keys=True) == json.dumps(
        default, sort_keys=True)
