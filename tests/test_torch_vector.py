"""The port's open-loop engine and analytics against the JAX reference.

* Bar 1: the flight race ``_flight_trial`` is bitwise the reference's on
  the same numpy ``z_seq``, ``fail_seq``, ``t_join`` and ``seq`` (cyclic
  shifts and per-trial permutations, padding masks, the tight and the
  full event budget, with and without errors).
* The closed forms give the reference's floats; the tensor batch
  reductions its values on the same inputs; the numpy Monte-Carlo
  helpers (``mc_flight_time``, the brownout-mixture predictions) its
  numbers at the same seed.
* Bar 3: ``VectorFlightSim`` with its own torch draws holds the reference
  tests' bars against the closed forms (tests/test_sim_vector.py) and
  matches the reference engine, fault rows included (the open-loop rows
  of ``experiments.fault_sweep``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import analytics as JA  # noqa: E402
from repro.sim import faults as JF  # noqa: E402
from repro.sim import policies as JP  # noqa: E402
from repro.sim import vector as JV  # noqa: E402
from repro_torch.core import analytics as PA  # noqa: E402
from repro_torch.sim import faults as PF  # noqa: E402
from repro_torch.sim import policies as PP  # noqa: E402
from repro_torch.sim import vector as PV  # noqa: E402
from repro_torch.sim.workloads import reliability_graph  # noqa: E402

TRIALS = 40_000


# ------------------------------------------------------------- bar 1

def _cyclic(F, K):
    return np.stack([np.roll(np.arange(K), -(m % K)) for m in range(F)])


@functools.lru_cache(maxsize=None)
def _ref_trial(F, K, per_trial_seq, active, events):
    act = None if active is None else jnp.asarray(np.array(active))
    seq_axis = 0 if per_trial_seq else None
    return jax.jit(jax.vmap(
        lambda z, f, tj, sq: JV._flight_trial(z, f, tj, sq, 0.5, act,
                                              num_events=events),
        in_axes=(0, 0, 0, seq_axis)))


@pytest.mark.parametrize("F,K,p_fail,mode", [
    (2, 2, 0.0, "tight"), (3, 5, 0.0, "tight"), (6, 2, 0.0, "tight"),
    (2, 2, 0.3, "full"), (3, 4, 0.25, "full"), (4, 4, 0.2, "random"),
    (4, 2, 0.3, "padded")])
def test_flight_trial_bitwise_on_same_draws(F, K, p_fail, mode):
    rng = np.random.default_rng(F * 10 + K)
    n = 512
    z = rng.exponential(700.0, (n, F, K)).astype(np.float32)
    fail = rng.uniform(size=(n, F, K)) < p_fail
    tj = rng.exponential(15.0, (n, F)).astype(np.float32)
    seq = _cyclic(F, K)
    active, events = None, (K if mode == "tight" else None)
    if mode == "random":
        seq = np.argsort(rng.uniform(size=(n, F, K)), axis=-1)
    if mode == "padded":
        active = tuple([True] * (F - 1) + [False])
        tj[:, -1] = np.inf
    t_ref, ok_ref = _ref_trial(F, K, mode == "random", active, events)(
        z, fail, tj, seq)
    t, ok = PV._flight_trial(
        torch.tensor(z), torch.tensor(fail), torch.tensor(tj),
        torch.tensor(seq), 0.5,
        None if active is None else torch.tensor(active), events)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    if p_fail > 0:
        assert not ok.all()


# -------------------------------------------------------- analytics

def test_closed_forms_equal_reference():
    for n in range(1, 9):
        assert PA.harmonic(n) == JA.harmonic(n)
        assert PA.e_min_exp(n, 3.5) == JA.e_min_exp(n, 3.5)
        assert PA.e_max_exp(n, 3.5) == JA.e_max_exp(n, 3.5)
        for f in (1, 2, 3, 8, 16):
            assert (PA.raptor_speedup_prediction(n, f)
                    == JA.raptor_speedup_prediction(n, f))
            assert (PA.raptor_plateau_prediction(n, f)
                    == JA.raptor_plateau_prediction(n, f))
            for p in (0.0, 0.05, 0.3):
                assert (PA.raptor_failure_exact(p, n, f)
                        == JA.raptor_failure_exact(p, n, f))
        for p in (0.0, 0.05, 0.3):
            assert PA.forkjoin_failure(p, n) == JA.forkjoin_failure(p, n)
            assert PA.raptor_failure(p, n) == JA.raptor_failure(p, n)
            assert (PA.raptor_failure_exact(p, n)
                    == JA.raptor_failure_exact(p, n))
    assert PA.response_ratio_paper() == JA.response_ratio_paper()
    assert PA.response_ratio_paper() == pytest.approx(2.0 / 3.0)


def test_batch_reductions_equal_reference():
    rng = np.random.default_rng(3)
    z = rng.exponential(size=(4096, 3, 2)).astype(np.float32)
    fail = rng.uniform(size=(4096, 3, 2)) < 0.4
    t_r = rng.exponential(size=4096).astype(np.float32)
    t_s = rng.exponential(size=4096).astype(np.float32) + 0.5
    for dim in (1, -1):
        assert float(PA.emp_min_mean(torch.tensor(z), dim)) == \
            pytest.approx(float(JA.emp_min_mean(z, dim)), rel=1e-6)
        assert float(PA.emp_max_mean(torch.tensor(z), dim)) == \
            pytest.approx(float(JA.emp_max_mean(z, dim)), rel=1e-6)
    assert float(PA.flight_fail_rate_batch(torch.tensor(fail))) == \
        float(JA.flight_fail_rate_batch(fail))
    assert float(PA.forkjoin_fail_rate_batch(torch.tensor(fail[:, 0]))) \
        == float(JA.forkjoin_fail_rate_batch(fail[:, 0]))
    assert float(PA.response_ratio_batch(torch.tensor(t_r),
                                         torch.tensor(t_s))) == \
        pytest.approx(float(JA.response_ratio_batch(t_r, t_s)), rel=1e-6)


def test_monte_carlo_helpers_equal_reference_at_same_seed():
    """The numpy helpers are the reference's, draw for draw."""
    a = np.random.default_rng(0).lognormal(size=999)
    assert PA.summarize(a) == JA.summarize(a)
    for rotated in (True, False):
        assert (PA.mc_flight_time(2, 3, 2_000, rotated, seed=4)
                == JA.mc_flight_time(2, 3, 2_000, rotated, seed=4))
    kw = dict(p_deg=0.2, inflation=3.0, n_samples=2_000, seed=1)
    for corr in (False, True):
        for dist, extra in (("exp", {}), ("lognorm", dict(cv=1.45,
                                                          offset=40.0))):
            assert PA.mc_flight_time_mixture(
                2, 2, correlated=corr, dist=dist, **extra, **kw) == \
                JA.mc_flight_time_mixture(2, 2, correlated=corr, dist=dist,
                                          **extra, **kw)
            assert PA.mc_forkjoin_mixture(
                3, correlated=corr, dist=dist, **extra, **kw) == \
                JA.mc_forkjoin_mixture(3, correlated=corr, dist=dist,
                                       **extra, **kw)
        assert PA.mixture_speedup_prediction(2, 2, correlated=corr, **kw) \
            == JA.mixture_speedup_prediction(2, 2, correlated=corr, **kw)
    with pytest.raises(ValueError):
        PA._mixture_draws(np.random.default_rng(0), (2,), "pareto", 1.0,
                          1.0, 0.0)


def test_reliability_graph_equals_reference():
    from repro.sim.workloads import reliability_graph as j_graph
    for n in (1, 2, 4):
        g, j = reliability_graph(n), j_graph(n)
        assert (g.name, g.tasks, g.means) == (j.name, j.tasks, j.means)


# ------------------------------------------------------------- bar 3

def _sim(wl, **kw):
    return PV.VectorFlightSim(wl, device="cpu", **kw)


def test_rho_zero_matches_exponential_prediction():
    pair = _sim(PV.exponential_vector(2, 1000.0), num_azs=3, flight=2,
                rho=0.0, stream_latency_ms=0.0, seed=0).run_pair(TRIALS)
    assert pair["mean_ratio"] == pytest.approx(PA.response_ratio_paper(),
                                               abs=0.05)


def test_keygen_ratio_matches_paper_and_reference():
    """Table 7's ratio (0.647) and the reference engine's summaries."""
    got = _sim(PV.keygen_vector(), num_azs=3, flight=2, load="low",
               seed=0).run_pair(TRIALS)
    ref = JV.VectorFlightSim(JV.keygen_vector(), num_azs=3, flight=2,
                             load="low", seed=0).run_pair(TRIALS)
    assert got["mean_ratio"] == pytest.approx(0.647, abs=0.06)
    for eng in ("raptor", "stock"):
        assert got[eng]["mean"] == pytest.approx(ref[eng]["mean"],
                                                 rel=0.03), (eng, got, ref)
        assert got[eng]["p99"] == pytest.approx(ref[eng]["p99"],
                                                rel=0.10), (eng, got, ref)
    assert got["mean_ratio"] == pytest.approx(ref["mean_ratio"], abs=0.02)


def test_failure_matches_exact_form():
    for n_tasks, p in ((2, 0.3), (4, 0.2)):
        sim = _sim(PV.reliability_vector(n_tasks, p), num_azs=3,
                   flight=n_tasks, seed=0)
        res = sim.run(TRIALS, raptor=True)
        assert res.fail_rate() == pytest.approx(
            PA.raptor_failure_exact(p, n_tasks), abs=0.02)
        assert res.fail_rate() == pytest.approx(res.theory_fail_rate(),
                                                abs=0.005)
        stock = sim.run(TRIALS, raptor=False)
        assert stock.fail_rate() == pytest.approx(
            PA.forkjoin_failure(p, n_tasks), abs=0.02)
        assert stock.fail_rate() == stock.theory_fail_rate()


FAULT_BASE = dict(az_mtbf_ms=24_000.0, az_mttr_ms=6_000.0,
                  degraded_inflation=3.0)


@pytest.mark.parametrize("correlated", [False, True])
def test_fault_sweep_open_loop_rows_match_reference(correlated):
    """``experiments.fault_sweep``'s open-loop rows: the port's measured
    ratio under i.i.d. and correlated brownouts equals the reference
    engine's within 0.02, and the i.i.d. row stays within 10% of the
    independence prediction (the reference measures 7%)."""
    kw = dict(FAULT_BASE, correlated=correlated)
    got = _sim(PV.exponential_vector(2, 1000.0,
                                     faults=PF.FaultProfile(**kw)),
               num_azs=3, flight=2, load="low", seed=0).run_pair(TRIALS)
    ref = JV.VectorFlightSim(
        JV.exponential_vector(2, 1000.0, faults=JF.FaultProfile(**kw)),
        num_azs=3, flight=2, load="low", seed=0).run_pair(TRIALS)
    assert got["mean_ratio"] == pytest.approx(ref["mean_ratio"], abs=0.02)
    pi = PF.FaultProfile(**FAULT_BASE).stationary_degraded
    pred = PA.mixture_speedup_prediction(2, 2, p_deg=pi, inflation=3.0,
                                         n_samples=20_000, seed=0)
    if not correlated:
        assert abs(got["mean_ratio"] - pred) / pred < 0.10


def test_policy_chain_transform_in_engine_matches_reference():
    """Timeouts and jittered retries fold into the open-loop draws: fail
    rates within 0.01 and means within 3% of the reference engine, both
    paths, cyclic and random sequences."""
    fkw = dict(FAULT_BASE, degraded_fail_prob=0.2)
    pkw = dict(timeout_ms=2_500.0, max_retries=2, backoff_ms=100.0,
               backoff_jitter=0.5)
    for seqs in ("cyclic", "random"):
        got = _sim(PV.exponential_vector(
            3, 1000.0, fail_prob=0.05, faults=PF.FaultProfile(**fkw),
            recovery=PP.RecoveryPolicy(**pkw)), num_azs=3, flight=3,
            seed=1, sequences=seqs).run_pair(TRIALS)
        ref = JV.VectorFlightSim(JV.exponential_vector(
            3, 1000.0, fail_prob=0.05, faults=JF.FaultProfile(**fkw),
            recovery=JP.RecoveryPolicy(**pkw)), num_azs=3, flight=3,
            seed=1, sequences=seqs).run_pair(TRIALS)
        for eng in ("raptor", "stock"):
            assert got[eng]["fail_rate"] == pytest.approx(
                ref[eng]["fail_rate"], abs=0.01), (seqs, eng, got, ref)
            assert got[eng]["mean"] == pytest.approx(
                ref[eng]["mean"], rel=0.03), (seqs, eng, got, ref)
        assert got["stock"]["fail_rate"] > 0.01


def test_summaries_condition_on_success_and_validate():
    res = _sim(PV.reliability_vector(2, 0.3), num_azs=3, flight=2,
               seed=0).run(4_000, raptor=True)
    ok, resp = res.ok.numpy(), res.response_ms.numpy()
    s = res.summary()
    assert s["n"] == ok.sum() and s["n_failed"] == (~ok).sum()
    assert s["mean"] == pytest.approx(float(resp[ok].mean()), rel=1e-5)
    assert np.isfinite(resp).all()      # failures carry detection times
    with pytest.raises(ValueError):
        _sim(PV.keygen_vector(), sequences="shuffled")
