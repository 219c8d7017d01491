"""The port's fault mode against the JAX reference engine.

Bar 2 (bitwise), raptor: the reference draws a stream's fault tables and
its fault-mode events (``_raptor_stream_fns``: ``draw_env`` /
``draw_events``); exported as numpy and brought in through
``repro_torch.sim.interop``, they make the port's ``step`` equal the
reference's ``step`` on runs and traces, tolerance zero, on every
configuration of ``STEP_CONFIGS`` — keygen and wordcount, with
brownouts, crashes, one correlated brownout process and a policy-only
profile (timeouts and retries on a healthy cluster).

Bar 2, stock: the reference sorts the attempt stream unstably, so whole
traces can only agree where the stream has no ties: one task per job.
There the reference trial's own draws, made again from its key splits,
are fed to the port's stock replay, which must equal the reference's
``trace_run`` (every attempt's ready, start, finish, worker and outcome).
On every stream each block, resolver and scan configuration must equal
the port's own ``block=1`` oracle, both engines, runs and traces — the
reference pins the same in tests/test_queue_properties.py.

The reference's own checkers (``assert_stock_fault_invariants``,
``assert_raptor_invariants``) hold the port's fault traces; a disabled
profile with the default policy gives the pre-fault engines bitwise;
streaming ``oracle_check`` stays bitwise with faults on; and bar 3: with
its own torch draws the port matches the reference's vector engine
(mean 8%, p99 10%, fail rate 0.01) under the reference agreement test's
profile and policy.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.sim import faults as JF  # noqa: E402
from repro.sim import policies as JP  # noqa: E402
from repro.sim import vector_queue as JQ  # noqa: E402
from repro.sim.cluster import OverheadModel, lognormal_params  # noqa: E402
from repro.sim.vector import unit_draws as j_unit_draws  # noqa: E402
from repro_torch.sim import faults as PF  # noqa: E402
from repro_torch.sim import policies as PP  # noqa: E402
from repro_torch.sim import vector_queue as PQ  # noqa: E402
from repro_torch.sim.interop import (env_from_numpy,  # noqa: E402
                                     events_from_numpy, wvector_from_numpy)
from repro_torch.sim.streaming import oracle_check  # noqa: E402
from test_queue_properties import (assert_raptor_invariants,  # noqa: E402
                                   assert_stock_fault_invariants)
from test_torch_engine import STEP_CONFIGS  # noqa: E402

W, A, SLAT, JOBS, TRIALS = 9, 3, 0.5, 64, 2

# fault processes fast enough to hit a 64-job stream (~16 s at load
# high); tables wide enough to cover twice that horizon
BROWNOUTS = dict(az_mtbf_ms=4_000.0, az_mttr_ms=2_000.0,
                 degraded_inflation=2.5, degraded_fail_prob=0.1,
                 max_intervals=16)
CRASHES = dict(crash_mtbf_ms=5_000.0, crash_restart_ms=500.0,
               max_crashes=16)
POLICY = dict(timeout_ms=3_000.0, max_retries=1, backoff_ms=50.0,
              backoff_jitter=0.5)
CASES = {
    # name: (workload, fault profile kwargs or None, policy kwargs)
    "keygen_brownouts": ("keygen_queue", BROWNOUTS, POLICY),
    "keygen_crashes": ("keygen_queue",
                       dict(CRASHES, crash_mtbf_ms=2_500.0),
                       dict(POLICY, timeout_ms=float("inf"))),
    "keygen_correlated": ("keygen_queue",
                          dict(BROWNOUTS, correlated=True, **CRASHES),
                          POLICY),
    "keygen_policy_only": ("keygen_queue", None, POLICY),
    "wordcount_faults": ("wordcount_queue", dict(BROWNOUTS, **CRASHES),
                         POLICY),
}


def _pair(cls_j, cls_p, kw):
    if kw is None:
        return None, None
    return cls_j(**kw), cls_p(**kw)


def _case(name):
    wl, fkw, pkw = CASES[name]
    jfp, pfp = _pair(JF.FaultProfile, PF.FaultProfile, fkw)
    jpol, ppol = _pair(JP.RecoveryPolicy, PP.RecoveryPolicy, pkw)
    return getattr(JQ, wl)(), getattr(PQ, wl)(), jfp, pfp, jpol, ppol


@functools.lru_cache(maxsize=None)
def reference_stream(name, seed=1, load="high"):
    """The reference's drawn fault tables and events for ``TRIALS``
    streams (arrivals made with numpy) and its ``block=1`` step's runs
    and traces on them, all as numpy ``(TRIALS, ...)`` arrays."""
    jwl, _, jfp, _, jpol, _ = _case(name)
    draw_env, draw, step = JQ._raptor_stream_fns(
        W, A, jwl.flight, jwl.graph, jwl.dist, jwl.fail_prob, jfp, jpol,
        1, "fixpoint", "seq", "xla", True)
    rate = JQ._rate_for_load(jwl.work_est_ws, W, load)
    mu, sigma = lognormal_params(*OverheadModel.TABLE[(True, load)])
    rng = np.random.default_rng(seed)
    envs, evs, outs = [], [], []
    for t in range(TRIALS):
        key = jax.random.PRNGKey(100 * seed + t)
        k_env, k_ev = jax.random.split(key)
        env = draw_env(k_env)
        arr = np.cumsum(rng.exponential(1000.0 / rate, JOBS))
        ev = draw(k_ev, jnp.asarray(arr, jnp.float32), 0.95,
                  jnp.asarray(jwl.task_means, jnp.float32), jwl.offset_ms,
                  jwl.cv, jwl.raptor_stage_ms, mu, sigma)
        wf, out = step(jnp.zeros(W), ev, env, SLAT)
        envs.append([np.asarray(x) for x in env])
        evs.append([np.asarray(x) for x in ev])
        outs.append([np.asarray(wf)] + [np.asarray(x) for x in out])
    stack = lambda rows: tuple(np.stack(xs) for xs in zip(*rows))  # noqa
    return stack(envs), stack(evs), stack(outs)


def port_step(name, cfg, trace=True, summary_backend="torch"):
    _, pwl, _, pfp, _, ppol = _case(name)
    env_np, ev_np, _ = reference_stream(name)
    _, _, step = PQ._raptor_stream_fns(
        W, A, pwl.flight, pwl.graph, pwl.dist, pwl.fail_prob, pfp, ppol,
        *cfg, summary_backend, trace, "cpu")
    wf0 = wvector_from_numpy(np.zeros((TRIALS, W), np.float32))
    wf, outs = step(wf0, events_from_numpy(ev_np), env_from_numpy(*env_np),
                    SLAT)
    return [wf.numpy()] + [x.numpy() for x in outs]


COLS = ("wf", "resp", "ok", "dispatch", "worker", "release")


@pytest.mark.parametrize("name", list(CASES))
def test_raptor_fault_step_bitwise_on_reference_events(name):
    """Every configuration of ``STEP_CONFIGS`` against the reference's
    ``block=1`` step on its own drawn fault tables and events, runs and
    traces; the fault processes must actually fire (some attempt fails,
    some placement avoids a browned-out AZ or a crash)."""
    _, _, ref = reference_stream(name)
    assert not ref[2].all() or name == "keygen_policy_only", \
        "no job failed: the fault wiring is idle"
    for cfg in STEP_CONFIGS:
        got = port_step(name, cfg)
        for col, g, r in zip(COLS, got, ref):
            np.testing.assert_array_equal(g, r,
                                          err_msg=f"{name} {cfg} {col}")
    got = port_step(name, (8, "fixpoint", "logdepth"), trace=True,
                    summary_backend="kernel")
    for col, g, r in zip(COLS, got, ref):
        np.testing.assert_array_equal(g, r, err_msg=f"{name} kernel {col}")


# ------------------------------------------------------------- stock

STOCK_FAULTS = dict(BROWNOUTS, **CRASHES)
STOCK_POLICY = dict(timeout_ms=2_500.0, max_retries=1, backoff_ms=50.0,
                    backoff_jitter=0.5, hedge_ms=1_500.0)


def _stock_sims(**kw):
    jfp, pfp = _pair(JF.FaultProfile, PF.FaultProfile, STOCK_FAULTS)
    jpol, ppol = _pair(JP.RecoveryPolicy, PP.RecoveryPolicy, STOCK_POLICY)
    base = dict(num_workers=W, num_azs=A, load="high", seed=4, block=1)
    base.update(kw)
    j = JQ.QueueFlightSim(JQ.exponential_queue(num_tasks=1), faults=jfp,
                          recovery=jpol, **base)
    p = PQ.QueueFlightSim(PQ.exponential_queue(num_tasks=1), faults=pfp,
                          recovery=ppol, device="cpu", **base)
    return j, p


@functools.lru_cache(maxsize=None)
def reference_stock_draws(jobs=JOBS, trials=TRIALS):
    """The reference stock trial's draws, made again from its own key
    splits (``vector_queue.py:994-1043``) with the same jitted
    arithmetic, plus its ``trace_run`` of the same trials."""
    jsim, _ = _stock_sims()
    K, A_att = 1, jsim.recovery.stock_attempts
    R = jsim.recovery.max_retries

    def draws(key, rate_hz, rho, means, offset, cv, oh_mu, oh_sigma):
        k_a, k_z, _, k_o, _, _, k_e, k_j = jax.random.split(key, 8)
        arrivals = jnp.cumsum(
            jax.random.exponential(k_a, (jobs,)) * (1000.0 / rate_hz))
        zz = j_unit_draws(k_z, (jobs, 2, K), "exp", cv)
        z = (rho * zz[:, 0] + (1 - rho) * zz[:, 1]) * means + offset
        oh = jnp.exp(oh_mu + oh_sigma * jax.random.normal(k_o,
                                                          (jobs, K + 1)))
        u_err = jax.random.uniform(k_e, (jobs, K, A_att))
        u_jit = jax.random.uniform(k_j, (jobs, K, R))
        return arrivals, z, oh, u_err, u_jit

    args = jsim._stock_args()
    fn = jax.jit(jax.vmap(draws, in_axes=(0,) + (None,) * 7))
    out = fn(jsim._keys(trials, False), args[0], args[1], args[2], args[4],
             args[5], args[7], args[8])
    return (tuple(np.asarray(x) for x in out),
            jsim.trace_run(jobs, trials, raptor=False))


def test_stock_fault_booking_bitwise_on_tie_free_stream():
    """One task per job (no exact ties in the merged attempt stream), a
    retry and a hedge: the port's stock replay of the reference's draws
    and tables equals the reference's trace, attempt by attempt."""
    (arr, z, oh, u_err, u_jit), ref = reference_stock_draws()
    _, psim = _stock_sims()
    trial = psim._stock_fn(JOBS, trace=True)
    env = env_from_numpy(ref["az_start"], ref["az_end"], ref["crash_start"],
                         ref["crash_end"])
    draws = (torch.tensor(arr), torch.tensor(z), torch.tensor(oh), env,
             torch.tensor(u_err), torch.tensor(u_jit))
    resp, ok, (arrival, ready, start, fin, wkr, fl, *_) = trial.replay(
        draws, psim.wl.stock_stage_ms)
    np.testing.assert_array_equal(arrival.numpy(), ref["arrival"])
    for key, got in (("ready", ready), ("start", start), ("fin", fin),
                     ("worker", wkr), ("fail", fl), ("response", resp),
                     ("ok", ok)):
        np.testing.assert_array_equal(got.numpy(), ref[key], err_msg=key)
    # the profile is hot enough that retries, hedges and failures fire
    assert np.isfinite(ref["ready"][..., 1:]).any() and ref["fail"].any()


def _fault_sim(wl, **kw):
    base = dict(num_workers=W, num_azs=A, load="high", seed=5,
                faults=PF.FaultProfile(**dict(BROWNOUTS, **CRASHES)),
                recovery=PP.RecoveryPolicy(**STOCK_POLICY), device="cpu")
    base.update(kw)
    return PQ.QueueFlightSim(wl, **base)


@pytest.mark.parametrize("raptor", [False, True])
def test_fault_block_invariance(raptor):
    """Every block, resolver and scan configuration (ragged tails
    included) replays the fault-mode engine bitwise like the port's own
    ``block=1`` oracle, runs and traces — keygen with base errors, a
    timeout, a jittered retry and a hedge."""
    wl = PQ.keygen_queue(fail_prob=0.01)
    jobs = 70
    base = _fault_sim(wl, block=1)
    ref = base.trace_run(jobs, TRIALS, raptor=raptor)
    run = base.run(jobs, TRIALS, raptor=raptor)
    np.testing.assert_array_equal(ref["response"], run.response_ms.numpy())
    np.testing.assert_array_equal(ref["ok"], run.ok.numpy())
    for block, resolver, scan in ((16, "fixpoint", "seq"),
                                  (8, "unrolled", "seq"),
                                  (16, "unrolled", "logdepth"),
                                  (0, "unrolled", "logdepth")):
        tr = _fault_sim(wl, block=block, resolver=resolver,
                        scan=scan).trace_run(jobs, TRIALS, raptor=raptor)
        for k in tr:
            np.testing.assert_array_equal(
                tr[k], ref[k], err_msg=f"{block}/{resolver}/{scan} {k}")
    tr = _fault_sim(wl, block=16, scan="logdepth",
                    summary_backend="kernel").trace_run(jobs, TRIALS,
                                                        raptor=raptor)
    for k in tr:
        np.testing.assert_array_equal(tr[k], ref[k], err_msg=f"kernel {k}")


@pytest.mark.parametrize("wl", ["keygen_queue", "wordcount_queue"])
def test_reference_invariant_checkers_hold_on_port_traces(wl):
    """The reference's own checkers: no attempt starts inside an outage
    or runs through a crash, no worker is double-booked, work is
    conserved counting retries and hedges, and flight placements are
    distinct."""
    sim = _fault_sim(getattr(PQ, wl)(), block=16)
    tr = sim.trace_run(JOBS, TRIALS, raptor=False)
    assert_stock_fault_invariants(tr, W)
    assert np.isinf(tr["ready"]).any()            # unlaunched slots
    assert np.isfinite(tr["ready"][..., 1:]).any()  # retries/hedges fired
    assert_raptor_invariants(sim.trace_run(JOBS, TRIALS, raptor=True), W)


def test_disabled_profile_is_the_prefault_path():
    """A disabled ``FaultProfile()`` with the default policy gives the
    pre-fault engines' results bitwise, both engines."""
    kw = dict(num_workers=W, num_azs=A, load="medium", seed=8,
              device="cpu")
    base = PQ.QueueFlightSim(PQ.wordcount_queue(fail_prob=0.02), **kw)
    gated = PQ.QueueFlightSim(
        PQ.wordcount_queue(fail_prob=0.02, faults=PF.FaultProfile(),
                           recovery=PP.RecoveryPolicy()), **kw)
    assert not gated.fault_mode
    for raptor in (False, True):
        a = base.run(JOBS, TRIALS, raptor=raptor)
        b = gated.run(JOBS, TRIALS, raptor=raptor)
        np.testing.assert_array_equal(a.response_ms.numpy(),
                                      b.response_ms.numpy())
        np.testing.assert_array_equal(a.ok.numpy(), b.ok.numpy())


@pytest.mark.parametrize("cfg", [dict(block=1), dict(
    block=8, scan="logdepth", summary_backend="kernel")])
def test_streaming_oracle_check_with_faults(cfg):
    """Microbatched steps on the persistent W-state, with the stream's
    one-shot fault tables, equal one whole-trace ``block=1`` replay of the
    concatenated stream bitwise, runs and traces."""
    sim = _fault_sim(PQ.keygen_queue(), load="medium", **cfg)
    res = oracle_check(sim, n_steps=3, microbatch=16, trace=True)
    assert res["bitwise"], res


# ------------------------------------------------------------- bar 3

@pytest.mark.parametrize("raptor", [True, False])
def test_fault_run_matches_reference_statistically(raptor):
    """Own torch draws against the reference's vector engine under the
    reference agreement test's profile and policy (tests/test_faults.py
    ``AGREE_FAULTS``/``AGREE_POLICY``), keygen on the HA deployment:
    mean within 8%, p99 within 10%, fail rate within 0.01 — at load
    medium, like tests/test_torch_engine.py's run-pair bar: at load high
    a trial's mean response varies by ~40% (trial to trial, 1,024-job
    streams, brownouts on), so these bars would need hundreds of trials
    a side there."""
    from test_faults import AGREE_FAULTS, AGREE_POLICY
    kw = {f: getattr(AGREE_FAULTS, f) for f in (
        "az_mtbf_ms", "az_mttr_ms", "degraded_inflation",
        "degraded_fail_prob")}
    pkw = {f: getattr(AGREE_POLICY, f) for f in (
        "timeout_ms", "max_retries", "backoff_ms")}
    ref = JQ.QueueFlightSim(
        JQ.keygen_queue(fail_prob=0.01, faults=AGREE_FAULTS,
                        recovery=AGREE_POLICY), load="medium",
        seed=0).run(256, 16, raptor=raptor).summary()
    got = PQ.QueueFlightSim(
        PQ.keygen_queue(fail_prob=0.01, faults=PF.FaultProfile(**kw),
                        recovery=PP.RecoveryPolicy(**pkw)), load="medium",
        seed=0, block=64, device="cpu").run(256, 32,
                                            raptor=raptor).summary()
    assert got["mean"] == pytest.approx(ref["mean"], rel=0.08), (got, ref)
    assert got["p99"] == pytest.approx(ref["p99"], rel=0.10), (got, ref)
    assert got["fail_rate"] == pytest.approx(ref["fail_rate"], abs=0.01)
