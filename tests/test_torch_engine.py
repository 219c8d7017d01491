"""The port's closed-loop engine against the JAX reference engine.

Bar 2 (bitwise): torch's generator is not threefry, so whole engines
cannot agree draw for draw.  The reference separates drawing from booking
(``_raptor_stream_fns``: ``draw_events`` / ``step``); here the port's
raptor ``step`` is fed the reference's drawn events (through
``repro_torch.sim.interop``) and must equal the reference ``step`` on
runs and traces, tolerance zero — keygen (the closed-form race),
wordcount (dependencies), thumbnail (F=4), keygen with ``fail_prob > 0``
(the full race budget and error broadcast) and the ETL graph
(conditionals).  Every port configuration is held to the reference's
``block=1`` step, which the reference's own tests hold bitwise to each of
its configurations (tests/test_streaming.py,
tests/test_queue_properties.py); the reference's unrolled log-depth
configurations take minutes to compile, so only its fixpoint
configurations are also compared directly.  The stock engine's
merged stream has exact ties that the reference sorts unstably, so the
stock path is held bitwise at the booking level
(tests/test_torch_scan_core.py) and statistically end to end.

Bar 3 (statistical): with its own draws, ``QueueFlightSim.run_pair`` must
match the reference on mean (8%) and p99 (10%), the tolerances of
tests/test_sim_queue.py.  Both sides run 128-job streams; the reference
takes 32 trials (its cost is compilation, not trials) and the port 64,
so each p99 rests on thousands of samples.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the engines' tensors are small: one thread per test worker avoids
# oversubscribing the cores that the other workers share
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.sim import vector_queue as JQ  # noqa: E402
from repro.sim.cluster import OverheadModel, lognormal_params  # noqa: E402
from repro_torch.sim import vector_queue as PQ  # noqa: E402
from repro_torch.sim.faults import FaultProfile  # noqa: E402
from repro_torch.sim.interop import (events_from_numpy,  # noqa: E402
                                     wvector_from_numpy)
from repro_torch.sim.policies import RecoveryPolicy  # noqa: E402

W, A, SLAT = 15, 3, 0.5
WORKLOADS = {
    "keygen": (JQ.keygen_queue, PQ.keygen_queue, {}),
    "wordcount": (JQ.wordcount_queue, PQ.wordcount_queue, {}),
    "thumbnail": (JQ.thumbnail_queue, PQ.thumbnail_queue, {}),
    "keygen_fail": (JQ.keygen_queue, PQ.keygen_queue, {"fail_prob": 0.1}),
    "etl": (JQ.etl_queue, PQ.etl_queue, {}),
}
STEP_CONFIGS = [(1, "fixpoint", "seq"), (8, "fixpoint", "seq"),
                (8, "unrolled", "seq"), (8, "fixpoint", "logdepth"),
                (16, "unrolled", "logdepth"), (0, "unrolled", "logdepth")]


@functools.lru_cache(maxsize=None)
def reference_events(name, jobs=64, trials=2, seed=1, load="high"):
    """The reference's drawn events for ``trials`` streams, as numpy
    ``(trials, jobs, ...)`` arrays (arrivals made with numpy)."""
    jwl = WORKLOADS[name][0](**WORKLOADS[name][2])
    _, draw, _ = JQ._raptor_stream_fns(W, A, jwl.flight, jwl.graph,
                                       jwl.dist, jwl.fail_prob)
    rate = JQ._rate_for_load(jwl.work_est_ws, W, load)
    mu, sigma = lognormal_params(*OverheadModel.TABLE[(True, load)])
    rng = np.random.default_rng(seed)
    per_trial = []
    for t in range(trials):
        arr = np.cumsum(rng.exponential(1000.0 / rate, jobs))
        ev = draw(jax.random.PRNGKey(100 * seed + t),
                  jnp.asarray(arr, jnp.float32), 0.95,
                  jnp.asarray(jwl.task_means, jnp.float32), jwl.offset_ms,
                  jwl.cv, jwl.raptor_stage_ms, mu, sigma)
        per_trial.append([np.asarray(x) for x in ev])
    return tuple(np.stack(xs) for xs in zip(*per_trial))


@functools.lru_cache(maxsize=None)
def reference_step(name, cfg, trace):
    jwl = WORKLOADS[name][0](**WORKLOADS[name][2])
    block, resolver, scan = cfg
    _, _, step = JQ._raptor_stream_fns(
        W, A, jwl.flight, jwl.graph, jwl.dist, jwl.fail_prob, None, None,
        block, resolver, scan, "xla", trace)
    events = reference_events(name)
    outs = []
    for t in range(events[0].shape[0]):
        wf, out = step(jnp.zeros(W), tuple(jnp.asarray(x[t])
                                           for x in events), None, SLAT)
        outs.append([np.asarray(wf)] + [np.asarray(x) for x in out])
    return [np.stack(xs) for xs in zip(*outs)]


def port_step(name, cfg, trace, summary_backend="torch"):
    pwl = WORKLOADS[name][1](**WORKLOADS[name][2])
    block, resolver, scan = cfg
    _, _, step = PQ._raptor_stream_fns(
        W, A, pwl.flight, pwl.graph, pwl.dist, pwl.fail_prob, None, None,
        block, resolver, scan, summary_backend, trace, "cpu")
    events = events_from_numpy(reference_events(name))
    wf0 = wvector_from_numpy(np.zeros((events[0].shape[0], W), np.float32))
    wf, outs = step(wf0, events, None, SLAT)
    return [wf.numpy()] + [x.numpy() for x in outs]


COLS = ("wf", "resp", "ok", "dispatch", "worker", "release")
SAME_CONFIG = {"keygen": [(8, "fixpoint", "seq"), (8, "fixpoint", "logdepth")],
               "wordcount": [(8, "fixpoint", "seq"),
                             (8, "fixpoint", "logdepth")]}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_raptor_step_bitwise_on_reference_events(name):
    """Every port configuration against the reference's ``block=1`` step
    (runs and traces); keygen and wordcount also against the reference's
    same fixpoint configurations, and on the run-only outputs
    (``trace=False``) through the ``maxplus_scan`` kernel's route (its
    plain version on the CPU).  One test per workload, so the reference's
    compilations happen once."""
    ref = reference_step(name, (1, "fixpoint", "seq"), trace=True)
    for cfg in STEP_CONFIGS:
        got = port_step(name, cfg, trace=True)
        for col, g, r in zip(COLS, got, ref):
            np.testing.assert_array_equal(g, r,
                                          err_msg=f"{name} {cfg} {col}")
    for cfg in SAME_CONFIG.get(name, []):
        got = port_step(name, cfg, trace=True)
        for col, g, r in zip(COLS, got, reference_step(name, cfg, True)):
            np.testing.assert_array_equal(g, r,
                                          err_msg=f"{name} {cfg} {col}")
    if name in SAME_CONFIG:
        ref = reference_step(name, (1, "fixpoint", "seq"), trace=False)
        for cfg, backend in (((1, "fixpoint", "seq"), "torch"),
                             ((8, "fixpoint", "logdepth"), "kernel")):
            got = port_step(name, cfg, trace=False, summary_backend=backend)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r, err_msg=f"{name} {cfg}")


@pytest.mark.parametrize("name", ["keygen_queue", "wordcount_queue"])
def test_run_pair_matches_reference_statistically(name):
    ref = JQ.QueueFlightSim(getattr(JQ, name)(), load="medium",
                            seed=0).run_pair(128, 32)
    got = PQ.QueueFlightSim(getattr(PQ, name)(), load="medium", seed=0,
                            device="cpu").run_pair(128, 64)
    for engine in ("raptor", "stock"):
        assert got[engine]["mean"] == pytest.approx(
            ref[engine]["mean"], rel=0.08), (name, engine, got, ref)
        assert got[engine]["p99"] == pytest.approx(
            ref[engine]["p99"], rel=0.10), (name, engine, got, ref)
    assert got["mean_ratio"] == pytest.approx(ref["mean_ratio"], rel=0.08)


# ------------------------------------------------ the port's own invariants

def _sim(wl, **kw):
    base = dict(num_workers=15, num_azs=3, load="high", seed=0,
                device="cpu")
    base.update(kw)
    return PQ.QueueFlightSim(wl, **base)


def test_kernel_booking_route_matches_scan():
    """``booking_backend="kernel"`` (the queue_booking route; its plain
    version on the CPU) replays the stock stream bitwise like the
    substrate, runs and traces."""
    a = _sim(PQ.wordcount_queue(), block=64)
    b = _sim(PQ.wordcount_queue(), block=64, booking_backend="kernel")
    np.testing.assert_array_equal(a.run(96, 2, raptor=False).response_ms,
                                  b.run(96, 2, raptor=False).response_ms)
    ta, tb = (s.trace_run(64, 2, raptor=False) for s in (a, b))
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_kernel_summary_route_matches_seq():
    """``scan="logdepth", summary_backend="kernel"`` equals the
    sequential chain bitwise on both engines."""
    kw = dict(block=16, resolver="unrolled")
    o = _sim(PQ.wordcount_queue(), **kw)
    k = _sim(PQ.wordcount_queue(), scan="logdepth", summary_backend="kernel",
             **kw)
    for raptor in (True, False):
        np.testing.assert_array_equal(o.run(96, 2, raptor=raptor).response_ms,
                                      k.run(96, 2, raptor=raptor).response_ms)
    to, tk = (s.trace_run(64, 2, raptor=True) for s in (o, k))
    for key in to:
        np.testing.assert_array_equal(to[key], tk[key], err_msg=key)


@pytest.mark.parametrize("raptor", [True, False])
def test_engine_block_invariance(raptor):
    """Every substrate configuration, including ragged tails, replays the
    port engine bitwise like its ``block=1`` oracle (runs and traces)."""
    base = _sim(PQ.wordcount_queue(), block=1)
    ref_tr = base.trace_run(70, 2, raptor=raptor)
    np.testing.assert_array_equal(
        ref_tr["response"], base.run(70, 2, raptor=raptor).response_ms)
    for block, resolver, scan in ((8, "fixpoint", "seq"),
                                  (8, "unrolled", "seq"),
                                  (16, "fixpoint", "logdepth"),
                                  (0, "unrolled", "logdepth")):
        tr = _sim(PQ.wordcount_queue(), block=block, resolver=resolver,
                  scan=scan).trace_run(70, 2, raptor=raptor)
        for k in tr:
            np.testing.assert_array_equal(
                tr[k], ref_tr[k], err_msg=f"{block}/{resolver}/{scan} {k}")


def test_stock_trace_invariants():
    """No task starts before it is ready, no worker runs two tasks at
    once, and every ready time was materialized."""
    tr = _sim(PQ.wordcount_queue(), block=16).trace_run(64, 2, raptor=False)
    for t in range(2):
        r, s, f, w = (tr[k][t].ravel()
                      for k in ("ready", "start", "fin", "worker"))
        assert np.all(np.isfinite(r)) and np.all(s >= r)
        for wk in range(15):
            iv = np.sort(np.stack([s[w == wk], f[w == wk]], 1), axis=0)
            assert np.all(iv[1:, 0] >= iv[:-1, 1])


def test_auto_config_defaults():
    """The host keeps the reference's measured defaults; a CUDA card gets
    the fewest-pass configurations measured on the card (PERF.md)."""
    assert PQ.auto_config("raptor") == JQ.auto_config("raptor")
    assert PQ.auto_config("stock") == JQ.auto_config("stock")
    assert PQ.auto_config("raptor", "logdepth") == (0, "unrolled",
                                                    "logdepth")
    assert PQ.auto_config("raptor", device="cuda") == (64, "fixpoint",
                                                       "logdepth")
    assert PQ.auto_config("raptor", "seq", "cuda") == (64, "fixpoint", "seq")
    assert PQ.auto_config("stock", device="cuda") == (256, "fixpoint", "seq")


def test_fault_mode_and_unknown_backends_are_refused():
    """Fault mode runs on the scan substrate only: the ``queue_booking``
    kernel books plain FCFS finish times, so ``booking_backend="kernel"``
    is refused with an enabled profile or a non-default policy (as the
    reference refuses its Pallas route), while the substrate and the
    ``maxplus_scan`` summary route are accepted.  Unknown backends and a
    flight wider than the pool are refused too."""
    crashes = FaultProfile(crash_mtbf_ms=1e4, crash_restart_ms=100.0)
    with pytest.raises(ValueError, match="fault injection"):
        _sim(PQ.keygen_queue(), faults=crashes, booking_backend="kernel")
    with pytest.raises(ValueError, match="fault injection"):
        _sim(PQ.keygen_queue(), recovery=RecoveryPolicy(max_retries=1),
             booking_backend="kernel")
    assert _sim(PQ.keygen_queue(), faults=crashes, scan="logdepth",
                summary_backend="kernel").fault_mode
    assert not _sim(PQ.keygen_queue(), faults=FaultProfile(),
                    booking_backend="kernel").fault_mode
    with pytest.raises(ValueError):
        _sim(PQ.keygen_queue(), booking_backend="pallas")
    with pytest.raises(ValueError):
        _sim(PQ.keygen_queue(), summary_backend="xla")
    with pytest.raises(ValueError):
        _sim(PQ.thumbnail_queue(), num_workers=3, num_azs=3)
