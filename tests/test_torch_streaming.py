"""The port's streaming scheduler service.

Its load-bearing claim is composition: N microbatched steps over the
persistent W-state equal, bitwise, one whole-trace replay of the
concatenated event stream through the ``block=1`` sequential oracle
(``oracle_check``), on runs and traces, for blocked and log-depth
configurations and padded tails.  The step itself is held bitwise to the
reference's step in tests/test_torch_engine.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores

from repro_torch.serving.engine import SchedulerService  # noqa: E402
from repro_torch.sim.events import MMPPArrivals, PoissonArrivals  # noqa: E402
from repro_torch.sim.streaming import (StreamingScheduler,  # noqa: E402
                                       oracle_check, run_open_load,
                                       stock_open_sojourns)
from repro_torch.sim.vector_queue import (QueueFlightSim,  # noqa: E402
                                          _raptor_stream_fns, keygen_queue,
                                          wordcount_queue)


def _sim(wl, **kw):
    base = dict(num_workers=12, num_azs=3, load="medium", seed=3,
                device="cpu")
    base.update(kw)
    return QueueFlightSim(wl, **base)


@pytest.mark.parametrize("block,microbatch,scan", [
    (1, 16, "auto"), (8, 16, "auto"), (16, 5, "auto"),
    (8, 16, "logdepth")])
def test_streamed_equals_whole_trace_runs(block, microbatch, scan):
    res = oracle_check(_sim(keygen_queue(), block=block, scan=scan),
                       n_steps=4, microbatch=microbatch)
    assert res["bitwise"], res


@pytest.mark.parametrize("wl,kw", [
    (keygen_queue(), dict(load="high", block=8)),
    (keygen_queue(fail_prob=0.08), dict(num_workers=9, block=8)),
    (wordcount_queue(), dict(num_workers=15, block=8, scan="logdepth",
                             summary_backend="kernel"))])
def test_streamed_equals_whole_trace_traces(wl, kw):
    res = oracle_check(_sim(wl, **kw), n_steps=3, microbatch=12, trace=True)
    for col in ("resp", "ok", "arrival", "dispatch", "worker", "release"):
        assert res[col], (col, res)


def test_padded_tail_leaves_wstate_untouched():
    """A padded (inf-arrival) slot books nothing: the W-state after a
    padded microbatch is bitwise the state after replaying only its live
    prefix of the engine's own drawn events."""
    sim = _sim(keygen_queue(), num_workers=8, num_azs=2, seed=9, block=1)
    eng = StreamingScheduler(sim, microbatch=16, keep_events=True, seed=0)
    eng.submit(PoissonArrivals(sim.rate_hz, seed=1).take(6))
    eng.drain()
    live = tuple(x[:, :6] for x in eng.concatenated_events())
    _, _, step = _raptor_stream_fns(sim.W, sim.A, sim.flight, sim.wl.graph,
                                    sim.wl.dist, sim.wl.fail_prob, None,
                                    None, 1, "fixpoint", "seq", "torch",
                                    False, "cpu")
    wf_live, _ = step(torch.zeros((1, sim.W)), live, None, sim.slat)
    np.testing.assert_array_equal(eng.wf.numpy(), wf_live.numpy())
    assert bool(torch.any(eng.wf > 0))


def test_submit_validation():
    sim = _sim(keygen_queue(), num_workers=8, num_azs=2, seed=0)
    eng = StreamingScheduler(sim, microbatch=8)
    with pytest.raises(ValueError):
        eng.submit(np.array([5.0, 3.0]))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((2, 2)))
    with pytest.raises(ValueError):
        eng.submit(np.arange(9, dtype=float))
    with pytest.raises(ValueError):
        StreamingScheduler(sim, microbatch=0)
    with pytest.raises(ValueError):
        StreamingScheduler(sim, pipeline_depth=0)


def test_service_open_load_report():
    """The service face: MMPP arrivals as the ``queue_streaming`` tier
    sets them, through the kernel summary route (plain on the CPU)."""
    sim = _sim(keygen_queue(), num_workers=15, scan="logdepth",
               summary_backend="kernel")
    svc = SchedulerService(sim, microbatch=32, seed=0)
    rep = svc.run_open_load(jobs=96, microbatch=32,
                            process=MMPPArrivals(sim.rate_hz,
                                                 burst_factor=5.0,
                                                 dwell_s=(20.0, 4.0),
                                                 seed=0))
    assert rep.jobs == 96 and rep.ok_frac == 1.0
    assert 0.0 < rep.p50_ms <= rep.p99_ms
    assert 0.0 <= rep.slo_violation_frac <= 1.0
    assert run_open_load(sim, jobs=40, microbatch=32).jobs == 40
    soj = stock_open_sojourns(sim, PoissonArrivals(sim.rate_hz).take(50))
    assert soj.shape == (50,) and np.all(soj > 0)
