"""The port's fault and policy layer against the JAX reference (bar 1).

The interval helpers (``interval_active``, ``push_out``,
``first_start_in``) and the chain folds (``fold_chain``,
``chain_transform``) must equal the reference's jnp twins bitwise on the
same numpy inputs — random tables, the ``[inf, inf)`` sentinels, ``t =
inf``, timeouts (finite and none), retries, jittered backoff, crashes and
degraded states.  The reference folds run jitted, as its engines run
them: XLA fuses a multiply feeding an add, and the port must round as it
does.  The port's helpers query their tables by binary search, so the
tables here are sorted, as drawn ones are (drawn tables are one of the
cases).  Also: the torch and numpy table draws keep the reference's
shapes, sentinels and correlation, and the policy properties and the
``can_fail`` gate agree.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.sim import faults as JF  # noqa: E402
from repro.sim import policies as JP  # noqa: E402
from repro_torch.sim import faults as PF  # noqa: E402
from repro_torch.sim import policies as PP  # noqa: E402

INF = np.float32(np.inf)


def _tables(rng, rows, width, scale):
    gaps = rng.exponential(scale, (rows, width))
    downs = rng.exponential(scale / 4, (rows, width))
    ends = np.cumsum(gaps + downs, axis=1)
    return (ends - downs).astype(np.float32), ends.astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("tables", ["random", "sentinel", "mixed", "drawn"])
def test_interval_helpers_bitwise(tables):
    """The port's helpers take the query axis explicitly (``t[:, None]``);
    the reference's broadcast one query per table row."""
    rng = np.random.default_rng(0)
    n = 4096
    starts, ends = _tables(rng, n, 8, 3000.0)
    if tables == "sentinel":
        starts = ends = np.full((n, 1), INF)
    elif tables == "mixed":
        starts[::3], ends[::3] = INF, INF
    elif tables == "drawn":
        # crash tables on even rows, one correlated brownout process on
        # odd rows, as the profile draws them
        fp = PF.FaultProfile(**dict(FP, correlated=True), max_intervals=8,
                             max_crashes=8)
        cs, ce = fp.crash_tables_np(rng, n // 2)
        bs, be = fp.brownout_tables_np(rng, n // 2)
        starts, ends = (np.stack([c, b], axis=1).reshape(n, 8)
                        .astype(np.float32) for c, b in ((cs, bs), (ce, be)))
    t = rng.uniform(0.0, 1.2 * float(ends[np.isfinite(ends)].max()
                                     if np.isfinite(ends).any() else 1e4),
                    n).astype(np.float32)
    t[::7] = INF
    t[1::11] = starts[1::11, 0]                # exactly on an interval start
    e = (t + rng.uniform(0.0, 5000.0, n)).astype(np.float32)
    jit = jax.jit
    tq, eq = _t(t)[:, None], _t(e)[:, None]
    np.testing.assert_array_equal(
        PF.interval_active(tq, _t(starts), _t(ends))[:, 0].numpy(),
        np.asarray(jit(JF.interval_active)(t, starts, ends)))
    np.testing.assert_array_equal(
        PF.push_out(tq, _t(starts), _t(ends))[:, 0].numpy(),
        np.asarray(jit(JF.push_out)(t, starts, ends)))
    np.testing.assert_array_equal(
        PF.first_start_in(tq, eq, _t(starts))[:, 0].numpy(),
        np.asarray(jit(JF.first_start_in)(t, e, starts)))


FP = dict(az_mtbf_ms=24e3, az_mttr_ms=6e3, degraded_inflation=2.0,
          degraded_fail_prob=0.3, crash_mtbf_ms=1e4, crash_restart_ms=500.0)


@functools.lru_cache(maxsize=None)
def _ref_fold(pol_kw, fp_kw, base_fail):
    pol = JP.RecoveryPolicy(**dict(pol_kw))
    fp = None if fp_kw is None else JF.FaultProfile(**dict(fp_kw))
    fold = jax.jit(functools.partial(JP.fold_chain, policy=pol, faults=fp,
                                     base_fail=base_fail))
    transform = jax.jit(functools.partial(JP.chain_transform, policy=pol,
                                          faults=fp, base_fail=base_fail))
    return fold, transform


@pytest.mark.parametrize("timeout", [math.inf, 3000.0])
@pytest.mark.parametrize("retries,jitter", [(0, 0.0), (1, 0.5), (2, 0.4),
                                            (2, 0.0)])
@pytest.mark.parametrize("env", ["faults", "policy_only"])
def test_chain_folds_bitwise(timeout, retries, jitter, env):
    """``fold_chain`` and ``chain_transform`` against the reference's
    jitted folds.  The jitter draws make the backoff's two fused
    multiply-adds visible; without a timeout XLA drops ``min(x, inf)``
    and fuses the inflation into the end time."""
    rng = np.random.default_rng(retries * 10 + int(jitter * 10))
    n = 8192
    pol_kw = (("timeout_ms", timeout), ("max_retries", retries),
              ("backoff_ms", 100.0), ("backoff_jitter", jitter))
    fp_kw = tuple(FP.items()) if env == "faults" else None
    t0 = rng.uniform(0.0, 4e4, n).astype(np.float32)
    t0[::97] = INF
    z = rng.exponential(2000.0, n).astype(np.float32)
    u_err = rng.uniform(size=(n, retries + 1)).astype(np.float32)
    u_jit = rng.uniform(size=(n, retries)).astype(np.float32)
    bs, be = _tables(rng, n, 8, 6000.0)
    cs, ce = _tables(rng, n, 6, 8000.0)
    if env == "policy_only":
        bs = be = cs = ce = np.full((n, 1), INF)
    else:
        bs[::5], be[::5] = INF, INF            # some lanes never brown out
    fold, transform = _ref_fold(pol_kw, fp_kw, 0.05)
    pol = PP.RecoveryPolicy(**dict(pol_kw))
    fp = None if fp_kw is None else PF.FaultProfile(**dict(fp_kw))
    end, failed = PP.fold_chain(*(_t(x) for x in (t0, z, u_err, u_jit, bs,
                                                  be, cs, ce)),
                                policy=pol, faults=fp, base_fail=0.05)
    j_end, j_failed = fold(t0, z, u_err, u_jit, bs, be, cs, ce)
    np.testing.assert_array_equal(end.numpy(), np.asarray(j_end))
    np.testing.assert_array_equal(failed.numpy(), np.asarray(j_failed))
    assert failed.any() and not failed.all()
    deg = rng.uniform(size=n) < 0.4
    dur, tfail = PP.chain_transform(_t(z), _t(u_err), _t(u_jit), _t(deg),
                                    policy=pol, faults=fp, base_fail=0.05)
    j_dur, j_tfail = transform(z, u_err, u_jit, deg)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))
    np.testing.assert_array_equal(tfail.numpy(), np.asarray(j_tfail))


def test_fma_rounds_once():
    """``fma`` is a fused multiply-add: it differs from the two rounded
    operations on some inputs and equals the float64 value rounded."""
    rng = np.random.default_rng(1)
    a, b, c = (rng.uniform(size=10_000).astype(np.float32) * s
               for s in (1e4, 1.0, 1e5))
    got = PP.fma(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(
        got, (a.astype(np.float64) * b + c).astype(np.float32))
    assert (got != a * b + c).any()


def test_table_draws_shapes_sentinels_and_correlation():
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    fp = PF.FaultProfile(az_mtbf_ms=24e3, az_mttr_ms=6e3, max_intervals=16)
    for bs, be in (fp.brownout_tables(gen, 3, (4,)),
                   tuple(torch.tensor(x) for x in
                         fp.brownout_tables_np(rng, 3))):
        assert bs.shape[-2:] == be.shape[-2:] == (3, 16)
        assert bool((bs < be).all())
        assert bool((be[..., :-1] < bs[..., 1:]).all())     # disjoint
    for s, e in (PF.NO_FAULTS.brownout_tables(gen, 3, (2,)),
                 PF.NO_FAULTS.crash_tables(gen, 5, (2,))):
        assert s.shape[-1] == 1 and bool(torch.isinf(s).all())
        assert bool(torch.isinf(e).all())
    s_np, e_np = PF.NO_FAULTS.crash_tables_np(rng, 5)
    assert s_np.shape == (5, 1) and np.isinf(e_np).all()
    cor = PF.FaultProfile(az_mtbf_ms=24e3, az_mttr_ms=6e3, correlated=True)
    bs, _ = cor.brownout_tables(gen, 4, (2,))
    assert bool((bs[:, 0] == bs[:, 3]).all())
    assert not bool((bs[0, 0] == bs[1, 0]).all())     # trials independent
    bs_np, _ = cor.brownout_tables_np(np.random.default_rng(2), 4)
    ref_np, _ = JF.FaultProfile(az_mtbf_ms=24e3, az_mttr_ms=6e3,
                                correlated=True).brownout_tables_np(
        np.random.default_rng(2), 4)
    np.testing.assert_array_equal(bs_np, ref_np)      # numpy: same stream
    cp = PF.FaultProfile(crash_mtbf_ms=50e3, crash_restart_ms=2e3,
                         max_crashes=8)
    cs, ce = cp.crash_tables(gen, 5, (3,))
    assert cs.shape == (3, 5, 8)
    np.testing.assert_allclose((ce - cs).numpy(), 2e3, rtol=1e-5)
    cs_np, _ = cp.crash_tables_np(np.random.default_rng(3), 5)
    ref_cs, _ = JF.FaultProfile(crash_mtbf_ms=50e3, crash_restart_ms=2e3,
                                max_crashes=8).crash_tables_np(
        np.random.default_rng(3), 5)
    np.testing.assert_array_equal(cs_np, ref_cs)
    assert cp.coverage_ms() == pytest.approx((50e3 + 2e3) * 8)
    # the torch draws follow the exponential law: mean cycle ~ mtbf+mttr
    big = PF.FaultProfile(az_mtbf_ms=24e3, az_mttr_ms=6e3, max_intervals=64)
    bs, be = big.brownout_tables(gen, 3, (64,))
    assert float((be[..., -1] / 64).mean()) == pytest.approx(30e3, rel=0.03)


def test_profile_flags_policy_properties_and_can_fail_gate():
    for kw in ({}, dict(az_mtbf_ms=24e3, az_mttr_ms=6e3),
               dict(crash_mtbf_ms=1e5, crash_restart_ms=2e3),
               dict(az_mtbf_ms=1e3, az_mttr_ms=1e3, degraded_fail_prob=0.1)):
        p, j = PF.FaultProfile(**kw), JF.FaultProfile(**kw)
        assert (p.has_brownouts, p.has_crashes, p.enabled,
                p.stationary_degraded, p.coverage_ms()) == \
            (j.has_brownouts, j.has_crashes, j.enabled,
             j.stationary_degraded, j.coverage_ms())
    assert not PF.NO_FAULTS.enabled
    for kw in ({}, dict(timeout_ms=6e3, max_retries=2, backoff_ms=100.0,
                        backoff_jitter=0.5, hedge_ms=2e3),
               dict(max_retries=1)):
        p, j = PP.RecoveryPolicy(**kw), JP.RecoveryPolicy(**kw)
        assert (p.is_default, p.has_hedge, p.chain_attempts,
                p.stock_attempts, p.backoff(1, 0.3)) == \
            (j.is_default, j.has_hedge, j.chain_attempts, j.stock_attempts,
             j.backoff(1, 0.3))
    cases = [(0.0, None, None), (0.01, None, None),
             (0.0, {}, {}), (0.0, None, dict(timeout_ms=5e3)),
             (0.0, dict(az_mtbf_ms=1e3, az_mttr_ms=1e3,
                        degraded_fail_prob=0.1), None),
             (0.0, dict(crash_mtbf_ms=1e5), None),
             (0.0, dict(az_mtbf_ms=1e3, az_mttr_ms=1e3,
                        degraded_inflation=2.0), None)]
    for base, fkw, pkw in cases:
        args_p = (base, None if fkw is None else PF.FaultProfile(**fkw),
                  None if pkw is None else PP.RecoveryPolicy(**pkw))
        args_j = (base, None if fkw is None else JF.FaultProfile(**fkw),
                  None if pkw is None else JP.RecoveryPolicy(**pkw))
        assert PP.can_fail(*args_p) == JP.can_fail(*args_j), (base, fkw, pkw)
