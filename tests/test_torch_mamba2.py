"""The port's Mamba2 layer, its SSD-scan kernel and zamba2's shared block
against the JAX reference, on the CPU.

On the CPU the wrapper ``ssd`` runs the kernel's plain PyTorch version,
``ssd_plain`` (the reference's ``ssd_chunked`` with its associative
bracketing of the inter-chunk recurrence), and that is held here to the
reference's ``ssd_ref`` and to the Pallas ``ssd_scan(interpret=True)`` at
the reference kernel tests' cases, within their 2e-4 bar.  The layer
(``mamba2_block``: projections, causal convs, the scan, the gated norm),
its decode step against the reference's, and zamba2's shared
attention+MLP block agree within 1e-5 in float32 on numpy-made inputs and
shared weights; the port writes the decode cache in place and the
reference returns a new one, and the two caches agree.

The CUDA kernel itself is held to ``ssd_plain`` on the card by
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    import hypothesis
    import hypothesis.strategies as st
except ModuleNotFoundError:  # bare env: property tests skip, rest still run
    from _hypothesis_compat import hypothesis, st

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as j_ssd  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_reference  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    segsum, ssd, ssd_plain)
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

# tests/test_kernels_ssd.py::CASES: b, s, h, p, g, n, chunk
SSD_CASES = [
    (1, 64, 2, 16, 1, 16, 32),
    (2, 128, 4, 32, 1, 32, 64),
    (1, 128, 4, 16, 2, 16, 32),
    (1, 256, 2, 64, 1, 64, 128),
]
SSD_TOL = 2e-4
TOL = 1e-5
SSM_ARCHS = ("mamba2-1.3b", "zamba2-1.2b")


def _np(x):
    return np.asarray(x, np.float32)


def make(seed, b, s, h, p, g, n, dt_scale=1.0):
    """The reference test's input law, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0) * dt_scale
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, s, g, n)) * 0.5
    C = rng.standard_normal((b, s, g, n)) * 0.5
    return tuple(a.astype(np.float32) for a in (x, dt, A, B, C))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_plain_matches_reference(b, s, h, p, g, n, chunk):
    jin, tin = _both(make(0, b, s, h, p, g, n))
    y, st_ = ssd(*tin, chunk=chunk)
    for want in (ssd_reference(*jin, chunk=chunk),
                 j_ssd(*jin, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(_np(y), _np(want[0]), atol=SSD_TOL,
                                   rtol=SSD_TOL)
        np.testing.assert_allclose(_np(st_), _np(want[1]), atol=SSD_TOL,
                                   rtol=SSD_TOL)


@hypothesis.given(chunks=st.integers(1, 4), h=st.sampled_from([1, 2, 4]),
                  g=st.sampled_from([1, 2]), seed=st.integers(0, 500))
@hypothesis.settings(max_examples=8, deadline=None, derandomize=True)
def test_ssd_plain_property(chunks, h, g, seed):
    if h % g:
        g = 1
    jin, tin = _both(make(seed, 1, 32 * chunks, h, 16, g, 16))
    y, st_ = ssd_plain(*tin, chunk=32)
    yr, str_ = ssd_reference(*jin, chunk=32)
    np.testing.assert_allclose(_np(y), _np(yr), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(_np(st_), _np(str_), atol=5e-4, rtol=5e-4)


def test_ssd_plain_is_the_sequential_recurrence():
    """Chunking is exact: every chunk length gives the step-by-step
    recurrence's y and state."""
    x, dt, A, B, C = (torch.from_numpy(a).double()
                      for a in make(1, 1, 64, 2, 8, 1, 8, dt_scale=0.1))
    state = torch.zeros((1, 2, 8, 8), dtype=torch.float64)
    ys = []
    for t in range(64):
        y_t, state = tm.ssd_decode_step(state, x[:, t], dt[:, t], A,
                                        B[:, t], C[:, t])
        ys.append(y_t)
    want = torch.stack(ys, dim=1)
    for chunk in (8, 16, 64):
        y, st_ = ssd_plain(x, dt, A, B, C, chunk=chunk)
        torch.testing.assert_close(y, want, atol=1e-10, rtol=1e-10)
        torch.testing.assert_close(st_, state, atol=1e-10, rtol=1e-10)


def test_ssd_state_carries_between_chunks():
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in make(1, 1, 128, 2, 16, 1, 16, dt_scale=0.02))
    y1, _ = ssd(x, dt, A, B, C, chunk=32)
    x2 = x.clone()
    x2[:, :32] = 0
    y2, _ = ssd(x2, dt, A, B, C, chunk=32)
    assert not torch.allclose(y1[:, 64:], y2[:, 64:])


def test_segsum_matches_reference():
    a = np.random.default_rng(4).standard_normal((3, 16)).astype(np.float32)
    got = _np(segsum(torch.from_numpy(a)))
    want = _np(jax.jit(jm._segsum)(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-5)


def test_ssd_refuses_what_the_reference_refuses():
    x, dt, A, B, C = (torch.from_numpy(a) for a in make(0, 1, 48, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x, dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="shapes do not match"):
        ssd(x, dt[:, :, :1], A, B, C, chunk=16)
    n = ssd.launches
    ssd(x, dt, A, B, C, chunk=16)
    assert ssd.launches == n        # the plain version is not a launch


def test_conv_and_decode_step_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(
        _np(tm.causal_conv(*map(torch.from_numpy, (x, w, bias)))),
        _np(jax.jit(jm.causal_conv)(*map(jnp.asarray, (x, w, bias)))),
        atol=1e-6, rtol=1e-6)
    cache = x[:, :3]
    got = tm._conv_step(*map(torch.from_numpy, (cache, x[:, 3:4], w, bias)))
    want = jax.jit(jm._conv_step)(*map(jnp.asarray,
                                       (cache, x[:, 3:4], w, bias)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-6)
    st0 = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
    xs = rng.standard_normal((2, 4, 8)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (2, 4)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, 4).astype(np.float32)
    Bs = rng.standard_normal((2, 2, 6)).astype(np.float32)
    Cs = rng.standard_normal((2, 2, 6)).astype(np.float32)
    args = (st0, xs, dt, A, Bs, Cs)
    for a, b in zip(tm.ssd_decode_step(*map(torch.from_numpy, args)),
                    jax.jit(jm.ssd_decode_step)(*map(jnp.asarray, args))):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-6)


def _layer(name, seed=0):
    jcfg = j_reduced(j_get_config(name))
    cfg = reduced_config(get_config(name))
    jp = jm.init_mamba2_params(jax.random.PRNGKey(seed), jcfg.d_model,
                               jcfg.ssm, jnp.float32)
    # the reference draws dt_bias, A_log and D as constants: vary them
    rng = np.random.default_rng(seed)
    h = jp["A_log"].shape[0]
    jp = dict(jp, dt_bias=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
              A_log=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
              D=jnp.asarray(rng.normal(1, 0.2, h), jnp.float32))
    p = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_mamba2_block_prefill_and_decode_match_reference(name):
    jcfg, cfg, jp, p = _layer(name)
    s, steps = 32, 4
    x = np.random.default_rng(8).standard_normal(
        (2, s + steps, cfg.d_model)).astype(np.float32)
    jpre = jax.jit(lambda x_, p_, c_: jm.mamba2_block(
        x_, p_, jcfg.ssm, mode="prefill", cache=c_))
    jdec = jax.jit(lambda x_, p_, c_: jm.mamba2_block(
        x_, p_, jcfg.ssm, mode="decode", cache=c_))
    jcache = jm.init_ssm_cache(2, jcfg.d_model, jcfg.ssm, jnp.float32)
    cache = tm.init_ssm_cache(2, cfg.d_model, cfg.ssm, torch.float32,
                              device="cpu")
    jy, jcache = jpre(jnp.asarray(x[:, :s]), jp, jcache)
    y, cache = tm.mamba2_block(torch.from_numpy(x[:, :s]), p, cfg.ssm,
                               mode="prefill", cache=cache)
    np.testing.assert_allclose(_np(y), _np(jy), atol=TOL, rtol=TOL)
    for t in range(s, s + steps):
        jy, jcache = jdec(jnp.asarray(x[:, t:t + 1]), jp, jcache)
        y, cache = tm.mamba2_block(torch.from_numpy(x[:, t:t + 1]), p,
                                   cfg.ssm, mode="decode", cache=cache)
        np.testing.assert_allclose(_np(y), _np(jy), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {t}")
    for key, want in jcache.items():
        np.testing.assert_allclose(_np(cache[key]), _np(want), atol=TOL,
                                   rtol=TOL, err_msg=key)


def test_init_mamba2_params_follow_the_reference():
    for name in SSM_ARCHS:
        jcfg, cfg, jp, _ = _layer(name)
        p = tm.init_mamba2_params(cfg.d_model, cfg.ssm, torch.float32,
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
        assert {k: tuple(v.shape) for k, v in p.items()} == {
            k: tuple(v.shape) for k, v in jp.items()}
        for k in ("conv_B_w", "A_log", "D", "norm", "dt_bias"):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(
                jm.init_mamba2_params(jax.random.PRNGKey(0), jcfg.d_model,
                                      jcfg.ssm, jnp.float32)[k]))
        cache = tm.init_ssm_cache(2, cfg.d_model, cfg.ssm, torch.bfloat16,
                                  device="meta")
        jcache = jm.init_ssm_cache(2, jcfg.d_model, jcfg.ssm, jnp.bfloat16)
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: tuple(v.shape) for k, v in jcache.items()}
        assert cache["state"].dtype == torch.float32


def test_shared_block_matches_reference():
    name = "zamba2-1.2b"
    jcfg = j_reduced(j_get_config(name))
    cfg = reduced_config(get_config(name))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(1))
    params = tt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    s, max_len = 12, 16
    x = np.random.default_rng(9).standard_normal(
        (2, s + 1, cfg.d_model)).astype(np.float32)
    jcache = {"k": jnp.zeros((2, max_len, cfg.num_kv_heads,
                              cfg.resolved_head_dim))}
    jcache["v"] = jcache["k"]
    cache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    pos = np.broadcast_to(np.arange(s + 1)[None], (2, s + 1))

    def jrun(x_, c_, pos_, mode):
        return jt._shared_block_apply(x_, jparams["shared_block"], jcfg,
                                      mode=mode, positions=pos_, cache=c_)
    jy, jcache = jax.jit(lambda x_, c_, p_: jrun(x_, c_, p_, "prefill"))(
        jnp.asarray(x[:, :s]), jcache, jnp.asarray(pos[:, :s]))
    rope = tt.rope_tables(torch.from_numpy(pos[:, :s].copy()),
                          cfg.resolved_head_dim, cfg.rope_theta)
    y, cache = tt._shared_block_apply(
        torch.from_numpy(x[:, :s]), params["shared_block"], cfg,
        mode="prefill", rope=rope, cache=cache)
    np.testing.assert_allclose(_np(y), _np(jy), atol=TOL, rtol=TOL)
    jy, jcache = jax.jit(lambda x_, c_, p_: jrun(x_, c_, p_, "decode"))(
        jnp.asarray(x[:, s:]), dict(jcache, index=jnp.int32(s)),
        jnp.asarray(pos[:, s:]))
    rope = tt.rope_tables(torch.from_numpy(pos[:, s:].copy()),
                          cfg.resolved_head_dim, cfg.rope_theta)
    y, cache = tt._shared_block_apply(
        torch.from_numpy(x[:, s:]), params["shared_block"], cfg,
        mode="decode", rope=rope, cache=dict(cache, index=s))
    np.testing.assert_allclose(_np(y), _np(jy), atol=TOL, rtol=TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(cache[kv]), _np(jcache[kv]),
                                   atol=TOL, rtol=TOL)
