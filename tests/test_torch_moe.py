"""The port's MoE layer and its expert-matmul kernel against the JAX
reference, on the CPU.

On the CPU the wrapper ``gmm`` runs the kernel's plain PyTorch version,
``expert_matmul_plain``, and that is held here to the reference's
``expert_matmul_ref`` and to the Pallas ``expert_matmul(interpret=True)``
at the reference kernel tests' shapes, within their ``tol * d`` bar.  The
layer (``moe_block_global``: router, capacity dispatch, expert MLPs,
combine, shared expert, aux loss) agrees with the reference's within 1e-5
in float32 on numpy-made inputs and shared weights.

The router's top-k is a discrete choice: an ulp of difference in the
float32 gates could pick another expert where the k-th and (k+1)-th gates
nearly tie.  The layer tests report the smallest such gap of their inputs
in the failure message; the inputs are not re-drawn to avoid it.

The CUDA kernel itself is held to ``expert_matmul_plain`` on the card by
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
from repro.kernels.moe_gmm.ops import gmm as j_gmm  # noqa: E402
from repro.kernels.moe_gmm.ops import gmm_reference  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import (  # noqa: E402
    expert_matmul_plain, gmm)
from repro_torch.models import moe as tm  # noqa: E402

# tests/test_kernels_gmm.py: e, c, d, f, dtype, tol
GMM_CASES = [
    (4, 128, 64, 128, "float32", 1e-5),
    (8, 64, 128, 64, "float32", 1e-5),
    (2, 256, 256, 128, "float32", 1e-5),
    (4, 128, 64, 128, "bfloat16", 3e-2),
]
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    """A numpy array as a JAX array and a torch tensor of ``dtype``; a
    bfloat16 pair holds the same rounded values."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy())
    return j, t.to(getattr(torch, dtype))


@pytest.mark.parametrize("e,c,d,f,dtype,tol", GMM_CASES)
def test_expert_matmul_plain_matches_reference(e, c, d, f, dtype, tol):
    rng = np.random.default_rng(0)
    jbuf, buf = _pair(rng.standard_normal((e, c, d), np.float32), dtype)
    jw, w = _pair(rng.standard_normal((e, d, f), np.float32), dtype)
    got = _np(gmm(buf, w).float())
    assert gmm(buf, w).dtype == buf.dtype
    for want in (gmm_reference(jbuf, jw),
                 j_gmm(jbuf, jw, block_c=64, block_f=64, block_d=64,
                       interpret=True)):
        np.testing.assert_allclose(got, _np(want), atol=tol * d, rtol=tol)


@hypothesis.given(e=st.integers(1, 6), cb=st.integers(1, 3),
                  db=st.integers(1, 3), fb=st.integers(1, 2),
                  seed=st.integers(0, 100))
@hypothesis.settings(max_examples=8, deadline=None, derandomize=True)
def test_expert_matmul_plain_property(e, cb, db, fb, seed):
    c, d, f = 32 * cb, 32 * db, 32 * fb
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((e, c, d), np.float32)
    w = rng.standard_normal((e, d, f), np.float32)
    np.testing.assert_allclose(
        _np(expert_matmul_plain(torch.from_numpy(buf), torch.from_numpy(w))),
        _np(gmm_reference(jnp.asarray(buf), jnp.asarray(w))),
        atol=1e-4, rtol=1e-4)


def test_gmm_refuses_mismatched_inputs():
    buf = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match=r"\[E, C, D\]"):
        gmm(buf, torch.zeros((2, 16, 8)))
    with pytest.raises(TypeError, match="bfloat16"):
        gmm(buf, torch.zeros((2, 8, 8), dtype=torch.bfloat16))
    n = gmm.launches
    gmm(buf, torch.zeros((2, 8, 8)))
    assert gmm.launches == n        # the plain version is not a launch


@pytest.mark.parametrize("t,k,e,cf", [(1, 8, 40, 1.25), (2, 8, 40, 1.25),
                                      (8192, 8, 40, 1.25), (32, 2, 8, 1.25),
                                      (100, 1, 128, 1.0), (7, 2, 8, 2.0)])
def test_moe_capacity_matches_reference(t, k, e, cf):
    cfg = tm.MoEConfig(num_experts=e, top_k=k, expert_ff=8)
    assert tm.moe_capacity(t, cfg, cf) == jm.moe_capacity(t, cfg, cf)


def test_top_k_breaks_ties_to_the_lowest_index():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (64, 10)).astype(np.float32) / 4   # many ties
    for k in (1, 3, 8):
        vals, idx = tm.top_k(torch.from_numpy(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def _gate_gap(gates, k):
    """The smallest gap between the k-th and (k+1)-th gate of any token:
    how close the router's choice is to a tie."""
    g = np.sort(_np(gates), axis=-1)[:, ::-1]
    return float((g[:, k - 1] - g[:, k]).min()) if g.shape[1] > k else \
        float("inf")


def _moe_inputs(name, t, seed):
    jcfg = j_reduced(j_get_config(name))
    cfg = reduced_config(get_config(name))
    jp = jm.init_moe_params(jax.random.PRNGKey(seed), jcfg.d_model,
                            jcfg.moe, jnp.float32)
    p = {k: (torch.from_numpy(np.asarray(v).copy()) if not isinstance(v, dict)
             else {kk: torch.from_numpy(np.asarray(vv).copy())
                   for kk, vv in v.items()})
         for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, t, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("t", [1, 16, 40])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_block_matches_reference(name, t):
    """t = 40 overflows the experts' capacity, so slots are dropped."""
    jcfg, cfg, jp, p, x = _moe_inputs(name, t, seed=5)
    fn = jax.jit(lambda x_, p_: jm.moe_block_global(
        x_, p_, jcfg.moe, jcfg.mlp_variant))
    jy, jaux = fn(jnp.asarray(x), jp)
    y, aux = tm.moe_block(torch.from_numpy(x), p, cfg.moe, cfg.mlp_variant)
    _, _, gates = tm._route(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                            p["router"], cfg.moe.top_k)
    gap = _gate_gap(gates, cfg.moe.top_k)
    np.testing.assert_allclose(_np(y), _np(jy), atol=TOL, rtol=TOL,
                               err_msg=f"smallest top-k gate gap {gap:.3g}")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)


def test_dispatch_and_combine_match_reference():
    rng = np.random.default_rng(2)
    t, d, e, k, cap = 24, 8, 4, 2, 8
    xt = rng.standard_normal((t, d)).astype(np.float32)
    topi = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    topw = rng.uniform(size=(t, k)).astype(np.float32)
    jbuf, jrouting = jax.jit(jm._dispatch_local, static_argnums=(3, 4))(
        jnp.asarray(xt), jnp.asarray(topi), jnp.asarray(topw), e, cap)
    buf, routing = tm._dispatch_local(torch.from_numpy(xt),
                                      torch.from_numpy(topi).long(),
                                      torch.from_numpy(topw), e, cap)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    for a, b in zip(routing, jrouting):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = rng.standard_normal((e, cap, d)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tm._combine_local(torch.from_numpy(out), routing,
                              torch.from_numpy(topw), t, d, torch.float32)),
        _np(jax.jit(jm._combine_local, static_argnums=(3, 4, 5))(
            jnp.asarray(out), jrouting, jnp.asarray(topw), t, d,
            jnp.float32)), atol=1e-6, rtol=1e-6)


def test_init_moe_params_follow_the_reference():
    for name in MOE_ARCHS:
        jcfg, cfg, jp, _, _ = _moe_inputs(name, 1, seed=0)
        gen = torch.Generator().manual_seed(0)
        p = tm.init_moe_params(cfg.d_model, cfg.moe, torch.float32,
                               generator=gen, device="cpu")
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        want = {".".join(k.key for k in path): tuple(v.shape)
                for path, v in flat}
        got = {k: tuple(v.shape) for k, v in p.items() if k != "shared"}
        got.update({f"shared.{k}": tuple(v.shape)
                    for k, v in p.get("shared", {}).items()})
        assert got == want
        assert 0.015 < float(p["w_up"].std()) < 0.025


def test_expert_parallelism_is_refused():
    """Expert parallelism, once refused, is ported: ``EPSpec`` reads
    its mesh as the reference's does (dp, tp, and the experts padded to a
    multiple of the model axis) on the abstract production meshes.  What
    stays refused is running the block over an abstract mesh.  The block
    itself is held to the reference on gloo ranks in
    tests/test_torch_ep.py."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh
    cfg = reduced_config(get_config("granite-moe-3b-a800m"))
    for multi_pod, (shape, names) in PRODUCTION_SHAPES.items():
        data = names[:-1]
        ep = tm.EPSpec(AbstractMesh(shape, names), data)
        jep = jm.EPSpec(jax.sharding.AbstractMesh(shape, names), data)
        assert (ep.dp, ep.tp) == (jep.dp, jep.tp) == (
            int(np.prod(shape[:-1])), 16)
        for e in (40, 128, 5):
            assert ep.e_pad(e) == -(-e // jep.tp) * jep.tp
        with pytest.raises(ValueError, match="AbstractMesh"):
            tm.moe_block(torch.zeros((1, 2, cfg.d_model)), {}, cfg.moe,
                         cfg.mlp_variant, ep=ep)