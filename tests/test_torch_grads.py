"""The gradients of the port's three training kernels against the JAX
reference's ``jax.vjp``, on the CPU.

The training forward runs ``flash_attention``, ``expert_matmul`` and
``ssd_scan``; each wrapper takes an autograd Function when grad mode is
on and an input requires grad.  Here (CPU tensors) the forwards are the
plain versions and the backwards are the port's own:

* ``attention_vjp`` (the explicit softmax gradient from q, k and v, in
  query blocks)
  against ``jax.vjp`` of the reference's ``attention_ref`` ([B, H, S, D])
  and ``attention_full`` (the model's [B, S, H, D]), causal with GQA, a
  window and a logit cap, and non-causal with Sq != Sk;
* the ``gmm`` Function, whose backward is two more expert matmuls (C
  padded to a multiple of 8 where it is the contraction), against
  ``jax.vjp`` of ``expert_matmul_ref``;
* ``ssd_vjp`` (the reverse of the chunked form) against ``jax.vjp`` of
  the reference's ``ssd_chunked``, with cotangents for both outputs, y and
  the final state.

Float32, numpy-made inputs and random cotangents; every gradient within
1e-4 x its max |grad| (atol) + 1e-4 (rtol).  The backwards never run a
plain version through autograd: the tests make the plain versions raise
during the backward.  The same Functions are held on the card to float32
autograd through the plain versions by tests/test_torch_kernels_cuda.py.
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.moe_gmm.ref import expert_matmul_ref  # noqa: E402
from repro.models.layers import attention_full  # noqa: E402
from repro.models.mamba2 import ssd_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as mg  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402

TOL = 1e-4

# b, hq, hkv, sq, sk, d, causal, window, cap
ATTN_CASES = [
    (2, 4, 2, 64, 64, 32, True, 0, 0.0),          # causal GQA
    (1, 4, 1, 96, 96, 64, True, 24, 30.0),        # window + cap, MQA
    (2, 2, 2, 40, 72, 32, False, 0, 0.0),         # cross: Sq != Sk
    (1, 6, 2, 33, 80, 16, False, 0, 50.0),        # cross with a cap
    (1, 2, 1, 48, 80, 32, True, 0, 0.0),          # causal, Sq < Sk
]
# e, c, d, f: C a multiple of 8, and C = 4, 12 (padded in dW)
GMM_CASES = [(4, 16, 24, 40), (3, 4, 16, 8), (2, 12, 32, 16)]
# b, s, h, p, g, n, chunk: tests/test_kernels_ssd.py's cases and one
# sequence of a single chunk
SSD_CASES = [(1, 64, 2, 16, 1, 16, 32), (2, 128, 4, 32, 1, 32, 64),
             (1, 128, 4, 16, 2, 16, 32), (1, 48, 2, 8, 1, 8, 64)]


def _vjp(f, primals, cotangent):
    """(f(*primals), the vjp of ``cotangent``), as one jitted function
    (eager ``jax.vjp`` compiles op by op)."""
    def both(ps, ct):
        out, pull = jax.vjp(f, *ps)
        return out, pull(ct)
    return jax.jit(both)(tuple(map(jnp.asarray, primals)),
                         jax.tree_util.tree_map(jnp.asarray, cotangent))


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    atol = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=atol, rtol=TOL,
                               err_msg=name)


def _refuse(*names):
    """Make the named plain versions raise (for the backward)."""
    def refused(*a, **k):
        raise AssertionError("a plain version ran in the backward")
    return [mock.patch.object(mod, name, refused) for mod, name in names]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap", ATTN_CASES)
def test_attention_vjp_matches_reference(b, hq, hkv, sq, sk, d, causal,
                                         window, cap):
    rng = np.random.default_rng(hq * 100 + sq)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    dout = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    scale = d ** -0.5
    out_j, want = _vjp(lambda q_, k_, v_: attention_ref(
        q_, k_, v_, causal=causal, window=window, logit_cap=cap,
        scale=scale), (q, k, v), dout)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.mha(qt, kt, vt, causal=causal, window=window, logit_cap=cap,
                 scale=scale)
    _close(out, out_j, "out")
    patches = _refuse((fa, "attention_plain"))
    for p in patches:
        p.start()
    try:
        got = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(dout))
    finally:
        for p in patches:
            p.stop()
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")
    # the query blocks: one query a block gives the same gradient
    small = fa.attention_vjp(qt.detach(), kt.detach(), vt.detach(),
                             torch.tensor(dout),
                             causal=causal, window=window, logit_cap=cap,
                             scale=scale, block_q=1)
    for name, g, w in zip("qkv", small, want):
        _close(g, w, f"d{name}, block_q=1")


def test_attention_vjp_matches_model_layout():
    """The model's [B, S, H, D] attention (``layers.attention``, which
    hands the kernel transposed views) against ``attention_full``."""
    from repro_torch.models.layers import attention
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    dout = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    _, want = _vjp(lambda q_, k_, v_: attention_full(
        q_, k_, v_, causal=True, window=16, logit_cap=20.0, scale=0.2),
        (q, k, v), dout)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = attention(qt, kt, vt, window=16, logit_cap=20.0, scale=0.2)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(dout))
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")


@pytest.mark.parametrize("e,c,d,f", GMM_CASES)
def test_gmm_function_matches_reference(e, c, d, f):
    rng = np.random.default_rng(c * 10 + d)
    buf = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    dout = rng.standard_normal((e, c, f)).astype(np.float32)
    out_j, want = _vjp(expert_matmul_ref, (buf, w), dout)
    bt, wt = torch.tensor(buf, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    calls = []
    forward = mg._forward

    def counted(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return forward(a, b)
    with mock.patch.object(mg, "_forward", counted):
        out = mg.gmm(bt, wt)
        got = torch.autograd.grad(out, (bt, wt), torch.tensor(dout))
    _close(out, out_j, "out")
    for name, g, wnt in zip(("dbuf", "dw"), got, want):
        _close(g, wnt, name)
    cp = -(-c // 8) * 8
    # the forward and two products in the backward, C padded in dW's
    assert calls == [((e, c, d), (e, d, f)), ((e, c, f), (e, f, d)),
                     ((e, d, cp), (e, cp, f))]


def test_gmm_serving_path_takes_no_function():
    """Without grad (serving) the wrapper launches directly."""
    buf = torch.ones((2, 8, 8), requires_grad=True)
    w = torch.ones((2, 8, 8))
    with torch.no_grad():
        assert mg.gmm(buf, w).grad_fn is None
    assert mg.gmm(buf, w).grad_fn is not None


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_vjp_matches_reference(b, s, h, p, g, n, chunk):
    rng = np.random.default_rng(s + h)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dst = rng.standard_normal((b, h, p, n)).astype(np.float32)
    (y_j, st_j), want = _vjp(lambda *a: ssd_chunked(*a, chunk=chunk),
                             (x, dt, A, B, C), (dy, dst))
    ins = [torch.tensor(t, requires_grad=True) for t in (x, dt, A, B, C)]
    y, st = sd.ssd(*ins, chunk=chunk)
    _close(y, y_j, "y")
    _close(st, st_j, "state")
    patches = _refuse((sd, "ssd_plain"))
    for pt in patches:
        pt.start()
    try:
        got = torch.autograd.grad((y, st), ins,
                                  (torch.tensor(dy), torch.tensor(dst)))
    finally:
        for pt in patches:
            pt.stop()
    for name, gr, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(gr, w, name)


def test_ssd_vjp_without_a_state_cotangent():
    """The model reads only y in training: the final state's cotangent is
    None, which the backward takes as zero."""
    b, s, h, p, g, n, chunk = 1, 64, 2, 16, 1, 16, 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    _, want = _vjp(lambda *a: ssd_chunked(*a, chunk=chunk)[0],
                   (x, dt, A, B, C), dy)
    ins = [torch.tensor(t, requires_grad=True) for t in (x, dt, A, B, C)]
    y, _ = sd.ssd(*ins, chunk=chunk)
    got = torch.autograd.grad(y, ins, torch.tensor(dy))
    for name, gr, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(gr, w, name)
