"""The port's attention kernels and layers against the JAX reference.

On the CPU the wrappers ``mha`` and ``gqa_decode`` run their kernels'
plain PyTorch versions, and those are held here to the reference on the
same numpy-made inputs: ``attention_plain`` to ``attention_ref``, to the
Pallas ``flash_attention(interpret=True)`` and to the model's three jnp
strategies (``attention_full``, ``attention_sliding_blocked``,
``attention_blockwise``); ``decode_attention_plain`` to
``decode_attention_ref``, to ``decode_attention(interpret=True)`` and to
the model's ``_decode_attention`` on a wrapped ring.  Tolerances are the
reference kernel tests': 2e-5 in float32 (the sums run in another order)
and 2e-2 in bfloat16.  The layers (``rms_norm``, ``apply_rope``,
``mlp_block``, ``softcap``) agree to 1e-6 in float32 (``apply_rope`` given
the same frequencies, which agree to one ulp).

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from functools import partial  # noqa: E402

# the reference's jitted wrappers: one compile per case, not one per op
from repro.kernels.decode_attention.ops import (  # noqa: E402
    gqa_decode as j_decode_kernel, gqa_decode_reference as
    decode_attention_ref)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    mha as j_flash_kernel, mha_reference as attention_ref)
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_plain, gqa_decode)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_plain, mha)
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.transformer import decode_positions  # noqa: E402

# tests/test_kernels_flash.py::CASES: b, hq, hkv, s, d, causal, window, cap
FLASH_CASES = [
    (1, 1, 1, 128, 64, True, 0, 0.0),
    (2, 4, 2, 256, 64, True, 0, 0.0),
    (1, 8, 1, 128, 128, True, 0, 0.0),
    (1, 2, 2, 256, 64, True, 128, 0.0),
    (1, 2, 1, 256, 64, True, 0, 50.0),
    (1, 2, 2, 192, 64, True, 0, 0.0),
    (2, 2, 2, 128, 64, False, 0, 0.0),
]
# tests/test_kernels_decode.py::CASES: b, hq, hkv, sk, d, valid, cap
DECODE_CASES = [
    (1, 1, 1, 256, 64, None, 0.0),
    (2, 8, 2, 512, 64, None, 0.0),
    (1, 16, 1, 256, 128, None, 0.0),
    (2, 4, 4, 512, 64, 300, 0.0),
    (1, 8, 8, 256, 64, None, 50.0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (bf16 is rounded once, by torch, and handed to JAX as those values)."""
    t = torch.as_tensor(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy().astype(jnp.dtype(dtype))), t


def qkv(seed, b, hq, hkv, sq, sk, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return [_pair(a, dtype) for a in arrs]


# the reference's bf16 case (test_flash_dtypes), and with gemma's cap
BF16_CASES = [(1, 4, 2, 128, 64, True, 0, 0.0),
              (1, 4, 2, 128, 64, True, 32, 50.0)]


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,causal,window,cap,dtype",
    [c + ("float32",) for c in FLASH_CASES]
    + [c + ("bfloat16",) for c in BF16_CASES])
def test_attention_plain_matches_reference(b, hq, hkv, s, d, causal, window,
                                           cap, dtype):
    (jq, tq), (jk, tk), (jv, tv) = qkv(0, b, hq, hkv, s, s, d, dtype)
    got = _np(attention_plain(tq, tk, tv, causal=causal, window=window,
                              logit_cap=cap).float())
    want = _np(attention_ref(jq, jk, jv, causal=causal, window=window,
                             logit_cap=cap))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == "float32":
        kern = _np(j_flash_kernel(jq, jk, jv, causal=causal, window=window,
                                  logit_cap=cap, block_q=64, block_k=64,
                                  interpret=True))
        np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)


def test_attention_plain_aligns_query_ends():
    """Sq < Sk: query i sits at key position i + Sk - Sq, as in the
    reference (a chunk of queries at the end of a longer prompt)."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(3, 1, 4, 2, 64, 192, 32)
    got = _np(attention_plain(tq, tk, tv, window=96, logit_cap=30.0))
    want = _np(attention_ref(jq, jk, jv, window=96, logit_cap=30.0))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


# b, hq, hkv, s, d, window, cap, blocks: a sequence split into ``blocks``
# query blocks, each a rank's (its keys whole)
OFFSET_CASES = [(1, 4, 2, 128, 32, 0, 0.0, 4), (2, 3, 1, 96, 16, 24, 50.0, 2),
                (1, 4, 4, 64, 32, 0, 30.0, 4)]


@pytest.mark.parametrize("b,hq,hkv,s,d,window,cap,blocks", OFFSET_CASES)
def test_attention_plain_query_offset_matches_reference_rows(
        b, hq, hkv, s, d, window, cap, blocks):
    """A block of queries at ``q_offset`` (the start of a rank's block of a
    sequence-sharded query) over the whole keys: the reference's
    attention's rows of that block."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(5, b, hq, hkv, s, s, d)
    want = _np(attention_ref(jq, jk, jv, window=window, logit_cap=cap))
    n = s // blocks
    for i in range(blocks):
        got = _np(attention_plain(tq[:, :, i * n:(i + 1) * n], tk, tv,
                                  window=window, logit_cap=cap,
                                  q_offset=i * n))
        np.testing.assert_allclose(got, want[:, :, i * n:(i + 1) * n],
                                   atol=2e-5, rtol=2e-5, err_msg=str(i))


# the model's strategies take [B, S, H, D]: (b, hq, hkv, s, d, window, cap)
STRATEGY_CASES = [
    ("full", 2, 4, 2, 48, 16, 0, 0.0),
    ("full", 1, 4, 1, 40, 32, 8, 50.0),
    ("sliding_blocked", 2, 4, 2, 64, 16, 16, 50.0),
    ("sliding_blocked", 1, 2, 2, 96, 32, 32, 0.0),
    ("blockwise", 1, 4, 2, 128, 16, 0, 50.0),
    ("blockwise", 2, 2, 1, 96, 32, 0, 0.0),
]


@pytest.mark.parametrize("strategy,b,hq,hkv,s,d,window,cap", STRATEGY_CASES)
def test_attention_plain_matches_model_strategies(strategy, b, hq, hkv, s, d,
                                                  window, cap):
    (jq, tq), (jk, tk), (jv, tv) = qkv(1, b, hq, hkv, s, s, d)
    jq, jk, jv = (x.swapaxes(1, 2) for x in (jq, jk, jv))     # [B,S,H,D]
    scale = 0.25
    if strategy == "full":
        fn = partial(jl.attention_full, causal=True, window=window)
    elif strategy == "sliding_blocked":
        fn = partial(jl.attention_sliding_blocked, window=window)
    else:
        fn = partial(jl.attention_blockwise, causal=True, chunk=32)
    want = jax.jit(partial(fn, logit_cap=cap, scale=scale))(jq, jk, jv)
    got = tl.attention(tq.transpose(1, 2), tk.transpose(1, 2),
                       tv.transpose(1, 2), window=window, logit_cap=cap,
                       scale=scale)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def decode_inputs(seed, b, hq, hkv, sk, d, dtype="float32", pos=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    if pos is None:
        pos = np.arange(sk, dtype=np.int32)
    return [_pair(a, dtype) for a in arrs] + [
        (jnp.asarray(pos), torch.as_tensor(pos))]


def ring_positions(idx, c, window):
    """A local layer's wrapped ring at decode index ``idx`` (holes of -1
    where the window has passed)."""
    slots = np.arange(c)
    kv_pos = idx - ((idx - slots) % c)
    ok = (kv_pos >= 0) & (kv_pos > idx - window) & (kv_pos <= idx)
    return np.where(ok, kv_pos, -1).astype(np.int32)


@pytest.mark.parametrize("b,hq,hkv,sk,d,valid,cap", DECODE_CASES + [
    (2, 8, 4, 96, 32, "ring", 50.0), (1, 4, 2, 256, 64, "holes", 0.0)])
def test_decode_plain_matches_reference(b, hq, hkv, sk, d, valid, cap):
    pos = np.arange(sk, dtype=np.int32)
    if valid == "ring":
        pos = ring_positions(150, sk, 70)
        assert (pos < 0).any() and pos.max() == 150
    elif valid == "holes":           # the reference's ring-mask test
        pos[np.random.default_rng(0).random(sk) < 0.3] = -1
    elif valid is not None:
        pos[valid:] = -1
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = decode_inputs(0, b, hq, hkv, sk,
                                                           d, pos=pos)
    got = _np(decode_attention_plain(tq, tk, tv, tp, logit_cap=cap))
    want = _np(decode_attention_ref(jq, jk, jv, jp, logit_cap=cap))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    kern = _np(j_decode_kernel(jq, jk, jv, jp, logit_cap=cap,
                               block_k=min(128, sk), interpret=True))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,hq,hkv,sk,d,cap,parts", [
    (2, 8, 2, 96, 32, 50.0, 2), (1, 4, 1, 256, 64, 0.0, 4)])
def test_decode_plain_lse_merges_ring_parts_to_reference(b, hq, hkv, sk, d,
                                                         cap, parts):
    """A ring (with out-of-window slots) cut into ``parts`` slices, as a
    slot-sharded cache's ranks hold it: each slice's output and
    log-sum-exp merged by ``merge_parts`` equal the reference's decode
    over the whole ring."""
    from repro_torch.kernels.decode_attention.ops import merge_parts
    pos = ring_positions(sk + 40, sk, sk - 30)
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = decode_inputs(
        6, b, hq, hkv, sk, d, pos=pos)
    want = _np(decode_attention_ref(jq, jk, jv, jp, logit_cap=cap))
    n = sk // parts
    outs = [decode_attention_plain(tq, tk[:, i * n:(i + 1) * n],
                                   tv[:, i * n:(i + 1) * n],
                                   tp[i * n:(i + 1) * n], logit_cap=cap,
                                   return_lse=True) for i in range(parts)]
    got = merge_parts(torch.stack([o for o, _ in outs]),
                      torch.stack([lse for _, lse in outs]))
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)
    whole, lse = decode_attention_plain(tq, tk, tv, tp, logit_cap=cap,
                                        return_lse=True)
    np.testing.assert_array_equal(_np(whole), _np(decode_attention_plain(
        tq, tk, tv, tp, logit_cap=cap)))
    assert lse.shape == (b, hq) and lse.dtype == torch.float32


def test_decode_plain_bf16():
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = decode_inputs(
        2, 2, 8, 2, 256, 64, "bfloat16")
    got = _np(decode_attention_plain(tq, tk, tv, tp).float())
    want = _np(decode_attention_ref(jq, jk, jv, jp))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("local", [True, False])
def test_decode_matches_model_decode_attention(local):
    """The model's grouped ``_decode_attention`` with the transformer's own
    cache positions: ring (local, wrapped) and global (partly filled)."""
    b, hq, hkv, c, d, idx = 2, 4, 2, 24, 16, 37 if local else 13
    window = 10
    pos = decode_positions(idx, c, window if local else 0, "cpu")
    if local:
        np.testing.assert_array_equal(pos.numpy(),
                                      ring_positions(idx, c, window))
    (jq, tq), (jk, tk), (jv, tv), _ = decode_inputs(4, b, hq, hkv, c, d)
    want = jax.jit(jt._decode_attention, static_argnums=(4, 5, 6))(
        jq[:, None], jk, jv, jnp.asarray(pos.numpy()), idx, 0.3, 50.0)
    got = gqa_decode(tq, tk, tv, pos, scale=0.3, logit_cap=50.0)
    np.testing.assert_allclose(_np(got), _np(want[:, 0]), atol=2e-5,
                               rtol=2e-5)


def test_wrappers_run_plain_on_cpu_without_counting():
    (_, tq), (_, tk), (_, tv) = qkv(5, 1, 2, 1, 64, 64, 32)
    n = mha.launches
    torch.testing.assert_close(mha(tq, tk, tv, window=16),
                               attention_plain(tq, tk, tv, window=16),
                               rtol=0, atol=0)
    (_, q), (_, k), (_, v), (_, p) = decode_inputs(5, 1, 2, 1, 64, 32)
    m = gqa_decode.launches
    torch.testing.assert_close(gqa_decode(q, k, v, p),
                               decode_attention_plain(q, k, v, p),
                               rtol=0, atol=0)
    assert (mha.launches, gqa_decode.launches) == (n, m)


def test_wrappers_refuse_bad_inputs():
    (_, tq), (_, tk), (_, tv) = qkv(6, 1, 3, 2, 32, 32, 32)
    with pytest.raises(ValueError, match="multiple"):
        mha(tq, tk, tv)
    (_, tq), (_, tk), (_, tv) = qkv(6, 1, 2, 1, 64, 32, 32)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        mha(tq, tk, tv)
    with pytest.raises(TypeError):
        mha(tq[:, :, :32], tk.to(torch.bfloat16), tv)
    (_, q), (_, k), (_, v), (_, p) = decode_inputs(6, 1, 2, 1, 64, 32)
    with pytest.raises(ValueError, match="int32"):
        gqa_decode(q, k, v, p.long())


# -- layers -----------------------------------------------------------------

def test_rms_norm_and_softcap_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    got = tl.rms_norm(torch.as_tensor(x), torch.as_tensor(scale))
    want = jax.jit(jl.rms_norm)(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    s = 40.0 * x
    for cap in (0.0, 50.0, 30.0):
        np.testing.assert_allclose(
            _np(tl.softcap(torch.as_tensor(s), cap)),
            _np(jax.jit(jl.softcap, static_argnums=1)(jnp.asarray(s), cap)),
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (256, 10000.0),
                                      (128, 1000000.0), (96, 10000.0)])
def test_apply_rope_matches_reference(hd, theta, monkeypatch):
    """The frequencies ``theta ** (-2i/hd)`` agree to one ulp: float32
    ``pow`` rounds differently in XLA and in torch (XLA's eager and jitted
    ``rope_freqs`` differ from each other by as much), and at position p
    one ulp of a frequency moves the angle by p ulps.  The rotation itself
    is held to 1e-6 given the same frequencies."""
    ours = tl.rope_freqs(hd, theta).numpy()
    np.testing.assert_array_max_ulp(ours, np.asarray(jl.rope_freqs(hd, theta)),
                                    maxulp=1)
    monkeypatch.setattr(jl, "rope_freqs", lambda *a: jnp.asarray(ours))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(20, 32)]).astype(np.int32)
    got = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    want = jax.jit(jl.apply_rope, static_argnums=2)(jnp.asarray(x),
                                                    jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("variant", ["swiglu", "geglu"])
def test_mlp_block_matches_reference(variant):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    p = {name: (0.05 * rng.standard_normal(shape)).astype(np.float32)
         for name, shape in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                             ("w_down", (128, 64)))}
    got = tl.mlp_block(torch.as_tensor(x),
                       {k: torch.as_tensor(v) for k, v in p.items()}, variant)
    want = jax.jit(jl.mlp_block, static_argnums=2)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, variant)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
