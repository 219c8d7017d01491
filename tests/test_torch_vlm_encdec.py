"""The port's VLM (qwen2-vl-2b) and encoder-decoder (seamless-m4t-medium)
serving paths against the JAX reference, on the CPU.

* ``apply_mrope`` equals the reference's within 1e-6 (given the same
  rotary frequencies, which agree to one ulp; see
  tests/test_torch_attention.py) on distinct (t, h, w) streams, and with
  equal streams it is the port's ``apply_rope``.
* Reduced qwen2-vl-2b, weights shared through ``params_from_numpy``:
  prefill of 16 embedding positions with distinct M-RoPE streams (text,
  then a patch grid, as Qwen2-VL lays out an image after text) and 10
  teacher-forced decode steps agree with ``jt.prefill`` /
  ``jt.decode_step`` within 1e-4, logits and caches, at the reduced GQA
  group of 4 and at qwen2-vl-2b's own group of 6.
* Reduced seamless-m4t-medium: the reference's ``prefill`` attends over a
  zero-filled cross cache and never reads its encoder (its logits do not
  move with ``enc_emb``; pinned here).  The port computes the cross K/V
  from the encoder, so it is held to the reference's own functions called
  so that they do: ``jt.encode``, ``jt.apply_stack(mode="prefill",
  enc_out=...)`` over a cache without ``cross_k`` / ``cross_v``, the
  final norm and ``jt._logits``, then ``jt.decode_step`` on the cache it
  returns; within 1e-4, ``cross_k`` / ``cross_v`` included.
* ``demo_requests`` makes the reference's draws bit for bit; greedy
  tokens of ``ServingEngine.generate`` equal the reference's exactly, and
  ``generate_flight``'s equal ``generate``'s; the cache shapes follow the
  reference (the parameter names are held in tests/test_torch_lm.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.step import cache_shape  # noqa: E402

VLM, ENCDEC = "qwen2-vl-2b", "seamless-m4t-medium"
PROMPT, ENC_LEN, STEPS, BATCH = 16, 24, 10, 2
TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.float()
    return np.asarray(x, np.float32)


def _model(name, **heads):
    """The reduced config (``heads``: num_heads / num_kv_heads to replace)
    in both packages, the reference's parameters and the port's copy."""
    cfg = dataclasses.replace(reduced_config(get_config(name)), **heads)
    jcfg = dataclasses.replace(j_reduced(j_get_config(name)), **heads)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
    return cfg, jcfg, jparams, params


def _thw(batch, text, rows, cols):
    """M-RoPE ids [3, batch, text + rows * cols]: ``text`` positions with
    t = h = w = i, then a rows x cols patch grid at t = text, h = text +
    row, w = text + col; each batch row shifted by 3."""
    t = list(range(text)) + [text] * (rows * cols)
    h = list(range(text)) + [text + r for r in range(rows)
                             for _ in range(cols)]
    w = list(range(text)) + [text + c for _ in range(rows)
                             for c in range(cols)]
    one = np.array([t, h, w], np.int32)
    return np.stack([one + 3 * i for i in range(batch)], axis=1)


def _assert_caches(got, want, path=""):
    assert set(got) == set(want), path
    for name, w in want.items():
        if name == "index":
            assert int(got[name]) == int(w)
        elif isinstance(w, dict):
            _assert_caches(got[name], w, f"{path}{name}.")
        else:
            np.testing.assert_allclose(_np(got[name]), _np(w), atol=TOL,
                                       rtol=TOL, err_msg=f"{path}{name}")


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)),
                                         (16, (2, 3, 3))])
def test_apply_mrope_matches_reference(hd, sections, dtype, monkeypatch):
    theta = 1000000.0
    ours = tl.rope_freqs(hd, theta).numpy()
    np.testing.assert_array_max_ulp(ours, np.asarray(jl.rope_freqs(hd, theta)),
                                    maxulp=1)
    monkeypatch.setattr(jl, "rope_freqs", lambda *a: jnp.asarray(ours))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos = _thw(2, 4, 2, 4)
    got = tl.apply_mrope(torch.as_tensor(x).to(getattr(torch, dtype)),
                         torch.as_tensor(pos), theta, sections)
    want = jax.jit(jl.apply_mrope, static_argnums=(2, 3))(
        jnp.asarray(x, dtype), jnp.asarray(pos), theta, sections)
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)),
                                         (16, (2, 3, 3))])
def test_mrope_with_equal_streams_is_rope(hd, sections):
    x = torch.randn((2, 9, 2, hd), generator=torch.Generator().manual_seed(3))
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9) + 5
    got = tl.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, sections)
    torch.testing.assert_close(got, tl.apply_rope(x, pos, 1e6), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="sections"):
        tl.mrope_tables(pos[None].expand(3, 2, 9), hd, 1e6, (1, 2, 3))


# --------------------------------------------------------------------------
# qwen2-vl-2b
# --------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [{}, {"num_heads": 6, "num_kv_heads": 1}],
                         ids=["group4", "group6"])
def test_vlm_prefill_and_decode_match_reference(heads):
    cfg, jcfg, jparams, params = _model(VLM, **heads)
    assert cfg.num_heads // cfg.num_kv_heads == (heads.get("num_heads", 4))
    rng = np.random.default_rng(12)
    emb = (0.02 * rng.standard_normal((BATCH, PROMPT, cfg.d_model))
           ).astype(np.float32)
    pos = _thw(BATCH, 4, 3, 4)
    forced = rng.integers(0, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    max_len = PROMPT + STEPS
    jpre = jax.jit(lambda p, e, q: jt.prefill(
        p, jcfg, {"embeddings": e, "positions": q}, max_len))
    jdec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    jlog, jcache = jpre(jparams, jnp.asarray(emb), jnp.asarray(pos))
    log, cache = tt.prefill(params, cfg, {
        "embeddings": torch.as_tensor(emb),
        "positions": torch.as_tensor(pos)}, max_len)
    np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL)
    _assert_caches(cache, jcache)
    for i in range(STEPS):
        tok = forced[:, i:i + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        log, cache = tt.decode_step(params, cfg, cache, torch.as_tensor(tok))
        np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
    _assert_caches(cache, jcache)


# --------------------------------------------------------------------------
# seamless-m4t-medium
# --------------------------------------------------------------------------

def _encdec_reference(jparams, jcfg, max_len):
    """The reference's prefill with the cross K/V computed from its
    encoder (jitted), and its decode step."""
    def prefill(p, emb, enc_emb):
        enc_out = jt.encode(p, jcfg, enc_emb)
        x = jt._embed(p, jcfg, emb)
        b, s = x.shape[0], x.shape[1]
        positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        caches = {name: ({"self": c["self"]} if isinstance(c, dict) else c)
                  for name, c in jt.init_cache(jcfg, b, max_len,
                                               enc_out.shape[1]).items()}
        h, new, _ = jt.apply_stack(p, jcfg, x, mode="prefill",
                                   positions=positions, caches=caches,
                                   enc_out=enc_out)
        h = jl.rms_norm(h, p["final_norm"], jcfg.norm_eps)
        new["index"] = jnp.full((), s, jnp.int32)
        return jt._logits(p, jcfg, h[:, -1:])[:, 0], new
    pre = jax.jit(prefill)
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    return (lambda e, enc: pre(jparams, e, enc),
            lambda c, t: dec(jparams, c, t))


def _encdec_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    emb = (0.02 * rng.standard_normal((BATCH, PROMPT, cfg.d_model))
           ).astype(np.float32)
    enc = (0.02 * rng.standard_normal((BATCH, ENC_LEN, cfg.d_model))
           ).astype(np.float32)
    forced = rng.integers(0, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    return emb, enc, forced


def test_encdec_prefill_and_decode_match_reference():
    cfg, jcfg, jparams, params = _model(ENCDEC)
    emb, enc, forced = _encdec_inputs(cfg, 13)
    max_len = PROMPT + STEPS
    jpre, jdec = _encdec_reference(jparams, jcfg, max_len)
    jlog, jcache = jpre(jnp.asarray(emb), jnp.asarray(enc))
    log, cache = tt.prefill(params, cfg, {
        "embeddings": torch.as_tensor(emb),
        "enc_emb": torch.as_tensor(enc)}, max_len)
    np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL)
    _assert_caches(cache, jcache)
    assert float(np.abs(_np(cache["layer_1"]["cross_k"])).max()) > 0.0
    for i in range(STEPS):
        tok = forced[:, i:i + 1]
        jlog, jcache = jdec(jcache, jnp.asarray(tok))
        log, cache = tt.decode_step(params, cfg, cache, torch.as_tensor(tok))
        np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
    _assert_caches(cache, jcache)


def test_reference_prefill_ignores_the_encoder_and_the_port_reads_it():
    """F6: the reference's ``prefill`` reads the zero-filled cross cache
    as if it were computed, so its logits do not move with ``enc_emb``;
    the port's do."""
    cfg, jcfg, jparams, params = _model(ENCDEC)
    emb, enc, _ = _encdec_inputs(cfg, 14)
    enc2 = enc + 0.05
    jpre = jax.jit(lambda e, x: jt.prefill(
        jparams, jcfg, {"embeddings": e, "enc_emb": x}, PROMPT + 2))
    (ja, jca), (jb, _) = (jpre(jnp.asarray(emb), jnp.asarray(x))
                          for x in (enc, enc2))
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))
    assert float(np.abs(np.asarray(jca["layer_0"]["cross_k"])).max()) == 0.0
    a, b = (tt.prefill(params, cfg, {"embeddings": torch.as_tensor(emb),
                                     "enc_emb": torch.as_tensor(x)},
                       PROMPT + 2)[0] for x in (enc, enc2))
    assert float((a - b).abs().max()) > 1e-3


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_demo_requests_match_reference_bitwise(name, reduced):
    cfg, jcfg = get_config(name), j_get_config(name)
    if reduced:
        cfg, jcfg = reduced_config(cfg), j_reduced(jcfg)
    for seed in (0, 5):
        want = je.demo_requests(jcfg, BATCH, 24, seed=seed)
        got = te.demo_requests(cfg, BATCH, 24, seed=seed, device="cpu")
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            if g.dtype == torch.bfloat16:
                g = g.view(torch.int16).numpy().view(np.uint16)
            else:
                g = g.numpy()
            w = _bits(w)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def _serve_config(**kw):
    return dict(max_len=PROMPT + STEPS + 4, decode_steps=STEPS, **kw)


def test_generate_matches_reference_tokens_vlm():
    cfg, jcfg, jparams, params = _model(VLM)
    want = je.ServingEngine(jcfg, jparams, je.ServeConfig(
        **_serve_config())).generate(
            je.demo_requests(jcfg, BATCH, PROMPT, seed=4)).tokens
    got = te.ServingEngine(cfg, params, te.ServeConfig(**_serve_config()),
                           device="cpu").generate(
        te.demo_requests(cfg, BATCH, PROMPT, seed=4, device="cpu"))
    np.testing.assert_array_equal(got.tokens, want)


def test_generate_matches_reference_greedy_loop_encdec():
    """The reference's ``ServingEngine`` runs its ``prefill``, which does
    not read the encoder (F6); the port's tokens are held to a greedy
    loop over the reference's functions with the cross K/V computed."""
    cfg, jcfg, jparams, params = _model(ENCDEC)
    sc = _serve_config()
    jpre, jdec = _encdec_reference(jparams, jcfg, sc["max_len"])
    req = je.demo_requests(jcfg, BATCH, PROMPT, seed=6)
    logits, cache = jpre(req["embeddings"], req["enc_emb"])
    want = []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok[:, 0]))
        logits, cache = jdec(cache, tok)
    got = te.ServingEngine(cfg, params, te.ServeConfig(**sc),
                           device="cpu").generate(
        te.demo_requests(cfg, BATCH, PROMPT, seed=6, device="cpu"))
    np.testing.assert_array_equal(got.tokens, np.stack(want, axis=1))


@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_generate_flight_matches_generate(name):
    cfg, _, _, params = _model(name)
    batch = te.demo_requests(cfg, BATCH, PROMPT, seed=7, device="cpu")
    plain = te.ServingEngine(cfg, params, te.ServeConfig(**_serve_config()),
                             device="cpu").generate(batch)
    flight = te.ServingEngine(cfg, params, te.ServeConfig(
        **_serve_config(flight_size=2, mean_jitter_s=0.002)), device="cpu")
    res = flight.generate_flight(batch)
    np.testing.assert_array_equal(res.tokens, plain.tokens)
    assert res.flight_report.ok and len(res.flight_report.executors) == 2


# --------------------------------------------------------------------------
# the cache
# --------------------------------------------------------------------------

def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in flat}


@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_cache_shape_matches_reference(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    enc_len = 4096 if cfg.is_encoder_decoder else 0
    want = _flat(jax.eval_shape(lambda: jt.init_cache(jcfg, 2, 4136,
                                                      enc_len)))
    shapes = cache_shape(cfg, 2, 4136, enc_len)
    got = {".".join(k for k in path): (tuple(t.shape),
                                       str(t.dtype).removeprefix("torch."))
           for path, t in _walk(shapes)}
    want.pop("index")
    assert got == want
    assert all(t.device.type == "meta" for _, t in _walk(shapes))
    if cfg.is_encoder_decoder:
        assert got["layer_11.cross_k"][0] == (2, 4096, 16, 64)
        assert got["layer_11.self.k"][0] == (2, 4136, 16, 64)


def _walk(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, path + (key,))
        elif isinstance(val, torch.Tensor):
            yield path + (key,), val

