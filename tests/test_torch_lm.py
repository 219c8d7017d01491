"""The port's LM serving path against the JAX reference, on the CPU.

* Configs: all ten architectures (and their reduced forms) equal the
  reference field by field.
* Model: the reduced dense configs (gemma-2b, gemma2-9b, gemma3-27b,
  phi3-mini), MoE configs (granite-moe-3b-a800m, llama4-maverick), SSM
  config (mamba2-1.3b), hybrid config (zamba2-1.2b) and VLM config
  (qwen2-vl-2b, on token ids here) share the
  reference's weights through ``params_from_numpy``; ``prefill`` of a
  16-token prompt and 10 teacher-forced ``decode_step``s agree with the
  reference's logits and caches (attention, Mamba2 conv and state) within
  1e-4 (float32; the reduced window of 8 makes the local layers' ring wrap
  in both).  A failure reports the smallest gap between the k-th and
  (k+1)-th router gate the port saw: an ulp of difference there can pick
  another expert.
* Engine: ``ServingEngine.generate`` gives the reference's greedy tokens
  exactly (a dense, an MoE and a hybrid config), and ``generate_flight``
  the same tokens as ``generate``.
* Scheduler: the cases of tests/test_core_engine.py run against the
  port's ``Flight``, ``StateStream``, ``TaskContext`` and
  ``RaptorScheduler``.
* tests/test_torch_vlm_encdec.py holds the VLM and encoder-decoder
  paths to the reference (the encoder-decoder's prefill there, since the
  reference's own ``prefill`` does not read its encoder), and
  tests/test_torch_training.py the training path (``loss_fn``,
  ``mode="train"``).
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_core_engine as core_cases  # noqa: E402
from repro.configs import ARCH_NAMES as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config  # noqa: E402
from repro_torch.core import manifest as tmanifest  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.step import cache_shape, greedy_sample  # noqa: E402

DENSE = ("gemma-2b", "gemma2-9b", "gemma3-27b", "phi3-mini-3.8b")
MOE_SSM_HYBRID = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                  "mamba2-1.3b", "zamba2-1.2b")
VLM_ENCDEC = ("qwen2-vl-2b", "seamless-m4t-medium")
PORTED = DENSE + MOE_SSM_HYBRID + VLM_ENCDEC
PROMPT, STEPS, BATCH = 16, 10, 2
TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", J_ARCHS)
def test_configs_equal_reference(name):
    assert ARCH_NAMES == J_ARCHS
    ours, ref = get_config(name), j_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced_config(ours)) == dataclasses.asdict(
        j_reduced(ref))
    assert ours.param_counts() == ref.param_counts()


def _shared_model(name):
    cfg = reduced_config(get_config(name))
    jparams = jt.init_params(j_reduced(j_get_config(name)),
                             jax.random.PRNGKey(0))
    params = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
    return cfg, jparams, params


def _assert_caches(got, want, msg=""):
    assert int(got["index"]) == int(want["index"])
    assert set(got) == set(want)
    for name, c in want.items():
        if name == "index":
            continue
        assert set(got[name]) == set(c), name
        for key, t in c.items():
            np.testing.assert_allclose(_np(got[name][key]), _np(t),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{name}.{key}{msg}")


@pytest.fixture
def gate_gap(monkeypatch):
    """Record the smallest gap between the k-th and (k+1)-th router gate
    of every routing the port makes (inf without MoE layers)."""
    seen = [float("inf")]
    route = tmoe._route

    def recording(xt, router, k):
        out = route(xt, router, k)
        g = out[2].sort(dim=-1, descending=True).values
        if g.shape[-1] > k:
            seen[0] = min(seen[0], float((g[:, k - 1] - g[:, k]).min()))
        return out
    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


@pytest.mark.parametrize("name", [n for n in PORTED
                                  if n != "seamless-m4t-medium"])
def test_prefill_and_decode_match_reference(name, gate_gap):
    cfg, jparams, params = _shared_model(name)
    jcfg = j_reduced(j_get_config(name))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    max_len = PROMPT + STEPS

    jpre = jax.jit(lambda p, t: jt.prefill(p, jcfg, {"tokens": t}, max_len))
    jdec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    jlog, jcache = jpre(jparams, jnp.asarray(prompt))
    log, cache = tt.prefill(params, cfg, {"tokens": torch.as_tensor(prompt)},
                            max_len)

    def msg():
        return f"; smallest top-k gate gap {gate_gap[0]:.3g}"
    np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL,
                               err_msg=msg())
    _assert_caches(cache, jcache, msg())
    for i in range(STEPS):
        tok = forced[:, i:i + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        log, cache = tt.decode_step(params, cfg, cache, torch.as_tensor(tok))
        np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}{msg()}")
    _assert_caches(cache, jcache, msg())


def test_param_names_follow_the_reference_pytree():
    cfg, jparams, params = _shared_model("phi3-mini-3.8b")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat}
    assert set(params.state_dict()) == names
    assert "lm_head" in names and "layers.1.mlp.w_down" in names
    drawn = tt.init_params(cfg, 0, device="cpu")
    assert {n: tuple(t.shape) for n, t in drawn.state_dict().items()} == {
        n: tuple(t.shape) for n, t in params.state_dict().items()}
    std = float(drawn["layers"][0]["attn"]["wq"].std())
    assert 0.015 < std < 0.025
    assert float(drawn["final_norm"].abs().max()) == 0.0


@pytest.mark.parametrize("name", MOE_SSM_HYBRID + VLM_ENCDEC)
def test_moe_ssm_hybrid_param_names_follow_the_reference(name):
    jcfg = j_reduced(j_get_config(name))
    shapes = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    names = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): (tuple(v.shape), str(v.dtype))
             for path, v in flat}
    drawn = tt.init_params(reduced_config(get_config(name)), 0, device="cpu")
    assert {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for n, t in drawn.state_dict().items()} == names
    if jcfg.is_encoder_decoder:
        assert "encoder.layers.1.mlp.w_down" in names
        assert "encoder.final_norm" in names
        assert "layers.1.cross.wk" in names and "layers.1.ln_cross" in names


def test_cache_shape_of_moe_and_hybrid():
    shapes = cache_shape(get_config("zamba2-1.2b"), 2, 4136)
    assert sorted(n for n in shapes if n.startswith("shared_")) == [
        f"shared_{j}" for j in range(6)]
    assert tuple(shapes["shared_5"]["k"].shape) == (2, 4136, 32, 64)
    assert tuple(shapes["layer_37"]["state"].shape) == (2, 64, 64, 64)
    assert shapes["layer_37"]["state"].dtype == torch.float32
    assert tuple(shapes["layer_0"]["conv_x"].shape) == (2, 3, 4096)
    assert shapes["layer_0"]["conv_x"].dtype == torch.bfloat16
    granite = cache_shape(get_config("granite-moe-3b-a800m"), 2, 4136)
    assert tuple(granite["layer_31"]["v"].shape) == (2, 4136, 8, 64)


def test_cache_shape_allocates_nothing():
    cfg = get_config("gemma2-9b")
    shapes = cache_shape(cfg, 2, 4648)
    assert shapes["layer_0"]["k"].device.type == "meta"
    assert tuple(shapes["layer_0"]["k"].shape) == (2, 4096, 8, 256)
    assert tuple(shapes["layer_1"]["v"].shape) == (2, 4648, 8, 256)
    assert shapes["layer_1"]["v"].dtype == torch.bfloat16


def test_greedy_sample_takes_the_lowest_index_on_a_tie():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0],
                           [-1.0, -3.0, -2.0, -1.0]])
    assert greedy_sample(logits).tolist() == [1, 0, 0]
    assert greedy_sample(logits).dtype == torch.int32
    np.testing.assert_array_equal(
        greedy_sample(logits).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)))


def test_generate_matches_reference_tokens():
    name = "gemma2-9b"
    cfg, jparams, params = _shared_model(name)
    jcfg = j_reduced(j_get_config(name))
    sc = dict(max_len=PROMPT + STEPS + 4, decode_steps=STEPS)
    jeng = je.ServingEngine(jcfg, jparams, je.ServeConfig(**sc))
    eng = te.ServingEngine(cfg, params, te.ServeConfig(**sc), device="cpu")
    for seed in (0, 1):
        want = jeng.generate(je.demo_requests(jcfg, BATCH, PROMPT,
                                              seed=seed)).tokens
        got = eng.generate(te.demo_requests(cfg, BATCH, PROMPT, seed=seed,
                                            device="cpu"))
        np.testing.assert_array_equal(got.tokens, want)
        assert got.prefill_s > 0 and got.decode_s > 0


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "zamba2-1.2b"])
def test_generate_matches_reference_tokens_moe_and_hybrid(name, gate_gap):
    cfg, jparams, params = _shared_model(name)
    jcfg = j_reduced(j_get_config(name))
    sc = dict(max_len=PROMPT + STEPS + 4, decode_steps=STEPS)
    want = je.ServingEngine(jcfg, jparams, je.ServeConfig(**sc)).generate(
        je.demo_requests(jcfg, BATCH, PROMPT, seed=2)).tokens
    got = te.ServingEngine(cfg, params, te.ServeConfig(**sc),
                           device="cpu").generate(
        te.demo_requests(cfg, BATCH, PROMPT, seed=2, device="cpu"))
    np.testing.assert_array_equal(
        got.tokens, want,
        err_msg=f"smallest top-k gate gap {gate_gap[0]:.3g}")


def test_generate_flight_matches_generate():
    cfg, _, params = _shared_model("gemma-2b")
    batch = te.demo_requests(cfg, BATCH, PROMPT, seed=3, device="cpu")
    sc = dict(max_len=PROMPT + STEPS, decode_steps=STEPS)
    plain = te.ServingEngine(cfg, params, te.ServeConfig(**sc),
                             device="cpu").generate(batch)
    flight = te.ServingEngine(
        cfg, params, te.ServeConfig(flight_size=2, mean_jitter_s=0.002, **sc),
        device="cpu")
    res = flight.generate_flight(batch)
    np.testing.assert_array_equal(res.tokens, plain.tokens)
    assert res.flight_report.ok and len(res.flight_report.executors) == 2
    stats = flight.serve([batch, batch])
    assert stats.summary()["requests"] == 2 * BATCH


# the names tests/test_core_engine.py imports from the reference
_CORE_NAMES = {
    tmanifest: ("ActionManifest", "ExecutionContext", "FunctionSpec",
                "parallel", "sequential"),
    tsched: ("Flight", "Preempted", "RaptorScheduler", "StateStream",
             "TaskContext", "TaskResult"),
}
_CORE_CASES = [n for n, f in inspect.getmembers(core_cases,
                                                inspect.isfunction)
               if n.startswith("test_")]


@pytest.mark.parametrize("case", _CORE_CASES)
def test_core_engine_cases_on_port(case, monkeypatch):
    """Each case of tests/test_core_engine.py, with the module's engine and
    manifest names pointing at the port's classes."""
    for mod, names in _CORE_NAMES.items():
        for name in names:
            assert getattr(core_cases, name) is not getattr(mod, name)
            monkeypatch.setattr(core_cases, name, getattr(mod, name))
    getattr(core_cases, case)()


def test_every_architecture_is_ported():
    assert sorted(PORTED) == sorted(ARCH_NAMES)


def test_left_out_features_are_refused():
    """The knobs refused until the distributed slice now run.  The
    sharding hook ``constrain`` is called at the reference's roles with
    the reference's shapes in prefill and decode (gemma2-9b, granite,
    zamba2); ``pad_heads=8`` serves the reduced gemma2-9b with the
    unpadded model's logits and caches (the padded heads are held to the
    reference's padded forward in tests/test_torch_ep.py).  What stays
    refused: distributing tensors over an abstract mesh."""
    import collections
    from repro_torch.distributed.sharding import Plan
    from repro_torch.launch.mesh import make_production_mesh
    for name in ("gemma2-9b", "granite-moe-3b-a800m", "zamba2-1.2b"):
        cfg, jparams, params = _shared_model(name)
        jcfg = j_reduced(j_get_config(name))
        prompt = np.arange(2 * 8, dtype=np.int32).reshape(2, 8) % 100
        seen = {"ref": collections.Counter(), "port": collections.Counter()}

        def rec(who):
            def constrain(t, role):
                seen[who][(role, tuple(t.shape))] += 1
                return t
            return constrain
        jlog, jcache = jax.jit(lambda p, t: jt.prefill(
            p, jcfg, {"tokens": t}, 12, constrain=rec("ref")))(
                jparams, jnp.asarray(prompt))
        jax.jit(lambda p, c, t: jt.decode_step(
            p, jcfg, c, t, constrain=rec("ref")))(
                jparams, jcache, jnp.asarray(prompt[:, :1]))
        log, cache = tt.prefill(params, cfg,
                                {"tokens": torch.as_tensor(prompt)}, 12,
                                constrain=rec("port"))
        tt.decode_step(params, cfg, cache, torch.as_tensor(prompt[:, :1]),
                       constrain=rec("port"))
        assert seen["port"] == seen["ref"], name
        np.testing.assert_allclose(_np(log), _np(jlog), atol=TOL, rtol=TOL)
    cfg, _, params = _shared_model("gemma2-9b")
    cfg8 = dataclasses.replace(cfg, pad_heads=8)
    tokens = torch.as_tensor(prompt)
    log, cache = tt.prefill(params, cfg, {"tokens": tokens}, 12)
    log8, cache8 = tt.prefill(params, cfg8, {"tokens": tokens}, 12)
    np.testing.assert_allclose(_np(log8), _np(log), atol=1e-5, rtol=1e-5)
    for _ in range(2):
        tok = greedy_sample(log)[:, None]
        log, cache = tt.decode_step(params, cfg, cache, tok)
        log8, cache8 = tt.decode_step(params, cfg8, cache8, tok)
        np.testing.assert_allclose(_np(log8), _np(log), atol=1e-5,
                                   rtol=1e-5)
    _assert_caches(cache8, cache)
    assert tuple(tt.init_params(cfg8, device="meta")["layers"][0]["attn"][
        "wq"].shape) == (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="DeviceMesh"):
        Plan(make_production_mesh(), cfg).distribute(params)
