"""The port's training path against the JAX reference, on the CPU.

Reduced float32 configs, numpy-made inputs and weights shared through
``params_from_numpy``; the reference's functions jitted.

* Data: ``make_batch`` bitwise equal to the reference's for every arch
  (tokens, labels, embeddings, ``enc_emb``, M-RoPE positions).
* Optimizer: ``lr_at``, ``global_norm`` and ``adamw_update`` (moments in
  float32 and in bfloat16) against the reference on the same numpy
  params, grads and moments: float32 within 1e-6 relative, the bf16
  moments within one bf16 rounding.
* Loss: ``loss_fn``'s loss within 1e-5 relative and every gradient leaf
  within 1e-4 x its max |grad| of ``jax.value_and_grad`` of the
  reference's ``make_loss_fn(remat=False)``, for seven families, with a
  ``loss_weight`` that drops one pod (an MoE failure reports the smallest
  top-k gate gap); remat (full and ``"dots"``) gives the same gradients
  as no remat (1e-6); three ``make_train_step`` steps track the
  reference's jitted step (metrics 1e-5 relative, parameters 1e-5).
* Gradient transforms: ``compress_grads("bf16")`` bitwise; ``"int8"``
  within ``scale / 127`` of each element and unbiased over draws;
  ``drop_straggler_transform`` as the reference's.
* ``raptor_dp``'s outputs equal the reference's, the all-pods-failed
  raise too.
* Checkpoints: round trip, gc and latest; the reference's checkpoint
  restored by the port and the port's by the reference (float32); a bf16
  state round-trips bitwise in the port.
* The port's versions of tests/test_substrate.py's and
  tests/test_system.py's training tests, ``launch/train.py`` on the CPU,
  and serving trained (grad-requiring) weights builds no autograd graph.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # small tensors; the test workers share cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as j_ckpt  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import make_batch as j_make_batch  # noqa: E402
from repro.distributed import collectives as j_coll  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import raptor_dp as j_rdp  # noqa: E402
from repro.training import step as j_step  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    DataConfig, data_iterator, make_batch)
from repro_torch.distributed.collectives import (  # noqa: E402
    compress_grads, drop_straggler_transform)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    ServeConfig, ServingEngine, demo_requests)
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import raptor_dp as rdp  # noqa: E402
from repro_torch.training.step import (  # noqa: E402
    StepOptions, batch_to, init_train_state, make_train_step,
    train_state_shape)

CPU = "cpu"
SHAPE = ShapeConfig("t", 32, 4, "train")
LOSS_ARCHS = ("gemma2-9b", "phi3-mini-3.8b", "granite-moe-3b-a800m",
              "mamba2-1.3b", "zamba2-1.2b", "qwen2-vl-2b",
              "seamless-m4t-medium")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf(tree, name):
    """The reference pytree's leaf at a port parameter name."""
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) \
            else tree[part]
    return tree


def _shared(name):
    """(cfg, jcfg, jparams, params): the reference's reduced model's
    weights, shared with the port's, gradients on."""
    jcfg = j_reduced(j_get_config(name))
    cfg = reduced_config(get_config(name))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device=CPU)
    params.requires_grad_(True)
    return cfg, jcfg, jparams, params


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture
def gate_gap(monkeypatch):
    """The smallest gap between the k-th and (k+1)-th router gate of
    every routing the port makes (inf without MoE layers)."""
    seen = [float("inf")]
    route = tmoe._route

    def recording(xt, router, k):
        out = route(xt, router, k)
        g = out[2].detach().sort(dim=-1, descending=True).values
        if g.shape[-1] > k:
            seen[0] = min(seen[0], float((g[:, k - 1] - g[:, k]).min()))
        return out
    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


# -- data ---------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_make_batch_bitwise_equals_reference(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    for step in (0, 5):
        got = make_batch(cfg, ShapeConfig("d", 16, 4, "train"), step)
        want = j_make_batch(jcfg, JShape("d", 16, 4, "train"), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sl = make_batch(cfg, ShapeConfig("d", 16, 4, "train"), 2,
                    DataConfig(seed=7), slice(2, 4))
    want = j_make_batch(jcfg, JShape("d", 16, 4, "train"), 2,
                        JDataConfig(seed=7), slice(2, 4))
    for k in want:
        np.testing.assert_array_equal(sl[k], want[k], err_msg=k)


def test_data_iterator_resumes():
    cfg = reduced_config(get_config("gemma-2b"))
    it = data_iterator(cfg, SHAPE, start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  make_batch(cfg, SHAPE, 3)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  make_batch(cfg, SHAPE, 4)["tokens"])


# -- optimizer ----------------------------------------------------------

def test_lr_at_matches_reference():
    oc = opt.OptConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    joc = j_opt.OptConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    steps = np.arange(0, 50, dtype=np.int32)
    got = _np(opt.lr_at(torch.as_tensor(steps), oc))
    want = np.asarray(jax.jit(lambda s: j_opt.lr_at(s, joc))(steps))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_tree(seed, state_dtype):
    """Numpy params, grads and moments: a matrix, a vector, a 3-D leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": (7,), "c": (2, 3, 4)}
    f32 = np.float32

    def draw(scale):
        return {k: (rng.standard_normal(s) * scale).astype(f32)
                for k, s in shapes.items()}
    params, grads = draw(0.5), draw(0.3)
    mu, nu = draw(0.1), {k: np.abs(v) for k, v in draw(0.05).items()}
    if state_dtype == "bfloat16":
        import ml_dtypes
        mu = {k: v.astype(ml_dtypes.bfloat16) for k, v in mu.items()}
        nu = {k: v.astype(ml_dtypes.bfloat16) for k, v in nu.items()}
    return params, grads, mu, nu


def test_global_norm_matches_reference():
    _, grads, _, _ = _opt_tree(1, "float32")
    got = float(opt.global_norm({k: torch.tensor(v)
                                 for k, v in grads.items()}))
    want = float(j_opt.global_norm({k: jnp.asarray(v)
                                    for k, v in grads.items()}))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    params, grads, mu, nu = _opt_tree(2, state_dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5,
              state_dtype=state_dtype)
    oc, joc = opt.OptConfig(**kw), j_opt.OptConfig(**kw)
    jstate = {"mu": {k: jnp.asarray(v) for k, v in mu.items()},
              "nu": {k: jnp.asarray(v) for k, v in nu.items()},
              "step": jnp.asarray(3, jnp.int32)}
    jp, jo, jm = jax.jit(lambda g, o, p: j_opt.adamw_update(g, o, p, joc))(
        {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
        {k: jnp.asarray(v) for k, v in params.items()})

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    state = {"mu": {k: tt._to_tensor(v, CPU) for k, v in mu.items()},
             "nu": {k: tt._to_tensor(v, CPU) for k, v in nu.items()},
             "step": torch.tensor(3, dtype=torch.int32)}
    module, state, m = opt.adamw_update(
        {k: torch.tensor(v) for k, v in grads.items()}, state, module, oc)
    assert int(state["step"]) == int(jo["step"]) == 4
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for k in params:
        np.testing.assert_allclose(_np(getattr(module, k)), _np(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for name in ("mu", "nu"):
            assert str(state[name][k].dtype) == f"torch.{state_dtype}"
            want = _np(jo[name][k])
            # bf16: one rounding of the same float32 value, so at most one
            # bf16 ulp apart where the float32 values straddle a tie
            tol = 1e-6 if state_dtype == "float32" else 2 ** -7
            np.testing.assert_allclose(_np(state[name][k]), want, rtol=tol,
                                       atol=1e-7, err_msg=f"{name}.{k}")


# -- loss and gradients -------------------------------------------------

def _weighted_batch(cfg, seed=0):
    batch = make_batch(cfg, SHAPE, seed)
    # pod 1 of 2 failed: its two samples weigh 0
    batch["loss_weight"] = rdp.signals_to_weights(
        4, 2, health=np.array([1.0, 0.0]))
    return batch


@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_loss_and_grads_match_reference(name, gate_gap):
    cfg, jcfg, jparams, params = _shared(name)
    batch = _weighted_batch(cfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        j_step.make_loss_fn(jcfg, remat=False), has_aux=True))(
            jparams, _jbatch(batch))
    loss, aux = tt.loss_fn(params, cfg, batch_to(cfg, batch, CPU))
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    msg = f"; smallest top-k gate gap {gate_gap[0]:.3g}"
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL), msg
    for key in ("ce", "aux"):
        assert float(aux[key].detach()) == pytest.approx(float(jaux[key]),
                                                rel=LOSS_RTOL, abs=1e-7), msg
    for n, g in zip(names, grads):
        want = _np(_leaf(jgrads, n))
        np.testing.assert_allclose(
            _np(g), want, rtol=0, err_msg=n + msg,
            atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "zamba2-1.2b"])
def test_remat_gives_the_same_gradients(name, policy):
    cfg = reduced_config(get_config(name))
    params = tt.init_params(cfg, 0, device=CPU).requires_grad_(True)
    batch = batch_to(cfg, _weighted_batch(cfg), CPU)
    leaves = list(params.parameters())

    def grads(**kw):
        loss, aux = tt.loss_fn(params, cfg, batch, **kw)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True)
    loss0, g0 = grads()
    loss1, g1 = grads(remat=True, remat_policy=policy)
    assert float(loss1.detach()) == pytest.approx(float(loss0.detach()),
                                                  rel=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6,
                                   atol=1e-6 * float(a.abs().max()))


@pytest.mark.parametrize("name", ["gemma2-9b", "granite-moe-3b-a800m"])
def test_train_steps_match_reference(name, gate_gap):
    cfg, jcfg, jparams, params = _shared(name)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    oc, joc = opt.OptConfig(**kw), j_opt.OptConfig(**kw)
    jstep = jax.jit(j_step.make_train_step(
        jcfg, joc, options=j_step.StepOptions(remat=False)))
    jstate = {"params": jparams, "opt": j_opt.init_opt_state(jparams, joc)}
    step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                           device=CPU)
    state = {"params": params, "opt": opt.init_opt_state(params, oc)}
    msg = f"; smallest top-k gate gap {gate_gap[0]:.3g}"
    for i in range(3):
        batch = _weighted_batch(cfg, i)
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, batch)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                abs=1e-7), k + msg
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    # Adam divides each gradient element by its own running rms, so an
    # element whose gradient sits at rounding level may take any update in
    # [-lr, lr] in either package: all within 3 steps' reach (3 x 2 lr),
    # and all but one in 1,000 within 1e-7
    diffs = np.concatenate([
        np.abs(_np(p) - _np(_leaf(jstate["params"], n))).ravel()
        for n, p in params.named_parameters()])
    assert diffs.max() <= 6 * kw["lr"], msg
    assert (diffs > 1e-7).mean() <= 1e-3, (float((diffs > 1e-7).mean()),
                                          msg)


def test_train_state_shape_allocates_nothing():
    cfg = get_config("gemma-2b")
    shape = train_state_shape(cfg, opt.OptConfig())
    p = shape["params"]
    assert p["embed"].device.type == "meta"
    assert tuple(p["embed"].shape) == (256000, 2048)
    assert p["embed"].dtype == torch.bfloat16 and p["embed"].requires_grad
    assert shape["opt"]["mu"]["embed"].dtype == torch.float32
    # every leaf's shape and dtype as the reference's (eval_shape)
    want = dict(j_ckpt._flatten(j_step.train_state_shape(
        j_get_config("gemma-2b"), j_opt.OptConfig())))
    got = dict(ckpt_io._flatten(shape))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k


# -- gradient transforms and raptor_dp ------------------------------------

def _grad_tree(seed=4):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal(16) * 3.0).astype(np.float32)}


def test_compress_bf16_bitwise_equals_reference():
    g = _grad_tree()
    got = compress_grads("bf16")({k: torch.tensor(v) for k, v in g.items()})
    want = j_coll.compress_grads("bf16")({k: jnp.asarray(v)
                                          for k, v in g.items()})
    for k in g:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    assert compress_grads(None) is None
    with pytest.raises(ValueError, match="unknown compression"):
        compress_grads("fp4")


def test_compress_int8_error_bound_and_unbiased():
    g = {k: torch.tensor(v) for k, v in _grad_tree().items()}
    t = compress_grads("int8", seed=3)
    draws = [t(g) for _ in range(400)]
    for k, x in g.items():
        scale = float(x.abs().max())
        stack = torch.stack([d[k] for d in draws])
        # every draw within one quantisation step of the gradient
        assert float((stack - x).abs().max()) <= scale / 127 * (1 + 1e-6)
        # unbiased: the mean of 400 draws within 4 standard errors of
        # a uniform rounding (step / sqrt(12) / sqrt(400)) of x
        se = scale / 127 / np.sqrt(12) / np.sqrt(400)
        assert float((stack.mean(0) - x).abs().max()) <= 5 * se
    # the reference's bound, for comparison of the modes
    jg = j_coll.compress_grads("int8")({k: jnp.asarray(v) for k, v in
                                        _grad_tree().items()})
    for k, x in g.items():
        assert float(np.abs(np.asarray(jg[k]) - _np(x)).max()) <= \
            float(x.abs().max()) / 127 * (1 + 1e-6)


def test_drop_straggler_transform_matches_reference():
    g = _grad_tree()
    w = np.array([1, 1, 0, 1], np.float32)
    got = drop_straggler_transform(w)({k: torch.tensor(v)
                                       for k, v in g.items()})
    want = j_coll.drop_straggler_transform(w)({k: jnp.asarray(v)
                                               for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(health=np.array([1, 1, 0, 1])),
    dict(latency=np.array([0.2, 0.9, 0.1, 0.5]), k=2),
    dict(health=np.array([1, 0, 1, 1]), latency=np.array([0.3, 0.1, 0.2,
                                                          0.9]), k=3),
    dict()])
def test_signals_to_weights_equal_reference(kw):
    got = rdp.signals_to_weights(8, 4, **kw)
    want = j_rdp.signals_to_weights(8, 4, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_raptor_dp_equal_reference():
    for micro, flight in ((4, 2), (3, 3), (5, 1), (1, 2)):
        assert rdp.redundant_assignment(micro, flight) == \
            j_rdp.redundant_assignment(micro, flight)
    times = np.random.default_rng(0).random((3, 5))
    np.testing.assert_array_equal(rdp.first_arrival_weights(5, 3, times),
                                  j_rdp.first_arrival_weights(5, 3, times))
    for mod in (rdp, j_rdp):
        with pytest.raises(RuntimeError, match="all flight members failed"):
            mod.signals_to_weights(8, 2, health=np.zeros(2))


# -- checkpoints ----------------------------------------------------------

def _assert_state_equal(a, b):
    pa = dict(ckpt_io._flatten(a))
    pb = dict(ckpt_io._flatten(b))
    assert set(pa) == set(pb)
    for k in pa:
        x, y = pa[k], pb[k]
        assert x.dtype == y.dtype, k
        assert torch.equal(x.detach(), y.detach()), k


def test_checkpoint_roundtrip(tmp_path):
    cfg = reduced_config(get_config("gemma-2b"))
    oc = opt.OptConfig(warmup_steps=2, total_steps=20)
    state = init_train_state(cfg, oc, 0, device=CPU)
    state, _ = make_train_step(cfg, oc, device=CPU)(
        state, make_batch(cfg, SHAPE, 0))
    ckpt_io.save(str(tmp_path), 7, state)
    fresh = init_train_state(cfg, oc, 1, device=CPU)
    restored, step = ckpt_io.restore(str(tmp_path), fresh)
    assert step == 7
    _assert_state_equal(restored, state)
    with open(tmp_path / "step_00000007" / "manifest_0.json") as f:
        keys = json.load(f)["keys"]
    assert "params/layers/0/attn/wq" in keys and "opt/step" in keys
    assert "opt/mu/layers/1/mlp/w_down" in keys


def test_checkpoint_gc_and_latest(tmp_path):
    state = {"x": torch.ones(3)}
    for s in (1, 2, 3, 4, 5):
        ckpt_io.save(str(tmp_path), s, state, keep=2)
    assert ckpt_io.latest_steps(str(tmp_path)) == [4, 5]
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore(str(tmp_path / "none"), state)


def _shared_state(name):
    cfg, jcfg, jparams, params = _shared(name)
    oc = opt.OptConfig(total_steps=5)
    jstate = {"params": jparams,
              "opt": j_opt.init_opt_state(jparams, j_opt.OptConfig(
                  total_steps=5))}
    return cfg, jstate, {"params": params,
                         "opt": opt.init_opt_state(params, oc)}


def test_checkpoint_reference_to_port(tmp_path):
    """The reference saves a (trained) float32 state; the port restores
    it exactly."""
    cfg, jstate, state = _shared_state("granite-moe-3b-a800m")
    jcfg = j_reduced(j_get_config("granite-moe-3b-a800m"))
    jstate, _ = jax.jit(j_step.make_train_step(
        jcfg, j_opt.OptConfig(total_steps=5),
        options=j_step.StepOptions(remat=False)))(
            jstate, _jbatch(make_batch(cfg, SHAPE, 0)))
    j_ckpt.save(str(tmp_path), 3, jstate)
    restored, step = ckpt_io.restore(str(tmp_path), state)
    assert step == 3 and int(restored["opt"]["step"]) == 1
    for key, leaf in ckpt_io._flatten(restored):
        want = np.asarray(dict(j_ckpt._flatten(jstate))[key])
        np.testing.assert_array_equal(leaf.detach().numpy(), want,
                                      err_msg=key)


def test_checkpoint_port_to_reference(tmp_path):
    """The port saves a trained float32 state; the reference restores
    it exactly."""
    cfg, jstate, state = _shared_state("zamba2-1.2b")
    state, _ = make_train_step(cfg, opt.OptConfig(total_steps=5),
                               device=CPU)(state, make_batch(cfg, SHAPE, 0))
    ckpt_io.save(str(tmp_path), 4, state)
    restored, step = j_ckpt.restore(str(tmp_path), jstate)
    assert step == 4
    ours = dict(ckpt_io._flatten(state))
    for key, leaf in j_ckpt._flatten(restored):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      ours[key].detach().numpy(),
                                      err_msg=key)


def test_checkpoint_bf16_state_roundtrips_bitwise(tmp_path):
    """bf16 parameters and bf16 moments (widened to float32 in the npz)
    come back with the same bits; the reference restores the same
    checkpoint into float32."""
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")),
                              dtype="bfloat16")
    oc = opt.OptConfig(total_steps=5, state_dtype="bfloat16")
    state = init_train_state(cfg, oc, 0, device=CPU)
    state, _ = make_train_step(cfg, oc, device=CPU)(
        state, make_batch(cfg, SHAPE, 0))
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["mu"]["embed"].dtype == torch.bfloat16
    ckpt_io.save(str(tmp_path), 1, state)
    restored, _ = ckpt_io.restore(
        str(tmp_path), init_train_state(cfg, oc, 1, device=CPU))
    _assert_state_equal(restored, state)
    # the npz holds float32, which the reference can read
    like = {"params": {"embed": jnp.zeros((cfg.vocab_size, cfg.d_model),
                                          jnp.float32)}}
    got, _ = j_ckpt.restore(str(tmp_path), like)
    np.testing.assert_array_equal(np.asarray(got["params"]["embed"]),
                                  _np(state["params"]["embed"]))


def test_checkpoint_reads_the_reference_bf16_bits(tmp_path):
    """The reference writes a bf16 leaf as an opaque 2-byte array (which
    its own restore cannot cast back); the port reads its bits."""
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)).astype(
        jnp.bfloat16)
    j_ckpt.save(str(tmp_path), 0, {"x": x})
    got, _ = ckpt_io.restore(str(tmp_path),
                             {"x": torch.zeros(12, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(_np(got["x"]), np.asarray(x, np.float32))


# -- the reference's training tests, on the port --------------------------

def test_train_loss_decreases():
    """Two alternating batches, enough steps for the synthetic (7x+3)
    rule to show: the loss drops well below ln(V)."""
    cfg = reduced_config(get_config("gemma-2b"))
    oc = opt.OptConfig(warmup_steps=2, total_steps=60, lr=3e-3,
                       weight_decay=0.0)
    step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                           device=CPU)
    state = init_train_state(cfg, oc, 0, device=CPU)
    batches = [make_batch(cfg, SHAPE, i) for i in range(2)]
    losses = []
    for i in range(30):
        state, m = step(state, batches[i % 2])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_grad_compression_preserves_training():
    cfg = reduced_config(get_config("gemma-2b"))
    oc = opt.OptConfig(warmup_steps=2, total_steps=60, lr=3e-3,
                       weight_decay=0.0)
    batches = [make_batch(cfg, SHAPE, i) for i in range(2)]
    for mode in ("bf16", "int8"):
        step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                               grad_transform=compress_grads(mode),
                               device=CPU)
        state = init_train_state(cfg, oc, 0, device=CPU)
        losses = []
        for i in range(25):
            state, m = step(state, batches[i % 2])
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.4, (mode, losses)


def test_masked_step_matches_subset_gradient():
    """Zero-weighting pod 1's samples == training on pod 0's half batch."""
    cfg = reduced_config(get_config("gemma-2b"))
    oc = opt.OptConfig(warmup_steps=2, total_steps=20)
    step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                           device=CPU)
    batch = make_batch(cfg, SHAPE, 0)
    wfull = rdp.signals_to_weights(4, 2, health=np.array([1, 0]))
    _, m1 = step(init_train_state(cfg, oc, 0, device=CPU),
                 dict(batch, loss_weight=wfull))
    half = {k: v[:2] for k, v in batch.items()}
    _, m2 = step(init_train_state(cfg, oc, 0, device=CPU), half)
    assert float(m1["ce"]) == pytest.approx(float(m2["ce"]), rel=1e-4)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-4)


def test_train_crash_resume_serve(tmp_path):
    cfg = reduced_config(get_config("phi3-mini-3.8b"))
    shape = ShapeConfig("sys", 32, 4, "train")
    oc = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(cfg, oc, options=StepOptions(remat=False),
                           device=CPU)

    # phase 1: 6 steps with a mid-run pod failure, a checkpoint each
    state = init_train_state(cfg, oc, 0, device=CPU)
    for i in range(6):
        batch = make_batch(cfg, shape, i)
        health = np.ones(2)
        if i == 3:
            health[1] = 0.0          # a flight member dies; step proceeds
        batch["loss_weight"] = rdp.signals_to_weights(4, 2, health=health)
        state, m = step(state, batch)
        ckpt_io.save(str(tmp_path), i, state)

    # phase 2: "crash" — rebuild from the checkpoint, continue
    state2 = init_train_state(cfg, oc, 0, device=CPU)
    state2, last = ckpt_io.restore(str(tmp_path), state2)
    assert last == 5
    _assert_state_equal(state2, state)
    for i in range(last + 1, last + 4):
        state2, m2 = step(state2, make_batch(cfg, shape, i))
    assert np.isfinite(float(m2["loss"]))
    assert int(state2["opt"]["step"]) == 9

    # phase 3: serve the trained weights, stock vs flight must agree
    eng = ServingEngine(cfg, state2["params"],
                        ServeConfig(max_len=24, decode_steps=4,
                                    flight_size=2, mean_jitter_s=0.005),
                        device=CPU)
    req = demo_requests(cfg, batch=2, prompt_len=8, device=CPU)
    r_stock = eng.generate(req)
    r_flight = eng.generate_flight(req)
    np.testing.assert_array_equal(r_stock.tokens, r_flight.tokens)


@pytest.mark.parametrize("name", ["gemma2-9b", "granite-moe-3b-a800m",
                                  "mamba2-1.3b", "zamba2-1.2b",
                                  "seamless-m4t-medium", "qwen2-vl-2b"])
def test_all_families_one_train_step(name):
    """One step with remat for one arch of each family."""
    cfg = reduced_config(get_config(name))
    shape = ShapeConfig("sys", 16, 2, "train")
    oc = opt.OptConfig(total_steps=5)
    step = make_train_step(cfg, oc, options=StepOptions(remat=True),
                           device=CPU)
    state = init_train_state(cfg, oc, 0, device=CPU)
    before = state["params"]["final_norm"].detach().clone()
    state, m = step(state, make_batch(cfg, shape, 0))
    assert np.isfinite(float(m["loss"])), name
    assert not torch.equal(before, state["params"]["final_norm"])


def test_serving_trained_weights_builds_no_graph():
    """Trained weights require grad; prefill and decode run under
    ``torch.inference_mode()``, entered in the calling thread, so neither
    the caller's nor a flight member's thread records a graph."""
    cfg = reduced_config(get_config("zamba2-1.2b"))
    oc = opt.OptConfig(total_steps=5)
    state = init_train_state(cfg, oc, 0, device=CPU)
    state, _ = make_train_step(cfg, oc, device=CPU)(
        state, make_batch(cfg, ShapeConfig("s", 16, 2, "train"), 0))
    assert all(p.requires_grad for p in state["params"].parameters())
    eng = ServingEngine(cfg, state["params"], ServeConfig(
        max_len=24, decode_steps=4, flight_size=2), device=CPU)
    req = demo_requests(cfg, batch=2, prompt_len=8, device=CPU)
    seen = []

    def check(fn):
        def run(*args):
            logits, cache = fn(*args)
            seen.append((threading.current_thread().name,
                         logits.requires_grad or logits.grad_fn is not None
                         or any(t.requires_grad for c in cache.values()
                                if isinstance(c, dict)
                                for t in c.values()
                                if isinstance(t, torch.Tensor))))
            return logits, cache
        return run
    eng._prefill, eng._decode = check(eng._prefill), check(eng._decode)
    np.testing.assert_array_equal(eng.generate(req).tokens,
                                  eng.generate_flight(req).tokens)
    assert any(name.startswith("raptor-exec") for name, _ in seen)
    assert not any(graph for _, graph in seen), seen


def test_launch_train_cpu_resume_and_failure(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "4", "--seq", "16", "--ckpt",
            str(tmp_path), "--ckpt-every", "2", "--simulate-failure-at", "1"]
    out = {}
    assert train.main(args, result=out) == 0
    text = capsys.readouterr().out
    assert "step 1: simulating pod failure" in text
    assert [r["step"] for r in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    assert ckpt_io.latest_steps(str(tmp_path)) == [0, 2, 3]
    # resume: the latest checkpoint is the last step, so nothing is left
    more = {}
    assert train.main(args[:5] + ["--steps", "6"] + args[7:] + ["--resume"],
                      result=more) == 0
    assert "resumed from step 3" in capsys.readouterr().out
    assert [r["step"] for r in more["history"]] == [4, 5]
    assert int(more["state"]["opt"]["step"]) == 6
