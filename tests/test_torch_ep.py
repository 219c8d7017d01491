"""Expert parallelism and padded heads: the port against the JAX reference
on the CPU.

* ``moe_block_ep`` on 4 gloo ranks, a (data=2, model=2) mesh
  (``tests/_torch_ranks.py``), against the reference's ``moe_block_ep``
  under a (2, 2) mesh of 4 forced host devices (a subprocess with
  ``XLA_FLAGS``, as tests/test_jaxops_multidevice.py runs it): y, the aux
  loss and the gradient of ``sum(y * cot) + 0.3 aux`` with respect to x
  and every MoE parameter, within 1e-5 (float32).  The reduced granite
  has 5 experts, so the 2-way model axis pads them to 6.  Two token
  counts: 32 tokens split over data x model, and 14, which split over
  data only, where every model rank dispatches the same tokens
  (duplicated compute, as in the reference).
* On a one-rank mesh the EP block equals the global block exactly, and
  its two exchanges are skipped.
* ``pad_heads``: the reduced gemma2-9b (4 query, 2 KV heads) padded to 8
  heads.  The reference's ``prefill`` cannot run padded heads: it writes
  the padded K/V into the unpadded cache and raises (F8 in ROADMAP.md).
  So the port's padded prefill logits are held to the reference's padded
  forward pass (``apply_stack(mode="train")`` with ``pad_heads=8``, its
  last position) within 1e-4, its cache to the reference's unpadded
  prefill cache, and the padded loss to the reference's padded
  ``loss_fn``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ranks import ROOT, run_ranks  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.layers import rms_norm as j_rms_norm  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = 1e-5
AUX_W = 0.3
MOE = dict(num_experts=5, top_k=2, expert_ff=32)
NAMES = ("router", "w_gate", "w_up", "w_down")
CASES = {"split": (4, 8), "dup": (2, 7)}      # (B, S): 32 and 14 tokens

JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import MoEConfig
    from repro.launch.mesh import make_mesh
    from repro.models import moe as jm
    z = np.load(sys.argv[1])
    moe = MoEConfig(num_experts=%(e)d, top_k=%(k)d, expert_ff=%(f)d)
    ep = jm.EPSpec(make_mesh((2, 2), ("data", "model")), ("data",))
    params = {n: jnp.asarray(z[n]) for n in %(names)r}
    out = {}
    for case in %(cases)r:
        cot = jnp.asarray(z[case + "_cot"])

        def f(x, p):
            y, aux = jm.moe_block_ep(x, p, moe, "swiglu", ep)
            return (y * cot).sum() + %(aux_w)r * aux, (y, aux)
        (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(z[case + "_x"]),
                                               params)
        out[case + "_y"], out[case + "_aux"] = y, aux
        out[case + "_x"] = gx
        out.update({case + "_" + n: g for n, g in gp.items()})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("EP_OK")
""") % dict(e=MOE["num_experts"], k=MOE["top_k"], f=MOE["expert_ff"],
            names=NAMES, cases=tuple(CASES), aux_w=AUX_W)


def _ep_inputs():
    d = reduced_config(get_config("granite-moe-3b-a800m")).d_model
    rng = np.random.default_rng(5)
    e, f = MOE["num_experts"], MOE["expert_ff"]
    p = {"router": rng.normal(0, 0.3, (d, e)),
         "w_gate": rng.normal(0, 0.1, (e, d, f)),
         "w_up": rng.normal(0, 0.1, (e, d, f)),
         "w_down": rng.normal(0, 0.1, (e, f, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    data = {}
    for case, (b, s) in CASES.items():
        data[case + "_x"] = rng.normal(0, 1, (b, s, d)).astype(np.float32)
        data[case + "_cot"] = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    return p, data


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def test_moe_block_ep_matches_reference_on_4_ranks(tmp_path):
    params, data = _ep_inputs()
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **params, **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", JAX_EP, str(src),
                            str(dst)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    ours = {case: run_ranks("moe_ep", 4, tmp_path, {
        "shape": (2, 2), "moe": MOE, "variant": "swiglu", "aux_w": AUX_W,
        "params": params, "x": data[case + "_x"],
        "cot": data[case + "_cot"]}) for case in CASES}
    log, _ = ref.communicate(timeout=240)
    assert "EP_OK" in log, log
    want = np.load(dst)
    for case, ranks in ours.items():
        by_data = sorted(ranks, key=lambda r: (r["data"], r["model"]))
        for r in by_data:                 # two exchanges a layer
            assert r["all_to_all"] == 2 and r["all_to_all_skipped"] == 0
        for a, b in zip(by_data[::2], by_data[1::2]):   # model replicas
            np.testing.assert_array_equal(a["y"], b["y"])
            for n in ("x",) + NAMES:
                np.testing.assert_array_equal(a["grads"][n], b["grads"][n])
        heads = by_data[::2]
        _close(np.concatenate([r["y"] for r in heads]), want[case + "_y"],
               f"{case} y")
        for r in heads:
            _close(r["aux"], want[case + "_aux"], f"{case} aux")
        _close(np.concatenate([r["grads"]["x"] for r in heads]),
               want[case + "_x"], f"{case} dx")
        for n in NAMES:
            _close(sum(r["grads"][n] for r in heads), want[f"{case}_{n}"],
                   f"{case} d{n}")


def test_moe_block_ep_on_one_rank_equals_the_global_block(tmp_path):
    """A (1, 1) mesh: no padding, no split, and the two exchanges with
    itself skipped (the identity) -- the outputs and gradients of
    ``moe_block_global`` exactly."""
    params, data = _ep_inputs()
    x, cot = data["split_x"], data["split_cot"]
    (r,) = run_ranks("moe_ep", 1, tmp_path, {
        "shape": (1, 1), "moe": MOE, "variant": "swiglu", "aux_w": AUX_W,
        "params": params, "x": x, "cot": cot})
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as tm
    p = {k: torch.as_tensor(v).requires_grad_(True)
         for k, v in params.items()}
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = tm.moe_block_global(xt, p, MoEConfig(**MOE), "swiglu")
    grads = torch.autograd.grad(
        (y * torch.as_tensor(cot)).sum() + AUX_W * aux,
        [xt] + [p[n] for n in NAMES])
    assert (r["all_to_all"], r["all_to_all_skipped"]) == (0, 2)
    np.testing.assert_array_equal(r["y"], y.detach().numpy())
    assert r["aux"] == float(aux.detach())
    for n, g in zip(("x",) + NAMES, grads):
        np.testing.assert_array_equal(r["grads"][n], g.numpy(), err_msg=n)


# --------------------------------------------------------------------------
# pad_heads
# --------------------------------------------------------------------------

PAD = 8


def _padded_models():
    jcfg = j_reduced(j_get_config("gemma2-9b"))
    cfg = reduced_config(get_config("gemma2-9b"))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
    return (cfg, dataclasses.replace(cfg, pad_heads=PAD), jcfg,
            dataclasses.replace(jcfg, pad_heads=PAD), jparams, params)


def test_pad_heads_prefill_matches_the_reference_forward():
    cfg, cfg8, jcfg, jcfg8, jparams, params = _padded_models()
    assert cfg.num_heads < PAD
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    max_len = 24

    def j_last_logits(p, t):
        x = jt._embed(p, jcfg8, t)
        pos = jnp.broadcast_to(jnp.arange(t.shape[1])[None], t.shape)
        h, _, _ = jt.apply_stack(p, jcfg8, x, mode="train", positions=pos)
        h = j_rms_norm(h, p["final_norm"], jcfg8.norm_eps)
        return jt._logits(p, jcfg8, h[:, -1:])[:, 0]
    want = jax.jit(j_last_logits)(jparams, jnp.asarray(tokens))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jt.prefill(jparams, jcfg8, {"tokens": jnp.asarray(tokens)}, max_len)
    _, jcache = jax.jit(lambda p, t: jt.prefill(
        p, jcfg, {"tokens": t}, max_len))(jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        got, cache = tt.prefill(params, cfg8,
                                {"tokens": torch.as_tensor(tokens)}, max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for name, c in jcache.items():
        if name == "index":
            continue
        for key, t in c.items():
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       np.asarray(t), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}.{key}")


def test_pad_heads_loss_matches_the_reference_loss():
    cfg, cfg8, jcfg, jcfg8, jparams, params = _padded_models()
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    want, _ = jax.jit(lambda p, b: jt.loss_fn(p, jcfg8, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tt.loss_fn(params, cfg8, {k: torch.as_tensor(v)
                                           for k, v in batch.items()})
        plain, _ = tt.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(got) == pytest.approx(float(plain), rel=1e-5)
