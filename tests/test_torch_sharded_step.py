"""The sharding plan run: the sharded train, prefill and decode steps on
gloo ranks against the JAX reference's unsharded step, on the CPU.

Each case runs ``tests/_torch_ranks.py::sharded_step`` on 2 ranks (a
1x2 (data, model) mesh) or 4 (2x2): the state placed by
``Plan.shard_state`` (parameters and AdamW moments ZeRO-3 over data and
tensor parallel over model), one ``make_train_step(..., plan=)`` step,
then a sharded prefill and greedy decode steps with the cache from
``Plan.init_cache``.  The reduced configs' weights are the reference's
(``params_from_numpy``), the batch ``make_batch``'s.  Bars (those of
tests/test_torch_training.py and tests/test_torch_distributed.py):

* the train loss within 1e-5 relative and every gradient within 1e-3 x
  its max |grad| of ``jax.value_and_grad`` of the reference's
  ``make_loss_fn(remat=False)`` on the whole batch, the same on every
  rank;
* the prefill's last logits within 1e-3 x max |logit| of the
  reference's ``prefill``, and the greedy decode tokens equal to the
  reference's greedy decode (seamless-m4t-medium: the reference's
  ``encode`` + ``apply_stack`` prefill, as tests/test_torch_vlm_encdec.py
  composes it, F6);
* each rank holds only its shard: its local bytes of parameters and
  moments equal the dry run's ``param_bytes_per_device +
  opt_bytes_per_device`` for the mesh;
* the steps built with ``plan=`` refuse plain parameters (prefill,
  decode) and a plain train state, naming ``plan.shard_params`` /
  ``plan.shard_state``.

The cases cover the dense family (gemma-2b: one kv head, so the decode
cache is slot-sharded over model and merged by log-sum-exp; gemma2-9b:
local windows and logit caps; and serving one prompt on a 2x1 mesh: a
batch of one does not divide the data axis, so the decode cache's slots
are sharded over data and merged by log-sum-exp across it, and the
residual's batch spec stays replicated), gemma2-9b with 3 query heads
and 1 kv head (the heads do not divide the model axis: the query is
sequence-sharded, K3 runs with a query offset, the residual is
sequence-parallel, the cache slot-sharded), MoE granite (experts over
model, through the EP block), the hybrid zamba2 (K6 on each rank's
heads, B and C of one group replicated), the VLM qwen2-vl-2b (M-RoPE,
embedding inputs) and the encoder-decoder seamless-m4t-medium.  The EP
block's capacity is per block (the reference's EP block too), the
global dispatch's per batch, so where slots drop the two keep different
ones: the MoE case gives both a capacity that drops none (the EP
block's ``capacity_factor``; the reference's ``moe_capacity`` patched
in this process to one slot a token and choice) and holds the exact
top-k mixture.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ranks import run_ranks  # noqa: E402
from test_torch_vlm_encdec import _encdec_reference  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import step as j_step  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

SHAPE = ShapeConfig("t", 16, 4, "train")
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-3, 1e-3
CASES = {
    "gemma-2b-2x2": ("gemma-2b", (2, 2), {}),
    "gemma2-9b-1x2": ("gemma2-9b", (1, 2), {}),
    "gemma2-9b-one-prompt-2x1": ("gemma2-9b", (2, 1), {}),
    "gemma2-9b-3-heads-2x2": ("gemma2-9b", (2, 2),
                              {"num_heads": 3, "num_kv_heads": 1}),
    "granite-2x2": ("granite-moe-3b-a800m", (2, 2), {}),
    "zamba2-2x2": ("zamba2-1.2b", (2, 2), {}),
    "qwen2-vl-1x2": ("qwen2-vl-2b", (1, 2), {}),
    "seamless-1x2": ("seamless-m4t-medium", (1, 2), {}),
}


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) \
            else tree[part]
    return np.asarray(tree, np.float32)


def _reference_serving(jcfg, jparams, prompt, cfg):
    """The reference's last prefill logits and its greedy tokens."""
    max_len = SHAPE.seq_len + STEPS
    if cfg.is_encoder_decoder:
        pre, dec = _encdec_reference(jparams, jcfg, max_len)
        logits, cache = pre(jnp.asarray(prompt["embeddings"]),
                            jnp.asarray(prompt["enc_emb"]))
    else:
        logits, cache = jax.jit(lambda p, b: jt.prefill(
            p, jcfg, b, max_len))(jparams, {k: jnp.asarray(v)
                                            for k, v in prompt.items()})
        step = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))

        def dec(c, t):
            return step(jparams, c, t)
    first, toks = np.asarray(logits, np.float32), []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = dec(cache, tok[:, None])
    return first, toks


def _every_slot(num_tokens, moe, capacity_factor=1.25, num_buckets=None):
    """A capacity that keeps every slot: one a token and choice."""
    return max(4, math.ceil(num_tokens * moe.top_k / 4) * 4)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference_unsharded(case, tmp_path,
                                                  monkeypatch):
    arch, shape, over = CASES[case]
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **over)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **over)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    batch = make_batch(cfg, SHAPE, 0)
    prompt = {k: v for k, v in batch.items()
              if k not in ("labels", "loss_weight")}
    if "one-prompt" in case:         # B=1: the cache's slots over data
        prompt = {k: v[:, :1] if k == "positions" else v[:1]
                  for k, v in prompt.items()}
    args = {"arch": arch, "overrides": over, "shape": shape,
            "params": nparams, "opt": OPT, "batch": batch,
            "prompt": prompt, "steps": STEPS}
    if cfg.moe is not None:
        args["capacity_factor"] = float(cfg.moe.num_experts)
        monkeypatch.setattr(j_moe, "moe_capacity", _every_slot)
    out = run_ranks("sharded_step", shape[0] * shape[1], tmp_path, args,
                    timeout=300)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_step.make_loss_fn(jcfg, remat=False), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    for r in out[1:]:
        assert r["metrics"] == out[0]["metrics"]
    got = out[0]
    assert got["metrics"]["loss"] == pytest.approx(float(jloss),
                                                   rel=LOSS_RTOL)
    assert set(got["grads"]) == {n for n, _ in tt.params_from_numpy(
        nparams, device="cpu").named_parameters()}
    for name, g in got["grads"].items():
        want = _leaf(jgrads, name)
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)

    jlogits, jtoks = _reference_serving(jcfg, jparams, prompt, cfg)
    for r in out:
        assert all(m and "plan.shard_" in m for m in r["refused"]), \
            r["refused"]
        np.testing.assert_allclose(
            r["logits"], jlogits, rtol=0,
            atol=LOGIT_TOL * np.abs(jlogits).max())
        for i, (t, jt_) in enumerate(zip(r["tokens"], jtoks)):
            np.testing.assert_array_equal(t, jt_, err_msg=f"step {i}")

    planned = dryrun.plan_cell(cfg, SHAPE, AbstractMesh(
        shape, ("data", "model")))
    for r in out:
        assert r["local_bytes"] == (planned["param_bytes_per_device"]
                                    + planned["opt_bytes_per_device"])
    assert planned["param_bytes_per_device"] < sum(
        v.size * v.itemsize for v in jax.tree_util.tree_leaves(nparams))
