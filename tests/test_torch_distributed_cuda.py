"""The distributed paths' kernel calls on the card, on a one-rank NCCL
group (one H100 holds one rank: NCCL puts no two ranks on a device).

* ``expert_matmul`` under expert parallelism: granite-moe-3b-a800m's
  experts at full width (40 of 1,536 x 512, top-8) through
  ``moe_block_ep`` over a (data=1, model=1) ``DeviceMesh``; every kernel
  call is held to ``expert_matmul_plain`` on its inputs (one bf16
  rounding), the block's output equals the non-EP block's bit for bit,
  with as many kernel launches and two all-to-alls.
* ``flash_attention`` on padded heads: qwen2-vl-2b's 12 query and 2 KV
  heads of 128 padded to 16 as ``pad_heads`` pads them, against
  ``attention_plain`` on the same padded heads, and its first 12 heads
  against the unpadded kernel call.
* The flight collectives on CUDA tensors: the rank adopts its own value.

JAX-free; every test is marked ``cuda`` and skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_distributed_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_plain, mha)
from repro_torch.kernels.moe_gmm.ops import expert_matmul_plain, gmm  # noqa: E402


@pytest.fixture
def nccl(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    torch.cuda.set_device(0)
    try:
        yield torch.device("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_expert_matmul_under_ep_on_one_rank_nccl(nccl, monkeypatch):
    from repro_torch.distributed import functional as dfn
    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    from repro_torch.models import moe as tm
    cfg = get_config("granite-moe-3b-a800m")
    g = torch.Generator(device=nccl).manual_seed(0)
    p = tm.init_moe_params(cfg.d_model, cfg.moe, torch.bfloat16,
                           generator=g, device=nccl)
    x = torch.randn((2, 256, cfg.d_model), generator=g,
                    device=nccl).bfloat16()
    calls = []

    def shadowed(buf, w):
        out = gmm(buf, w)
        torch.testing.assert_close(out.float(), expert_matmul_plain(
            buf, w).float(), atol=1e-2, rtol=1.6e-2)
        calls.append(tuple(buf.shape))
        return out
    monkeypatch.setattr(tm, "gmm", shadowed)
    mesh = make_host_mesh(1, 1)
    ep = tm.EPSpec(mesh, batch_axes(mesh))
    with torch.inference_mode():
        n0, a0 = gmm.launches, dfn.all_to_all.calls
        s0 = dfn.all_to_all.skipped
        y_ep, _ = tm.moe_mlp(x, p, cfg.moe, cfg.mlp_variant, ep=ep)
        n_ep, a_ep = gmm.launches - n0, dfn.all_to_all.calls - a0
        s_ep = dfn.all_to_all.skipped - s0
        n0 = gmm.launches
        y, _ = tm.moe_mlp(x, p, cfg.moe, cfg.mlp_variant)
        n_plain = gmm.launches - n0
    # the one-rank model group's exchanges are the identity, skipped
    assert n_ep == n_plain == 3 and a_ep == 0 and s_ep == 2
    assert len(calls) == 6 and calls[0] == calls[3]
    assert torch.equal(y_ep, y)


@pytest.mark.cuda
def test_flash_attention_on_padded_heads(nccl):
    from repro_torch.models.transformer import _pad_heads
    cfg = get_config("qwen2-vl-2b")
    hq, hkv, d, pad = cfg.num_heads, cfg.num_kv_heads, 128, 16
    g = torch.Generator(device=nccl).manual_seed(1)
    q = torch.randn((2, 512, hq, d), generator=g, device=nccl).bfloat16()
    k = torch.randn((2, 512, hkv, d), generator=g, device=nccl).bfloat16()
    v = torch.randn((2, 512, hkv, d), generator=g, device=nccl).bfloat16()
    qp, kp, vp = (_pad_heads(t, hq, pad).transpose(1, 2) for t in (q, k, v))
    assert qp.shape[1] == kp.shape[1] == pad
    n0 = mha.launches
    got = mha(qp, kp, vp, causal=True, scale=d ** -0.5)
    unpadded = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal=True, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert mha.launches == n0 + 2
    want = attention_plain(qp, kp, vp, causal=True, scale=d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(got[:, :hq].float(), unpadded.float(),
                               atol=2e-2, rtol=2e-2)
    assert float(got[:, hq:].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_flight_collectives_on_one_rank_nccl(nccl):
    from repro_torch.core import distops
    v = torch.arange(6, dtype=torch.float32, device=nccl)
    adopted, winner = distops.first_finisher({"v": v}, 2.5)
    assert int(winner) == 0 and torch.equal(adopted["v"], v)
    m, n = distops.masked_mean(v, 0.0)
    assert float(n) == 0.0 and float(m.abs().max()) == 0.0
    assert torch.equal(distops.k_of_n_mean(v, 1.0, 1), v)
