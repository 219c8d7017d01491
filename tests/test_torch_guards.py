"""Boundaries of the port: it stands alone, and it never falls back to
the CPU on its own.

* A fresh interpreter imports every ``repro_torch`` module and must end
  with neither ``jax`` nor the reference package ``repro`` loaded.
* Entry points default to the CUDA card: with no card visible and no
  ``device``, they raise instead of quietly running on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_never_imports_torch_testing_internals():
    """No module of the port imports ``torch.testing._internal`` (PyTorch's
    own test harness; ``import torch`` may load it, the port must not
    lean on it), and the distributed modules are among those checked."""
    import ast
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    names = {f.relative_to(SRC).as_posix() for f in files}
    for need in ("repro_torch/core/distops.py",
                 "repro_torch/distributed/sharding.py",
                 "repro_torch/distributed/functional.py",
                 "repro_torch/distributed/local.py",
                 "repro_torch/launch/mesh.py", "repro_torch/launch/specs.py",
                 "repro_torch/launch/dryrun.py"):
        assert need in names, need
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            bad += [f"{f.name}: {m}" for m in mods
                    if m.startswith("torch.testing._internal")
                    or (m == "torch.testing" and isinstance(
                        node, ast.ImportFrom) and any(
                            a.name == "_internal" for a in node.names))]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch._device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.sim.vector_queue import QueueFlightSim, keygen_queue
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueueFlightSim(keygen_queue())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueueFlightSim(keygen_queue(), device="cuda")
    from repro_torch.sim.vector import VectorFlightSim, keygen_vector
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorFlightSim(keygen_vector())
    assert VectorFlightSim(keygen_vector(),
                           device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "scheduler", "--jobs", "8"])
    assert QueueFlightSim(keygen_queue(), device="cpu").device.type == "cpu"
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = reduced_config(get_config("gemma2-9b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, None, ServeConfig(), device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "generate", "--arch", "gemma2-9b",
                    "--reduced"])
    from repro_torch.launch import train
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import init_train_state, make_train_step
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, OptConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, OptConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma2-9b", "--reduced", "--steps", "1"])


def test_sweeps_and_experiments_raise_without_cuda(monkeypatch):
    """The sweeps and the vector experiments have no host
    fallback: without a card and without ``device`` they raise."""
    from repro_torch.sim import experiments as X
    from repro_torch.sim.sweeps import queue_pair_plan
    from repro_torch.sim.vector import keygen_vector, sweep_pairs
    from repro_torch.sim.vector_queue import (QueueFlightSim, keygen_queue,
                                              load_sweep, rate_sweep)
    # a plan built while a card was visible re-checks when it runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    plan = queue_pair_plan([QueueFlightSim(keygen_queue())], 16, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        plan.run,
        lambda: sweep_pairs(keygen_vector(), [dict(flight=2, num_azs=3)]),
        lambda: load_sweep(keygen_queue()),
        lambda: rate_sweep(keygen_queue(), [1.0, 2.0]),
        X.fig6_scale_effect, X.fig7_other_workloads, X.workflow_bank,
        X.load_sweep_util, X.sweep_scale, X.fault_sweep,
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the scalar oracle never needed a card
    assert set(X.table6_overhead(n=100)) >= {"three_az/low", "one_az/high"}


def test_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--mode", "scheduler", "--device", "cpu", "--jobs",
                       "48", "--microbatch",
                       "16", "--arrival", "mmpp", "--scan", "logdepth",
                       "--summary-backend", "kernel"]) == 0
    out = capsys.readouterr().out
    assert "sustained" in out and "cpu" in out


def test_generate_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--mode", "generate", "--arch", "gemma2-9b",
                       "--reduced", "--device", "cpu", "--flight", "2",
                       "--requests", "2"]) == 0
    out = capsys.readouterr().out
    assert "gemma2-9b-smoke on cpu" in out and "4 requests" in out


def test_summaries_match_numpy():
    """``summarize_batch``'s quantiles interpolate linearly like numpy;
    the masked form conditions on ``ok``."""
    from repro_torch.core.analytics import (summarize_batch,
                                            summarize_masked_batch)
    rng = np.random.default_rng(0)
    a = rng.lognormal(size=1001).astype(np.float32)
    ok = rng.uniform(size=1001) < 0.9
    s = summarize_batch(torch.as_tensor(a))
    for k, q in (("median", 50), ("p90", 90), ("p99", 99)):
        assert float(s[k]) == pytest.approx(np.percentile(a, q), rel=1e-5)
    m = summarize_masked_batch(torch.as_tensor(a), torch.as_tensor(ok))
    for k, q in (("median", 50), ("p99", 99)):
        assert float(m[k]) == pytest.approx(np.percentile(a[ok], q),
                                            rel=1e-5)
    assert float(m["mean"]) == pytest.approx(a[ok].mean(), rel=1e-5)
    assert int(m["n"]) == ok.sum()
