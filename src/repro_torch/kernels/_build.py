"""Build the package's hand-written CUDA kernels at first use.

Every ``*.cu`` source under ``repro_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface, all
``nvcc`` processes started together, into ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``).  A library's file name carries
a hash of its source, of every header under ``csrc/`` (``*.cuh``, which
any source may include) and of the flags, link flags included, so an
unchanged build is not repeated and a changed header rebuilds every
source.  The libraries link the CUDA driver (``-lcuda``) for the tensor
maps of the Hopper kernels' TMA copies.
The wrappers load the libraries with ``ctypes``: pointers are passed as
``data_ptr()`` integers and the launch stream is PyTorch's current one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")

_libs: Dict[str, ctypes.CDLL] = {}
#: per-source compiler output (ptxas' register, spill and shared-memory
#: report; kept beside the library, so a cached build has it too), and
#: the wall time of the build in this process, in seconds
build_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
                 else None, shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source (one ``nvcc`` each, run in parallel);
    raise with the compiler's output if any fails.  Returns the library
    path of every source by stem."""
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: _target(src) for src in srcs}
    running = []
    for src in srcs:
        out = paths[src.stem]
        if out.exists():
            saved = out.with_suffix(".log")
            if saved.exists():
                build_log[src.stem] = saved.read_text()
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc, time.perf_counter()))
    failed = []
    for src, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        build_seconds[src.stem] = time.perf_counter() - t0
        build_log[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for)"
                    r" '?([\w$.]+)'?")
_IN_FUNCTION = re.compile(r"function '([\w$.]+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FAULT = re.compile(r"\(C75\d\d\)")


def ptxas_kernels(log: str) -> Dict[str, dict]:
    """Each kernel of a ``-Xptxas -v`` log, by its (mangled) name: the
    registers it was given, its spill stores and loads in bytes, and its
    faults: every line that reports a spill or a C75xx warning (a wgmma
    serialised, e.g. C7512 for want of registers)."""
    kernels: Dict[str, dict] = {}
    current = None

    def entry(name):
        return kernels.setdefault(name, dict(registers=None, spill_stores=0,
                                             spill_loads=0, faults=[]))
    for ln in log.splitlines():
        m = _ENTRY.search(ln)
        if m:
            current = m.group(1)
            entry(current)
            continue
        named = _IN_FUNCTION.search(ln)
        name = named.group(1) if named else current
        if name is None:
            continue
        k = entry(name)
        m = _SPILL.search(ln)
        if m:
            k["spill_stores"], k["spill_loads"] = map(int, m.groups())
            if k["spill_stores"] or k["spill_loads"]:
                k["faults"].append(ln.strip())
        m = _REGS.search(ln)
        if m:
            k["registers"] = int(m.group(1))
        if _FAULT.search(ln):
            k["faults"].append(ln.strip())
    return kernels


def ptxas_faults(log: str) -> List[Tuple[str, str]]:
    """``(kernel, line)`` for every spill and every C75xx warning that
    ``-Xptxas -v`` reported; empty for a clean build."""
    return [(name, ln) for name, k in ptxas_kernels(log).items()
            for ln in k["faults"]]


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    call)."""
    if name not in _libs:
        paths = build_all()
        if name not in paths:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        _libs[name] = ctypes.CDLL(str(paths[name]))
    return _libs[name]
