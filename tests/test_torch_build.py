"""The kernel build's inputs: a library's name must change with anything
that changes what ``nvcc`` would produce, so that a stale library is never
loaded; and every header a source includes must be in ``csrc/``, where the
build hashes it.  No compiler is needed: this checks the names only."""
import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

SOURCES = sorted(_build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_name_is_stable(csrc):
    assert _build._target(csrc / "k.cu") == _build._target(csrc / "k.cu")


@pytest.mark.parametrize("change", ["source", "header", "new header",
                                    "flags"])
def test_name_follows_every_build_input(csrc, monkeypatch, change):
    before = _build._target(csrc / "k.cu")
    if change == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    elif change == "header":
        (csrc / "h.cuh").write_text("// v2\n")
    elif change == "new header":
        (csrc / "g.cuh").write_text("// new\n")
    else:
        monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-lfoo",))
    assert _build._target(csrc / "k.cu") != before


def test_flags_link_the_driver():
    """The Hopper kernels encode TMA tensor maps through the driver API."""
    assert "-lcuda" in _build.FLAGS


@pytest.mark.parametrize("src", SOURCES, ids=[p.name for p in SOURCES])
def test_included_headers_are_hashed(src):
    local = re.findall(r'#include\s+"([^"]+)"', src.read_text())
    for name in local:
        assert (_build.CSRC / name).is_file(), f"{src.name}: {name}"
        assert name.endswith(".cuh"), f"{src.name}: {name} is not hashed"


# ptxas' -v report as nvcc prints it: a clean kernel, then one that
# spills and has its wgmmas serialised (the C7512 line names its kernel)
K128 = ("_ZN12_GLOBAL__N_128flash_attention_wgmma_kernelILi128ELb1EEEv"
        "14CUtensorMap_stS1_S1_NS_6ParamsE")
K256 = ("_ZN12_GLOBAL__N_128flash_attention_wgmma_kernelILi256ELb0EEEv"
        "14CUtensorMap_stS1_S1_NS_6ParamsE")
CLEAN = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{K128}' for 'sm_90a'
ptxas info    : Function properties for {K128}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1152 bytes cmem[0]
"""
SPILL = f"""ptxas info    : Compiling entry function '{K256}' for 'sm_90a'
ptxas info    : Function properties for {K256}
    104 bytes stack frame, 100 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 104 bytes cumulative \
stack size, 1152 bytes cmem[0]
"""
C7512 = ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
         "instructions are serialized due to insufficient register resources "
         f"for the function '{K256}'\n")


def test_ptxas_report_of_a_clean_build():
    kernels = _build.ptxas_kernels(CLEAN)
    assert kernels[K128] == dict(registers=168, spill_stores=0,
                                 spill_loads=0, faults=[])
    assert _build.ptxas_faults(CLEAN) == []


@pytest.mark.parametrize("log", [CLEAN + SPILL, CLEAN + C7512 + SPILL,
                                 C7512 + CLEAN + SPILL, CLEAN + C7512],
                         ids=["spill", "spill and C7512", "C7512 first",
                              "C7512 alone"])
def test_ptxas_faults_name_their_kernel(log):
    kernels = _build.ptxas_kernels(log)
    faults = _build.ptxas_faults(log)
    assert faults and {k for k, _ in faults} == {K256}
    assert kernels[K128]["faults"] == []
    assert ("C7512" in log) == any("(C7512)" in ln for _, ln in faults)
    if SPILL in log:
        assert (kernels[K256]["spill_stores"],
                kernels[K256]["spill_loads"]) == (100, 88)
        assert any("100 bytes spill stores" in ln for _, ln in faults)


def test_a_cached_build_keeps_its_ptxas_report(csrc, tmp_path, monkeypatch):
    """``build_all`` runs the compiler only for a stale library, and a
    cached library's report is read back from beside it."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!/bin/sh
echo x >> {calls}
while [ "$1" != "-o" ]; do shift; done
touch "$2"
printf '%s' "{CLEAN}"
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "build_log", {})
    first = _build.build_all()
    assert list(first) == ["k"] and first["k"].exists()
    _build.build_log.clear()
    assert _build.build_all() == first
    assert calls.read_text().count("x") == 1
    assert _build.ptxas_faults(_build.build_log["k"]) == []
    assert K128 in _build.ptxas_kernels(_build.build_log["k"])
