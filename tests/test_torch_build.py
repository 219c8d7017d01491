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
