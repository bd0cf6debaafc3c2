"""The kernels' build cache: a library is rebuilt when its source or a header
it may include changes, and reused otherwise.  Runs without nvcc: it only
computes library paths."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return g(); }\n')
    (src / "helpers.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


def test_unchanged_sources_reuse_the_library(csrc):
    assert build.library_path("kern") == build.library_path("kern")
    assert build.library_path("kern").parent == csrc.parent / "build"


def test_an_included_header_change_rebuilds(csrc):
    before = build.library_path("kern")
    (csrc / "helpers.cuh").write_text("inline int g() { return 2; }\n")
    assert build.library_path("kern") != before


def test_a_source_change_rebuilds(csrc):
    before = build.library_path("kern")
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return -g(); }\n')
    assert build.library_path("kern") != before


def test_a_new_header_rebuilds(csrc):
    before = build.library_path("kern")
    (csrc / "more.cuh").write_text("inline int h() { return 3; }\n")
    assert build.library_path("kern") != before


def test_the_repo_kernels_hash_their_shared_header():
    """The attention kernel includes csrc/ptx.cuh, which the hash covers."""
    assert '#include "ptx.cuh"' in (build.CSRC / "flash_attention.cu").read_text()
    assert (build.CSRC / "ptx.cuh").exists()
    for name in ("flash_attention", "mamba_scan", "moe_gmm"):
        assert build.library_path(name).name.startswith(f"{name}-")
