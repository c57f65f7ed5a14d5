"""The kernel build's cache key on CPU (no nvcc needed): a library is named
by a hash of its ``.cu`` source, of every ``csrc`` header that source
includes and of the compiler flags, so an edited shared header is never
served from a stale build."""
import shutil

import pytest

from repro_torch.kernels import _build

INCLUDERS = ("paged_attention", "flash_attention")   # include attn_mma.cuh


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_kernel_source_is_hashed_with_its_headers(csrc):
    for name in _build.KERNELS:
        srcs = _build._sources(name)
        assert srcs[0] == csrc / f"{name}.cu"
        assert all(p.exists() for p in srcs)
    for name in INCLUDERS:
        assert csrc / "attn_mma.cuh" in _build._sources(name)


def test_editing_a_shared_header_renames_both_libraries(csrc):
    before = {n: _build._lib_path(n) for n in _build.KERNELS}
    assert before == {n: _build._lib_path(n) for n in _build.KERNELS}
    header = csrc / "attn_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.KERNELS}
    for name in _build.KERNELS:
        changed = after[name] != before[name]
        assert changed == (name in INCLUDERS), name


def test_nested_headers_are_followed(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    header = csrc / "attn_mma.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert csrc / "inner.cuh" in _build._sources("flash_attention")
    before = _build._lib_path("flash_attention")
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build._lib_path("flash_attention") != before
