"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the card unless the caller asks for the
CPU, and a kernel wrapper handed CUDA tensors without a card raises
instead of quietly taking the plain version."""
import ast
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.engine.paged_cache import DevicePagedCache, PagedCacheSpec
from repro_torch.kernels.cache_write import ops as tcw
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.selective_scan import ops as tss
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_port_files_include_every_kernel_module():
    """The import scan below covers each kernel's wrapper and plain
    version, beside its CUDA source."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for kernel in ("cache_write", "paged_attention", "selective_scan",
                   "flash_attention"):
        for part in ("ops.py", "ref.py"):
            assert f"src/repro_torch/kernels/{kernel}/{part}" in names
        assert (ROOT / "src" / "repro_torch" / "csrc"
                / f"{kernel}.cu").exists()


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


@pytest.fixture(scope="module")
def small():
    cfg = get_config("llava-1.5-7b").reduced()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0))


def test_engine_defaults_to_the_card_and_raises_without_one(no_card, small):
    cfg, params = small
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params, DisaggConfig({"EPD": 1}))


@pytest.mark.parametrize("entry", ["RunnerCaches", "ModelRunner",
                                   "DevicePagedCache"])
def test_other_entry_points_default_to_the_card(no_card, small, entry):
    cfg, params = small
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "RunnerCaches":
            R.RunnerCaches(cfg)
        elif entry == "ModelRunner":
            caches = R.RunnerCaches(cfg, device="cpu")
            R.ModelRunner(cfg, params, caches)
        else:
            DevicePagedCache(PagedCacheSpec(2, 1, 4, 8, 4))


def _fake_cuda(*shape):
    """Stands in for a CUDA tensor on a machine without a card."""
    return SimpleNamespace(device=torch.device("cuda", 0), shape=shape)


def _boom(*a, **k):  # pragma: no cover - only hit on regression
    raise AssertionError("a CUDA request reached the plain version")


@pytest.mark.parametrize("wrapper", ["cache_write", "paged_attention",
                                     "paged_prefill_attention",
                                     "selective_scan", "flash_attention"])
def test_wrapper_never_falls_back_to_plain_version(no_card, monkeypatch,
                                                   wrapper):
    monkeypatch.setattr(tcw, "cache_write_ref", _boom)
    monkeypatch.setattr(tpa, "paged_attention_ref", _boom)
    monkeypatch.setattr(tpa, "paged_prefill_attention_ref", _boom)
    monkeypatch.setattr(tss, "selective_scan_ref", _boom)
    monkeypatch.setattr(tfa, "flash_attention_ref", _boom)
    pages, tables, lens = _fake_cuda(8, 4, 2, 8), _fake_cuda(1, 2), \
        _fake_cuda(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if wrapper == "cache_write":
            tcw.paged_chunk_write(_fake_cuda(2, 1, 8, 4, 16), 0,
                                  _fake_cuda(2, 1, 1, 16), _fake_cuda(1, 1))
        elif wrapper == "selective_scan":
            seq, bc = _fake_cuda(1, 3, 8), _fake_cuda(1, 3, 4)
            tss.selective_scan(seq, seq, _fake_cuda(8, 4), bc, bc)
        elif wrapper == "flash_attention":
            tfa.flash_attention(_fake_cuda(1, 2, 3, 64),
                                _fake_cuda(1, 2, 5, 64),
                                _fake_cuda(1, 2, 5, 64))
        elif wrapper == "paged_attention":
            tpa.paged_attention(_fake_cuda(1, 2, 8), pages, pages, tables,
                                lens)
        else:
            tpa.paged_prefill_attention(_fake_cuda(1, 3, 2, 8), pages, pages,
                                        tables, lens)
