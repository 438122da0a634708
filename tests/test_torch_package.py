"""Package rules of liftreg_tpu_torch: no JAX, no liftreg_tpu, no
``msgpack`` or ``ml_dtypes`` (the card's machine need not have them), CUDA
by default with no silent CPU fallback."""
import re
from pathlib import Path

import pytest
import torch

import liftreg_tpu_torch
from liftreg_tpu_torch import RegistrationPipeline
from liftreg_tpu_torch.ops import _build
from liftreg_tpu_torch.pca import load_pca

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|liftreg_tpu|ml_dtypes|"
                       r"msgpack)\b", re.MULTILINE)


def test_no_jax_or_reference_imports():
    files = sorted((ROOT / "liftreg_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    tools = sorted((ROOT / "tools").glob("torch_*.py"))
    assert len(tools) >= 23
    files += tools
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    # the JAX tools' timing helper (tools/_timing.py) imports JAX
    timing = re.compile(r"^\s*(import|from)\s+(tools\.)?_timing\b",
                        re.MULTILINE)
    assert not [f for f in files if timing.search(f.read_text())]


def test_kernel_sources_exist():
    for src in _build.SOURCES:
        assert src.is_file(), src
    assert _build.library_path().parent.parent == _build.BUILD_ROOT


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegistrationPipeline((32, 32, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pca("unused")


def test_exports():
    assert set(liftreg_tpu_torch.__all__) == {"RegistrationPipeline",
                                              "params_from_jax"}


def test_codec_builds_into_build_dir():
    """The native codec builds at first use under build/, never beside its
    source (the JAX package writes its library next to ``codec.cpp``)."""
    from liftreg_tpu_torch import native
    src_dir = ROOT / "liftreg_tpu_torch" / "native"
    lib = native.library_path()
    assert lib.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parent == ROOT / "build"
    assert native.native_available()
    assert lib.is_file()
    assert sorted(p.name for p in src_dir.iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "codec.cpp"]
