"""Package rules of liftreg_tpu_torch: no JAX, no liftreg_tpu, CUDA by
default with no silent CPU fallback."""
import re
from pathlib import Path

import pytest
import torch

import liftreg_tpu_torch
from liftreg_tpu_torch import RegistrationPipeline
from liftreg_tpu_torch.ops import _build
from liftreg_tpu_torch.pca import load_pca

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|liftreg_tpu)\b",
                       re.MULTILINE)


def test_no_jax_or_reference_imports():
    files = sorted((ROOT / "liftreg_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


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
