"""PCA expansion ``disp = bf16(coefs) @ V + mean``: the Hopper kernel and
its plain PyTorch version.

The kernel (``csrc/pca_expand.cu``) replaces
``liftreg_tpu/ops/pallas_pca.py:_expand_kernel``. It is bound by the one
read of the bf16 basis (1.38 GB at the 160^3 serving shape, ~0.48 ms of
the card's memory rate with the mean and the output): each basis element
is read once for all batch rows, with 16-byte loads, and the ragged tail
of any length is masked (the TPU wrapper instead fell back to XLA there).

:func:`pca_expand` launches the kernel for CUDA tensors and runs
:func:`pca_expand_plain` for CPU tensors; it never falls back from one to
the other. ``pca_expand.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

#: the kernel keeps one accumulator row per batch row in registers
MAX_BATCH = 8
_MAX_SMEM = 48 * 1024


def pca_expand_plain(coefs, vectors, mean):
    """coefs (B, L) f32, vectors (L, n) bf16, mean (n,) f32 -> (B, n) f32:
    the coefficients rounded to bf16, products and sums in f32."""
    return coefs.to(torch.bfloat16).float() @ vectors.float() + mean


def pca_expand(coefs, vectors, mean):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    devices = {t.device for t in (coefs, vectors, mean)}
    if len(devices) != 1:
        raise ValueError(f"pca_expand: tensors on several devices {devices}")
    (device,) = devices
    if device.type == "cpu":
        return pca_expand_plain(coefs, vectors, mean)
    if device.type != "cuda":
        raise ValueError(f"pca_expand: unsupported device {device}")
    if coefs.dtype != torch.float32 or vectors.dtype != torch.bfloat16 \
            or mean.dtype != torch.float32:
        raise TypeError("pca_expand: want coefs f32, vectors bf16, mean f32; "
                        f"got {coefs.dtype}, {vectors.dtype}, {mean.dtype}")
    if coefs.dim() != 2 or vectors.dim() != 2 or mean.dim() != 1:
        raise ValueError("pca_expand: want coefs (B, L), vectors (L, n), "
                         "mean (n,)")
    B, L = coefs.shape
    n = vectors.shape[1]
    if vectors.shape[0] != L or mean.shape[0] != n:
        raise ValueError(f"pca_expand: shapes {tuple(coefs.shape)}, "
                         f"{tuple(vectors.shape)}, {tuple(mean.shape)} "
                         "do not agree")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"pca_expand: batch {B} outside [1, {MAX_BATCH}]")
    if B * L * 4 > _MAX_SMEM:
        raise ValueError(f"pca_expand: B*L = {B * L} coefficients exceed "
                         "the kernel's shared memory")
    for name, t in (("coefs", coefs), ("vectors", vectors), ("mean", mean)):
        if not t.is_contiguous():
            raise ValueError(f"pca_expand: {name} is not contiguous")
    out = torch.empty((B, n), dtype=torch.float32, device=device)
    vec = int(n % 8 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (vectors, mean, out)))
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_pca_expand(coefs.data_ptr(), vectors.data_ptr(),
                                    mean.data_ptr(), out.data_ptr(), B, L, n,
                                    vec, stream)
    _build.check(rc, "pca_expand")
    pca_expand.launches += 1
    return out


pca_expand.launches = 0
