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
the other. It is the ``torch.library`` operator ``liftreg::pca_expand``
(:mod:`._library`), whose CUDA implementation chunks the rows.
``pca_expand.launches`` counts kernel launches: one per chunk of at most
``MAX_CHUNK`` batch rows.

The backward, ``dcoefs = bf16(g @ V^T)``, is the kernel's second entry
(:func:`pca_grad`, plain version :func:`pca_grad_plain`); it rounds the f32
product to bf16 as JAX's autodiff of ``expand_pca`` does (the cast of the
coefficients to bf16 is the last op before the dot). :func:`pca_expand_ad`
wraps forward and backward in a ``torch.autograd.Function``,
differentiable in the coefficients only: every JAX path holds the basis
and the mean fixed.
"""
from __future__ import annotations

import torch

from . import _build, _library

#: the kernel keeps one accumulator row per batch row in registers, so the
#: wrappers launch it once per chunk of at most this many batch rows (each
#: launch reads the basis once; rows are independent)
MAX_CHUNK = 8
_MAX_SMEM = 48 * 1024
_F32 = (torch.float32,)
#: the backward's columns per block and tile (csrc/pca_expand.cu
#: kGradTile), and the blocks it starts per SM: two fit at B=4 (128
#: registers a thread), the fastest grid measured on the H100
_GRAD_TILE = 256
_GRAD_BLOCKS_PER_SM = 2


def pca_expand_plain(coefs, vectors, mean):
    """coefs (B, L) f32, vectors (L, n) bf16, mean (n,) f32 -> (B, n) f32:
    the coefficients rounded to bf16, products and sums in f32."""
    return coefs.to(torch.bfloat16).float() @ vectors.float() + mean


def _shapes(coefs, vectors, name, rows):
    """(B, L, n) of a call, after checking the operands' ranks and that
    ``coefs.shape[1] == rows(L, n)``."""
    if coefs.dim() != 2 or vectors.dim() != 2:
        raise ValueError(f"{name}: want 2-D tensors; got "
                         f"{tuple(coefs.shape)}, {tuple(vectors.shape)}")
    B = coefs.shape[0]
    L, n = vectors.shape
    if coefs.shape[1] != rows(L, n):
        raise ValueError(f"{name}: shapes {tuple(coefs.shape)}, "
                         f"{tuple(vectors.shape)} do not agree")
    return B, L, n


def _check(coefs, vectors, name, rows, **more):
    """Device, dtypes and shapes of a call; returns (device, B, L, n).
    ``more`` holds further f32 operands (the mean)."""
    device = _build.inputs_device(
        name, {"first operand": coefs, "vectors": vectors, **more},
        {"first operand": _F32, "vectors": (torch.bfloat16,), "mean": _F32})
    return (device,) + _shapes(coefs, vectors, name, rows)


def _chunks(B):
    """Row ranges of the kernel launches for a batch of B rows."""
    return [(b0, min(b0 + MAX_CHUNK, B)) for b0 in range(0, B, MAX_CHUNK)]


def _check_mean(mean, n):
    if mean.shape != (n,):
        raise ValueError(f"pca_expand: want mean ({n},); got "
                         f"{tuple(mean.shape)}")


def _expand_impl(coefs, vectors, mean):
    """``liftreg::pca_expand`` on the CPU (the plain version) and on CUDA
    (the kernel, one launch per chunk of rows)."""
    device, B, L, n = _check(coefs, vectors, "pca_expand", lambda L, n: L,
                             mean=mean)
    _check_mean(mean, n)
    if device.type == "cpu":
        return pca_expand_plain(coefs, vectors, mean)
    if min(B, MAX_CHUNK) * L * 4 > _MAX_SMEM:
        raise ValueError(f"pca_expand: {L} coefficients per row exceed the "
                         "kernel's shared memory")
    out = torch.empty((B, n), dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0, b1 in _chunks(B):
            c, o = coefs[b0:b1], out[b0:b1]
            vec = int(n % 8 == 0 and all(t.data_ptr() % 16 == 0
                                         for t in (vectors, mean, o)))
            rc = lib.liftreg_pca_expand(c.data_ptr(), vectors.data_ptr(),
                                        mean.data_ptr(), o.data_ptr(),
                                        b1 - b0, L, n, vec, stream)
            _build.check(rc, "pca_expand")
            pca_expand.launches += 1
    return out


def _expand_fake(coefs, vectors, mean):
    B, L, n = _shapes(coefs, vectors, "pca_expand", lambda L, n: L)
    _check_mean(mean, n)
    return coefs.new_empty((B, n), dtype=torch.float32)


_library.define("pca_expand(Tensor coefs, Tensor vectors, Tensor mean) "
                "-> Tensor", _expand_impl, _expand_fake)


def pca_expand(coefs, vectors, mean):
    """The kernel on CUDA tensors, the plain version on CPU tensors: the
    operator ``liftreg::pca_expand``."""
    return torch.ops.liftreg.pca_expand(coefs, vectors, mean)


pca_expand.launches = 0


def pca_grad_plain(g, vectors):
    """g (B, n) f32, vectors (L, n) bf16 -> dcoefs (B, L) f32: the f32
    product with the widened basis, rounded to bf16 and back."""
    return (g.float() @ vectors.float().T).to(torch.bfloat16).float()


def pca_grad(g, vectors):
    """The backward kernel on CUDA tensors, the plain version on CPU
    tensors. ``pca_grad.launches`` counts kernel launches: one per chunk of
    at most ``MAX_CHUNK`` batch rows, each of which runs as two passes on
    the card (per-block partial sums, then their ordered sum), counted as
    one launch. The kernel keeps its sums in registers, so any L fits."""
    device, B, L, n = _check(g, vectors, "pca_grad", lambda L, n: n)
    if device.type == "cpu":
        return pca_grad_plain(g, vectors)
    rows = min(B, MAX_CHUNK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-n // _GRAD_TILE)
    blocks = max(1, min(tiles, _GRAD_BLOCKS_PER_SM * sms))
    # one scratch for every chunk: the launches run in order on the stream
    partial = torch.empty((blocks, L, rows), dtype=torch.float32,
                          device=device)
    dcoefs = torch.empty((B, L), dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0, b1 in _chunks(B):
            gc, dc = g[b0:b1], dcoefs[b0:b1]
            vec = int(n % 8 == 0 and gc.data_ptr() % 16 == 0
                      and vectors.data_ptr() % 16 == 0)
            rc = lib.liftreg_pca_grad(gc.data_ptr(), vectors.data_ptr(),
                                      partial.data_ptr(), dc.data_ptr(),
                                      b1 - b0, L, n, vec, blocks, stream)
            _build.check(rc, "pca_grad")
            pca_grad.launches += 1
    return dcoefs


pca_grad.launches = 0


class _PcaExpand(torch.autograd.Function):
    """Forward :func:`pca_expand`, backward :func:`pca_grad`."""

    @staticmethod
    def forward(ctx, coefs, vectors, mean):
        ctx.save_for_backward(vectors)
        return pca_expand(coefs, vectors, mean)

    @staticmethod
    def backward(ctx, g):
        (vectors,) = ctx.saved_tensors
        return pca_grad(g.contiguous(), vectors), None, None


def pca_expand_ad(coefs, vectors, mean):
    """:func:`pca_expand`, differentiable with respect to ``coefs``. Raises
    if the basis or the mean requires grad: they are fixed in every path of
    the JAX package."""
    if torch.is_grad_enabled() and (vectors.requires_grad
                                    or mean.requires_grad):
        raise NotImplementedError("pca_expand_ad: the basis and the mean "
                                  "are fixed; detach them")
    if torch.is_grad_enabled() and coefs.requires_grad:
        return _PcaExpand.apply(coefs, vectors, mean)
    return pca_expand(coefs, vectors, mean)
