"""Coordinate conventions, PyTorch port of ``liftreg_tpu/coords.py``.

Volumes are ``(B, C, D, W, H)``. A map ``phi`` is ``(B, 3, D, W, H)`` whose
channel ``c`` holds the normalized sample coordinate along spatial axis
``c``. Normalized coordinates use ``align_corners=True``: voxel ``i`` of an
axis with ``N`` voxels sits at ``-1 + 2*i/(N-1)``.
"""
from __future__ import annotations

import functools

import torch


def linspace(start, stop, n):
    """``jnp.linspace(start, stop, n)`` in f32, rounded as XLA computes it
    on the CPU for a call outside ``jit`` (a CPU tensor). XLA turns the
    division by ``n - 1`` into a product with ``r = f32(1/(n-1))`` and
    fuses the sum into one multiply-add:
    ``fma(i, f32(stop*r), f32(start*(1 - f32(i*r))))``, the last element
    ``stop``. The product of two f32 values is exact in f64, so the f64 sum
    rounded to f32 stands in for the fused multiply-add.
    ``torch.linspace`` rounds differently (by an ulp in most elements).

    ``tests/test_torch_coords_drr.py`` holds it bit-equal to
    ``jnp.linspace`` for ``(-1, 1)`` at every n from 1 to 256 and for the
    DRR geometry's ranges at the sizes it names. Known exceptions, one ulp
    in element 1 of ``(-n/2, n/2 - 1)``: n = 7, 12, 15, 21, 25, 29, 31.
    Inside ``jit`` XLA folds the constants and rounds some elements
    otherwise; the refinement from zero coefficients still agrees with the
    JAX refiner (``tests/test_torch_refine.py``)."""
    n = int(n)
    start32 = torch.tensor(start, dtype=torch.float32)
    if n == 1:
        return start32[None]
    stop32 = torch.tensor(stop, dtype=torch.float32)
    i = torch.arange(n, dtype=torch.float32)
    r = torch.tensor(1.0 / (n - 1), dtype=torch.float32)
    low = start32 * (1.0 - i * r)
    out = (i.double() * (stop32 * r).double() + low.double()).float()
    out[-1] = stop32
    return out


@functools.lru_cache(maxsize=16)
def _identity_map(sz, device, dtype):
    axes = [linspace(-1.0, 1.0, n) for n in sz]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)
    return grid.to(device=device, dtype=dtype)


def identity_map(sz, device=None, dtype=torch.float32):
    """Normalized identity map ``(ndim, *sz)`` in [-1, 1] on ``device``:
    axis ``d`` varies along spatial dim ``d`` as ``linspace(-1, 1, sz[d])``
    with JAX's rounding (:func:`linspace`). Cached by ``(sz, device,
    dtype)``: the same tensor comes back on every call, so callers must not
    write into it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return _identity_map(tuple(int(n) for n in sz), device, dtype)


def norm_to_pixel(coord, n):
    """[-1, 1] normalized coordinate -> pixel coordinate, align_corners=True."""
    return (coord + 1.0) * 0.5 * (n - 1.0)


def pixel_to_norm(pix, n):
    """Pixel coordinate -> [-1, 1] normalized, align_corners=True."""
    return pix / (n - 1.0) * 2.0 - 1.0
