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
    division by ``d = n - 1`` into a product with ``r = f32(1/d)``, takes
    ``tr = f32(stop*r)``, and fuses the sums into multiply-adds:

    - ``out[i] = f32(fma(i, tr, f32(start * s_i)))``, the last element
      ``stop``;
    - ``s_i = f32(fma(-i, r, 1))`` for ``i < 32*floor(d/32)`` when
      ``n >= 353`` (XLA's vectorised loop body of 32 elements contracts
      ``1 - i*r`` too), else ``s_i = f32(1 - f32(i*r))`` (its scalar
      remainder);
    - for ``2 < n <= 34`` element 1 takes the other contraction,
      ``f32(fma(start, s_1, f32(tr)))``.

    The split comes from XLA's CPU code generation, not from the HLO (it is
    the same at n = 352 and 353), so the rule holds for the XLA version and
    the CPU vector width it was measured on (jax 0.9.0, AVX-512) and may
    move with either. The product of two f32 values is exact in f64, so
    the f64 sum rounded to f32 stands in for each multiply-add.
    ``torch.linspace`` rounds differently (by an ulp in most elements).

    ``tests/test_torch_linspace_long.py`` holds it bit-equal to a live
    ``jnp.linspace`` for every n from 2 to 1024 on ``(-1, 1)``,
    ``(-n/2, n/2 - 1)``, its reverse, ``(0, 1)`` and ``(-1.1n, 0.7n)``.
    Inside ``jit``, where the JAX package builds its DRR geometry and
    identity map, XLA compiles the same expression with its constants
    folded in and rounds otherwise: the centred range ``(-n/2, n/2 - 1)``
    differs there by up to 1 ulp of ``n/2`` and ``(-1, 1)`` by up to
    1 ulp of 1 (measured for n from 2 to 1024); the reversed range
    ``(n - 1, 0)`` and ``(0, n - 1)`` are bit-equal."""
    n = int(n)
    start32 = torch.tensor(start, dtype=torch.float32)
    if n == 1:
        return start32[None]
    stop32 = torch.tensor(stop, dtype=torch.float32)
    d = n - 1
    i = torch.arange(n, dtype=torch.float32)
    r = torch.tensor(1.0, dtype=torch.float32) / d
    tr = (stop32 * r).double()
    s = 1.0 - i * r
    if n >= 353:
        body = 32 * (d // 32)
        s[:body] = (1.0 - i[:body].double() * r.double()).float()
    out = (i.double() * tr + (start32 * s).double()).float()
    if 2 < n <= 34:
        out[1] = (start32.double() * s[1].double() + tr).float()
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
