"""Coordinate conventions, PyTorch port of ``liftreg_tpu/coords.py``.

Volumes are ``(B, C, D, W, H)``. A map ``phi`` is ``(B, 3, D, W, H)`` whose
channel ``c`` holds the normalized sample coordinate along spatial axis
``c``. Normalized coordinates use ``align_corners=True``: voxel ``i`` of an
axis with ``N`` voxels sits at ``-1 + 2*i/(N-1)``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def linspace_in_jit(start, stop, n):
    """``jnp.linspace(start, stop, n)`` in f32, rounded as XLA compiles it
    inside ``jit`` on the CPU, with ``start`` and ``stop`` constants: the
    JAX package's identity map (``liftreg_tpu/coords.py:identity_map``,
    called inside the jitted models, refiners, pipeline and train steps)
    and its DRR geometry (``liftreg_tpu/ops/drr.py:125-127,165-167``, inside
    the jitted projector and lift). The compiled HLO folds ``stop * (i/d)``
    into ``i * c`` with ``r = f32(1/d)``, ``c = f32(stop * r)`` (``c = r``
    when ``stop`` is 1, a product that ``1 - i*r`` shares):

    - ``out[i] = f32(f32(start * s_i) + f32(i * c))`` with
      ``s_i = f32(1 - f32(i * r))``, no fused multiply-add, the last element
      ``stop``;
    - from n = 353, for ``i < 32*floor(d/32)`` (XLA's vectorised loop
      body of 32 elements; the scalar remainder keeps the rule above),
      when ``stop`` is not 1, the body contracts
      ``s_i = f32(fma(-i, r, 1))`` and the product of the positive end:
      ``f32(fma(i, c, f32(start * s_i)))`` for ``start < 0 < stop``,
      ``f32(fma(start, s_i, f32(i * c)))`` for ``stop <= 0 < start``
      (the product of two f32 values is exact in f64, so an f64 sum
      rounded to f32 stands in for each multiply-add).

    Measured bit-equal to ``jax.jit`` (jax 0.9.0, AVX-512) for every n from
    2 to 1024 on ``(-1, 1)``, ``(-n/2, n/2 - 1)``, its reverse, ``(0, 1)``,
    ``(-1.1n, 0.7n)``, ``(0, n - 1)`` and ``(n - 1, 0)``, and the identity
    map also where XLA fuses it into the models' ``disp + identity_map``
    and into the phi of the jitted ``RegistrationPipeline.register``
    (``tests/test_torch_linspace_jit.py``). Other ranges with an end of
    0 or 1 can contract otherwise from n = 353 (``(3, 1)``, ``(1, -1)``
    and ``(-1, 0)`` do): the rule is not claimed for them. The split of
    the body from the remainder comes from XLA's CPU code generation, not
    from the HLO, so the rule holds for the XLA version and the CPU vector
    width it was measured on and may move with either. ``torch.linspace``
    and an eager ``jnp.linspace`` round otherwise (by an ulp in many
    elements)."""
    n = int(n)
    start32 = torch.tensor(start, dtype=torch.float32)
    if n == 1:
        return start32[None]
    stop32 = torch.tensor(stop, dtype=torch.float32)
    d = n - 1
    i = torch.arange(n, dtype=torch.float32)
    r = torch.tensor(1.0, dtype=torch.float32) / d
    c = stop32 * r
    s = 1.0 - i * r
    out = start32 * s + i * c
    if n >= 353 and stop != 1.0 and (start < 0 < stop or stop <= 0 < start):
        body = 32 * (d // 32)
        ib = i[:body].double()
        sf = (1.0 - ib * r.double()).float().double()
        if start < 0:
            out[:body] = (ib * c.double() + (start32 * sf).float()).float()
        else:
            out[:body] = (start32.double() * sf
                          + (i[:body] * c).double()).float()
    out[-1] = stop32
    return out


@functools.lru_cache(maxsize=16)
def _identity_map(sz, device, dtype):
    axes = [linspace_in_jit(-1.0, 1.0, n) for n in sz]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)
    return grid.to(device=device, dtype=dtype)


def identity_map(sz, device=None, dtype=torch.float32):
    """Normalized identity map ``(ndim, *sz)`` in [-1, 1] on ``device``:
    axis ``d`` varies along spatial dim ``d`` as ``linspace(-1, 1, sz[d])``
    rounded as the JAX package's identity map rounds inside ``jit``, where
    every one of its callers builds it (:func:`linspace_in_jit`). Cached by
    ``(sz, device, dtype)``: the same tensor comes back on every call, so
    callers must not write into it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return _identity_map(tuple(int(n) for n in sz), device, dtype)


def norm_to_pixel(coord, n):
    """[-1, 1] normalized coordinate -> pixel coordinate, align_corners=True."""
    return (coord + 1.0) * 0.5 * (n - 1.0)


def pixel_to_norm(pix, n):
    """Pixel coordinate -> [-1, 1] normalized, align_corners=True."""
    return pix / (n - 1.0) * 2.0 - 1.0


def phi_to_01(phi):
    """Map in [-1, 1] -> its stored form in [0, 1], ``(phi + 1) / 2``
    (``liftreg_tpu/coords.py:phi_to_01``); a tensor or a numpy array."""
    return (phi + 1.0) / 2.0


def phi_from_01(phi01):
    """Stored [0, 1] map -> [-1, 1], ``phi01 * 2 - 1``; a tensor or a numpy
    array."""
    return phi01 * 2.0 - 1.0


def flip_sar_to_spr(vol):
    """Flip axis 1 (anterior/posterior), SAR -> SPR orientation: a numpy
    view as ``np.flip`` gives it, or a flipped copy of a tensor."""
    if isinstance(vol, torch.Tensor):
        return torch.flip(vol, dims=(1,))
    return np.flip(vol, axis=1)
