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


def linspace_eager(start, stop, n):
    """``jnp.linspace(start, stop, n)`` in f32, rounded as XLA computes it
    on the CPU for a call outside ``jit``: the identity map that
    ``liftreg_tpu/optreg.py:DenseRegisterer.__call__`` subtracts from the
    last level's phi. XLA turns the division by ``d = n - 1`` into a
    product with ``r = f32(1/d)``, takes ``tr = f32(stop*r)``, and fuses
    the sums into multiply-adds:

    - ``out[i] = f32(fma(i, tr, f32(start * s_i)))``, the last element
      ``stop``;
    - ``s_i = f32(fma(-i, r, 1))`` for ``i < 32*floor(d/32)`` when
      ``n >= 353`` (XLA's vectorised loop body of 32 elements contracts
      ``1 - i*r`` too), else ``s_i = f32(1 - f32(i*r))`` (its scalar
      remainder);
    - for ``2 < n <= 34`` element 1 takes the other contraction,
      ``f32(fma(start, s_1, f32(tr)))``.

    Measured bit-equal to an eager ``jnp.linspace`` (jax 0.9.0, AVX-512)
    for every n from 2 to 1024 on ``(-1, 1)``
    (``tests/test_torch_optreg.py``); the split comes from XLA's CPU code
    generation and may move with its version or the CPU's vector width.
    The product of two f32 values is exact in f64, so the f64 sum rounded
    to f32 stands in for each multiply-add."""
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
def _identity_map(sz, device, dtype, eager):
    rule = linspace_eager if eager else linspace_in_jit
    axes = [rule(-1.0, 1.0, n) for n in sz]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)
    return grid.to(device=device, dtype=dtype)


def identity_map(sz, device=None, dtype=torch.float32, eager=False):
    """Normalized identity map ``(ndim, *sz)`` in [-1, 1] on ``device``:
    axis ``d`` varies along spatial dim ``d`` as ``linspace(-1, 1, sz[d])``
    rounded as the JAX package's identity map rounds inside ``jit``, where
    its models, refiners, pipeline and train steps build it
    (:func:`linspace_in_jit`), or with ``eager`` as it rounds outside
    ``jit`` (:func:`linspace_eager`; ``optreg.DenseRegisterer``'s ``disp``).
    Cached by ``(sz, device, dtype, eager)``: the same tensor comes back on
    every call, so callers must not write into it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return _identity_map(tuple(int(n) for n in sz), device, dtype,
                         bool(eager))


def identity_map_np(sz, dtype=np.float32):
    """The identity map in numpy, ``np.linspace`` per axis (the JAX
    package's ``coords.identity_map_np``, which its tools use for stored
    phi maps)."""
    axes = [np.linspace(-1.0, 1.0, int(n), dtype=dtype) for n in sz]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)


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
