"""Central finite differences, PyTorch port of ``liftreg_tpu/ops/fd.py``
(that module imports ``jax.numpy``, so the port keeps its own copy).

``d f/dx [i] = (f[i+1] - f[i-1]) / (2h)`` with replicate boundaries
(``f[-1] := f[0]``, ``f[N] := f[N-1]``), so boundary derivatives are
one-sided halves. The reference calls these with spacing ``2/(N-1)``.
"""
from __future__ import annotations

import torch


def _central(x, axis, h):
    n = x.shape[axis]
    device = x.device
    fwd = torch.arange(1, n + 1, device=device).clamp(0, n - 1)
    bwd = torch.arange(-1, n - 1, device=device).clamp(0, n - 1)
    return (x.index_select(axis, fwd) - x.index_select(axis, bwd)) \
        * (0.5 / h)


def dXc(f, h, axis=-3):
    """Central difference along the first spatial axis of (..., D, W, H)."""
    return _central(f, axis, h)


def dYc(f, h, axis=-2):
    return _central(f, axis, h)


def dZc(f, h, axis=-1):
    return _central(f, axis, h)


def grad_norm_sq(disp, spacing):
    """``sum_c sum_d |d disp_c / d x_d|^2`` pointwise: disp (B, 3, D, W, H),
    spacing length 3 -> (B, D, W, H)."""
    hx, hy, hz = [float(s) for s in spacing]
    total = 0.0
    for c in range(disp.shape[1]):
        f = disp[:, c]
        total = total + _central(f, -3, hx) ** 2 \
                      + _central(f, -2, hy) ** 2 \
                      + _central(f, -1, hz) ** 2
    return total
