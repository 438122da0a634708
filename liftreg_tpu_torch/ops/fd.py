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


def jacobian_determinant(phi, spacing):
    """Jacobian determinant of a map ``(B, 3, D, W, H)`` by central
    differences -> (B, D, W, H)."""
    hx, hy, hz = [float(s) for s in spacing]
    a = _central(phi[:, 0], -3, hx)
    b = _central(phi[:, 0], -2, hy)
    c = _central(phi[:, 0], -1, hz)
    d = _central(phi[:, 1], -3, hx)
    e = _central(phi[:, 1], -2, hy)
    f = _central(phi[:, 1], -1, hz)
    g = _central(phi[:, 2], -3, hx)
    h = _central(phi[:, 2], -2, hy)
    i = _central(phi[:, 2], -1, hz)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def compute_jacobi_map(phi, spacing, crop_boundary=True, use_01=False):
    """Folding metric: (sum of |negative jacobian det|, count of
    negatives), averaged over the batch, as host floats. ``phi`` is a
    tensor or numpy array ``(B, 3, D, W, H)``, taken in f32 on its device;
    ``spacing`` per axis, doubled unless ``use_01``.

    Keeps the JAX package's quirk (``liftreg_tpu/ops/fd.py:71-76``): its
    crop-boundary branch computes cropped values and then overwrites them
    with the uncropped ones, so ``crop_boundary`` changes nothing."""
    del crop_boundary
    phi = torch.as_tensor(phi).float()
    span = 1.0 if use_01 else 2.0
    sp = [float(s) * span for s in spacing]
    det = jacobian_determinant(phi, sp).double()
    neg = det < 0.0
    jacobi_abs = -float(torch.where(neg, det, 0.0).sum())
    jacobi_num = float(neg.sum())
    return jacobi_abs / phi.shape[0], jacobi_num / phi.shape[0]
