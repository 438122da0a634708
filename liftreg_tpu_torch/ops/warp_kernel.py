"""Trilinear warp at pixel coordinates: the Hopper kernel and its plain
PyTorch version.

The kernel (``csrc/warp_trilinear.cu``) replaces the forward of
``liftreg_tpu/ops/pallas_warp.py:_warp_plane_kernel`` with the semantics of
``liftreg_tpu/ops/resample.py:_oct_plain``, exact for any field (the TPU
kernel clamps outside its (dy, dx) window). It is bound by bytes: the f32
coordinates, the taps and the f32 output, ~0.30 GB or ~0.09 ms of the
card's memory rate at the 160^3 serving shape with B=4 and bf16 taps. One
thread computes one output position.

:func:`warp_trilinear` launches the kernel for CUDA tensors and runs
:func:`warp_trilinear_plain` for CPU tensors; it never falls back from one
to the other. ``warp_trilinear.launches`` counts kernel launches.

The coordinate gradient (the TPU kernel's ``with_grad`` variant) is the
kernel's second entry, :func:`warp_coord_grad`, with the analytic plain
version :func:`warp_coord_grad_plain`; :func:`warp_trilinear_ad` wraps the
two in a ``torch.autograd.Function``. At a kink (a coordinate on an integer
or on a border clip) the gradient follows XLA's autodiff of
``liftreg_tpu/ops/resample.py:warp_image``, the path that the JAX
refinement differentiates: there ``d|t|/dt = 1`` at 0, ``max(0, y)`` and
``clip`` split the derivative in halves at a tie, and the z axis of f32
taps (``_trilinear_quad``) differentiates ``floor``-based weights. Plain
autograd of :func:`warp_trilinear_plain` uses other conventions and is not
the reference.

Each axis samples in one of three modes (:func:`axis_modes`), chosen from
the volume's shape as ``liftreg_tpu/ops/resample.py:grid_sample`` routes
it, so that a spatial dim of 1 is sampled and differentiated as in JAX:
``OCT`` (``_oct_plain``), ``QUAD`` (the z axis of ``_trilinear_quad``) and
``GENERIC`` (the generic gather path, taken when W or H is 1).
"""
from __future__ import annotations

import torch

from . import _build

TAPS_DTYPES = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)


#: the axis modes of csrc/warp_trilinear.cu
OCT, QUAD, GENERIC = 0, 1, 2


def axis_modes(spatial, quad_z):
    """Modes of the (z, y, x) axes for a volume of ``spatial`` (D, W, H):
    JAX's generic path (every axis ``GENERIC``) when W or H is 1, else
    ``OCT`` on y and x and on z ``QUAD`` when D is 1 or ``quad_z`` (the
    coordinate gradient of f32 taps), ``OCT`` otherwise."""
    D, W, H = (int(n) for n in spatial)
    if W < 2 or H < 2:
        return (GENERIC,) * 3
    return (QUAD if quad_z or D < 2 else OCT, OCT, OCT)


def _packed(modes):
    return modes[0] | modes[1] << 2 | modes[2] << 4


def _clip_grad(c, hi):
    """d clip(c, 0, hi)/dc under JAX's convention: 1/2 at either bound."""
    inside = ((c > 0) & (c < hi)).float()
    return inside + 0.5 * ((c == 0) | (c == hi)).float()


def _relu_grad(y):
    return (y > 0).float() + 0.5 * (y == 0).float()


def _abs_grad(t):
    return torch.where(t >= 0, 1.0, -1.0)


def _axis(c, n, border, mode, grad):
    """Tap indices, weights and (with ``grad``, else None) the weights'
    derivatives along one axis in ``mode`` (see the module docstring), as
    the kernel computes them."""
    cg = torch.ones_like(c)
    if border and mode != GENERIC:
        if grad:
            cg = _clip_grad(c, n - 1.0)
        c = c.clamp(0.0, n - 1.0)
    if mode == OCT:
        s = torch.floor(c).clamp(0, n - 2)
        t = c - s
        y0, y1 = 1.0 - t.abs(), 1.0 - (t - 1.0).abs()
        idx = (s.long(), s.long() + 1)
        weights = (y0.clamp(min=0.0), y1.clamp(min=0.0))
        if not grad:
            return idx, weights, None
        grads = (-_abs_grad(t) * _relu_grad(y0) * cg,
                 -_abs_grad(t - 1.0) * _relu_grad(y1) * cg)
        return idx, weights, grads
    z0 = torch.floor(c)
    f = c - z0
    k0 = z0.long()
    if border:
        m0 = m1 = torch.ones_like(c)
    else:
        m0 = ((k0 >= 0) & (k0 <= n - 1)).float()
        m1 = ((k0 + 1 >= 0) & (k0 + 1 <= n - 1)).float()
    idx = (k0.clamp(0, n - 1), (k0 + 1).clamp(0, n - 1))
    grads = (-m0 * cg, m1 * cg) if grad else None
    return idx, ((1.0 - f) * m0, f * m1), grads


def _axes(taps, coords, border, quad_z, grad):
    c = coords.float()
    modes = axis_modes(taps.shape[2:], quad_z)
    return [_axis(c[..., d], n, border, mode, grad)
            for d, (n, mode) in enumerate(zip(taps.shape[2:], modes))]


def warp_trilinear_plain(taps, coords, border):
    """taps (B, C, D, W, H) bf16/f32, coords (B, M, 3) f32 pixel (z, y, x)
    -> (B, C, M) f32. Border padding clips the coordinates first; in the
    ``OCT`` mode starts are clip(floor(c), 0, n-2) and the weights
    relu(1-|t|), relu(1-|t-1|), so zeros padding falls out of vanishing
    weights; corners are summed in (dz, dy, dx) order in f32."""
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    (iz, wz, _), (iy, wy, _), (ix, wx, _) = _axes(taps, coords, border,
                                                  quad_z=False, grad=False)
    v = taps.reshape(B, C, D * W * H)
    out = torch.zeros((B, C, M), dtype=torch.float32, device=taps.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = ((iz[dz] * W + iy[dy]) * H + ix[dx])[:, None, :]
                rows = torch.gather(v, 2, idx.expand(B, C, M)).float()
                out = out + rows * (wz[dz] * wy[dy] * wx[dx])[:, None, :]
    return out


def _check(taps, coords, name, **more):
    """Device, dtypes and shapes of a call. ``more`` holds further f32
    operands (the cotangent)."""
    _build.inputs_device(name, {"taps": taps, "coords": coords, **more},
                         {"taps": TAPS_DTYPES, "coords": _F32, "g": _F32})
    if taps.dim() != 5 or coords.dim() != 3 or coords.shape[-1] != 3 \
            or coords.shape[0] != taps.shape[0]:
        raise ValueError(f"{name}: want taps (B, C, D, W, H) and "
                         f"coords (B, M, 3); got {tuple(taps.shape)}, "
                         f"{tuple(coords.shape)}")
    if min(taps.shape[2:]) < 1:
        raise ValueError(f"{name}: empty volume {tuple(taps.shape[2:])}")
    if taps.dtype not in TAPS_DTYPES or coords.dtype != torch.float32:
        raise TypeError(f"{name}: want bf16/f32 taps and f32 coords; got "
                        f"{taps.dtype}, {coords.dtype}")


def warp_trilinear(taps, coords, border):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(taps, coords, "warp_trilinear")
    if taps.device.type == "cpu":
        return warp_trilinear_plain(taps, coords, border)
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    out = torch.empty((B, C, M), dtype=torch.float32, device=taps.device)
    lib = _build.library()
    with torch.cuda.device(taps.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_warp_trilinear(
            taps.data_ptr(), int(taps.dtype == torch.bfloat16),
            coords.data_ptr(), out.data_ptr(), B, C, D, W, H, M, int(border),
            _packed(axis_modes((D, W, H), quad_z=False)), stream)
    _build.check(rc, "warp_trilinear")
    warp_trilinear.launches += 1
    return out


warp_trilinear.launches = 0


def warp_coord_grad_plain(taps, coords, g, border):
    """taps (B, C, D, W, H) bf16/f32, coords (B, M, 3) f32, cotangent g
    (B, C, M) f32 -> dcoords (B, M, 3) f32, the gradient of
    ``sum(g * warp_trilinear(taps, coords, border))`` with respect to the
    coordinates, at kinks as XLA's autodiff of the JAX warp gives it."""
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    axes = _axes(taps, coords, border, quad_z=taps.dtype == torch.float32,
                 grad=True)
    v = taps.reshape(B, C, D * W * H)
    g = g.float()
    grad = [torch.zeros((B, M), dtype=torch.float32, device=taps.device)
            for _ in range(3)]
    for a in (0, 1):
        for b in (0, 1):
            for e in (0, 1):
                (iz, wz, dz), (iy, wy, dy), (ix, wx, dx) = [
                    (idx[k], w[k], dw[k])
                    for (idx, w, dw), k in zip(axes, (a, b, e))]
                flat = ((iz * W + iy) * H + ix)[:, None, :]
                gt = (g * torch.gather(v, 2, flat.expand(B, C, M)).float()
                      ).sum(dim=1)
                grad[0] = grad[0] + gt * (dz * wy * wx)
                grad[1] = grad[1] + gt * (wz * dy * wx)
                grad[2] = grad[2] + gt * (wz * wy * dx)
    return torch.stack(grad, dim=-1)


def check_grad_offsets(taps_shape, M):
    """Raise ``ValueError`` unless the coordinate-gradient kernel's 32-bit
    offsets hold for taps of ``taps_shape`` (B, C, D, W, H) and M points:
    it indexes one (b, c) volume and one batch element's points in 32 bits
    (D*W*H < 2^31, M < 2^31 - 2^16) and takes b from the grid's second
    dimension (B < 2^16)."""
    B, C, D, W, H = (int(n) for n in taps_shape)
    if D * W * H >= 2 ** 31 or M >= 2 ** 31 - 2 ** 16 or B >= 2 ** 16:
        raise ValueError(f"warp_coord_grad: taps {tuple(taps_shape)} and "
                         f"{M} points exceed the kernel's 32-bit offsets")


def warp_coord_grad(taps, coords, g, border):
    """The coordinate-gradient kernel on CUDA tensors, the plain version on
    CPU tensors. ``warp_coord_grad.launches`` counts kernel launches."""
    _check(taps, coords, "warp_coord_grad", g=g)
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    if g.shape != (B, C, M) or g.dtype != torch.float32:
        raise ValueError(f"warp_coord_grad: want an f32 cotangent of shape "
                         f"{(B, C, M)}; got {tuple(g.shape)} {g.dtype}")
    if taps.device.type == "cpu":
        return warp_coord_grad_plain(taps, coords, g, border)
    check_grad_offsets(taps.shape, M)
    dcoords = torch.empty((B, M, 3), dtype=torch.float32, device=taps.device)
    lib = _build.library()
    with torch.cuda.device(taps.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_warp_coord_grad(
            taps.data_ptr(), int(taps.dtype == torch.bfloat16),
            coords.data_ptr(), g.data_ptr(), dcoords.data_ptr(), B, C, D, W,
            H, M, int(border),
            _packed(axis_modes((D, W, H), taps.dtype == torch.float32)),
            stream)
    _build.check(rc, "warp_coord_grad")
    warp_coord_grad.launches += 1
    return dcoords


warp_coord_grad.launches = 0


class _WarpTrilinear(torch.autograd.Function):
    """Forward :func:`warp_trilinear`, backward :func:`warp_coord_grad`;
    differentiable in the coordinates only."""

    @staticmethod
    def forward(ctx, taps, coords, border):
        ctx.save_for_backward(taps, coords)
        ctx.border = border
        return warp_trilinear(taps, coords, border)

    @staticmethod
    def backward(ctx, g):
        taps, coords = ctx.saved_tensors
        dcoords = None
        if ctx.needs_input_grad[1]:
            dcoords = warp_coord_grad(taps, coords, g.contiguous(),
                                      ctx.border)
        return None, dcoords, None


def warp_trilinear_ad(taps, coords, border):
    """:func:`warp_trilinear`, differentiable with respect to ``coords``.
    Raises if ``taps`` requires grad: the image gradient is not ported
    (the TPU kernel returns NaN for it)."""
    if taps.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "warp_trilinear_ad: the gradient with respect to the image is "
            "not ported (ROADMAP B3); detach the image")
    if coords.requires_grad and torch.is_grad_enabled():
        return _WarpTrilinear.apply(taps, coords, border)
    return warp_trilinear(taps, coords, border)
