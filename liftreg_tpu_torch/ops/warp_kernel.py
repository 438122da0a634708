"""Trilinear warp: the Hopper kernel and its plain PyTorch version.

The kernel (``csrc/warp_trilinear.cu``) replaces the forward of
``liftreg_tpu/ops/pallas_warp.py:_warp_plane_kernel`` with the semantics of
``liftreg_tpu/ops/resample.py:_oct_plain``, exact for any field (the TPU
kernel clamps outside its (dy, dx) window). It takes its points in one of
two layouts: pixel coordinates (B, M, 3), ``grid_sample``'s points, or
(``normalized=True``) the normalized map phi (B, 3, *out_shape) where it
lies, which ``warp_image`` passes: the kernel then makes the pixel
coordinates in registers as the glue ``(phi + 1) * (n - 1) / 2`` rounds
them, and with ``scale_intensity`` returns ``out * 2 - 1``, so no
coordinate buffer and no rescale pass exist on the card. It is bound by
bytes: phi, the taps and the f32 output, ~0.30 GB or ~0.088 ms of the
card's memory rate at the 160^3 serving shape with B=4 and bf16 taps. A
thread computes 4 points (2 with f32 taps) 32 apart, so that each of a
warp's loads reads neighbouring addresses.

:func:`warp_trilinear` launches the kernel for CUDA tensors and runs
:func:`warp_trilinear_plain` (the glue and the gather, as the port ran
them before the kernel read phi) for CPU tensors; it never falls back from
one to the other. It is the ``torch.library`` operator
``liftreg::warp_trilinear`` (:mod:`._library`); the gradients' entries are
plain calls. ``warp_trilinear.launches`` counts kernel launches in
either layout.

The coordinate gradient (the TPU kernel's ``with_grad`` variant) is the
kernel's second entry, :func:`warp_coord_grad`, in the same two layouts,
with the analytic plain version :func:`warp_coord_grad_plain`;
:func:`warp_trilinear_ad` wraps the two in a ``torch.autograd.Function``.
At a kink (a coordinate on an integer or on a border clip) the gradient
follows XLA's autodiff of ``liftreg_tpu/ops/resample.py:warp_image``, the
path that the JAX refinement differentiates: there ``d|t|/dt = 1`` at 0,
``max(0, y)`` and ``clip`` split the derivative in halves at a tie, and the
z axis of f32 taps (``_trilinear_quad``) differentiates ``floor``-based
weights. Plain autograd of :func:`warp_trilinear_plain` uses other
conventions and is not the reference.

The gradient with respect to the taps (no TPU kernel computes it: the
TPU kernel's ``with_grad`` returns NaN for the image) is the kernel's third
entry, :func:`warp_image_grad`, in the same two layouts, with the plain
version :func:`warp_image_grad_plain`: the scatter-add of ``g * w`` into
the 8 taps of each point, with the forward's taps and weights, as XLA's
autodiff of ``liftreg_tpu/ops/resample.py`` gives it: for f32 taps with
the z axis of ``_trilinear_quad`` (``_quad_plain``), for bf16 taps with the
oct weights of ``_oct_plain`` on every axis, summed in f32 and cast to bf16
once, as ``_oct_sample_bwd`` casts it (JAX's default path scatter-adds in
bf16 instead: within a bf16 tolerance of this,
``tests/test_torch_warp_image_grad.py``). The image gradient never reads
the taps, so one kernel serves both tap types. The kernel sums a tile of
points' terms in shared memory and adds each tap of the tile's box to
device memory once (a tile whose box overflows adds its terms there
directly, counted in :func:`image_grad_overflow`); both sums use f32
atomics, so their order, and their last bits, change from call to call.

Each axis samples in one of three modes (:func:`axis_modes`), chosen from
the volume's shape as ``liftreg_tpu/ops/resample.py:grid_sample`` routes
it, so that a spatial dim of 1 is sampled and differentiated as in JAX:
``OCT`` (``_oct_plain``), ``QUAD`` (the z axis of ``_trilinear_quad``) and
``GENERIC`` (the generic gather path, taken when W or H is 1).
"""
from __future__ import annotations

import math

import torch

from . import _build, _library

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


def _clamp(x, lo, hi):
    """``fminf(fmaxf(x, lo), hi)`` as the kernel clamps: NaN goes to ``lo``
    (``clamp`` would keep it, and a NaN index cannot gather)."""
    return x.clamp(lo, hi).nan_to_num(nan=lo)


def _axis(c, n, border, mode, grad):
    """Tap indices, weights and (with ``grad``, else None) the weights'
    derivatives along one axis in ``mode`` (see the module docstring), as
    the kernel computes them, NaN coordinates included (finite indices,
    NaN weights)."""
    cg = torch.ones_like(c)
    if border and mode != GENERIC:
        if grad:
            cg = _clip_grad(c, n - 1.0)
        c = _clamp(c, 0.0, n - 1.0)
    if mode == OCT:
        s = _clamp(torch.floor(c), 0.0, n - 2.0)
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
    # k0 only matters inside [-1, n]: the clamp is exact
    k0 = _clamp(z0, -2.0, n + 1.0).long()
    if border:
        m0 = m1 = torch.ones_like(c)
    else:
        m0 = ((k0 >= 0) & (k0 <= n - 1)).float()
        m1 = ((k0 + 1 >= 0) & (k0 + 1 <= n - 1)).float()
    idx = (k0.clamp(0, n - 1), (k0 + 1).clamp(0, n - 1))
    grads = (-m0 * cg, m1 * cg) if grad else None
    return idx, ((1.0 - f) * m0, f * m1), grads


def _axes(spatial, coords, border, quad_z, grad):
    c = coords.float()
    modes = axis_modes(spatial, quad_z)
    return [_axis(c[..., d], n, border, mode, grad)
            for d, (n, mode) in enumerate(zip(spatial, modes))]


def _scale(taps, like):
    """f32((n - 1) / 2) of each spatial axis of the volume, in ``like``'s
    dtype: the normalized-to-pixel factor of ``grid_sample_normalized``."""
    return torch.tensor([(n - 1) * 0.5 for n in taps.shape[2:]],
                        dtype=like.dtype, device=like.device)


def _pixel_coords(taps, phi):
    """The glue that the kernel folds in: phi (B, 3, *out_shape) normalized
    -> (B, M, 3) f32 pixel coordinates ``(phi + 1) * (n - 1) / 2``."""
    grid = phi.movedim(1, -1)
    return ((grid + 1.0) * _scale(taps, grid)).reshape(
        phi.shape[0], -1, 3).float()


def _gather_sum(taps, coords, border):
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    (iz, wz, _), (iy, wy, _), (ix, wx, _) = _axes(taps.shape[2:], coords,
                                                  border, quad_z=False,
                                                  grad=False)
    v = taps.reshape(B, C, D * W * H)
    out = torch.zeros((B, C, M), dtype=torch.float32, device=taps.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = ((iz[dz] * W + iy[dy]) * H + ix[dx])[:, None, :]
                rows = torch.gather(v, 2, idx.expand(B, C, M)).float()
                out = out + rows * (wz[dz] * wy[dy] * wx[dx])[:, None, :]
    return out


def warp_trilinear_plain(taps, coords, border, normalized=False,
                         scale_intensity=False):
    """taps (B, C, D, W, H) bf16/f32 sampled at coords (B, M, 3) f32 pixel
    (z, y, x) -> (B, C, M) f32, or with ``normalized`` at phi
    (B, 3, *out_shape) normalized -> (B, C, *out_shape), then with
    ``scale_intensity`` ``out * 2 - 1``. Border padding clips the
    coordinates first; in the ``OCT`` mode starts are clip(floor(c), 0,
    n-2) and the weights relu(1-|t|), relu(1-|t-1|), so zeros padding falls
    out of vanishing weights; corners are summed in (dz, dy, dx) order in
    f32."""
    if not normalized:
        return _gather_sum(taps, coords, border)
    out = _gather_sum(taps, _pixel_coords(taps, coords), border)
    if scale_intensity:
        out = out * 2.0 - 1.0
    return out.reshape(taps.shape[:2] + coords.shape[2:])


def _points(taps, coords, normalized, name):
    """M, the number of points of a call, after checking the points'
    shape against the taps'."""
    B = taps.shape[0]
    if normalized:
        ok = coords.dim() >= 3 and coords.shape[:2] == (B, 3)
        want = "phi (B, 3, *out_shape)"
    else:
        ok = coords.dim() == 3 and coords.shape[::2] == (B, 3)
        want = "coords (B, M, 3)"
    if taps.dim() != 5 or not ok:
        raise ValueError(f"{name}: want taps (B, C, D, W, H) and {want}; "
                         f"got {tuple(taps.shape)}, {tuple(coords.shape)}")
    if min(taps.shape[2:]) < 1:
        raise ValueError(f"{name}: empty volume {tuple(taps.shape[2:])}")
    if taps.dtype not in TAPS_DTYPES or coords.dtype != torch.float32:
        raise TypeError(f"{name}: want bf16/f32 taps and f32 coordinates; "
                        f"got {taps.dtype}, {coords.dtype}")
    return math.prod(coords.shape[2:]) if normalized else coords.shape[1]


def _check(taps, coords, name, normalized, scale_intensity, **more):
    """Device, dtypes and shapes of a call; returns M. ``more`` holds
    further f32 operands (the cotangent)."""
    _build.inputs_device(name, {"taps": taps, "coords": coords, **more},
                         {"taps": TAPS_DTYPES, "coords": _F32, "g": _F32})
    if scale_intensity and not normalized:
        raise ValueError(f"{name}: scale_intensity needs normalized "
                         "coordinates (phi)")
    return _points(taps, coords, normalized, name)


def check_offsets(taps_shape, M):
    """Raise ``ValueError`` unless the warp kernels' 32-bit offsets hold
    for taps of ``taps_shape`` (B, C, D, W, H) and M points: they index
    one (b, c) volume and one batch element's points in 32 bits
    (D*W*H < 2^31, M < 2^31 - 2^16) and take b from the grid's second
    dimension (B < 2^16)."""
    B, C, D, W, H = (int(n) for n in taps_shape)
    if D * W * H >= 2 ** 31 or M >= 2 ** 31 - 2 ** 16 or B >= 2 ** 16:
        raise ValueError(f"warp kernels: taps {tuple(taps_shape)} and {M} "
                         "points exceed the kernels' 32-bit offsets")


def _warp_impl(taps, coords, border, normalized, scale_intensity):
    """``liftreg::warp_trilinear`` on the CPU (the plain version) and on
    CUDA (the kernel)."""
    M = _check(taps, coords, "warp_trilinear", normalized, scale_intensity)
    if taps.device.type == "cpu":
        return warp_trilinear_plain(taps, coords, border, normalized,
                                    scale_intensity)
    check_offsets(taps.shape, M)
    B, C, D, W, H = taps.shape
    out_shape = coords.shape[2:] if normalized else (M,)
    out = torch.empty((B, C) + tuple(out_shape), dtype=torch.float32,
                      device=taps.device)
    lib = _build.library()
    args = (taps.data_ptr(), int(taps.dtype == torch.bfloat16),
            coords.data_ptr(), out.data_ptr(), B, C, D, W, H, M, int(border),
            _packed(axis_modes((D, W, H), quad_z=False)))
    with torch.cuda.device(taps.device):
        stream = torch.cuda.current_stream().cuda_stream
        if normalized:
            rc = lib.liftreg_warp_trilinear_phi(*args, int(scale_intensity),
                                                stream)
        else:
            rc = lib.liftreg_warp_trilinear(*args, stream)
    _build.check(rc, "warp_trilinear")
    warp_trilinear.launches += 1
    return out


def _warp_fake(taps, coords, border, normalized, scale_intensity):
    if scale_intensity and not normalized:
        raise ValueError("warp_trilinear: scale_intensity needs normalized "
                         "coordinates (phi)")
    M = _points(taps, coords, normalized, "warp_trilinear")
    out_shape = tuple(coords.shape[2:]) if normalized else (M,)
    return taps.new_empty(tuple(taps.shape[:2]) + out_shape,
                          dtype=torch.float32)


_library.define("warp_trilinear(Tensor taps, Tensor coords, bool border, "
                "bool normalized, bool scale_intensity) -> Tensor",
                _warp_impl, _warp_fake)


def warp_trilinear(taps, coords, border, normalized=False,
                   scale_intensity=False):
    """:func:`warp_trilinear_plain`'s function: the kernel on CUDA tensors,
    the plain version on CPU tensors; the operator
    ``liftreg::warp_trilinear``. ``scale_intensity`` needs
    ``normalized``."""
    return torch.ops.liftreg.warp_trilinear(taps, coords, bool(border),
                                            bool(normalized),
                                            bool(scale_intensity))


warp_trilinear.launches = 0


def _coord_grad_sum(taps, coords, g, border):
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    axes = _axes(taps.shape[2:], coords, border,
                 quad_z=taps.dtype == torch.float32, grad=True)
    v = taps.reshape(B, C, D * W * H)
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


def warp_coord_grad_plain(taps, coords, g, border, normalized=False,
                          scale_intensity=False):
    """taps (B, C, D, W, H) bf16/f32, coords (B, M, 3) f32 and a cotangent
    g (B, C, M) f32 -> dcoords (B, M, 3) f32, the gradient of
    ``sum(g * warp_trilinear(taps, coords, border))`` with respect to the
    coordinates, at kinks as XLA's autodiff of the JAX warp gives it. With
    ``normalized``, phi (B, 3, *out_shape) and g (B, C, *out_shape) ->
    dphi (B, 3, *out_shape), as autograd carries the gradient back through
    the glue of :func:`warp_trilinear_plain` (g doubled under
    ``scale_intensity``, dcoords times (n - 1) / 2)."""
    B, C = taps.shape[:2]
    g = g.float().reshape(B, C, -1)
    if not normalized:
        return _coord_grad_sum(taps, coords, g, border)
    if scale_intensity:
        g = g * 2.0
    dcoords = _coord_grad_sum(taps, _pixel_coords(taps, coords), g, border)
    grid_shape = (B,) + coords.shape[2:] + (3,)
    return (dcoords.reshape(grid_shape) * _scale(taps, dcoords)).movedim(
        -1, 1).contiguous()


def warp_coord_grad(taps, coords, g, border, normalized=False,
                    scale_intensity=False):
    """The coordinate-gradient kernel on CUDA tensors, the plain version on
    CPU tensors. ``warp_coord_grad.launches`` counts kernel launches."""
    M = _check(taps, coords, "warp_coord_grad", normalized, scale_intensity,
               g=g)
    B, C, D, W, H = taps.shape
    g_shape = (B, C) + (tuple(coords.shape[2:]) if normalized else (M,))
    if g.shape != g_shape or g.dtype != torch.float32:
        raise ValueError(f"warp_coord_grad: want an f32 cotangent of shape "
                         f"{g_shape}; got {tuple(g.shape)} {g.dtype}")
    if taps.device.type == "cpu":
        return warp_coord_grad_plain(taps, coords, g, border, normalized,
                                     scale_intensity)
    check_offsets(taps.shape, M)
    dcoords = torch.empty_like(coords)
    lib = _build.library()
    args = (taps.data_ptr(), int(taps.dtype == torch.bfloat16),
            coords.data_ptr(), g.data_ptr(), dcoords.data_ptr(), B, C, D, W,
            H, M, int(border),
            _packed(axis_modes((D, W, H), taps.dtype == torch.float32)))
    with torch.cuda.device(taps.device):
        stream = torch.cuda.current_stream().cuda_stream
        if normalized:
            rc = lib.liftreg_warp_coord_grad_phi(*args, int(scale_intensity),
                                                 stream)
        else:
            rc = lib.liftreg_warp_coord_grad(*args, stream)
    _build.check(rc, "warp_coord_grad")
    warp_coord_grad.launches += 1
    return dcoords


warp_coord_grad.launches = 0


def _image_grad_sum(taps, coords, g, border):
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    (iz, wz, _), (iy, wy, _), (ix, wx, _) = _axes(
        taps.shape[2:], coords, border,
        quad_z=taps.dtype == torch.float32, grad=False)
    dtaps = torch.zeros((B, C, D * W * H), dtype=torch.float32,
                        device=g.device)
    for dz in (0, 1):
        gz = g * wz[dz][:, None, :]
        for dy in (0, 1):
            for dx in (0, 1):
                idx = ((iz[dz] * W + iy[dy]) * H + ix[dx])[:, None, :]
                dtaps.scatter_add_(2, idx.expand(B, C, M),
                                   gz * (wy[dy] * wx[dx])[:, None, :])
    return dtaps.reshape(taps.shape)


def warp_image_grad_plain(taps, coords, g, border, normalized=False,
                          scale_intensity=False):
    """taps (B, C, D, W, H) bf16/f32 (read for their shape and type only),
    coords (B, M, 3) f32 and a cotangent g (B, C, M) f32 -> dtaps
    (B, C, D, W, H) in the taps' type, the gradient of
    ``sum(g * warp_trilinear(taps, coords, border))`` with respect to the
    taps: each point adds ``(g * w_z) * (w_y * w_x)`` to each of its 8
    taps in f32, with the z axis of ``_trilinear_quad`` for f32 taps (their
    path in JAX) and the oct weights for bf16 taps, whose sums are cast to
    bf16 once. With ``normalized``, phi (B, 3, *out_shape) and g
    (B, C, *out_shape), through the glue of :func:`warp_trilinear_plain`
    (g doubled under ``scale_intensity``)."""
    B, C = taps.shape[:2]
    g = g.float().reshape(B, C, -1)
    if normalized:
        coords = _pixel_coords(taps, coords)
        if scale_intensity:
            g = g * 2.0
    return _image_grad_sum(taps, coords, g, border).to(taps.dtype)


def warp_image_grad(taps, coords, g, border, normalized=False,
                    scale_intensity=False):
    """The image-gradient kernel on CUDA tensors, the plain version on CPU
    tensors. ``warp_image_grad.launches`` counts kernel launches. With
    ``normalized`` and a 3-D out_shape the kernel tiles the output grid in
    3-D (a tile's taps then lie close together); other points go in runs of
    consecutive points. The kernel sums in f32 with the taps' axis modes;
    for bf16 taps its result is cast to bf16 once."""
    M = _check(taps, coords, "warp_image_grad", normalized, scale_intensity,
               g=g)
    B, C, D, W, H = taps.shape
    f32_taps = taps.dtype == torch.float32
    g_shape = (B, C) + (tuple(coords.shape[2:]) if normalized else (M,))
    if g.shape != g_shape or g.dtype != torch.float32:
        raise ValueError(f"warp_image_grad: want an f32 cotangent of shape "
                         f"{g_shape}; got {tuple(g.shape)} {g.dtype}")
    if taps.device.type == "cpu":
        return warp_image_grad_plain(taps, coords, g, border, normalized,
                                     scale_intensity)
    check_offsets(taps.shape, M)
    dtaps = torch.zeros(taps.shape, dtype=torch.float32, device=taps.device)
    lib = _build.library()
    ptrs = (coords.data_ptr(), g.data_ptr(), dtaps.data_ptr(),
            image_grad_overflow(taps.device).data_ptr(), B, C, D, W, H, M)
    flags = (int(border), _packed(axis_modes((D, W, H), quad_z=f32_taps)))
    with torch.cuda.device(taps.device):
        stream = torch.cuda.current_stream().cuda_stream
        if normalized:
            out_shape = tuple(coords.shape[2:])
            grid = out_shape if len(out_shape) == 3 else (0, 0, 0)
            rc = lib.liftreg_warp_image_grad_phi(
                *ptrs, *grid, *flags, int(scale_intensity), stream)
        else:
            rc = lib.liftreg_warp_image_grad(*ptrs, *flags, stream)
    _build.check(rc, "warp_image_grad")
    warp_image_grad.launches += 1
    return dtaps if f32_taps else dtaps.to(taps.dtype)


warp_image_grad.launches = 0
_OVERFLOW = {}


def image_grad_overflow(device):
    """The image-gradient kernel's overflow counter on CUDA ``device``: one
    int64 to which each launch adds the points of every tile whose box of
    live taps did not fit the kernel's shared memory, and which therefore
    added their terms straight to device memory. Made zero at first use;
    callers that measure the share zero it themselves."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _OVERFLOW:
        _OVERFLOW[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _OVERFLOW[device]


class _WarpTrilinear(torch.autograd.Function):
    """Forward :func:`warp_trilinear`; backward :func:`warp_image_grad` for
    the taps and :func:`warp_coord_grad` for the coordinates, each only
    where its input needs it."""

    @staticmethod
    def forward(ctx, taps, coords, border, normalized, scale_intensity):
        ctx.save_for_backward(taps, coords)
        ctx.flags = (border, normalized, scale_intensity)
        return warp_trilinear(taps, coords, *ctx.flags)

    @staticmethod
    def backward(ctx, g):
        taps, coords = ctx.saved_tensors
        g = g.contiguous()
        dtaps = dcoords = None
        if ctx.needs_input_grad[0]:
            dtaps = warp_image_grad(taps, coords, g, *ctx.flags)
        if ctx.needs_input_grad[1]:
            dcoords = warp_coord_grad(taps, coords, g, *ctx.flags)
        return dtaps, dcoords, None, None, None


def warp_trilinear_ad(taps, coords, border, normalized=False,
                      scale_intensity=False):
    """:func:`warp_trilinear`, differentiable with respect to ``coords``
    (or phi) and ``taps``."""
    if not torch.is_grad_enabled() or not (taps.requires_grad
                                           or coords.requires_grad):
        return warp_trilinear(taps, coords, border, normalized,
                              scale_intensity)
    return _WarpTrilinear.apply(taps, coords, border, normalized,
                                scale_intensity)
