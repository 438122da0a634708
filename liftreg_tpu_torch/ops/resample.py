"""Trilinear resampling (the spatial-transformer core), PyTorch port of
``liftreg_tpu/ops/resample.py`` for the 3D bilinear case.

Semantics are ``align_corners=True`` with ``zeros`` / ``border`` padding;
``phi`` follows :mod:`liftreg_tpu_torch.coords` (channel ``c`` indexes
spatial axis ``c``). On CUDA tensors the sampling is the Hopper kernel of
:mod:`.warp_kernel`; on CPU tensors its plain version. :func:`warp_image`
hands the kernel phi in its (B, 3, D, W, H) layout, so on the card no
coordinate buffer, no ``(phi + 1) * scale`` and no ``out * 2 - 1`` pass
is made; its tap tensor comes from :func:`warp_taps`, which a caller that
warps one image many times (the refinement) builds once and passes to
:func:`warp_with_taps`. :func:`grid_sample` takes pixel coordinates
(B, *out_shape, 3). The sampling is differentiable with respect to the
coordinates (and so to ``phi``), through the kernel's coordinate-gradient
entry, and with respect to the image, through its image-gradient entry
(with bf16 taps summed in f32 and cast to bf16 once).
``warp_image(..., mode="nearest")`` (the trainer's warp of label maps) is a
plain gather, :func:`grid_sample_nearest`, on either device.
:func:`resize_nearest_2d` and :func:`resize_trilinear` are the JAX
package's resizes, for the lift of ``LiftRegSubspace`` and the decoder of
``RegNet2D3D``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_dtype
from .warp_kernel import warp_trilinear_ad


def _taps_dtype(taps_dtype, spatial):
    """The tap storage type, as ``liftreg_tpu.ops.resample.grid_sample``
    routes it: bf16 (given as a dtype or its name, e.g. ``"bfloat16"``
    from a JSON config) when every spatial dim is >= 2, else f32, the type
    of JAX's quad and generic paths."""
    if resolve_dtype(taps_dtype, "taps_dtype") == torch.bfloat16 \
            and min(spatial) >= 2:
        return torch.bfloat16
    return torch.float32


def grid_sample(vol, coords, padding="zeros", taps_dtype=None):
    """Sample ``vol`` (B, C, D, W, H) at pixel ``coords`` (B, *out_shape, 3),
    ``coords[..., d]`` indexing spatial axis ``d`` (NOT torch's reversed
    order). ``taps_dtype`` bf16 (or ``"bfloat16"``) stores the taps in bf16
    (the serving warp) when no spatial dim is 1; otherwise the taps are
    f32. Weights and sums are f32. Returns ``(B, C, *out_shape)`` f32."""
    if padding not in ("zeros", "border"):
        raise ValueError(f"padding {padding!r} not in ('zeros', 'border')")
    if vol.dim() != 5 or coords.shape[-1] != 3:
        raise ValueError(f"grid_sample handles 3D volumes only; got vol "
                         f"{tuple(vol.shape)}, coords {tuple(coords.shape)}")
    taps_dtype = _taps_dtype(taps_dtype, vol.shape[2:])
    B, C = vol.shape[:2]
    out_shape = coords.shape[1:-1]
    out = warp_trilinear_ad(vol.to(taps_dtype).contiguous(),
                            coords.reshape(B, -1, 3).float().contiguous(),
                            border=padding == "border")
    return out.reshape(B, C, *out_shape)


def grid_sample_normalized(vol, grid, padding="zeros", taps_dtype=None):
    """Like :func:`grid_sample` but ``grid`` holds [-1, 1] normalized
    coordinates (align_corners=True), ``grid[..., d]`` indexing axis ``d``."""
    scale = torch.tensor([(n - 1) * 0.5 for n in vol.shape[2:]],
                         dtype=grid.dtype, device=grid.device)
    return grid_sample(vol, (grid + 1.0) * scale, padding=padding,
                       taps_dtype=taps_dtype)


def warp_taps(image, scale_intensity=True, taps_dtype=None):
    """The tap tensor that :func:`warp_with_taps` samples: ``image``
    (B, C, D, W, H) shifted from [-1, 1] to [0, 1] with
    ``scale_intensity``, in the tap type of :func:`grid_sample`'s
    ``taps_dtype`` rule, contiguous."""
    taps_dtype = _taps_dtype(taps_dtype, image.shape[2:])
    if scale_intensity:
        image = (image + 1.0) * 0.5
    return image.to(taps_dtype).contiguous()


def warp_with_taps(taps, phi, zero_boundary=True, scale_intensity=True):
    """:func:`warp_image` of the image whose :func:`warp_taps` are ``taps``
    (built with the same ``scale_intensity``)."""
    return warp_trilinear_ad(taps, phi.contiguous(),
                             border=not zero_boundary, normalized=True,
                             scale_intensity=scale_intensity)


def grid_sample_nearest(vol, coords, padding="zeros"):
    """Nearest-neighbour sampling of ``vol`` (B, C, D, W, H) at pixel
    ``coords`` (B, *out_shape, 3), ``coords[..., d]`` indexing axis ``d``:
    the voxel ``floor(x + 0.5)`` per axis (half-integers round up), as
    ``liftreg_tpu.ops.resample.grid_sample(mode="nearest")`` takes it;
    outside the volume zero (``"zeros"``) or the clamped voxel
    (``"border"``). ``F.grid_sample(mode="nearest")`` rounds half to even,
    so it is not used. Returns ``(B, C, *out_shape)`` in ``vol``'s dtype."""
    if padding not in ("zeros", "border"):
        raise ValueError(f"padding {padding!r} not in ('zeros', 'border')")
    B, C = vol.shape[:2]
    spatial = vol.shape[2:]
    out_shape = coords.shape[1:-1]
    c = coords.reshape(B, -1, 3).float()
    flat = torch.zeros(c.shape[:-1], dtype=torch.int64, device=vol.device)
    inside = torch.ones(c.shape[:-1], dtype=torch.bool, device=vol.device)
    stride = 1
    for d in reversed(range(3)):
        n = spatial[d]
        idx = torch.floor(c[..., d] + 0.5).long()
        inside &= (idx >= 0) & (idx <= n - 1)
        flat += idx.clamp(0, n - 1) * stride
        stride *= n
    out = torch.gather(vol.reshape(B, C, -1), 2,
                       flat[:, None, :].expand(B, C, flat.shape[1]))
    if padding == "zeros":
        out = out * inside[:, None, :].to(out.dtype)
    return out.reshape(B, C, *out_shape)


def warp_image(image, phi, zero_boundary=True, scale_intensity=True,
               taps_dtype=None, mode="bilinear"):
    """Warp ``image`` (B, C, D, W, H) by the normalized map ``phi``
    (B, 3, D, W, H); channel ``c`` of ``phi`` indexes spatial axis ``c``.

    zero_boundary: zeros padding if True, else border.
    scale_intensity: shift [-1, 1] intensities to [0, 1] around the warp,
    so zeros padding maps to the -1 background.
    mode: ``"bilinear"`` (trilinear, the kernel) or ``"nearest"``
    (:func:`grid_sample_nearest`, which ignores ``taps_dtype``)."""
    if mode == "nearest":
        # the pixel coordinates as the JAX package makes them, in f32
        scale = phi.new_tensor([(n - 1) * 0.5 for n in image.shape[2:]])
        coords = (phi.movedim(1, -1) + 1.0) * scale
        padding = "zeros" if zero_boundary else "border"
        if scale_intensity:
            return grid_sample_nearest((image + 1.0) * 0.5, coords,
                                       padding) * 2.0 - 1.0
        return grid_sample_nearest(image, coords, padding)
    if mode != "bilinear":
        raise ValueError(f"mode {mode!r} not in ('bilinear', 'nearest')")
    return warp_with_taps(warp_taps(image, scale_intensity, taps_dtype), phi,
                          zero_boundary, scale_intensity)


def resize_nearest_2d(img, out_hw):
    """``img`` (B, C, H, W) -> (B, C, *out_hw), the source index of output
    row i ``floor(i * (H / out_h))`` with the product in f32, as
    ``liftreg_tpu.ops.resample.resize_nearest_2d`` computes it (torch's
    ``F.interpolate(mode="nearest")`` rounds its index arithmetic
    otherwise)."""
    H, W = img.shape[2:]
    oh, ow = (int(n) for n in out_hw)

    def src(n_out, n_in):
        i = torch.arange(n_out, dtype=torch.float32, device=img.device)
        # the scalar is rounded to f32 first, as JAX's weak type is
        return torch.floor(i * (n_in / n_out)).long()

    return img[:, :, src(oh, H)[:, None], src(ow, W)[None, :]]


def resize_trilinear(vol, out_shape):
    """Trilinear resize of ``vol`` (B, C, D, W, H) to ``out_shape`` with
    ``align_corners=True``: ``F.interpolate(mode="trilinear")``, one pass.
    ``liftreg_tpu.ops.resample.resize_trilinear`` takes the same 2-tap
    weights per axis as three matrix products, so the two round
    differently, by about an ulp (tests/test_torch_regnet.py)."""
    out_shape = tuple(int(n) for n in out_shape)
    if out_shape == tuple(vol.shape[2:]):
        return vol
    return F.interpolate(vol, size=out_shape, mode="trilinear",
                         align_corners=True)
