"""Trilinear resampling (the spatial-transformer core), PyTorch port of
``liftreg_tpu/ops/resample.py`` for the 3D bilinear case.

Semantics are ``align_corners=True`` with ``zeros`` / ``border`` padding;
``phi`` follows :mod:`liftreg_tpu_torch.coords` (channel ``c`` indexes
spatial axis ``c``). On CUDA tensors the sampling is the Hopper kernel of
:mod:`.warp_kernel`; on CPU tensors its plain version. The sampling is
differentiable with respect to the coordinates (and so to ``phi``), through
the kernel's coordinate-gradient entry; not with respect to the image.
"""
from __future__ import annotations

import torch

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


def warp_image(image, phi, zero_boundary=True, scale_intensity=True,
               taps_dtype=None):
    """Warp ``image`` (B, C, D, W, H) by the normalized map ``phi``
    (B, 3, D, W, H); channel ``c`` of ``phi`` indexes spatial axis ``c``.

    zero_boundary: zeros padding if True, else border.
    scale_intensity: shift [-1, 1] intensities to [0, 1] around the warp,
    so zeros padding maps to the -1 background."""
    grid = phi.movedim(1, -1)
    padding = "zeros" if zero_boundary else "border"
    if scale_intensity:
        out = grid_sample_normalized((image + 1.0) * 0.5, grid,
                                     padding=padding, taps_dtype=taps_dtype)
        return out * 2.0 - 1.0
    return grid_sample_normalized(image, grid, padding=padding,
                                  taps_dtype=taps_dtype)
