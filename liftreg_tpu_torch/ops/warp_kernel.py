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
"""
from __future__ import annotations

import torch

from . import _build

TAPS_DTYPES = (torch.bfloat16, torch.float32)


def warp_trilinear_plain(taps, coords, border):
    """taps (B, C, D, W, H) bf16/f32, coords (B, M, 3) f32 pixel (z, y, x)
    -> (B, C, M) f32. Border padding clips the coordinates first; starts
    are clip(floor(c), 0, n-2) and the weights relu(1-|t|), relu(1-|t-1|),
    so zeros padding falls out of vanishing weights; corners are summed in
    (dz, dy, dx) order in f32."""
    B, C, D, W, H = taps.shape
    M = coords.shape[1]
    c = coords.float()
    if border:
        hi = torch.tensor([D - 1, W - 1, H - 1], dtype=torch.float32,
                          device=c.device)
        c = torch.minimum(c.clamp(min=0.0), hi)
    starts, weights = [], []
    for d, n in enumerate((D, W, H)):
        cd = c[..., d]
        s = torch.floor(cd).clamp(0, n - 2)
        t = cd - s
        starts.append(s.long())
        weights.append(((1.0 - t.abs()).clamp(min=0.0),
                        (1.0 - (t - 1.0).abs()).clamp(min=0.0)))
    base = (starts[0] * W + starts[1]) * H + starts[2]          # (B, M)
    v = taps.reshape(B, C, D * W * H)
    wz, wy, wx = weights
    out = torch.zeros((B, C, M), dtype=torch.float32, device=taps.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = (base + (dz * W + dy) * H + dx)[:, None, :]
                rows = torch.gather(v, 2, idx.expand(B, C, M)).float()
                out = out + rows * (wz[dz] * wy[dy] * wx[dx])[:, None, :]
    return out


def warp_trilinear(taps, coords, border):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if taps.device != coords.device:
        raise ValueError(f"warp_trilinear: taps on {taps.device}, coords on "
                         f"{coords.device}")
    if taps.dim() != 5 or coords.dim() != 3 or coords.shape[-1] != 3 \
            or coords.shape[0] != taps.shape[0]:
        raise ValueError(f"warp_trilinear: want taps (B, C, D, W, H) and "
                         f"coords (B, M, 3); got {tuple(taps.shape)}, "
                         f"{tuple(coords.shape)}")
    B, C, D, W, H = taps.shape
    if min(D, W, H) < 2:
        raise ValueError(f"warp_trilinear: spatial dims {(D, W, H)} must "
                         "be >= 2")
    if taps.dtype not in TAPS_DTYPES or coords.dtype != torch.float32:
        raise TypeError(f"warp_trilinear: want bf16/f32 taps and f32 "
                        f"coords; got {taps.dtype}, {coords.dtype}")
    if taps.device.type == "cpu":
        return warp_trilinear_plain(taps, coords, border)
    if taps.device.type != "cuda":
        raise ValueError(f"warp_trilinear: unsupported device {taps.device}")
    if not (taps.is_contiguous() and coords.is_contiguous()):
        raise ValueError("warp_trilinear: taps and coords must be "
                         "contiguous")
    M = coords.shape[1]
    out = torch.empty((B, C, M), dtype=torch.float32, device=taps.device)
    lib = _build.library()
    with torch.cuda.device(taps.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_warp_trilinear(
            taps.data_ptr(), int(taps.dtype == torch.bfloat16),
            coords.data_ptr(), out.data_ptr(), B, C, D, W, H, M, int(border),
            stream)
    _build.check(rc, "warp_trilinear")
    warp_trilinear.launches += 1
    return out


warp_trilinear.launches = 0
