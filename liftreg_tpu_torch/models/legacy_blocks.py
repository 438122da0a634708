"""Legacy building blocks, PyTorch port of
``liftreg_tpu/models/legacy_blocks.py``: conv and transposed-conv blocks,
the resize-conv, the 2D residual block, the 2D -> 3D transfer layer and
the module-form DRR projector. No model uses them; they are kept as the
JAX package keeps them. Channels-first (B, C, *spatial); the JAX blocks are
channels-last. Batch norm is flax's (:class:`.blocks.BatchNorm`, default
momentum 0.99, eps 1e-5), ``train`` as in flax.

A flax ``ConvTranspose`` with explicit padding ``p`` dilates its input by
the stride, pads it by ``p`` and correlates it with the kernel as flax
holds it (not flipped): :func:`conv_transpose_flax`. Torch's
``ConvTranspose`` reads ``padding`` as a crop and flips the kernel, and
cannot give ``DeconvNdBlock``'s default output size ``(n - 1) * s + 3``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import drr, drr_kernel, resample
from .blocks import _CONV, BatchNorm, conv_nd


def conv_transpose_flax(x, conv, stride, padding):
    """flax ``ConvTranspose`` with ``padding=[(p, p)] * ndim`` on
    (B, C, *spatial): zeros between the input's samples (``stride - 1``
    of them), ``p`` on every side (a negative ``p`` crops), then ``conv``'s
    correlation, its weight (Cout, Cin, *k) being flax's kernel
    (*k, Cin, Cout) transposed."""
    ndim = x.dim() - 2
    if stride > 1:
        shape = tuple((n - 1) * stride + 1 for n in x.shape[2:])
        up = x.new_zeros(x.shape[:2] + shape)
        up[(slice(None),) * 2 + (slice(None, None, stride),) * ndim] = x
        x = up
    x = F.pad(x, (padding, padding) * ndim)
    return conv_nd(conv, x)


class ConvNdBlock(nn.Module):
    """conv + optional batch norm + ReLU."""
    FLAX_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn"}

    def __init__(self, in_features, features, ndim=3, kernel_size=3,
                 stride=1, padding=1, has_bn=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = _CONV[ndim](in_features, features, kernel_size,
                                stride=stride, padding=padding)
        self.bn = BatchNorm(features) if has_bn else None

    def forward(self, x, train=False):
        y = conv_nd(self.conv, x, stride=self.stride, padding=self.padding)
        if self.bn is not None:
            y = self.bn(y, train)
        return F.relu(y)


class DeconvNdBlock(nn.Module):
    """transposed conv (flax's operator, :func:`conv_transpose_flax`) +
    optional batch norm + ReLU; with the defaults (k 1, stride 1, padding
    1) an axis of n grows to n + 2."""
    FLAX_NAMES = {"ConvTranspose_0": "conv", "BatchNorm_0": "bn"}

    def __init__(self, in_features, features, ndim=3, kernel_size=1,
                 stride=1, padding=1, has_bn=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = _CONV[ndim](in_features, features, kernel_size)
        self.bn = BatchNorm(features) if has_bn else None

    def forward(self, x, train=False):
        y = conv_transpose_flax(x, self.conv, self.stride, self.padding)
        if self.bn is not None:
            y = self.bn(y, train)
        return F.relu(y)


class ResizeConv3D(nn.Module):
    """align_corners trilinear resize to ``out_dim``
    (:func:`..ops.resample.resize_trilinear`) + :class:`ConvNdBlock`."""
    FLAX_NAMES = {"ConvNdBlock_0": "block"}

    def __init__(self, in_features, out_dim, features, kernel_size=3,
                 has_bn=False):
        super().__init__()
        self.out_dim = tuple(int(n) for n in out_dim)
        self.block = ConvNdBlock(in_features, features, ndim=3,
                                 kernel_size=kernel_size, has_bn=has_bn)

    def forward(self, x, train=False):
        return self.block(resample.resize_trilinear(x, self.out_dim), train)


class ResBlock2D(nn.Module):
    """stride-2 conv block (k 4) + conv block (k 3), both with batch norm,
    and ReLU of their sum."""
    FLAX_NAMES = {"ConvNdBlock_0": "c1", "ConvNdBlock_1": "c2"}

    def __init__(self, in_features, features):
        super().__init__()
        self.c1 = ConvNdBlock(in_features, features, ndim=2, kernel_size=4,
                              stride=2, padding=1, has_bn=True)
        self.c2 = ConvNdBlock(features, features, ndim=2, kernel_size=3,
                              stride=1, padding=1, has_bn=True)

    def forward(self, x, train=False):
        c1 = self.c1(x, train)
        return F.relu(c1 + self.c2(c1, train))


class TransLayer(nn.Module):
    """2D -> 3D feature transfer: 1x1 conv + ReLU, the channels-last
    (B, H, W, C) features reshaped to (-1, 4, 4, 4, ``in_features_3d``) as
    the JAX layer reshapes them, then a 1x1x1 transposed conv + ReLU;
    (B, C, H, W) in, (B', ``in_features_3d``, 4, 4, 4) out."""
    FLAX_NAMES = {"Conv_0": "conv", "ConvTranspose_0": "deconv"}

    def __init__(self, in_features, in_features_3d):
        super().__init__()
        self.in_features_3d = in_features_3d
        self.conv = nn.Conv2d(in_features, in_features, 1)
        self.deconv = nn.Conv3d(in_features_3d, in_features_3d, 1)

    def forward(self, x):
        y = F.relu(conv_nd(self.conv, x))
        y = y.movedim(1, -1).reshape(-1, 4, 4, 4, self.in_features_3d)
        return F.relu(conv_nd(self.deconv, y.movedim(-1, 1)))


class ProjLayer(nn.Module):
    """Module-form DRR projector: geometry fixed at construction (poses
    from ``scan_range``, ``proj_num`` and the volume's width; detector
    ``resolution_scale`` times axes 0 and 2), built once per device; the
    forward projects (B, D, W, H) attenuation to (B, P, res_d, res_h)
    through the projector kernel on the card (its plain version on the
    CPU), differentiably."""

    def __init__(self, volume_spacing, scan_range, proj_num, in_shape,
                 resolution_scale=1.5):
        super().__init__()
        self.shape = tuple(int(s) for s in in_shape)
        self.spacing = tuple(float(s) for s in volume_spacing)
        self.poses = drr.synthesize_poses(scan_range, proj_num,
                                          self.shape[1])
        self.resolution = (int(self.shape[0] * resolution_scale),
                           int(self.shape[2] * resolution_scale))
        self._geometry = {}

    def geometry(self, device):
        if device not in self._geometry:
            poses = torch.as_tensor(self.poses, device=device)
            self._geometry[device] = drr.forward_geometry(
                poses, self.shape, self.resolution, self.spacing)
        return self._geometry[device]

    def forward(self, vol):
        return drr_kernel.project_taps_ad(vol.contiguous(),
                                          *self.geometry(vol.device))
