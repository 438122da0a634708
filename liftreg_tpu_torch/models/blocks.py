"""NN building blocks, PyTorch port of ``liftreg_tpu/models/blocks.py``.

Torch's default initialisation (kaiming-uniform with a=sqrt(5), fan-in
bias bound) is the one the JAX package reproduces, so the blocks keep it.
``dtype`` is the compute type, as in flax: the parameters stay f32 and are
cast with the input at each call. The blocks are channels-first
(B, C, *spatial); the JAX ones are channels-last.

Batch norm follows flax's ``nn.BatchNorm`` (:class:`BatchNorm`), not
torch's: ``forward(x, train)`` takes flax's ``train`` flag (False, the
default, normalises by the running averages), the batch variance is the
biased one, ``E[x^2] - E[x]^2`` clipped at 0, and the running averages
move by flax's momentum. ``FLAX_NAMES`` maps the names of a JAX block's
submodules to the port's attributes, for :func:`..params.params_from_jax`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import f32_precision

NEGATIVE_SLOPE = 0.2  # LeakyReLU slope of every block
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_FN = {2: F.conv2d, 3: F.conv3d}


def conv_nd(conv, x, dtype=None, stride=1, padding=0):
    """``conv``'s operator on ``x`` in the compute type ``dtype`` (the
    parameters cast with the input), with the given stride and padding."""
    w, b = conv.weight, conv.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    return _CONV_FN[w.dim() - 2](x, w, b, stride=stride, padding=padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of (B, C, *spatial):
    ``weight`` is flax's ``scale``; ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var``. With ``train`` the batch's mean and
    biased variance (in f32) normalise and update the running averages by
    ``ra = momentum * ra + (1 - momentum) * stat`` (flax's momentum; torch's
    is 1 minus it); without, the running averages normalise.

    ``mesh`` (:func:`..parallel.mesh.attach`): in training the statistics
    are those of the global batch of the mesh's ranks, pad rows included,
    as flax's are under the JAX mesh: one differentiable ``all_reduce`` of
    the per-channel sums of x and x^2; the running averages stay equal on
    every rank."""

    mesh = None

    def __init__(self, features, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = float(momentum), float(eps)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train=False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            xf = x.float()
            sums = torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
            count = xf.numel() // xf.shape[1]
            if self.mesh is not None:
                sums, count = self.mesh.sum(sums), count * self.mesh.size
            mean, mean2 = sums / count
            var = (mean2 - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """conv (k, pad (k-1)//2) + optional batch norm (flax momentum 0.9,
    eps 1e-5) + LeakyReLU(0.2) + optional 1x1 residual conv (the block's
    stride, fan-in the input's channels); 2D or 3D by ``ndim``. Without
    batch norm and residual, the configuration every model uses."""
    FLAX_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "Conv_1": "res"}

    def __init__(self, in_features, features, stride=1, dtype=None, ndim=3,
                 kernel_size=3, use_bias=True, batchnorm=False,
                 residual=False, negative_slope=NEGATIVE_SLOPE):
        super().__init__()
        conv = _CONV[ndim]
        self.pad = (kernel_size - 1) // 2
        self.stride = stride
        self.conv = conv(in_features, features, kernel_size, stride=stride,
                         padding=self.pad, bias=use_bias)
        self.bn = BatchNorm(features, momentum=0.9) if batchnorm else None
        self.res = (conv(in_features, features, 1, stride=stride,
                         bias=use_bias) if residual else None)
        self.negative_slope = negative_slope
        self.dtype = dtype

    def forward(self, x, train=False):
        y = conv_nd(self.conv, x, self.dtype, self.stride, self.pad)
        if self.bn is not None:
            y = self.bn(y, train)
        y = F.leaky_relu(y, self.negative_slope)
        if self.res is not None:
            y = y + conv_nd(self.res, x, self.dtype, self.stride)
        return y


class ConvResBlock(nn.Module):
    """conv - BN - act - conv (+ 1x1 residual) - BN - act, the batch norms
    with flax's default momentum (0.99)."""
    FLAX_NAMES = {"Conv_0": "conv0", "BatchNorm_0": "bn0", "Conv_1": "conv1",
                  "Conv_2": "res", "BatchNorm_1": "bn1"}

    def __init__(self, in_features, features, stride=1, dtype=None, ndim=3,
                 kernel_size=3, use_bias=True, batchnorm=False,
                 residual=False, negative_slope=NEGATIVE_SLOPE):
        super().__init__()
        conv = _CONV[ndim]
        self.pad = (kernel_size - 1) // 2
        self.stride = stride
        self.conv0 = conv(in_features, features, kernel_size, stride=stride,
                          padding=self.pad, bias=use_bias)
        self.conv1 = conv(features, features, kernel_size,
                          padding=self.pad, bias=use_bias)
        self.res = (conv(in_features, features, 1, stride=stride,
                         bias=use_bias) if residual else None)
        self.bn0 = BatchNorm(features) if batchnorm else None
        self.bn1 = BatchNorm(features) if batchnorm else None
        self.negative_slope = negative_slope
        self.dtype = dtype

    def forward(self, x, train=False):
        y = conv_nd(self.conv0, x, self.dtype, self.stride, self.pad)
        if self.bn0 is not None:
            y = self.bn0(y, train)
        y = F.leaky_relu(y, self.negative_slope)
        y = conv_nd(self.conv1, y, self.dtype, 1, self.pad)
        if self.res is not None:
            y = y + conv_nd(self.res, x, self.dtype, self.stride)
        if self.bn1 is not None:
            y = self.bn1(y, train)
        return F.leaky_relu(y, self.negative_slope)


class FullyConnectBlock(nn.Module):
    """Linear + optional LeakyReLU(0.2)."""

    def __init__(self, in_features, features, nonlinear=True, dtype=None):
        super().__init__()
        self.linear = nn.Linear(in_features, features)
        self.nonlinear = nonlinear
        self.dtype = dtype

    def forward(self, x):
        w, b = self.linear.weight, self.linear.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        y = F.linear(x, w, b)
        if self.nonlinear:
            y = F.leaky_relu(y, NEGATIVE_SLOPE)
        return y


def gaussian_kernel_1d(size: int, sigma: float):
    """The unnormalised 1-D Gaussian over ``arange(size)`` centred at
    ``(size - 1) / 2``, f64 numpy."""
    x = np.arange(size, dtype=np.float64)
    mean = (size - 1) / 2.0
    return (np.exp(-(((x - mean) / sigma) ** 2) / 2.0)
            / (sigma * math.sqrt(2 * math.pi)))


def gaussian_smooth(x, kernel_size, sigma, ndim=None):
    """Depthwise Gaussian smoothing over the trailing spatial axes of
    (B, C, *spatial): the separable kernel's outer product in f64,
    normalised, cast to ``x``'s dtype; padding ``kernel_size // 2`` on
    every side, so an even kernel grows each axis by 1. Kept in f32 on the
    card (:func:`..device.f32_precision`)."""
    spatial = x.dim() - 2 if ndim is None else ndim
    if np.isscalar(kernel_size):
        kernel_size = [int(kernel_size)] * spatial
    if np.isscalar(sigma):
        sigma = [float(sigma)] * spatial
    kernel = np.ones((1,), dtype=np.float64)
    for size, sg in zip(kernel_size, sigma):
        kernel = np.multiply.outer(kernel, gaussian_kernel_1d(size, sg))
    kernel = kernel[0]
    kernel = kernel / kernel.sum()
    C = x.shape[1]
    kern = torch.from_numpy(kernel).to(device=x.device, dtype=x.dtype)
    pad = int(kernel_size[0] // 2)
    xs = x.reshape(-1, 1, *x.shape[2:])
    with f32_precision():
        out = _CONV_FN[spatial](xs, kern[None, None], padding=pad)
    return out.reshape(x.shape[0], C, *out.shape[2:])
