"""NN building blocks, PyTorch port of ``liftreg_tpu/models/blocks.py``.

Torch's default initialisation (kaiming-uniform with a=sqrt(5), fan-in
bias bound) is the one the JAX package reproduces, so the blocks keep it.
``dtype`` is the compute type, as in flax: the parameters stay f32 and are
cast with the input at each call.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

NEGATIVE_SLOPE = 0.2  # LeakyReLU slope of every block


class ConvBlock(nn.Module):
    """3D conv (k3, pad 1) + LeakyReLU(0.2): the JAX ``ConvBlock`` in the
    configuration the subspace encoder uses (no batch norm, no residual)."""

    def __init__(self, in_features, features, stride=1, dtype=None):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 3, stride=stride,
                              padding=1)
        self.dtype = dtype

    def forward(self, x):
        w, b = self.conv.weight, self.conv.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        y = F.conv3d(x, w, b, stride=self.conv.stride, padding=1)
        return F.leaky_relu(y, NEGATIVE_SLOPE)


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
