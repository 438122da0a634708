"""Space-to-depth form of the encoder's first two conv stages, PyTorch port
of ``liftreg_tpu/models/s2d.py``.

Stage 0 (3^3, C -> F, stride 1, SAME) and stage 1 (3^3, F -> G, stride 2,
pad 1) are rewritten as two 2^3 VALID convolutions over 2 x 2 x 2 blocks
folded into channels: at 160^3 with C = 5, F = 16, G = 32, a 40 -> 128
channel conv at 81^3 -> 80^3, then a 128 -> 32 conv at 80^3. The 2^3
kernels are taken from the same (F, C, 3, 3, 3) and (G, F, 3, 3, 3)
parameters of the encoder's ``ConvBlock``s, so the operator, the state
dict and every checkpoint are those of the plain stages; the zero taps
cost (4/3)^3 ~ 2.4 times the plain stages' multiply-adds.

Derivation, per axis (tap k = d + 1, d in {-1, 0, 1}):

* pack: pad by one voxel front and back (stage 0's SAME padding) and fold
  block pairs: ``X2[(s, c), Q] = xpad[c, 2Q + s]``, Q in [0, D/2 + 1);
* stage 0: output voxel 2P + r reads ``xpad[2P + r + d + 1]``, block
  P + t with 2t + s = r + d + 1: a 2-tap VALID conv with
  ``W2[(r, f), (s, c), t] = w[f, c, 2t + s - r]`` (zero outside 0..2); its
  output is the packed stage-0 output;
* stage 1: output P reads ``y[2P + d]``, block P - 1 + t of the packed
  output front-padded by one zero block: ``V2[g, (r, f), t] =
  w1[g, f, 2t + r - 1]`` (zero outside 0..2); its output holds plain
  channels at half resolution, what stage 2 reads.

Tensors are channels-first (B, C, D, W, H), torch's conv layout; the
packed channels keep the JAX module's order, sub-position (sz, sy, sx)
major over the channel, so each function equals JAX's after one permute
of the channel axis to the end. The 2^3 kernels are products of the
parameters with constant 0/1 selection tensors, one per axis, each tap a
sum with one nonzero term: the same values as JAX's index gather, and a
backward without the gather's atomic adds (deterministic on the card).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["eligible", "pack_s2d", "stage0_weights", "stage1_weights",
           "conv0_s2d", "conv1_s2d", "unpack_s2d", "conv_pair_s2d"]


def eligible(x_shape, enc_filters) -> bool:
    """The s2d pair applies when every spatial dim of the (B, C, D, W, H)
    input is even (blocks of 2) and at least 4, and there are at least two
    encoder stages (stride 1 then stride 2)."""
    return (len(enc_filters) >= 2
            and all(int(s) % 2 == 0 and int(s) >= 4 for s in x_shape[2:5]))


def pack_s2d(x):
    """(B, C, D, W, H) -> (B, 8C, D/2+1, W/2+1, H/2+1): pads one voxel on
    every side (stage 0's SAME padding) and folds 2 x 2 x 2 blocks into
    channels, sub-position (sz, sy, sx) major over c."""
    B, C, D, W, H = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    dq, wq, hq = (D + 2) // 2, (W + 2) // 2, (H + 2) // 2
    xp = xp.reshape(B, C, dq, 2, wq, 2, hq, 2)
    xp = xp.permute(0, 3, 5, 7, 1, 2, 4, 6)          # (B,sz,sy,sx,C,dq,wq,hq)
    return xp.reshape(B, 8 * C, dq, wq, hq)


@functools.lru_cache(maxsize=None)
def _selection(stage):
    """One axis's 0/1 selection, (8, 3) for stage 0 (rows (t, s, r)) or
    (4, 3) for stage 1 (rows (t, r)): 1 where the 3-tap index k is the
    row's tap, 0 where the row has none."""
    t = np.arange(2)
    if stage == 0:
        k = 2 * t[:, None, None] + t[None, :, None] - t[None, None, :]
    else:
        k = 2 * t[:, None] + t[None, :] - 1
    k = k.reshape(-1)
    return (k[:, None] == np.arange(3)[None, :]).astype(np.float32)


def _taps(w, stage):
    """(O, I, 3, 3, 3) -> (O, I, Rz, Ry, Rx) with R the selection's rows:
    each axis's taps contracted with its selection by a product and a sum
    of one nonzero term (exact in any dtype)."""
    sel = torch.from_numpy(_selection(stage)).to(w.device, w.dtype)
    lead = w.shape[:2]
    for _ in range(3):
        k = w.movedim(2, -1)                          # this axis's taps last
        rest = k.shape[:-1]
        k = (k.reshape(-1, 1, 3) * sel).sum(-1)       # (rest..., rows)
        w = k.reshape(*rest, sel.shape[0])
    return w.reshape(*lead, *(sel.shape[0],) * 3)


def stage0_weights(w):
    """(F, C, 3, 3, 3) -> (8F, 8C, 2, 2, 2) s2d kernel of stage 0."""
    Fo, C = int(w.shape[0]), int(w.shape[1])
    w2 = _taps(w, 0).reshape(Fo, C, 2, 2, 2, 2, 2, 2, 2, 2, 2)
    # (f, c, tz, sz, rz, ty, sy, ry, tx, sx, rx)
    #   -> (rz, ry, rx, f, sz, sy, sx, c, tz, ty, tx)
    w2 = w2.permute(4, 7, 10, 0, 3, 6, 9, 1, 2, 5, 8)
    return w2.reshape(8 * Fo, 8 * C, 2, 2, 2)


def stage1_weights(v):
    """(G, F, 3, 3, 3) -> (G, 8F, 2, 2, 2) s2d kernel of the stride-2
    stage."""
    G, Fi = int(v.shape[0]), int(v.shape[1])
    v2 = _taps(v, 1).reshape(G, Fi, 2, 2, 2, 2, 2, 2)
    # (g, f, tz, rz, ty, ry, tx, rx) -> (g, rz, ry, rx, f, tz, ty, tx)
    v2 = v2.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return v2.reshape(G, 8 * Fi, 2, 2, 2)


def _conv(x, w, b, dtype):
    """VALID conv3d with bias in the compute type ``dtype`` (None: the
    operands' own), as ``blocks.conv_nd`` casts its operands."""
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.conv3d(x, w, b)


def conv0_s2d(x, w0, b0, negative_slope=0.2, dtype=None):
    """Stage 0 (k3, stride 1, SAME, bias, LeakyReLU) in s2d form.

    x: (B, C, D, W, H) -> the packed output (B, 8F, D/2, W/2, H/2), the
    space-to-depth layout of the ConvBlock's output (sub-position major
    over the F features); :func:`unpack_s2d` gives the full-resolution
    tensor where it is needed (a U-Net skip)."""
    if dtype is not None:
        x = x.to(dtype)
    y2 = _conv(pack_s2d(x), stage0_weights(w0), b0.repeat(8), dtype)
    return F.leaky_relu(y2, negative_slope)


def conv1_s2d(y2, w1, b1, negative_slope=0.2, dtype=None):
    """Stage 1 (k3, stride 2, pad 1, bias, LeakyReLU) of the packed stage-0
    output; returns plain channels (B, G, D/2, W/2, H/2)."""
    # one zero block in front of each spatial axis (F.pad lists the last
    # axis first: (H front, H back, W front, W back, D front, D back))
    y2p = F.pad(y2, (1, 0, 1, 0, 1, 0))
    z = _conv(y2p, stage1_weights(w1), b1, dtype)
    return F.leaky_relu(z, negative_slope)


def unpack_s2d(y2):
    """(B, 8F, D/2, W/2, H/2) packed -> (B, F, D, W, H)."""
    B, c8, dq, wq, hq = y2.shape
    Fo = c8 // 8
    y = y2.reshape(B, 2, 2, 2, Fo, dq, wq, hq)
    y = y.permute(0, 4, 5, 1, 6, 2, 7, 3)            # (B,F,dq,sz,wq,sy,hq,sx)
    return y.reshape(B, Fo, 2 * dq, 2 * wq, 2 * hq)


def conv_pair_s2d(x, w0, b0, w1, b1, negative_slope=0.2, dtype=None):
    """Stages 0+1 of the encoder as two space-to-depth convolutions.

    x: (B, C, D, W, H); w0: (F, C, 3, 3, 3); w1: (G, F, 3, 3, 3). Returns
    (B, G, D/2, W/2, H/2): ``ConvBlock(C, F, stride=1)`` then
    ``ConvBlock(F, G, stride=2)`` with the same parameters, LeakyReLU after
    each."""
    y2 = conv0_s2d(x, w0, b0, negative_slope, dtype)
    return conv1_s2d(y2, w1, b1, negative_slope, dtype)
