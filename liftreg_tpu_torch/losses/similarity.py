"""Similarity measures, PyTorch port of ``liftreg_tpu/losses/similarity.py``:
``ncc_loss``, ``ncc_sqr_loss``, ``ngf_loss`` (2D, the projection refiner's)
and ``lncc_loss`` (3D), with the JAX package's registry of names, and
``gradient_loss`` (3D Sobel gradients), which that registry leaves out.

``lncc_loss`` takes its box sums in f32 whatever PyTorch's TF32 flags say:
they are ``avg_pool3d`` sums (``divisor_override=1``), which no TF32 path
computes. Truncated sums made the variances negative and diverged LNCC
training in the JAX package (``liftreg_tpu/losses/similarity.py:_box_sum``).
The clamps of the variances use ``torch.maximum``, whose gradient at a tie
is 1/2 as ``jnp.maximum``'s is."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_precision
from ..tracing import spanned


@dataclasses.dataclass(frozen=True)
class RankShare:
    """The weights of one rank's rows of a global batch that ``ranks``
    processes hold in equal parts (:mod:`..parallel.mesh`): ``local`` (b,)
    this rank's, ``total`` the whole batch's weight ``max(sum, 1)`` (a
    host number, or a 0-dim tensor for one tensor of the whole batch's).
    Given as ``weights``, a loss returns this rank's share of the global
    batch's weighted mean, and the shares of the ranks sum to it: each
    rank's rows over ``total``, and a ``1 - mean`` form's 1 split as ``1
    / ranks`` a rank."""
    local: torch.Tensor
    total: float | torch.Tensor
    ranks: int = 1

    @classmethod
    def of(cls, weights):
        """``weights`` as a share: a (B,) tensor is the whole batch's, on
        one rank (the JAX package's form of the argument); None stays
        None."""
        if weights is None or isinstance(weights, cls):
            return weights
        return cls(weights, weights.sum().clamp(min=1.0))


def _batch_mean(per_sample, weights):
    """Mean over the batch axis; with ``weights`` (B,) a weighted mean, so
    zero-weight pad rows contribute nothing; with a :class:`RankShare`
    this rank's share of the global weighted mean."""
    if weights is None:
        return per_sample.mean()
    share = RankShare.of(weights)
    return (per_sample * share.local.to(per_sample.dtype)).sum() / share.total


def _reduce(per_sample_cc, weights, reduction):
    """``"mean"``: scalar ``1 - batch_mean(cc)``; ``"none"``: the
    per-sample vector ``1 - cc_i``."""
    if reduction == "none":
        return 1.0 - per_sample_cc
    share = RankShare.of(weights)
    one = 1.0 if share is None else 1.0 / share.ranks
    return one - _batch_mean(per_sample_cc, share)


@spanned("loss.similarity")
def ncc_loss(pred, target, weights=None, reduction="mean"):
    """1 - mean_batch NCC, with the reference's ``+1e-10`` on the centred
    values."""
    b = pred.shape[0]
    x = pred.reshape(b, -1)
    y = target.reshape(b, -1)
    xm = x - x.mean(dim=1, keepdim=True) + 1e-10
    ym = y - y.mean(dim=1, keepdim=True) + 1e-10
    ncc = (xm * ym).mean(dim=1) / (
        (xm ** 2).mean(dim=1) * (ym ** 2).mean(dim=1)).sqrt()
    return _reduce(ncc, weights, reduction)


@spanned("loss.similarity")
def ncc_sqr_loss(pred, target, weights=None, reduction="mean"):
    """Squared-NCC variant: per-channel squared correlation, channel mean,
    ``1 - batch_mean``."""
    b, c = pred.shape[0], pred.shape[1]
    x = pred.reshape(b, c, -1)
    y = target.reshape(b, c, -1)
    xm = x - x.mean(dim=2, keepdim=True)
    ym = y - y.mean(dim=2, keepdim=True)
    ncc_sqr = (xm * ym).mean(dim=2) ** 2 / (
        (xm ** 2).mean(dim=2) * (ym ** 2).mean(dim=2) + 1e-12)
    return _reduce(ncc_sqr.mean(dim=1), weights, reduction)


def _ngf_gradient(x, eps):
    """Normalized 2D gradient of x (B, C, H, W): central differences with
    one-sided (linear) rows and columns at the borders, divided by
    ``sqrt(|g|^2 + eps)``."""
    gx = torch.cat([x[:, :, 1:2] - x[:, :, :1], x[:, :, 2:] - x[:, :, :-2],
                    x[:, :, -1:] - x[:, :, -2:-1]], dim=2)
    gy = torch.cat([x[..., 1:2] - x[..., :1], x[..., 2:] - x[..., :-2],
                    x[..., -1:] - x[..., -2:-1]], dim=3)
    g = torch.stack([gx, gy], dim=-1)
    return g / torch.sqrt(torch.sum(g ** 2, dim=-1, keepdim=True) + eps)


@spanned("loss.similarity")
def ngf_loss(i0, i1, eps=1e-10, weights=None, reduction="mean"):
    """Normalized-gradient-field loss of 2D images (B, C, H, W):
    ``1 - mean((g0 . g1)^2)`` per sample."""
    dot = torch.sum(_ngf_gradient(i0, eps) * _ngf_gradient(i1, eps), dim=-1)
    per_sample = torch.mean(dot.reshape(dot.shape[0], -1) ** 2, dim=1)
    return _reduce(per_sample, weights, reduction)


@functools.lru_cache(maxsize=8)
def _sobel_filters(device, dtype):
    """(3, 1, 3, 3, 3): the 3D Sobel-like filter along each axis, the
    outer planes +base and -base. Cached on the device (callers must not
    write into it)."""
    base = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]])
    fil = torch.zeros((3, 3, 3, 3))
    fil[0, 0], fil[0, 2] = base, -base
    fil[1, :, 0], fil[1, :, 2] = base, -base
    fil[2, :, :, 0], fil[2, :, :, 2] = base, -base
    return fil[:, None].to(device=device, dtype=dtype)


@f32_precision()
def gradient_loss(x, y):
    """Sum over the three axes of the MSE between Sobel gradients of x and y
    (B, 1, D, W, H), 'same' zero padding. Not in the registry, as in the
    JAX package."""
    fil = _sobel_filters(x.device, x.dtype)
    gx = F.conv3d(x, fil, padding=1)
    gy = F.conv3d(y, fil, padding=1)
    total = 0.0
    for axis in range(3):
        total = total + torch.mean((gx[:, axis] - gy[:, axis]) ** 2)
    return total


def _box_sum(x, win):
    """Box-filter sum over ``win`` voxels along each spatial axis of
    (B, C, D, W, H), with XLA's SAME zero padding ((win-1)//2 before,
    win//2 after). Each axis is one f32 ``avg_pool3d`` sum."""
    b, c = x.shape[:2]
    x = x.reshape(b * c, 1, *x.shape[2:])
    for axis in range(3):
        size, pad = [1, 1, 1], [0, 0, 0]
        size[axis] = win
        if win % 2 and x.shape[2 + axis] >= win:
            pad[axis] = win // 2
        else:
            # SAME pads an even window unevenly, and avg_pool3d refuses an
            # axis shorter than its window: pad explicitly
            spec = [0] * 6
            spec[2 * (2 - axis)] = (win - 1) // 2
            spec[2 * (2 - axis) + 1] = win // 2
            x = F.pad(x, spec)
        x = F.avg_pool3d(x, size, stride=1, padding=pad,
                         count_include_pad=True, divisor_override=1)
    return x.reshape(b, c, *x.shape[2:])


@functools.lru_cache(maxsize=64)
def _triangle_profile(n, k, device, dtype):
    """The weight of two ``k``-box passes along an axis of ``n`` voxels
    (numpy, as the JAX package builds it), on ``device``. Cached: a copy
    from the host in every refinement step would synchronise the stream;
    callers must not write into it."""
    t = np.convolve(np.convolve(np.ones(n), np.ones(k), "same"), np.ones(k),
                    "same")
    return torch.as_tensor(t, dtype=dtype).to(device)


def _smooth_triangle(x, k):
    """Normalized separable triangle pre-filter: two ``k``-box passes
    divided by their per-voxel weight (a numpy profile per axis), so that
    constants, border voxels included, are kept. ``k`` must be an odd int
    >= 1."""
    if k != int(k) or int(k) < 1 or int(k) % 2 == 0:
        raise ValueError(f"smooth must be an odd integer >= 1, got {k!r}")
    k = int(k)
    num = _box_sum(_box_sum(x, k), k)
    den = 1.0
    for axis in (2, 3, 4):
        n = x.shape[axis]
        shape = [1] * 5
        shape[axis] = n
        den = den * _triangle_profile(n, k, x.device, x.dtype).view(shape)
    return num / den


def _avg_pool3(x, k):
    """k^3 average pool with stride k (VALID) over (B, C, D, W, H)."""
    return F.avg_pool3d(x, k, k)


@spanned("loss.similarity")
def lncc_loss(pred, target, win=9, eps=1e-5, weights=None, smooth=0,
              scales=None, reduction="mean"):
    """Local NCC over ``win``-cubed windows of (B, 1, D, W, H) volumes,
    ``1 - mean(cc)`` per sample, ``cc = cross^2 / (var_i var_j + eps)``.

    ``scales`` (e.g. ``[1, 2]``): the mean of the per-sample losses at each
    average-pooled factor; ``None`` or ``[1]`` is one scale. ``smooth``: an
    odd box width ``k`` applied twice to both images first
    (:func:`_smooth_triangle`); 0 disables it."""
    if scales is not None and list(scales) != [1]:
        per_scale = []
        for s in scales:
            s = int(s)
            p = pred if s == 1 else _avg_pool3(pred, s)
            t = target if s == 1 else _avg_pool3(target, s)
            per_scale.append(lncc_loss(p, t, win=win, eps=eps, smooth=smooth,
                                       reduction="none"))
        # the entries are per-sample losses already: no second 1 - x
        per_sample_loss = torch.mean(torch.stack(per_scale), dim=0)
        if reduction == "none":
            return per_sample_loss
        return _batch_mean(per_sample_loss, weights)
    if smooth:
        pred = _smooth_triangle(pred, smooth)
        target = _smooth_triangle(target, smooth)
    i, j = pred, target
    i2, j2, ij = i * i, j * j, i * j
    n = float(win ** 3)
    si, sj = _box_sum(i, win), _box_sum(j, win)
    si2, sj2, sij = _box_sum(i2, win), _box_sum(j2, win), _box_sum(ij, win)
    mu_i, mu_j = si / n, sj / n
    cross = sij - mu_j * si - mu_i * sj + mu_i * mu_j * n
    # true variances are >= 0: clamp the f32 cancellation noise
    zero = si.new_zeros(())  # filled on the device: no host copy
    var_i = torch.maximum(si2 - 2 * mu_i * si + mu_i * mu_i * n, zero)
    var_j = torch.maximum(sj2 - 2 * mu_j * sj + mu_j * mu_j * n, zero)
    cc = (cross * cross) / (var_i * var_j + eps)
    per_sample = torch.mean(cc.reshape(cc.shape[0], -1), dim=1)
    return _reduce(per_sample, weights, reduction)


SIMILARITY_REGISTRY = {
    "ncc": ncc_loss,
    "ncc_sqr": ncc_sqr_loss,
    "ngf": ngf_loss,
    "lncc": lncc_loss,
    # reference class-path aliases (the JAX registry's)
    "liftreg.layers.losses.NCCLoss": ncc_loss,
    "layers.losses.NCCLoss": ncc_loss,
    "liftreg.layers.layers.NCCLoss": ncc_sqr_loss,
    "liftreg.layers.losses.NGFLoss": ngf_loss,
}


def get_similarity(name):
    if name in SIMILARITY_REGISTRY:
        return SIMILARITY_REGISTRY[name]
    raise KeyError(f"unknown similarity '{name}'; known: "
                   f"{sorted(SIMILARITY_REGISTRY)}")
