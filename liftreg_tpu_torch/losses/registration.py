"""Training losses (similarity + displacement regularisation), PyTorch port
of ``liftreg_tpu/losses/registration.py``:

* :class:`SubspaceLoss`: ``sim(warped, target) + reg_factor(epoch) *
  mean ||grad disp||^2``, central differences at spacing ``2/(N-1)``, the
  factor sigmoid-decayed over epochs;
* :class:`Subspace2DLoss`: the similarity on the projections;
* :class:`RegNet2D3DLoss`: bidirectional projection similarity +
  regularisation of the forward and inverse fields;
* :class:`RegNetImageLoss`: CT-CT similarity of the dense stage.

The epoch-dependent factor is a host float, passed into each call.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..ops import fd
from ..tracing import spanned
from .similarity import RankShare, _batch_mean, get_similarity


def sigmoid_decay(ep, static=5, k=5):
    """k/(k + exp(ep/k)) after ``static`` epochs."""
    if ep < static:
        return 1.0
    return float(k / (k + np.exp((ep - static) / k)))


@spanned("loss.regulariser")
def displacement_reg(disp, reduction="mean", weights=None):
    """Mean (or per-sample-mean-then-sum) of ``||grad disp||^2`` with
    spacing ``2/(N-1)``; ``reduction="none"`` returns the per-sample vector.
    ``weights`` (B,) zero out pad rows in either reduction; a
    :class:`.similarity.RankShare` gives this rank's share of either."""
    sp = [2.0 / (n - 1.0) for n in disp.shape[2:]]
    l2 = fd.grad_norm_sq(disp, sp)
    per_sample = l2.reshape(l2.shape[0], -1).mean(dim=1)
    if reduction == "none":
        return per_sample
    if weights is None:
        if reduction == "mean":
            return l2.mean()
        return per_sample.sum()
    share = RankShare.of(weights)
    if reduction == "mean":
        return _batch_mean(per_sample, share)
    return (per_sample * share.local.to(per_sample.dtype)).sum()


@dataclasses.dataclass
class RegFactorSchedule:
    """The sigmoid-decayed regularisation factor."""
    initial: float = 10.0
    minimum: float = 1e-3
    decay_from: int = 10
    decay_factor: float = 2.0

    def __call__(self, epoch):
        return float(max(
            sigmoid_decay(epoch, static=self.decay_from, k=self.decay_factor)
            * self.initial, self.minimum))


class SubspaceLoss:
    """``total = sim(warped, target) + reg_factor(epoch) * reg(params)``."""

    sim_key = "warped"
    target_key = "target"

    def __init__(self, opt=None):
        opt = opt or {}
        self.sim = get_similarity(opt.get("sim_class", "ncc"))
        # optional keyword arguments of the similarity (lncc's win/smooth)
        sim_opts = dict(opt.get("sim_opts", {}) or {})
        if sim_opts:
            self.sim = functools.partial(self.sim, **sim_opts)
        self.reg_factor = RegFactorSchedule(
            initial=float(opt.get("initial_reg_factor", 10)),
            minimum=float(opt.get("min_reg_factor", 1e-3)),
            decay_from=int(opt.get("reg_factor_decay_from", 10)))

    def __call__(self, output, reg_factor, weights=None):
        """``reg_factor``: the scalar of :meth:`factor`. ``weights``: an
        optional (B,) validity mask; pad rows get weight 0 and so carry no
        gradient."""
        sim_loss = self.sim(output[self.sim_key], output[self.target_key],
                            weights=weights)
        reg_loss = displacement_reg(output["params"], weights=weights)
        total = sim_loss + reg_factor * reg_loss
        return {"total_loss": total, "sim_loss": sim_loss,
                "reg_loss": reg_loss}

    def factor(self, epoch):
        return self.reg_factor(epoch)


class Subspace2DLoss(SubspaceLoss):
    """The similarity on the projections."""
    sim_key = "warped_proj"
    target_key = "target_proj"


class RegNet2D3DLoss(SubspaceLoss):
    """Bidirectional projection similarity + regularisation of both
    fields, each a per-sample mean summed over the batch."""

    def __call__(self, output, reg_factor, weights=None):
        sim_loss = (self.sim(output["warped_proj"], output["target_proj"],
                             weights=weights)
                    + self.sim(output["source_proj"],
                               output["warped_proj_inv"], weights=weights))
        disp, disp_inv = output["params"]
        reg_loss = (displacement_reg(disp, reduction="sum_of_means",
                                     weights=weights)
                    + displacement_reg(disp_inv, reduction="sum_of_means",
                                       weights=weights))
        total = sim_loss + reg_factor * reg_loss
        return {"total_loss": total, "sim_loss": sim_loss,
                "reg_loss": reg_loss}


class RegNetImageLoss(SubspaceLoss):
    """CT-CT image similarity + regularisation of the forward field, for
    the dense (basis-building) stage: ``total = sim(warped, target) +
    reg_factor * reg(forward disp)``."""

    def __call__(self, output, reg_factor, weights=None):
        sim_loss = self.sim(output["warped"], output["target"],
                            weights=weights)
        reg_loss = displacement_reg(output["params"][0], weights=weights)
        total = sim_loss + reg_factor * reg_loss
        return {"total_loss": total, "sim_loss": sim_loss,
                "reg_loss": reg_loss}


LOSS_REGISTRY = {
    "subspace": SubspaceLoss,
    "subspace2d": Subspace2DLoss,
    "regnet2d3d": RegNet2D3DLoss,
    "regnet_image": RegNetImageLoss,
    # reference class-path aliases (the JAX registry's)
    "liftreg.losses.SubspaceLoss.loss": SubspaceLoss,
    "liftreg.losses.Subspace2DLoss.loss": Subspace2DLoss,
    "liftreg.losses.RegNet2D3DLoss.loss": RegNet2D3DLoss,
}


def get_loss(name):
    if name in LOSS_REGISTRY:
        return LOSS_REGISTRY[name]
    raise KeyError(f"unknown loss '{name}'; known: {sorted(LOSS_REGISTRY)}")
