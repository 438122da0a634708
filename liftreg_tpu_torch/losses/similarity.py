"""Similarity measures, PyTorch port of ``liftreg_tpu/losses/similarity.py``
for ``ncc_loss`` and ``ncc_sqr_loss``; ``lncc``, ``ngf`` and ``gradient``
are still to be ported (``ROADMAP.md`` A7)."""
from __future__ import annotations


def _batch_mean(per_sample, weights):
    """Mean over the batch axis; with ``weights`` (B,) a weighted mean, so
    zero-weight pad rows contribute nothing."""
    if weights is None:
        return per_sample.mean()
    w = weights.to(per_sample.dtype)
    return (per_sample * w).sum() / w.sum().clamp(min=1.0)


def _reduce(per_sample_cc, weights, reduction):
    """``"mean"``: scalar ``1 - batch_mean(cc)``; ``"none"``: the
    per-sample vector ``1 - cc_i``."""
    if reduction == "none":
        return 1.0 - per_sample_cc
    return 1.0 - _batch_mean(per_sample_cc, weights)


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


SIMILARITY_REGISTRY = {
    "ncc": ncc_loss,
    "ncc_sqr": ncc_sqr_loss,
    # reference class-path aliases (the JAX registry's)
    "liftreg.layers.losses.NCCLoss": ncc_loss,
    "layers.losses.NCCLoss": ncc_loss,
    "liftreg.layers.layers.NCCLoss": ncc_sqr_loss,
}

#: similarities of the JAX package that the port does not have yet
NOT_PORTED = ("lncc", "ngf", "gradient", "liftreg.layers.losses.NGFLoss")


def get_similarity(name):
    if name in SIMILARITY_REGISTRY:
        return SIMILARITY_REGISTRY[name]
    if name in NOT_PORTED:
        raise ValueError(f"similarity {name!r} is not ported yet "
                         "(ROADMAP.md A7)")
    raise KeyError(f"unknown similarity '{name}'; known: "
                   f"{sorted(SIMILARITY_REGISTRY)}")
