"""Displacement regulariser, PyTorch port of ``displacement_reg`` in
``liftreg_tpu/losses/registration.py``."""
from __future__ import annotations

from ..ops import fd


def displacement_reg(disp, reduction="mean", weights=None):
    """Mean (or per-sample-mean-then-sum) of ``||grad disp||^2`` with
    spacing ``2/(N-1)``; ``reduction="none"`` returns the per-sample vector.
    ``weights`` (B,) zero out pad rows in either reduction."""
    sp = [2.0 / (n - 1.0) for n in disp.shape[2:]]
    l2 = fd.grad_norm_sq(disp, sp)
    per_sample = l2.reshape(l2.shape[0], -1).mean(dim=1)
    if reduction == "none":
        return per_sample
    if weights is None:
        if reduction == "mean":
            return l2.mean()
        return per_sample.sum()
    w = weights.to(per_sample.dtype)
    if reduction == "mean":
        return (per_sample * w).sum() / w.sum().clamp(min=1.0)
    return (per_sample * w).sum()
