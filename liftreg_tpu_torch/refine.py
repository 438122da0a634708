"""Instance refinement in the PCA subspace, PyTorch port of
``liftreg_tpu/refine.py`` (``_build_refine`` and ``make_refiner``; the
projection-domain refiner is still to be ported, ``ROADMAP.md``).

After the amortized encoder prediction, Adam optimizes the (B, L) latent
coefficients per case. Each step differentiates the objective of training,
``sim(warped, target) + reg_factor * ||grad disp||^2``, through the PCA
expansion and the warp: on CUDA the PCA kernel and its backward, the warp
kernel and its coordinate gradient. The loop runs eagerly; each step's
autograd graph is freed before the next step.

Typical use::

    refiner = make_refiner((160, 160, 160), n_steps=30)
    res = refiner(coefs0, pca, moving_masked, target_masked)
    res["phi"], res["warped"], res["sim_history"]
"""
from __future__ import annotations

import functools
import math

import torch

from .coords import identity_map
from .losses.registration import displacement_reg
from .losses.similarity import get_similarity
from .models.subspace_backproj import expand_pca
from .ops import resample

#: optax.adam's defaults besides the learning rate
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class Adam:
    """optax.adam's update written out for one tensor:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
    corrections ``1 - b^count``, ``-lr * mu_hat / (sqrt(nu_hat + eps_root)
    + eps)``."""

    def __init__(self, z, lr):
        self.lr = lr
        self.mu = torch.zeros_like(z)
        self.nu = torch.zeros_like(z)
        self.count = 0

    def step(self, z, g):
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * self.nu
        self.count += 1
        mu_hat = self.mu / (1 - ADAM_B1 ** self.count)
        nu_hat = self.nu / (1 - ADAM_B2 ** self.count)
        update = mu_hat / ((nu_hat + ADAM_EPS_ROOT).sqrt() + ADAM_EPS)
        return z + (-self.lr) * update


def _build_refine(losses_fn, lr, n_steps, early_stop_patience=None,
                  early_stop_tol=1e-4):
    """The refinement loop: n_steps + 1 gradient evaluations (z_0, the
    unrefined prediction, through z_n; the last update is evaluated, not
    dropped) of ``losses_fn(z, *args) -> (per_sample_total (B,),
    (per_sample_sim (B,), phi, warped))``, gradients through the batch mean,
    and per sample the best iterate by ``total < best`` (a NaN total never
    enters ``best``). One final forward on the selected iterates gives the
    outputs and the histories' last entry.

    ``early_stop_patience=k`` stops once no sample has improved its best
    total by more than ``early_stop_tol`` for ``k`` consecutive steps;
    history entries past the exit hold NaN and ``steps_run`` counts the
    evaluations made.
    """

    def refine(coefs0, *args):
        z = coefs0.detach().float().clone()
        B = z.shape[0]
        opt = Adam(z, lr)
        best_z = z.clone()
        best_total = torch.full((B,), math.inf, device=z.device)
        totals, sims = [], []
        stale = 0
        steps_run = 0
        for _ in range(n_steps + 1):
            with torch.enable_grad():
                zg = z.detach().requires_grad_(True)
                per_total, (per_sim, _, _) = losses_fn(zg, *args)
                total = per_total.mean()
                (g,) = torch.autograd.grad(total, zg)
            per_total = per_total.detach()
            if early_stop_patience is not None:
                # significant movement of any sample's best; the best
                # tracking itself stays strict
                improved = (per_total < best_total - early_stop_tol).any()
                stale = 0 if bool(improved) else stale + 1
            better = per_total < best_total
            best_z = torch.where(better[:, None], z, best_z)
            best_total = torch.where(better, per_total, best_total)
            z = opt.step(z, g)
            totals.append(total.detach())
            sims.append(per_sim.detach().mean())
            steps_run += 1
            if early_stop_patience is not None \
                    and stale >= early_stop_patience:
                break

        with torch.no_grad():
            sel_total, (sel_sim, phi, warped) = losses_fn(best_z, *args)
        nan = torch.full((n_steps + 1 - steps_run,), math.nan,
                         device=z.device)
        totals = torch.cat([torch.stack(totals), nan])
        sims = torch.cat([torch.stack(sims), nan])
        out = {
            "coefs": best_z,
            "phi": phi,
            "warped": warped,
            # entries 0..n-1: the batch-mean objective of z_0..z_{n-1}; the
            # last entry: that of the selected iterates
            "total_history": torch.cat([totals[:-1], sel_total.mean()[None]]),
            "sim_history": torch.cat([sims[:-1], sel_sim.mean()[None]]),
            "total_per_sample": sel_total,
            "sim_per_sample": sel_sim,
        }
        if early_stop_patience is not None:
            out["steps_run"] = steps_run
        return out

    return refine


def make_refiner(img_sz, sim="ncc", sim_opts=None, n_steps=30, lr=0.05,
                 reg_factor=1e-3, warp_taps_dtype=None, fast_vjp=False,
                 early_stop_patience=None, early_stop_tol=1e-4):
    """Build the refinement function for one volume geometry.

    Arguments as ``liftreg_tpu.refine.make_refiner`` (without ``mesh``).
    ``fast_vjp`` is accepted and changes nothing: the JAX package's two
    warp VJPs give the same gradient, and the port has one.

    Returns ``refine(coefs0, pca, moving, target) -> dict`` with ``coefs``
    (the best iterate per sample), ``phi``, ``warped``, ``total_history``
    and ``sim_history`` ((n_steps+1,): entry 0 the unrefined objective, the
    last entry that of the returned iterates), ``total_per_sample``,
    ``sim_per_sample`` and, with early stop, ``steps_run``.
    """
    del fast_vjp
    img_sz = tuple(int(s) for s in img_sz)
    sim_fn = get_similarity(sim)
    if sim_opts:
        sim_fn = functools.partial(sim_fn, **dict(sim_opts))

    def _losses(coefs, pca, moving, target):
        disp = expand_pca(coefs, pca["vectors"], pca["mean"], img_sz)
        phi = disp + identity_map(img_sz, device=disp.device)[None]
        warped = resample.warp_image(moving, phi, zero_boundary=True,
                                     scale_intensity=True,
                                     taps_dtype=warp_taps_dtype)
        sim_loss = sim_fn(warped, target, reduction="none")
        total = sim_loss + reg_factor * displacement_reg(disp,
                                                         reduction="none")
        return total, (sim_loss, phi, warped)

    return _build_refine(_losses, lr, n_steps,
                         early_stop_patience=early_stop_patience,
                         early_stop_tol=early_stop_tol)
