"""Instance refinement in the PCA subspace, PyTorch port of
``liftreg_tpu/refine.py``: ``_build_refine``, ``make_refiner`` (image
domain) and ``make_projection_refiner`` (projection domain).

After the amortized encoder prediction, Adam optimizes the (B, L) latent
coefficients per case. Each step differentiates the objective of training,
``sim(warped, target) + reg_factor * ||grad disp||^2``, through the PCA
expansion and the warp: on CUDA the PCA kernel and its backward, the warp
kernel and its coordinate gradient. The projection domain scores the DRR
of the warped attenuation against measured projections instead, and so
also differentiates through the projector (its adjoint kernel). The loop
runs eagerly; each step's autograd graph is freed before the next step.

With ``mesh`` (:mod:`.parallel.mesh`) each rank refines its own rows of a
batch that the mesh's ranks hold in equal parts, and computes what the
JAX refiner computes on the whole (padded) batch under its mesh: the
objective is the mean over the global batch (each rank divides by the
global B, which Adam's eps can see), the early stop asks whether any row
of any rank improved (one ``all_reduce`` a step), the histories are
global means (one ``all_reduce`` at the end), and the projection
domain's ``"minmax"`` normalisation takes the global extremes.

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
from .device import f32_precision
from .losses.registration import displacement_reg
from .losses.similarity import get_similarity
from .models.subspace_backproj import expand_pca
from .ops import drr, resample
from .ops.drr_kernel import project_adjoint_plan, project_taps_ad

#: optax.adam's defaults besides the learning rate
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class Adam:
    """optax.adam's update written out for one tensor:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
    corrections ``1 - b^count``, ``-lr * mu_hat / (sqrt(nu_hat + eps_root)
    + eps)``. As optax rounds them: ``1 - b`` from Python floats, the bias
    corrections as f32 powers of f32 ``b`` by the int32 step count, here
    kept on z's device (filled there, not copied from the host)."""

    def __init__(self, z, lr):
        self.lr = lr
        self.mu = torch.zeros_like(z)
        self.nu = torch.zeros_like(z)
        self.b1 = z.new_full((), ADAM_B1)
        self.b2 = z.new_full((), ADAM_B2)
        self.count = z.new_zeros(())

    def step(self, z, g):
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * self.nu
        self.count = self.count + 1
        mu_hat = self.mu / (1 - self.b1 ** self.count)
        nu_hat = self.nu / (1 - self.b2 ** self.count)
        update = mu_hat / ((nu_hat + ADAM_EPS_ROOT).sqrt() + ADAM_EPS)
        return z + (-self.lr) * update


def _build_refine(losses_fn, lr, n_steps, early_stop_patience=None,
                  early_stop_tol=1e-4, mesh=None):
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

    ``mesh``: the rows are this rank's of the mesh's global batch (the
    module's docstring); every rank runs the same number of steps.
    """

    @f32_precision()
    def refine(coefs0, *args):
        z = coefs0.detach().float().clone()
        B = z.shape[0]
        n_total = B * (1 if mesh is None else mesh.size)

        def batch_mean(v):
            """The mean over the global batch: this rank's share of it."""
            return v.sum() / n_total

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
                total = batch_mean(per_total)
                (g,) = torch.autograd.grad(total, zg)
            per_total = per_total.detach()
            if early_stop_patience is not None:
                # significant movement of any sample's best; the best
                # tracking itself stays strict
                improved = (per_total < best_total - early_stop_tol).any()
                if mesh is not None:
                    improved = mesh.any(improved)
                stale = 0 if bool(improved) else stale + 1
            better = per_total < best_total
            # the (B,) mask over z's trailing dims: (B, L) coefficients, or
            # optreg's (B, 3, g, g, g) control grids
            best_z = torch.where(
                better.view((-1,) + (1,) * (z.dim() - 1)), z, best_z)
            best_total = torch.where(better, per_total, best_total)
            z = opt.step(z, g)
            totals.append(total.detach())
            sims.append(batch_mean(per_sim.detach()))
            steps_run += 1
            if early_stop_patience is not None \
                    and stale >= early_stop_patience:
                break

        with torch.no_grad():
            sel_total, (sel_sim, phi, warped) = losses_fn(best_z, *args)
            totals, sims = torch.stack(totals), torch.stack(sims)
            sel = torch.stack([batch_mean(sel_total), batch_mean(sel_sim)])
            if mesh is not None:
                totals, sims, sel = mesh.all_reduce(torch.cat(
                    [totals, sims, sel])).split([steps_run, steps_run, 2])
        nan = torch.full((n_steps + 1 - steps_run,), math.nan,
                         device=z.device)
        totals = torch.cat([totals, nan])
        sims = torch.cat([sims, nan])
        out = {
            "coefs": best_z,
            "phi": phi,
            "warped": warped,
            # entries 0..n-1: the batch-mean objective of z_0..z_{n-1}; the
            # last entry: that of the selected iterates
            "total_history": torch.cat([totals[:-1], sel[:1]]),
            "sim_history": torch.cat([sims[:-1], sel[1:]]),
            "total_per_sample": sel_total,
            "sim_per_sample": sel_sim,
        }
        if early_stop_patience is not None:
            out["steps_run"] = steps_run
        return out

    return refine


def make_refiner(img_sz, sim="ncc", sim_opts=None, n_steps=30, lr=0.05,
                 reg_factor=1e-3, warp_taps_dtype=None, fast_vjp=False,
                 early_stop_patience=None, early_stop_tol=1e-4, mesh=None):
    """Build the refinement function for one volume geometry.

    Arguments as ``liftreg_tpu.refine.make_refiner``; ``mesh`` a
    :class:`.parallel.mesh.Mesh` whose ranks each refine their rows.
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

    def _losses(coefs, pca, taps, target):
        disp = expand_pca(coefs, pca["vectors"], pca["mean"], img_sz)
        phi = disp + identity_map(img_sz, device=disp.device)[None]
        warped = resample.warp_with_taps(taps, phi, zero_boundary=True,
                                         scale_intensity=True)
        sim_loss = sim_fn(warped, target, reduction="none")
        total = sim_loss + reg_factor * displacement_reg(disp,
                                                         reduction="none")
        return total, (sim_loss, phi, warped)

    steps = _build_refine(_losses, lr, n_steps,
                          early_stop_patience=early_stop_patience,
                          early_stop_tol=early_stop_tol, mesh=mesh)

    def refine(coefs0, pca, moving, target):
        # the moving image's taps are the same in every step: built once
        taps = resample.warp_taps(moving, scale_intensity=True,
                                  taps_dtype=warp_taps_dtype)
        return steps(coefs0, pca, taps, target)

    return refine


#: similarities that score (B, 1, D, W, H) volumes only (3D box filters)
#: and so cannot score (B, P, pw, ph) projections
_VOLUME_ONLY_SIMS = ("lncc",)


def make_projection_refiner(img_sz, poses, resolution,
                            spacing=(2.2, 2.2, 2.2), sim="ncc",
                            sim_opts=None, n_steps=30, lr=0.05,
                            reg_factor=1e-3, proj_norm="drr",
                            warp_taps_dtype=None, fast_vjp=False,
                            early_stop_patience=None, early_stop_tol=1e-4,
                            mesh=None):
    """Projection-domain refinement: the objective needs no target CT, only
    the measured projections.

    Arguments as ``liftreg_tpu.refine.make_projection_refiner`` and
    :func:`make_refiner` (``fast_vjp`` is accepted and changes nothing).
    ``poses`` (P, 3) numpy or tensor in voxel units;
    the projector's geometry is built once here, on the poses' device, and
    moved to the inputs' device once, the first time they lie elsewhere;
    the plan of its adjoint (:func:`.ops.drr_kernel.project_adjoint_plan`)
    is built once per device on the card, at the first call there, and
    kept for every later call's steps (the plain adjoint on the CPU needs
    none). ``proj_norm``:
    ``"drr"`` (clip [0, 6] -> [-1, 1], the pipeline's convention),
    ``"minmax"`` (min-max over the whole batch -> [-1, 1]) or ``None``
    (raw line integrals); it must match how ``target_proj`` was made.

    Returns ``refine(coefs0, pca, moving_atten, target_proj) -> dict`` with
    the keys of :func:`make_refiner`; ``moving_atten`` (B, 1, D, W, H) is
    the moving CT's linear attenuation (``drr.calc_relative_atten_coef``),
    ``target_proj`` (B, P, pw, ph), and ``warped`` is the warped
    attenuation. The attenuation's taps are built once per call, without
    the [-1, 1] intensity shift.
    """
    del fast_vjp
    if sim in _VOLUME_ONLY_SIMS:
        raise ValueError(
            f"similarity {sim!r} is 3D-volume-only (NCDHW box-filter "
            f"convolutions) and cannot score (B, P, pw, ph) projections; "
            f"use a 2D-capable similarity for projection-domain "
            f"refinement (e.g. 'ncc', 'ngf')")
    if proj_norm not in ("drr", "minmax", None):
        raise ValueError(f"proj_norm {proj_norm!r} not in ('drr', 'minmax', "
                         "None)")
    img_sz = tuple(int(s) for s in img_sz)
    sim_fn = get_similarity(sim)
    if sim_opts:
        sim_fn = functools.partial(sim_fn, **dict(sim_opts))
    poses = torch.as_tensor(poses, dtype=torch.float32)
    geometry = drr.forward_geometry(poses, img_sz,
                                    tuple(int(r) for r in resolution),
                                    tuple(float(s) for s in spacing))

    def _normalize(p):
        if proj_norm == "drr":
            return drr.normalize_drr(p)
        if proj_norm == "minmax":
            lo, hi = (p.amin(), p.amax()) if mesh is None \
                else mesh.extremes(p)
            return (p - lo) / (hi - lo) * 2.0 - 1.0
        return p

    def _losses(coefs, pca, taps, target_proj, geom, plan):
        disp = expand_pca(coefs, pca["vectors"], pca["mean"], img_sz)
        phi = disp + identity_map(img_sz, device=disp.device)[None]
        # attenuation is a nonnegative density: no [-1, 1] shift
        warped = resample.warp_with_taps(taps, phi, zero_boundary=True,
                                         scale_intensity=False)
        proj = _normalize(project_taps_ad(warped[:, 0], *geom, plan=plan))
        sim_loss = sim_fn(proj, target_proj, reduction="none")
        total = sim_loss + reg_factor * displacement_reg(disp,
                                                         reduction="none")
        return total, (sim_loss, phi, warped)

    steps = _build_refine(_losses, lr, n_steps,
                          early_stop_patience=early_stop_patience,
                          early_stop_tol=early_stop_tol, mesh=mesh)

    # the geometry and its adjoint's plan on each device the refiner has
    # run on: they depend on the poses alone
    on_device = {}

    def _geometry(device):
        if device not in on_device:
            geom = tuple(t.to(device) for t in geometry)
            plan = (project_adjoint_plan(geom[0], geom[1], img_sz)
                    if geom[0].is_cuda else None)
            on_device[device] = geom, plan
        return on_device[device]

    def refine(coefs0, pca, moving_atten, target_proj):
        taps = resample.warp_taps(moving_atten, scale_intensity=False,
                                  taps_dtype=warp_taps_dtype)
        geom, plan = _geometry(moving_atten.device)
        return steps(coefs0, pca, taps, target_proj, geom, plan)

    return refine
