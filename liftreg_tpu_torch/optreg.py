"""Dense 3D-3D deformable registration by per-pair optimization, PyTorch
port of ``liftreg_tpu/optreg.py``.

The unknowns are a coarse displacement control grid (B, 3, g, g, g),
upsampled to full resolution inside the objective; each pyramid level runs
Adam over that grid through the refinement loop of
:func:`.refine._build_refine` (per-sample best iterate), with the PCA
expansion swapped for the upsampling. A level builds the moving image's
taps once (:func:`.ops.resample.warp_taps`) and warps them every step
(:func:`.ops.resample.warp_with_taps`): on the card one warp launch and one
coordinate-gradient launch a step. The PCA basis of the learned-basis
workflow is fitted to the fields this returns
(``tools/torch_build_pca.py --from_optreg``).

Typical use::

    reg = DenseRegisterer((160, 160, 160))
    out = reg(moving_masked, target_masked)   # dict: disp, phi, warped, ...
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .coords import identity_map
from .losses.registration import displacement_reg
from .losses.similarity import get_similarity
from .ops import resample
from .refine import _build_refine

#: ``DenseRegisterer``'s default pyramid: (grid edge, Adam steps, lr)
DEFAULT_LEVELS = ((10, 80, 0.04), (20, 60, 0.02), (40, 60, 0.01))


def upsample_grid(z, img_sz):
    """(B, 3, g, g, g) control grid -> (B, 3, D, W, H) displacement:
    ``jax.image.resize(method="linear")``, a triangle filter on half-pixel
    centres whose weights are renormalised at the edges, which is
    ``align_corners=False`` trilinear interpolation with the source index
    clamped at the edges (it rounds otherwise than JAX's per-axis products,
    by about an ulp; ``tests/test_torch_optreg.py``)."""
    img_sz = tuple(int(s) for s in img_sz)
    if tuple(z.shape[2:]) == img_sz:
        return z
    return F.interpolate(z, size=img_sz, mode="trilinear",
                         align_corners=False)


def make_level(img_sz, grid_sz, sim="ncc", sim_opts=None, n_steps=60,
               lr=0.02, reg_factor=1e-3, warp_taps_dtype=None, mesh=None):
    """One pyramid level: Adam over a (B, 3, g, g, g) control grid.

    Arguments as ``liftreg_tpu.optreg.make_level``; with ``mesh`` each
    rank registers its rows (:func:`.refine._build_refine`).
    Returns ``refine(z0, moving, target) -> dict`` with the contract of
    :func:`.refine._build_refine` (``coefs`` the best control grid per
    sample, ``phi`` and ``warped`` at full resolution,
    ``history[-1] <= history[0]`` per sample). On the card a level of n
    steps launches the warp n + 2 times and its coordinate gradient n + 1
    times."""
    img_sz = tuple(int(s) for s in img_sz)
    sim_fn = get_similarity(sim)
    if sim_opts:
        sim_fn = functools.partial(sim_fn, **dict(sim_opts))
    del grid_sz  # the shape is carried by z0

    def _losses(z, taps, target):
        disp = upsample_grid(z, img_sz)
        phi = disp + identity_map(img_sz, device=disp.device)[None]
        warped = resample.warp_with_taps(taps, phi, zero_boundary=True,
                                         scale_intensity=True)
        sim_loss = sim_fn(warped, target, reduction="none")
        total = sim_loss + reg_factor * displacement_reg(disp,
                                                         reduction="none")
        return total, (sim_loss, phi, warped)

    steps = _build_refine(_losses, lr, n_steps, mesh=mesh)

    def refine(z0, moving, target):
        # the moving image is not differentiated: its taps, once a level
        taps = resample.warp_taps(moving, scale_intensity=True,
                                  taps_dtype=warp_taps_dtype)
        return steps(z0, taps, target)

    return refine


class DenseRegisterer:
    """Multi-level dense 3D-3D registration, as
    ``liftreg_tpu.optreg.DenseRegisterer`` (``mesh``: each rank registers
    its rows of the mesh's batch).

    ``levels``: ``(grid, n_steps, lr)`` per level, coarse to fine; between
    levels the best iterate is resized to the next grid as the warm start.
    Calling with (B, 1, D, W, H) moving and target tensors (on the card,
    or on the CPU for the plain versions) returns the last level's output
    dict plus ``disp`` (``phi`` minus the identity map, which JAX builds
    outside ``jit``: :func:`.coords.linspace_eager`) and ``z`` (the final
    control grid)."""

    def __init__(self, img_sz, levels=DEFAULT_LEVELS, sim="ncc",
                 sim_opts=None, reg_factor=1e-3, warp_taps_dtype=None,
                 mesh=None):
        self.img_sz = tuple(int(s) for s in img_sz)
        self.levels = tuple((int(g), int(n), float(lr))
                            for g, n, lr in levels)
        self._mk = functools.lru_cache(maxsize=None)(
            lambda g, n, lr: make_level(
                self.img_sz, g, sim=sim, sim_opts=sim_opts, n_steps=n,
                lr=lr, reg_factor=reg_factor,
                warp_taps_dtype=warp_taps_dtype, mesh=mesh))

    def launches(self):
        """Warp forwards and coordinate gradients of one call on the card:
        ``(sum(n + 2), sum(n + 1))`` over the levels."""
        return (sum(n + 2 for _, n, _ in self.levels),
                sum(n + 1 for _, n, _ in self.levels))

    def __call__(self, moving, target):
        B = moving.shape[0]
        g0 = self.levels[0][0]
        z = moving.new_zeros((B, 3, g0, g0, g0), dtype=torch.float32)
        out = None
        for g, n_steps, lr in self.levels:
            z = upsample_grid(z, (g, g, g))
            out = self._mk(g, n_steps, lr)(z, moving, target)
            z = out["coefs"]
        idm = identity_map(self.img_sz, device=out["phi"].device,
                           eager=True)[None]
        out["disp"] = out["phi"] - idm
        out["z"] = z
        return out
