"""Inference pipeline, PyTorch port of ``liftreg_tpu/pipeline.py``:
HU clip -> attenuation -> DRR -> projection normalization ->
backprojection lift -> encoder -> PCA expansion -> warp, then optionally
per-case refinement of the PCA coefficients (``refine_steps``), against the
target CT (``refine_domain="image"``) or against the projections
(``"projection"``).

Example::

    pipe = RegistrationPipeline((160, 160, 160), latent_dim=56,
                                compute_dtype=torch.bfloat16)
    pipe.model.load_state_dict(params_from_jax(flax_params))
    warped, phi = pipe.register(pca, src_hu, tgt_hu, src_seg, tgt_seg)

The weights live in ``pipe.model`` (a ``torch.nn.Module``); the JAX
pipeline's ``params`` argument has no counterpart.
"""
from __future__ import annotations

import torch

from .device import resolve_device, resolve_dtype
from .models.subspace_backproj import LiftRegSubspaceBackproj, mask_lung
from .ops import drr
from .ops.drr_kernel import project_taps
from .ops.resample import warp_image
from .refine import make_projection_refiner, make_refiner

normalize_drr = drr.normalize_drr


def normalize_hu(vol_hu):
    """HU clip [-1000, 0] -> [-1, 1]."""
    return vol_hu.clamp(-1000.0, 0.0) / 1000.0 * 2.0 + 1.0


class RegistrationPipeline:
    """Build once, then call :meth:`register` or
    :meth:`register_projections`.

    ``compute_dtype`` is the encoder's compute type (None = f32), a
    ``torch.dtype`` or its name (``"bfloat16"``), as the JAX pipeline takes
    it; an unknown name raises ``ValueError`` here. A bf16 compute type
    also selects bf16 warp taps unless ``warp_taps_dtype`` overrides it.
    ``device`` None means the CUDA card and raises without
    one; pass ``"cpu"`` to run the kernels' plain versions. The pipeline
    turns TF32 off process-wide so that f32 products and convolutions
    keep f32 precision, as the JAX package asks XLA for HIGHEST. The DRR
    geometry of the (static) poses is built once, here, for a detector of
    ``resolution``; :meth:`register_projections` builds the lift's anew
    for projections of another size, as the JAX model does.

    ``refine_steps > 0`` continues each case after the encoder's
    prediction with that many Adam steps on the PCA coefficients. With
    ``refine_domain="image"`` (:func:`.refine.make_refiner`) the objective
    compares the warped CT with the (lung-masked) target CT; with
    ``"projection"`` (:func:`.refine.make_projection_refiner`,
    ``proj_norm="drr"``) it compares the DRR of the warped attenuation
    with the target projections, so :meth:`register_projections` refines
    too; the output is then the masked CT rewarped by the refined phi.
    ``refiner`` is the refinement function (None without refinement);
    ``last_refine`` holds its output dict from the last call.
    """

    def __init__(self, img_sz=(160, 160, 160), latent_dim=56, n_proj=4,
                 scan_range_deg=30.0, spacing=(2.2, 2.2, 2.2),
                 resolution=None, compute_dtype=None, mask_ct=True,
                 warp_taps_dtype="auto", refine_steps=0, refine_lr=0.05,
                 refine_sim="ncc", refine_sim_opts=None,
                 refine_reg_factor=1e-3, refine_domain="image",
                 refine_early_stop_patience=None, refine_early_stop_tol=1e-4,
                 device=None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.img_sz = tuple(int(s) for s in img_sz)
        self.spacing = tuple(float(s) for s in spacing)
        self.resolution = tuple(int(r) for r in resolution) \
            if resolution is not None else drr.default_resolution(self.img_sz)
        self.poses = torch.from_numpy(drr.synthesize_poses(
            scan_range_deg, n_proj, self.img_sz[1])).to(self.device)
        self.project_geometry = drr.forward_geometry(
            self.poses, self.img_sz, self.resolution, self.spacing)
        self.lift_geometry = drr.backward_geometry(
            self.poses, self.img_sz, self.resolution)
        compute_dtype = resolve_dtype(compute_dtype, "compute_dtype")
        if warp_taps_dtype == "auto":
            warp_taps_dtype = compute_dtype
        warp_taps_dtype = resolve_dtype(warp_taps_dtype, "warp_taps_dtype")
        self.mask_ct = mask_ct
        self.model = LiftRegSubspaceBackproj(
            self.img_sz, latent_dim=latent_dim, drr_feature_num=n_proj,
            compute_dtype=compute_dtype, warp_taps_dtype=warp_taps_dtype,
            mask_ct=mask_ct).to(self.device).eval()
        self.refiner = None
        self.last_refine = None
        self.refine_domain = refine_domain
        self.warp_taps_dtype = warp_taps_dtype
        if refine_steps:
            opts = dict(sim=refine_sim, sim_opts=refine_sim_opts,
                        n_steps=int(refine_steps), lr=refine_lr,
                        reg_factor=refine_reg_factor,
                        warp_taps_dtype=warp_taps_dtype,
                        early_stop_patience=refine_early_stop_patience,
                        early_stop_tol=refine_early_stop_tol)
            if refine_domain == "image":
                self.refiner = make_refiner(self.img_sz, **opts)
            elif refine_domain == "projection":
                self.refiner = make_projection_refiner(
                    self.img_sz, self.poses, self.resolution, self.spacing,
                    proj_norm="drr", **opts)
            else:
                raise ValueError(f"refine_domain {refine_domain!r} not in "
                                 "('image', 'projection')")

    def _inputs(self, source_hu, target, target_proj):
        inputs = {
            "source": normalize_hu(source_hu),
            "target": target,
            "target_proj": target_proj,
            "target_poses": self.poses[None],
        }
        # the cached lift geometry holds pixel coordinates of a detector of
        # ``resolution``; projections of another size get their own
        if tuple(target_proj.shape[2:]) == self.resolution:
            inputs["lift_geometry"] = self.lift_geometry
        return inputs

    def _moving_cp(self, inputs):
        if self.mask_ct and "source_label" in inputs:
            return mask_lung(inputs["source"], inputs["source_label"])
        return inputs["source"]

    @torch.no_grad()
    def register(self, pca, source_hu, target_hu, source_seg=None,
                 target_seg=None):
        """source_hu/target_hu: (B, 1, D, W, H) HU volumes (SPR
        orientation); segs optional (B, 1, D, W, H) in {0, 1}. Returns
        ``(warped, phi)``, refined when the pipeline refines."""
        att = drr.calc_relative_atten_coef(target_hu[:, 0]).contiguous()
        proj = normalize_drr(project_taps(att, *self.project_geometry))
        inputs = self._inputs(source_hu, normalize_hu(target_hu), proj)
        if source_seg is not None:
            inputs["source_label"] = source_seg
            inputs["target_label"] = target_seg
        out = self.model(inputs, pca)
        if self.refiner is None:
            return out["warped"], out["phi"]
        return self._refine_tail(out, pca, source_hu, inputs)

    def _refine_tail(self, out, pca, source_hu, inputs):
        """Refine each case from the encoder's prediction; returns
        ``(warped, phi)``. The encoder's weights gather no gradient: the
        refinement starts from detached coefficients and only they require
        grad."""
        coefs0 = out["pca_coefs"].detach()
        if self.refine_domain == "image":
            res = self.refiner(coefs0, pca, self._moving_cp(inputs),
                               out["target"])
            self.last_refine = res
            return res["warped"], res["phi"]
        # the projection domain reads no target CT: the DRR of the warped
        # attenuation against the target projections
        res = self.refiner(coefs0, pca,
                           drr.calc_relative_atten_coef(source_hu),
                           inputs["target_proj"])
        self.last_refine = res
        # the output is register's: the masked, normalized CT under the
        # refined map, not the warped attenuation
        warped = warp_image(self._moving_cp(inputs), res["phi"],
                            zero_boundary=True, scale_intensity=True,
                            taps_dtype=self.warp_taps_dtype)
        return warped, res["phi"]

    @torch.no_grad()
    def register_projections(self, pca, source_hu, target_proj,
                             source_seg=None):
        """Register from projections only (no target CT): ``target_proj``
        (B, P, pw, ph) in the normalized DRR convention. With projection-
        domain refinement each case is refined against ``target_proj``;
        image-domain refinement raises ``ValueError``. Returns
        ``(warped, phi)``."""
        if self.refiner is not None and self.refine_domain != "projection":
            raise ValueError(
                "register_projections with refine_steps requires "
                "refine_domain='projection' (image-domain refinement needs "
                "a target CT, which this entry does not take)")
        inputs = self._inputs(source_hu, torch.zeros_like(source_hu),
                              target_proj)
        if source_seg is not None:
            inputs["source_label"] = source_seg
            inputs["target_label"] = torch.ones_like(source_seg)
        out = self.model(inputs, pca)
        if self.refiner is None:
            return out["warped"], out["phi"]
        return self._refine_tail(out, pca, source_hu, inputs)
