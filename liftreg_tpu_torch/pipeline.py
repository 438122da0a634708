"""Inference pipeline, PyTorch port of ``liftreg_tpu/pipeline.py``:
HU clip -> attenuation -> DRR -> projection normalization ->
backprojection lift -> encoder -> PCA expansion -> warp.

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

from .device import resolve_device
from .models.subspace_backproj import LiftRegSubspaceBackproj
from .ops import drr

normalize_drr = drr.normalize_drr


def normalize_hu(vol_hu):
    """HU clip [-1000, 0] -> [-1, 1]."""
    return vol_hu.clamp(-1000.0, 0.0) / 1000.0 * 2.0 + 1.0


class RegistrationPipeline:
    """Build once, then call :meth:`register` or
    :meth:`register_projections`.

    ``compute_dtype`` is the encoder's compute type (None = f32). A bf16
    compute type also selects bf16 warp taps unless ``warp_taps_dtype``
    overrides it. ``device`` None means the CUDA card and raises without
    one; pass ``"cpu"`` to run the kernels' plain versions. The pipeline
    turns TF32 off process-wide so that f32 products and convolutions
    keep f32 precision, as the JAX package asks XLA for HIGHEST.
    """

    def __init__(self, img_sz=(160, 160, 160), latent_dim=56, n_proj=4,
                 scan_range_deg=30.0, spacing=(2.2, 2.2, 2.2),
                 resolution=None, compute_dtype=None, mask_ct=True,
                 warp_taps_dtype="auto", device=None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.img_sz = tuple(int(s) for s in img_sz)
        self.spacing = tuple(float(s) for s in spacing)
        self.resolution = tuple(resolution) if resolution is not None \
            else drr.default_resolution(self.img_sz)
        self.poses = torch.from_numpy(drr.synthesize_poses(
            scan_range_deg, n_proj, self.img_sz[1])).to(self.device)
        if warp_taps_dtype == "auto":
            warp_taps_dtype = compute_dtype
        self.model = LiftRegSubspaceBackproj(
            self.img_sz, latent_dim=latent_dim, drr_feature_num=n_proj,
            compute_dtype=compute_dtype, warp_taps_dtype=warp_taps_dtype,
            mask_ct=mask_ct).to(self.device).eval()

    def _inputs(self, source_hu, target, target_proj):
        return {
            "source": normalize_hu(source_hu),
            "target": target,
            "target_proj": target_proj,
            "target_poses": self.poses[None],
        }

    @torch.no_grad()
    def register(self, pca, source_hu, target_hu, source_seg=None,
                 target_seg=None):
        """source_hu/target_hu: (B, 1, D, W, H) HU volumes (SPR
        orientation); segs optional (B, 1, D, W, H) in {0, 1}. Returns
        ``(warped, phi)``."""
        att = drr.calc_relative_atten_coef(target_hu[:, 0])
        proj = normalize_drr(drr.project(att, self.poses, self.resolution,
                                         self.spacing))
        inputs = self._inputs(source_hu, normalize_hu(target_hu), proj)
        if source_seg is not None:
            inputs["source_label"] = source_seg
            inputs["target_label"] = target_seg
        out = self.model(inputs, pca)
        return out["warped"], out["phi"]

    @torch.no_grad()
    def register_projections(self, pca, source_hu, target_proj,
                             source_seg=None):
        """Register from projections only (no target CT): ``target_proj``
        (B, P, pw, ph) in the normalized DRR convention. Returns
        ``(warped, phi)``."""
        inputs = self._inputs(source_hu, torch.zeros_like(source_hu),
                              target_proj)
        if source_seg is not None:
            inputs["source_label"] = source_seg
            inputs["target_label"] = torch.ones_like(source_seg)
        out = self.model(inputs, pca)
        return out["warped"], out["phi"]
