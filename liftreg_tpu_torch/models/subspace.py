"""LiftReg subspace model without the backprojection lift (the ablation),
PyTorch port of ``liftreg_tpu/models/subspace.py``.

The 2D->3D lift is a nearest-neighbour resize of each projection to (D, H)
broadcast along the coronal axis W (:func:`..ops.resample.resize_nearest_2d`,
as JAX computes its source indices); the encoder, the PCA expansion and
the warp are those of :class:`.subspace_backproj.LiftRegSubspaceBackproj`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..coords import identity_map
from ..device import f32_precision, resolve_dtype
from ..ops import resample
from .subspace_backproj import SubspaceEncoder, expand_pca, mask_lung


class LiftRegSubspace(nn.Module):
    """``forward(inputs, pca)`` as the JAX model; returns its output dict.
    ``s2d_encoder`` runs the encoder's first two stages as space-to-depth
    convolutions, as :class:`.subspace_backproj.LiftRegSubspaceBackproj`
    does. ``fast_vjp``, ``warp_plane_window`` and ``pca_expand_pallas`` are
    the JAX model's options and are accepted: ``fast_vjp`` changes JAX's
    traced program, not the result; the Pallas window warp is a TPU
    serving path whose result the port's exact warp gives; and the port
    expands a bf16 basis with its PCA kernel whatever
    ``pca_expand_pallas`` says, an f32 basis with ``torch.matmul``."""

    def __init__(self, img_sz, latent_dim=56, drr_feature_num=4,
                 enc_filters=(16, 32, 32, 32, 32, 32), compute_dtype=None,
                 warp_taps_dtype=None, warp_plane_window=None, mask_ct=True,
                 s2d_encoder=False, fast_vjp=False, pca_expand_pallas=False):
        super().__init__()
        del warp_plane_window, fast_vjp, pca_expand_pallas
        self.img_sz = tuple(int(s) for s in img_sz)
        self.compute_dtype = resolve_dtype(compute_dtype, "compute_dtype")
        self.warp_taps_dtype = resolve_dtype(warp_taps_dtype,
                                             "warp_taps_dtype")
        self.mask_ct = mask_ct
        self.encoder = SubspaceEncoder(1 + drr_feature_num, latent_dim,
                                       self.img_sz, enc_filters,
                                       dtype=self.compute_dtype,
                                       s2d_stage01=s2d_encoder)

    @f32_precision()
    def forward(self, inputs, pca):
        moving = inputs["source"]            # (B, 1, D, W, H)
        target = inputs["target"]
        target_proj = inputs["target_proj"]  # (B, P, pw, ph)
        if self.mask_ct and "source_label" in inputs:
            moving_cp = mask_lung(moving, inputs["source_label"])
            target_cp = mask_lung(target, inputs["target_label"])
        else:
            moving_cp, target_cp = moving, target

        D, W, H = self.img_sz
        lifted2d = resample.resize_nearest_2d(target_proj, (D, H))
        lifted = lifted2d[:, :, :, None, :].expand(-1, -1, D, W, H)
        x = torch.cat([moving, lifted], dim=1)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        coefs = self.encoder(x)

        disp = expand_pca(coefs, pca["vectors"], pca["mean"], self.img_sz)
        phi = disp + identity_map(self.img_sz, device=disp.device)[None]
        warped = resample.warp_image(moving_cp, phi, zero_boundary=True,
                                     scale_intensity=True,
                                     taps_dtype=self.warp_taps_dtype)
        return {
            "warped": warped,
            "phi": phi,
            "params": disp,
            "target": target_cp,
            "pca_coefs": coefs,
        }
