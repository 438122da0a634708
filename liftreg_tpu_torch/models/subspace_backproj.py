"""LiftReg subspace model with backprojection lift, PyTorch port of
``liftreg_tpu/models/subspace_backproj.py``.

The projections are backprojected into per-view feature volumes (no
gradient, as in the reference), a 6-stage 3D conv encoder and an FC head
regress PCA coefficients, the coefficients expand through the PCA basis
into a displacement, and the lung-masked moving CT is warped by
``phi = disp + identity``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..coords import identity_map
from ..device import f32_precision, resolve_dtype
from ..ops import drr, resample
from ..ops.drr_kernel import backproject_taps, lift_encoder_input
from ..ops.pca_kernel import pca_expand_ad
from ..tracing import span
from . import s2d
from .blocks import ConvBlock, FullyConnectBlock


def _downsampled(n, stages):
    for _ in range(stages):
        n = (n - 1) // 2 + 1          # k3, stride 2, pad 1
    return n


class SubspaceEncoder(nn.Module):
    """Conv encoder + FC head emitting PCA coefficients (f32).

    The FC head consumes a channels-last flatten, as the JAX encoder does,
    so imported flax Dense kernels need only a transpose. ``s2d_stage01``
    runs stages 0+1 as space-to-depth convolutions (:mod:`.s2d`) from the
    same two ``ConvBlock``s' parameters where the input is eligible
    (:func:`.s2d.eligible`), and the plain convolutions elsewhere."""

    def __init__(self, in_channels, latent_dim, img_sz,
                 enc_filters=(16, 32, 32, 32, 32, 32), fc_widths=(800, 256),
                 dtype=None, s2d_stage01=False):
        super().__init__()
        self.s2d_stage01 = bool(s2d_stage01)
        convs, c = [], in_channels
        for i, feats in enumerate(enc_filters):
            convs.append(ConvBlock(c, feats, stride=1 if i == 0 else 2,
                                   dtype=dtype))
            c = feats
        self.convs = nn.ModuleList(convs)
        spatial = [_downsampled(int(n), len(enc_filters) - 1) for n in img_sz]
        width = c * spatial[0] * spatial[1] * spatial[2]
        fcs = []
        for w in fc_widths:
            fcs.append(FullyConnectBlock(width, w, dtype=dtype))
            width = w
        fcs.append(FullyConnectBlock(width, latent_dim, nonlinear=False,
                                     dtype=dtype))
        self.fcs = nn.ModuleList(fcs)

    def forward(self, x):
        start = 0
        if self.s2d_stage01 and s2d.eligible(x.shape, self.convs):
            c0, c1 = self.convs[0], self.convs[1]
            x = s2d.conv_pair_s2d(x, c0.conv.weight, c0.conv.bias,
                                  c1.conv.weight, c1.conv.bias,
                                  c0.negative_slope, c0.dtype)
            start = 2
        for conv in self.convs[start:]:
            x = conv(x)
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = fc(x)
        return x.float()


def mask_lung(img, seg):
    """(img+1)*seg-1: air (-1) outside the lung mask."""
    return (img + 1.0) * seg - 1.0


def expand_pca(coefs, pca_vectors, pca_mean, img_sz):
    """coefs (B, L) -> displacement (B, 3, D, W, H).

    ``pca_vectors`` (L, 3*D*W*H) in the on-disk layout, ``pca_mean``
    (3*D*W*H,) f32. A bf16 basis goes to the PCA kernel (the plain version
    on CPU), differentiable in ``coefs`` through the kernel's backward; an
    f32 basis to an f32 ``torch.matmul``."""
    B = coefs.shape[0]
    if pca_vectors.dtype == torch.bfloat16:
        disp = pca_expand_ad(coefs.float().contiguous(), pca_vectors,
                             pca_mean)
    else:
        disp = coefs @ pca_vectors.float() + pca_mean
    return disp.reshape(B, 3, *img_sz)


class LiftRegSubspaceBackproj(nn.Module):
    """``forward(inputs, pca)`` with ``pca = {'vectors': (L, 3*D*W*H),
    'mean': (3*D*W*H,)}``; returns the JAX model's output dict.
    ``compute_dtype`` and ``warp_taps_dtype`` are a ``torch.dtype``, its
    name or None, resolved here (an unknown name raises ``ValueError``).
    The forward keeps f32 products and convolutions in f32 on the card
    whatever the caller's TF32 flags (:func:`..device.f32_precision`).
    ``s2d_encoder`` runs the encoder's first two stages as space-to-depth
    convolutions (:mod:`.s2d`), the same operator from the same parameters
    (the state dict does not change). ``fast_vjp`` is the JAX model's
    option and is accepted: it picks between two JAX warp VJPs that give
    the same gradient, and the port has one.
    An optional ``inputs["lift_geometry"]`` carries the lift's prebuilt
    ``drr.backward_geometry``, which must be built for the detector size of
    ``inputs["target_proj"]``, and an optional ``inputs["identity_map"]``
    the (3, D, W, H) identity map (else :func:`..coords.identity_map`'s
    cached one): a served program takes both as inputs."""

    def __init__(self, img_sz, latent_dim=56, drr_feature_num=4,
                 enc_filters=(16, 32, 32, 32, 32, 32), compute_dtype=None,
                 backproject_chunk=16, warp_taps_dtype=None, mask_ct=True,
                 s2d_encoder=False, fast_vjp=False):
        super().__init__()
        del fast_vjp
        self.img_sz = tuple(int(s) for s in img_sz)
        self.compute_dtype = resolve_dtype(compute_dtype, "compute_dtype")
        self.backproject_chunk = backproject_chunk
        self.warp_taps_dtype = resolve_dtype(warp_taps_dtype,
                                             "warp_taps_dtype")
        self.mask_ct = mask_ct
        self.encoder = SubspaceEncoder(1 + drr_feature_num, latent_dim,
                                       self.img_sz, enc_filters,
                                       dtype=self.compute_dtype,
                                       s2d_stage01=s2d_encoder)

    def lift(self, target_proj, poses, geometry=None):
        """Backproject (B, P, pw, ph) projections into (B, P, D, W, H) f32
        feature volumes, without gradient (the reference detaches).
        ``geometry`` is ``drr.backward_geometry`` of the poses, built here
        when not given."""
        with torch.no_grad():
            if geometry is None:
                geometry = drr.backward_geometry(poses, self.img_sz,
                                                 target_proj.shape[2:])
            return backproject_taps(target_proj.contiguous(), *geometry,
                                    plane_chunk=self.backproject_chunk)

    def encoder_input(self, moving, target_proj, poses, geometry=None):
        """The encoder's (B, 1+P, D, W, H) input in its compute type: the
        moving CT in channel 0 and the lift, written by the lift kernel,
        in channels 1..P; each value rounded once, as JAX's
        ``concatenate(...).astype(compute_dtype)``. One operator
        (``liftreg::encoder_input``) makes and fills the buffer."""
        if geometry is None:
            geometry = drr.backward_geometry(poses, self.img_sz,
                                             target_proj.shape[2:])
        return lift_encoder_input(moving, target_proj.contiguous(),
                                  *geometry,
                                  dtype=self.compute_dtype or torch.float32,
                                  plane_chunk=self.backproject_chunk)

    @f32_precision()
    def forward(self, inputs, pca):
        moving = inputs["source"]            # (B, 1, D, W, H)
        target = inputs["target"]
        target_proj = inputs["target_proj"]  # (B, P, pw, ph)
        poses = inputs["target_poses"]       # (B, P, 3) or (P, 3)
        if poses.dim() == 3:
            poses = poses[0]
        if self.mask_ct and "source_label" in inputs:
            moving_cp = mask_lung(moving, inputs["source_label"])
            target_cp = mask_lung(target, inputs["target_label"])
        else:
            moving_cp, target_cp = moving, target

        with span("model.lift"):
            x = self.encoder_input(moving, target_proj, poses,
                                   inputs.get("lift_geometry"))
        with span("model.encoder"):
            coefs = self.encoder(x)
        with span("model.pca"):
            disp = expand_pca(coefs, pca["vectors"], pca["mean"],
                              self.img_sz)
        with span("model.warp"):
            idm = inputs.get("identity_map")
            if idm is None:
                idm = identity_map(self.img_sz, device=disp.device)
            phi = disp + idm[None]
            warped = resample.warp_image(moving_cp, phi, zero_boundary=True,
                                         scale_intensity=True,
                                         taps_dtype=self.warp_taps_dtype)
        return {
            "warped": warped,
            "phi": phi,
            "params": disp,
            "target": target_cp,
            "pca_coefs": coefs,
            "target_proj": target_proj,
            # reference quirk: warped_proj echoes the target projections
            "warped_proj": target_proj,
        }
