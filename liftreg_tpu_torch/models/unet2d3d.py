"""Dense-displacement 2D/3D registration model (VoxelMorph-style U-Net),
PyTorch port of ``liftreg_tpu/models/unet2d3d.py`` ``RegNet2D3D``.

The projections are lifted by the backprojection kernel without gradient;
a 5-stage conv encoder and a 6-stage decoder with align-corners trilinear
upsampling and skip concatenations regress a dense displacement through a
flow head initialised N(0, 0.001); a 7-step fixed-point iteration inverts
it; the attenuation volume is warped by ``phi`` and back by the inverse,
and the warped, inverse-warped and source volumes are re-projected for the
projection-domain losses. Differentiating the inverse iteration and the
inverse warp takes the warp's gradient with respect to the image (its f32
taps), as well as the coordinate gradient.
"""
from __future__ import annotations

import torch
from torch import nn

from ..coords import identity_map
from ..device import f32_precision, resolve_dtype
from ..ops import drr, resample
from ..ops.drr_kernel import (backproject_taps, project_adjoint_plan,
                              project_taps_ad)
from . import s2d
from .blocks import ConvBlock

#: standard deviation of the flow head's initial weights (reference
#: ``RegNet2D3D.py:81-84``)
FLOW_INIT_STD = 0.001


class RegNet2D3D(nn.Module):
    """``forward(inputs, pca=None)`` as the JAX model (``pca`` is ignored);
    returns its output dict. The parameters are ``convs.{n}`` (the JAX
    tree's ``CheckpointConvBlock_{n}``: 5 encoder and 6 decoder stages) and
    ``flow`` (its top-level ``Conv_0``), whose weights are drawn from a
    ``torch.Generator`` of their own, seeded from torch's global generator
    (so that a seeded caller gets the same weights).

    ``s2d_encoder`` runs the encoder's first two stages as space-to-depth
    convolutions (:mod:`.s2d`) from the same parameters, and unpacks stage
    0's output for the decoder's full-resolution skip, as JAX does.
    ``remat_inverse`` and ``fast_vjp`` are the JAX model's options and are
    accepted: they change what JAX keeps in memory or the program it
    traces, not the result. The port stores each step of the inverse
    iteration for the backward (its coordinates: 7 maps of 3 * 160^3 f32,
    under 1 GB at B = 1).
    ``backproject_chunk`` and ``project_chunk`` shape only the plain
    versions' products. ``mesh`` (:func:`..parallel.mesh.attach`): the
    re-projections' min-max normalisation takes the extremes of the mesh's
    global batch, as ``jnp.min``/``max`` do under the JAX mesh."""

    mesh = None

    def __init__(self, img_sz, drr_feature_num=4,
                 enc_filters=(16, 32, 32, 32, 32),
                 dec_filters=(32, 32, 32, 32, 16, 16), inverse_iters=7,
                 compute_dtype=None, backproject_chunk=16, project_chunk=32,
                 remat_inverse=True, s2d_encoder=False, fast_vjp=False):
        super().__init__()
        del remat_inverse, fast_vjp
        self.s2d_encoder = bool(s2d_encoder)
        if len(enc_filters) != 5 or len(dec_filters) != 6:
            raise ValueError("RegNet2D3D takes 5 encoder and 6 decoder "
                             f"widths; got {enc_filters}, {dec_filters}")
        self.img_sz = tuple(int(s) for s in img_sz)
        self.inverse_iters = int(inverse_iters)
        self.compute_dtype = resolve_dtype(compute_dtype, "compute_dtype")
        self.backproject_chunk = backproject_chunk
        self.project_chunk = project_chunk
        dt = self.compute_dtype
        convs, c = [], 1 + drr_feature_num
        for i, feats in enumerate(enc_filters):
            convs.append(ConvBlock(c, feats, stride=1 if i == 0 else 2,
                                   dtype=dt))
            c = feats
        convs.append(ConvBlock(c, dec_filters[0], dtype=dt))
        c = dec_filters[0]
        for i, skip in enumerate(reversed(enc_filters[:-1])):
            convs.append(ConvBlock(c + skip, dec_filters[i + 1], dtype=dt))
            c = dec_filters[i + 1]
        convs.append(ConvBlock(c, dec_filters[5], dtype=dt))
        self.convs = nn.ModuleList(convs)
        self.n_enc = len(enc_filters)
        self.flow = nn.Conv3d(dec_filters[5], 3, 3, padding=1)
        generator = torch.Generator().manual_seed(
            int(torch.randint(0, 2 ** 62, ()).item()))
        with torch.no_grad():
            self.flow.weight.copy_(torch.randn(
                self.flow.weight.shape, generator=generator) * FLOW_INIT_STD)
            self.flow.bias.zero_()

    def lift(self, target_proj, poses):
        """(B, P, pw, ph) projections -> (B, P, D, W, H), without gradient."""
        with torch.no_grad():
            geometry = drr.backward_geometry(poses, self.img_sz,
                                             target_proj.shape[2:])
            return backproject_taps(target_proj.contiguous(), *geometry,
                                    plane_chunk=self.backproject_chunk)

    def _flow(self, x):
        """The U-Net: (B, 1+P, D, W, H) -> displacement (B, 3, D, W, H) f32."""
        skips = []
        start = 0
        if self.s2d_encoder and s2d.eligible(x.shape,
                                             self.convs[:self.n_enc]):
            c0, c1 = self.convs[0], self.convs[1]
            y2 = s2d.conv0_s2d(x, c0.conv.weight, c0.conv.bias,
                               c0.negative_slope, self.compute_dtype)
            # the decoder's last skip is stage 0's output at full resolution
            skips.append(s2d.unpack_s2d(y2))
            x = s2d.conv1_s2d(y2, c1.conv.weight, c1.conv.bias,
                              c1.negative_slope, self.compute_dtype)
            skips.append(x)
            start = 2
        for conv in self.convs[start:self.n_enc]:
            x = conv(x)
            skips.append(x)
        x = self.convs[self.n_enc](skips[-1])
        for conv, skip in zip(self.convs[self.n_enc + 1:-1],
                              reversed(skips[:-1])):
            x = resample.resize_trilinear(
                x, tuple(2 * s for s in x.shape[2:]))
            x = conv(torch.cat([x, skip], dim=1))
        x = self.convs[-1](x)
        w, b = self.flow.weight, self.flow.bias
        if self.compute_dtype is not None:
            x, w, b = (t.to(self.compute_dtype) for t in (x, w, b))
        return nn.functional.conv3d(x, w, b, padding=1).float()

    @f32_precision()
    def forward(self, inputs, pca=None):
        moving = inputs["source"]
        target = inputs["target"]
        target_proj = inputs["target_proj"]      # (B, P, pw, ph)
        poses = inputs["target_poses"]
        if poses.dim() == 3:
            poses = poses[0]
        spacing = inputs["spacing"]
        if spacing.dim() == 2:
            spacing = spacing[0]
        moving_cp = moving * inputs["source_label"] \
            if "source_label" in inputs else moving

        x = torch.cat([moving_cp, self.lift(target_proj, poses)], dim=1)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        disp = self._flow(x)

        idm = identity_map(self.img_sz, device=disp.device)[None]
        # fixed-point inverse flow; step 0 warps at the identity, whose
        # coordinates take no gradient
        disp_inv = torch.zeros_like(disp)
        for _ in range(self.inverse_iters):
            disp_inv = -resample.warp_image(disp, idm + disp_inv,
                                            zero_boundary=True,
                                            scale_intensity=False)
        phi = disp + idm

        moving_origin = inputs["original_source"]   # attenuation volume
        warped = resample.warp_image(moving_origin, phi, zero_boundary=True,
                                     scale_intensity=False)
        warped_inv = resample.warp_image(warped, idm + disp_inv,
                                         zero_boundary=True,
                                         scale_intensity=False)

        geometry = drr.forward_geometry(poses, self.img_sz,
                                        tuple(target_proj.shape[2:]), spacing)
        # the adjoint's plan, built once for the two differentiated
        # projections (on the card; the plain adjoint needs none)
        plan = (project_adjoint_plan(geometry[0], geometry[1], self.img_sz)
                if torch.is_grad_enabled() and geometry[0].is_cuda else None)

        def compute_proj(vol):
            p = project_taps_ad(vol[:, 0].contiguous(), *geometry,
                                plane_chunk=self.project_chunk, plan=plan)
            lo, hi = (p.amin(), p.amax()) if self.mesh is None \
                else self.mesh.extremes(p)
            return (p - lo) / (hi - lo) * 2.0 - 1.0

        return {
            "warped": warped,
            "phi": phi,
            "target": target,
            "params": [disp, disp_inv],
            "warped_proj": compute_proj(warped),
            "warped_proj_inv": compute_proj(warped_inv),
            "source_proj": compute_proj(moving_origin),
            "target_proj": target_proj,
        }
