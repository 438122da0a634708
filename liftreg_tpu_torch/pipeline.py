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

from .coords import identity_map
from .device import resolve_device, resolve_dtype
from .models.subspace_backproj import LiftRegSubspaceBackproj, mask_lung
from .ops import drr
from .ops.drr_kernel import project_taps
from .ops.resample import warp_image
from .refine import make_projection_refiner, make_refiner
from .tracing import span, spanned

normalize_drr = drr.normalize_drr


def normalize_hu(vol_hu):
    """HU clip [-1000, 0] -> [-1, 1]."""
    return vol_hu.clamp(-1000.0, 0.0) / 1000.0 * 2.0 + 1.0


def build_refiner(img_sz, poses, resolution, spacing, domain, **opts):
    """The refinement function of ``domain`` (``"image"``:
    :func:`.refine.make_refiner`; ``"projection"``:
    :func:`.refine.make_projection_refiner` with ``proj_norm="drr"``) for
    the pipeline's geometry; ``opts`` are the refiners' shared options."""
    if domain == "image":
        return make_refiner(img_sz, **opts)
    if domain == "projection":
        return make_projection_refiner(img_sz, poses, resolution, spacing,
                                       proj_norm="drr", **opts)
    raise ValueError(f"refine_domain {domain!r} not in "
                     "('image', 'projection')")


def refine_tail(refiner, domain, taps_dtype, coefs, pca, moving_cp, target,
                source_hu):
    """Refine each case from the encoder's coefficients ``coefs``; returns
    ``(warped, phi, res)`` with ``res`` the refiner's output dict. The
    refinement starts from detached coefficients and only they require
    grad. ``target`` is the (masked) target CT in the image domain and the
    target projections in the projection domain, which reads no target CT:
    there the objective compares the DRR of the warped attenuation of
    ``source_hu`` with them, and the output is the masked, normalized CT
    ``moving_cp`` under the refined map, as :meth:`RegistrationPipeline.
    register` returns it."""
    coefs0 = coefs.detach()
    if domain == "image":
        res = refiner(coefs0, pca, moving_cp, target)
        return res["warped"], res["phi"], res
    res = refiner(coefs0, pca, drr.calc_relative_atten_coef(source_hu),
                  target)
    warped = warp_image(moving_cp, res["phi"], zero_boundary=True,
                        scale_intensity=True, taps_dtype=taps_dtype)
    return warped, res["phi"], res


class RegistrationPipeline:
    """Build once, then call :meth:`register` or
    :meth:`register_projections`.

    ``compute_dtype`` is the encoder's compute type (None = f32), a
    ``torch.dtype`` or its name (``"bfloat16"``), as the JAX pipeline takes
    it; an unknown name raises ``ValueError`` here. A bf16 compute type
    also selects bf16 warp taps unless ``warp_taps_dtype`` overrides it.
    ``s2d_encoder`` runs the encoder's first two stages as space-to-depth
    convolutions (:mod:`.models.s2d`), the same operator from the same
    weights.
    ``device`` None means the CUDA card and raises without
    one; pass ``"cpu"`` to run the kernels' plain versions. The model and
    the refinement keep their f32 products and convolutions in f32 on the
    card (:func:`.device.f32_precision`); no process-wide flag is set. The DRR
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
    ``settings`` holds every constructor argument that changes the result
    (a served artifact's meta carries them).

    ``mesh`` (:mod:`.parallel.mesh`): the pipeline is one rank's, which
    registers its rows of a batch that the mesh's ranks hold in equal
    parts (:func:`.parallel.shard_batch`), on the mesh's device unless
    ``device`` says otherwise; the refinement is the mesh's
    (:func:`.refine.make_refiner`). ``mesh.gather_rows`` gives the whole
    batch's phi or warped volume on every rank.
    """

    def __init__(self, img_sz=(160, 160, 160), latent_dim=56, n_proj=4,
                 scan_range_deg=30.0, spacing=(2.2, 2.2, 2.2),
                 resolution=None, compute_dtype=None, s2d_encoder=False,
                 mask_ct=True, warp_taps_dtype="auto", refine_steps=0,
                 refine_lr=0.05, refine_sim="ncc", refine_sim_opts=None,
                 refine_reg_factor=1e-3, refine_domain="image",
                 refine_early_stop_patience=None, refine_early_stop_tol=1e-4,
                 device=None, mesh=None):
        self.device = resolve_device(device) \
            if device is not None or mesh is None else mesh.device
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
            mask_ct=mask_ct, s2d_encoder=s2d_encoder).to(self.device).eval()
        self.refiner = None
        self.last_refine = None
        self.refine_steps = int(refine_steps)
        self.refine_domain = refine_domain
        self.warp_taps_dtype = warp_taps_dtype
        opts = dict(
            sim=refine_sim, sim_opts=refine_sim_opts,
            n_steps=self.refine_steps, lr=refine_lr,
            reg_factor=refine_reg_factor, warp_taps_dtype=warp_taps_dtype,
            early_stop_patience=refine_early_stop_patience,
            early_stop_tol=refine_early_stop_tol)
        self.settings = dict(
            img_sz=self.img_sz, latent_dim=int(latent_dim),
            n_proj=int(n_proj), scan_range_deg=float(scan_range_deg),
            spacing=self.spacing, resolution=self.resolution,
            compute_dtype=compute_dtype, s2d_encoder=bool(s2d_encoder),
            mask_ct=bool(mask_ct),
            warp_taps_dtype=warp_taps_dtype, refine_steps=self.refine_steps,
            refine_lr=float(refine_lr), refine_sim=refine_sim,
            refine_sim_opts=refine_sim_opts,
            refine_reg_factor=float(refine_reg_factor),
            refine_domain=refine_domain,
            refine_early_stop_patience=refine_early_stop_patience,
            refine_early_stop_tol=float(refine_early_stop_tol))
        if refine_steps:
            self.refiner = build_refiner(self.img_sz, self.poses,
                                         self.resolution, self.spacing,
                                         refine_domain, mesh=mesh, **opts)

    def constants(self):
        """The tensors that every call reads besides the weights: the
        poses, the projector's and the lift's geometry and the identity
        map, by name (a served program takes them as inputs)."""
        (x_pix, z_pix, dx), (u_pix, v_pix) = (self.project_geometry,
                                              self.lift_geometry)
        return {"poses": self.poses, "project_x_pix": x_pix,
                "project_z_pix": z_pix, "project_dx": dx,
                "lift_u_pix": u_pix, "lift_v_pix": v_pix,
                "identity_map": identity_map(self.img_sz,
                                             device=self.device)}

    def _inputs(self, consts, source_hu, target, target_proj):
        inputs = {
            "source": normalize_hu(source_hu),
            "target": target,
            "target_proj": target_proj,
            "target_poses": consts["poses"][None],
            "identity_map": consts["identity_map"],
        }
        # the cached lift geometry holds pixel coordinates of a detector of
        # ``resolution``; projections of another size get their own
        if tuple(target_proj.shape[2:]) == self.resolution:
            inputs["lift_geometry"] = (consts["lift_u_pix"],
                                       consts["lift_v_pix"])
        return inputs

    def _moving_cp(self, inputs):
        if self.mask_ct and "source_label" in inputs:
            return mask_lung(inputs["source"], inputs["source_label"])
        return inputs["source"]

    def _model(self, inputs, pca, params):
        if params is None:
            return self.model(inputs, pca)
        return torch.func.functional_call(self.model, params, (inputs, pca))

    def predict(self, consts, pca, source_hu, target_hu, source_seg=None,
                target_seg=None, params=None):
        """The amortized :meth:`register` (no refinement, no gradient
        context of its own) from the tensors of :meth:`constants` and, if
        given, the model's weights ``params`` (a ``state_dict``) in place
        of its own; returns the model's output dict and its inputs."""
        att = drr.calc_relative_atten_coef(target_hu[:, 0]).contiguous()
        proj = normalize_drr(project_taps(
            att, consts["project_x_pix"], consts["project_z_pix"],
            consts["project_dx"]))
        inputs = self._inputs(consts, source_hu, normalize_hu(target_hu),
                              proj)
        if source_seg is not None:
            inputs["source_label"] = source_seg
            inputs["target_label"] = target_seg
        return self._model(inputs, pca, params), inputs

    def predict_projections(self, consts, pca, source_hu, target_proj,
                            source_seg=None, params=None):
        """The amortized :meth:`register_projections`, as :meth:`predict`
        gives :meth:`register`'s."""
        inputs = self._inputs(consts, source_hu, torch.zeros_like(source_hu),
                              target_proj)
        if source_seg is not None:
            inputs["source_label"] = source_seg
            inputs["target_label"] = torch.ones_like(source_seg)
        return self._model(inputs, pca, params), inputs

    def refine_target(self, out, inputs):
        """What the refinement compares with: the (masked) target CT in the
        image domain, the target projections in the projection domain."""
        if self.refine_domain == "image":
            return out["target"]
        return inputs["target_proj"]

    @torch.no_grad()
    @spanned("entry.register")
    def register(self, pca, source_hu, target_hu, source_seg=None,
                 target_seg=None):
        """source_hu/target_hu: (B, 1, D, W, H) HU volumes (SPR
        orientation); segs optional (B, 1, D, W, H) in {0, 1}. Returns
        ``(warped, phi)``, refined when the pipeline refines."""
        out, inputs = self.predict(self.constants(), pca, source_hu,
                                   target_hu, source_seg, target_seg)
        if self.refiner is None:
            return out["warped"], out["phi"]
        return self._refine_tail(out, pca, source_hu, inputs)

    def _refine_tail(self, out, pca, source_hu, inputs):
        with span("refine"):
            warped, phi, self.last_refine = refine_tail(
                self.refiner, self.refine_domain, self.warp_taps_dtype,
                out["pca_coefs"], pca, self._moving_cp(inputs),
                self.refine_target(out, inputs), source_hu)
        return warped, phi

    @torch.no_grad()
    @spanned("entry.register_projections")
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
        out, inputs = self.predict_projections(self.constants(), pca,
                                               source_hu, target_proj,
                                               source_seg)
        if self.refiner is None:
            return out["warped"], out["phi"]
        return self._refine_tail(out, pca, source_hu, inputs)
