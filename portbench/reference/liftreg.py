"""Plain PyTorch reference of LiftReg's subspace model with the
backprojection lift (Tian et al., MICCAI 2022, arXiv 2203.05565), of its
per-case refinement of the PCA coefficients in the projection domain, and
of its train step, for the benchmark's check of the port.

It imports nothing of the port and nothing of JAX, and takes nothing that
the port has made: the projector's and the lift's geometry are worked out
here from the poses (in float64, then the two-tap interpolation matrices
in float32), the basis expansion is an f32 matrix product, the warp is
``F.grid_sample``, the regulariser and NCC are written out, and so is Adam.
The benchmark hands it the same weights, basis and volumes it hands the
port.

Precision: ``low`` names the type that the configuration states for the
encoder's compute, the basis and the warp's taps (``"bfloat16"`` for the
serving configuration, ``"float32"`` for the reference training one).
Each convolution and product then reads operands rounded to it, sums in
f32 and rounds its output to it, as a cuDNN or cuBLAS call in that type
does. ``tf32`` lets f32 products and convolutions run in TF32. The
benchmark's control is this reference with ``low`` one step down
(float8 for bfloat16) or with ``tf32`` on (for float32).

Conventions followed (the published model's): volumes (B, C, D, W, H);
a map phi (B, 3, D, W, H) whose channel c is the normalized
(align_corners) sample coordinate along spatial axis c; the projector
integrates along the coronal axis W through each detector pixel from the
emitter; the lift reads each voxel's detector pixel with the coronal axis
reversed; the encoder's fully connected head reads a channels-last
flatten; NCC adds 1e-10 to the centred values; the regulariser is
``||grad disp||^2`` by central differences at spacing 2/(N-1) with
replicated borders; the DRR normalisation clips to [0, 6] and maps to
[-1, 1]; HU are clipped to [-1000, 0] and mapped to [-1, 1].
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEGATIVE_SLOPE = 0.2
#: optax.adam's defaults, which the refinement uses
REFINE_BETAS, REFINE_EPS = (0.9, 0.999), 1e-8


@contextlib.contextmanager
def precision(tf32=False):
    """f32 products and convolutions on the card in f32 (``tf32`` False)
    or TF32; the caller's settings come back on exit."""
    saved_matmul = torch.get_float32_matmul_precision()
    saved_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved_matmul)
        torch.backends.cudnn.allow_tf32 = saved_cudnn


def rounder(name):
    """``x`` rounded to the type ``name`` and back to f32 (identity for
    float32)."""
    if name in (None, "float32"):
        return lambda x: x
    dtype = getattr(torch, name)
    return lambda x: x.to(dtype).float()


def synthesize_poses(scan_range_deg, n_proj, width, emitter_y_scale=3.5):
    """(P, 3) f32 emitter positions in voxel units over a limited arc:
    x = 3W tan(angle), y = 3.5W, z from -0.2W to 0.2W."""
    half = scan_range_deg / 2.0
    ang = torch.linspace(-half, half, n_proj, dtype=torch.float64)
    x = torch.tan(ang / 180.0 * math.pi) * 3.0
    y = torch.full_like(x, emitter_y_scale)
    z = torch.linspace(-0.2, 0.2, n_proj, dtype=torch.float64)
    return (torch.stack([x, y, z], dim=1) * width).float()


def _two_tap(pix, n):
    """(..., n) linear interpolation weights at pixel ``pix``, zero
    outside [0, n-1]."""
    grid = torch.arange(n, dtype=pix.dtype, device=pix.device)
    return (1.0 - (pix[..., None] - grid).abs()).clamp(min=0.0)


def _span(a, b, n, device):
    return torch.linspace(a, b, n, dtype=torch.float64, device=device)


def normalize_hu(hu):
    return hu.clamp(-1000.0, 0.0) / 1000.0 * 2.0 + 1.0


def attenuation(hu):
    """HU -> linear attenuation, water 0.2 / cm."""
    return (hu.clamp(min=-1000.0) + 1000.0) / 1000.0 * 0.2


def normalize_drr(proj):
    """Clip to [0, 6] (``minimum(maximum(.))``, so that the gradient at a
    bound is 1/2, as a clip's is) and map to [-1, 1]."""
    clipped = torch.minimum(torch.maximum(proj, proj.new_zeros(())),
                            proj.new_full((), 6.0))
    return clipped / 6.0 * 2.0 - 1.0


def identity_map(sz, device):
    axes = [torch.linspace(-1.0, 1.0, int(n), device=device) for n in sz]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


class Geometry:
    """The projector's and the lift's dense two-tap matrices for one
    volume size, detector and set of poses, built on ``device``."""

    def __init__(self, poses, vol_shape, resolution, spacing, device):
        D, W, H = (int(n) for n in vol_shape)
        rd, rh = (int(n) for n in resolution)
        p = poses.to(device=device, dtype=torch.float64)
        ex, ey, ez = p[:, 0], p[:, 1], p[:, 2]
        # projector: each coronal plane k meets the ray through detector
        # pixel (u, v) at (x_pix, z_pix)
        lin_u = _span(-rd / 2.0, rd / 2.0 - 1.0, rd, device)
        lin_v = _span(-rh / 2.0, rh / 2.0 - 1.0, rh, device)
        planes = _span(0.0, W - 1.0, W, device)
        s = (planes[None] - ey[:, None]) / (-ey[:, None])            # (P, W)
        px = ex[:, None, None] + s[:, :, None] * (lin_u - ex[:, None, None])
        pz = ez[:, None, None] + s[:, :, None] * (lin_v - ez[:, None, None])
        # (P, W, rd, D) and (P, W, rh, H)
        self.ax = _two_tap((px / D + 0.5) * (D - 1.0), D).float()
        self.az = _two_tap((pz / H + 0.5) * (H - 1.0), H).float()
        ru = (lin_u[None] - ex[:, None]) / (-ey[:, None])
        rv = (lin_v[None] - ez[:, None]) / (-ey[:, None])
        sp = [float(v) for v in spacing]
        self.dx = torch.sqrt((ru[:, :, None] * sp[0]) ** 2 + sp[1] ** 2
                             + (rv[:, None, :] * sp[2]) ** 2).float()
        # lift: voxel (i, j, k) of the reversed coronal axis reads detector
        # pixel (u_pix, v_pix)
        gx = _span(-D / 2.0, D / 2.0 - 1.0, D, device)
        yw = _span(W - 1.0, 0.0, W, device)
        gz = _span(-H / 2.0, H / 2.0 - 1.0, H, device)
        scale = ey[:, None] / (ey[:, None] - yw[None])              # (P, W)
        u3 = (gx - ex[:, None, None]) * scale[:, :, None] + ex[:, None, None]
        v3 = (gz - ez[:, None, None]) * scale[:, :, None] + ez[:, None, None]
        # (P, W, D, rd) and (P, W, H, rh)
        self.bu = _two_tap((u3 / rd + 0.5) * (rd - 1.0), rd).float()
        self.bv = _two_tap((v3 / rh + 0.5) * (rh - 1.0), rh).float()
        self.vol_shape = (D, W, H)

    def project(self, vol, chunk=32):
        """(B, D, W, H) attenuation -> (B, P, rd, rh) line integrals (cm),
        differentiable in ``vol``."""
        W = vol.shape[2]
        out = 0.0
        for k0 in range(0, W, chunk):
            k1 = min(k0 + chunk, W)
            t = torch.einsum("pkud,bdkh->bpkuh", self.ax[:, k0:k1],
                             vol[:, :, k0:k1, :])
            out = out + torch.einsum("bpkuh,pkvh->bpuv", t,
                                     self.az[:, k0:k1])
        return out * self.dx[None] * 0.1

    def lift(self, proj, chunk=16):
        """(B, P, rd, rh) projections -> (B, P, D, W, H) feature volumes."""
        B, P = proj.shape[:2]
        D, W, H = self.vol_shape
        out = proj.new_empty((B, P, D, W, H))
        for j0 in range(0, W, chunk):
            j1 = min(j0 + chunk, W)
            t = torch.einsum("pjdu,bpuv->bpjdv", self.bu[:, j0:j1], proj)
            out[:, :, :, j0:j1, :] = torch.einsum(
                "bpjdv,pjhv->bpdjh", t, self.bv[:, j0:j1])
        return out


def warp(img, phi, border=False):
    """``img`` (B, C, D, W, H) sampled trilinearly at phi (B, 3, D, W, H),
    channel c of phi indexing spatial axis c."""
    grid = phi.permute(0, 2, 3, 4, 1).flip(-1)
    return F.grid_sample(img, grid, mode="bilinear",
                         padding_mode="border" if border else "zeros",
                         align_corners=True)


def ncc_per_sample(x, y):
    b = x.shape[0]
    x = x.reshape(b, -1)
    y = y.reshape(b, -1)
    xm = x - x.mean(dim=1, keepdim=True) + 1e-10
    ym = y - y.mean(dim=1, keepdim=True) + 1e-10
    return (xm * ym).mean(dim=1) / ((xm ** 2).mean(dim=1)
                                    * (ym ** 2).mean(dim=1)).sqrt()


def _central(f, axis, h):
    n = f.shape[axis]
    up = torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                   dim=axis)
    down = torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                     dim=axis)
    return (up - down) * (0.5 / h)


def smoothness_per_sample(disp):
    """Mean over the voxels of ``sum_c sum_axis (d disp_c / d x)^2``."""
    total = 0.0
    for axis in (2, 3, 4):
        h = 2.0 / (disp.shape[axis] - 1.0)
        total = total + (_central(disp, axis, h) ** 2).sum(dim=1)
    return total.reshape(disp.shape[0], -1).mean(dim=1)


class LiftReg:
    """The model and its two uses (serving with optional projection-domain
    refinement, and the train step) for one configuration.

    ``cfg``: the configuration's sizes (``img_sz``, ``n_proj``,
    ``scan_range_deg``, ``spacing``, ``resolution``). ``low``/``tf32``:
    see the module docstring. ``geometry`` shares another instance's
    :class:`Geometry` of the same configuration."""

    def __init__(self, cfg, device, low="float32", tf32=False,
                 geometry=None):
        self.sz = tuple(int(n) for n in cfg["img_sz"])
        self.device = torch.device(device)
        self.q = rounder(low)
        self.tf32 = tf32
        self.poses = synthesize_poses(cfg["scan_range_deg"], cfg["n_proj"],
                                      self.sz[1])
        self.geometry = geometry or Geometry(
            self.poses, self.sz, cfg["resolution"], cfg["spacing"],
            self.device)
        self.identity = identity_map(self.sz, self.device)

    # -- pieces -------------------------------------------------------------
    def drr(self, hu):
        """(B, 1, D, W, H) HU -> normalized (B, P, rd, rh) DRRs."""
        with precision(self.tf32):
            return normalize_drr(self.geometry.project(attenuation(hu[:, 0])))

    def encode(self, weights, source, proj):
        """PCA coefficients (B, L) f32 from the normalized moving CT
        (B, 1, D, W, H) and the target projections (B, P, rd, rh)."""
        q = self.q
        x = q(torch.cat([source, self.geometry.lift(proj)], dim=1))
        for i, (w, b) in enumerate(weights["convs"]):
            x = q(F.conv3d(x, q(w), q(b), stride=1 if i == 0 else 2,
                           padding=1))
            x = q(F.leaky_relu(x, NEGATIVE_SLOPE))
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        fcs = weights["fcs"]
        for j, (w, b) in enumerate(fcs):
            x = q(F.linear(x, q(w), q(b)))
            if j < len(fcs) - 1:
                x = q(F.leaky_relu(x, NEGATIVE_SLOPE))
        return x

    def expand(self, coefs, basis):
        """(B, L) coefficients -> (B, 3, D, W, H) displacement."""
        vectors, mean = basis
        disp = self.q(coefs) @ self.q(vectors.float()) + mean
        return disp.reshape(coefs.shape[0], 3, *self.sz)

    def _warp_ct(self, moving_cp, phi):
        """The normalized masked CT under phi, its taps in [0, 1] rounded
        to the stated type, zeros outside."""
        return warp(self.q((moving_cp + 1.0) * 0.5), phi) * 2.0 - 1.0

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
    def serve(self, weights, basis, source_hu, source_seg, target_proj,
              refine=None):
        """``RegistrationPipeline.register_projections``' result for
        normalized target DRRs; ``refine`` (steps, lr, reg_factor) refines
        the coefficients against them in the projection domain. Returns
        ``coefs``, ``phi`` and ``warped``, and with ``refine`` the
        objective of each evaluated iterate, ``totals`` (steps + 1, B), and
        the batch mean of the first, ``start``."""
        with precision(self.tf32):
            coefs = self.encode(weights, normalize_hu(source_hu),
                                target_proj)
            out = {}
            if refine is not None:
                coefs, out["totals"] = self._refine(coefs, basis, source_hu,
                                                    target_proj, *refine)
                out["start"] = out["totals"][0].mean()
            out.update(self.outputs(basis, source_hu, source_seg, coefs))
            return out

    @torch.no_grad()
    def objective(self, basis, source_hu, target_proj, coefs, reg_factor):
        """The projection-domain refinement's objective of each case at
        ``coefs`` (B, L)."""
        with precision(self.tf32):
            return self._refine_losses(coefs, basis,
                                       self.q(attenuation(source_hu)),
                                       target_proj, reg_factor)

    @torch.no_grad()
    def outputs(self, basis, source_hu, source_seg, coefs):
        """``coefs``, and phi and the warped masked CT that they give."""
        with precision(self.tf32):
            moving_cp = (normalize_hu(source_hu) + 1.0) * source_seg - 1.0
            phi = self.expand(coefs, basis) + self.identity[None]
            return {"coefs": coefs, "phi": phi,
                    "warped": self._warp_ct(moving_cp, phi)}

    def _refine_losses(self, z, basis, taps, target_proj, reg_factor):
        disp = self.expand(z, basis)
        warped = warp(taps, disp + self.identity[None])
        proj = normalize_drr(self.geometry.project(warped[:, 0]))
        return (1.0 - ncc_per_sample(proj, target_proj)
                + reg_factor * smoothness_per_sample(disp))

    def _refine(self, coefs0, basis, source_hu, target_proj, steps, lr,
                reg_factor):
        """Adam on the coefficients over ``steps`` + 1 gradient evaluations
        of the batch mean; returns each case's best iterate and the objective
        of every evaluated iterate."""
        taps = self.q(attenuation(source_hu))
        z = coefs0.clone()
        b1, b2 = REFINE_BETAS
        mu = torch.zeros_like(z)
        nu = torch.zeros_like(z)
        best_z = z.clone()
        best = torch.full((z.shape[0],), math.inf, device=z.device)
        totals = []
        for t in range(1, steps + 2):
            with torch.enable_grad():
                zg = z.detach().requires_grad_(True)
                per = self._refine_losses(zg, basis, taps, target_proj,
                                          reg_factor)
                (g,) = torch.autograd.grad(per.mean(), zg)
            per = per.detach()
            totals.append(per)
            better = per < best
            best_z = torch.where(better[:, None], z, best_z)
            best = torch.where(better, per, best)
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * g * g + b2 * nu
            m_hat = mu / (1 - b1 ** t)
            v_hat = nu / (1 - b2 ** t)
            z = z - lr * m_hat / (v_hat.sqrt() + REFINE_EPS)
        return best_z, torch.stack(totals)

    # -- training -----------------------------------------------------------
    def _train_loss(self, weights, basis, rows, n_total, reg_factor):
        """The rows' share of the batch's loss: their NCC and smoothness
        terms over the whole batch's size."""
        source, target = rows["source"], rows["target"]
        moving_cp = (source + 1.0) * rows["source_label"] - 1.0
        target_cp = (target + 1.0) * rows["target_label"] - 1.0
        coefs = self.encode(weights, source, rows["target_proj"])
        disp = self.expand(coefs, basis)
        warped = self._warp_ct(moving_cp, disp + self.identity[None])
        sim = (1.0 - ncc_per_sample(warped, target_cp)).sum() / n_total
        reg = smoothness_per_sample(disp).sum() / n_total
        return sim + reg_factor * reg

    def train(self, weights, basis, batches, lr, reg_factor, betas=(0.9,
              0.999), eps=1e-5, block=10):
        """Adam steps from ``weights`` over ``batches`` (dicts of (B, ...)
        tensors), each batch's loss and gradient taken ``block`` rows at a
        time. Returns the losses, the first step's gradients and the
        weights after the last step, as lists of leaves in the order of
        ``leaves(weights)``."""
        params = [p.detach().clone().requires_grad_(True)
                  for p in leaves(weights)]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        b1, b2 = betas
        losses, first_grads = [], None
        for t, batch in enumerate(batches, start=1):
            n = next(iter(batch.values())).shape[0]
            grads = [torch.zeros_like(p) for p in params]
            loss = 0.0
            with precision(self.tf32):
                for r0 in range(0, n, block):
                    rows = {k: v[r0:r0 + block] for k, v in batch.items()}
                    part = self._train_loss(rebuild(weights, params), basis,
                                            rows, n, reg_factor)
                    for acc, g in zip(grads, torch.autograd.grad(part,
                                                                 params)):
                        acc += g
                    loss += float(part.detach())
            losses.append(loss)
            if first_grads is None:
                first_grads = [g.clone() for g in grads]
            with torch.no_grad():
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    m_hat = m / (1 - b1 ** t)
                    v_hat = v / (1 - b2 ** t)
                    p -= lr * m_hat / (v_hat.sqrt() + eps)
        return losses, first_grads, [p.detach() for p in params]


def leaves(weights):
    """The weights' tensors in a fixed order: each convolution's weight
    and bias, then each fully connected layer's."""
    return [t for layer in weights["convs"] + weights["fcs"] for t in layer]


def rebuild(weights, flat):
    """``weights``' structure holding the tensors of ``flat``."""
    it = iter(flat)
    return {k: [(next(it), next(it)) for _ in weights[k]]
            for k in ("convs", "fcs")}
