"""DRR projector and backprojector, PyTorch port of ``liftreg_tpu/ops/drr.py``.

The ray/plane intersection coordinates of the reference geometry are
separable, so the bilinear line integral is a pair of products with 2-tap
interpolation matrices per coronal plane ``k``:

    proj[p,u,v] = 0.1*dx[p,u,v] * sum_k  Rx[p,k] @ vol[:,k,:] @ Rz[p,k]^T

and the backprojection lift is ``out[b,p,:,k,:] = Bu[p,k] @ proj[b,p] @
Bv[p,k]^T`` with the reversed coronal axis folded into ``Bu``/``Bv``.
:func:`forward_geometry` and :func:`backward_geometry` give the pixel
coordinates whose 2-tap rows make those matrices; the kernels of
:mod:`.drr_kernel` read the coordinates, and the dense products here
(plain f32 ``torch.matmul``, kept in f32 on the card by
:func:`..device.f32_precision`, as the JAX package leaves them to XLA at
HIGHEST precision) are their plain versions, and
:func:`project_adjoint_with_mats` is the plain version of the projector's
adjoint; ``project`` and ``backproject`` from poses are in
:mod:`.drr_kernel`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..coords import linspace_in_jit
from ..device import f32_precision


def calc_relative_atten_coef(img):
    """HU -> linear attenuation, water = 0.2/cm."""
    return (img.clamp(min=-1000.0) + 1000.0) / 1000.0 * 0.2


def normalize_drr(proj):
    """DRR clip [0, 6] -> [-1, 1], the dataset's stored-projection
    normalization. The clip is ``minimum(maximum(p, 0), 6)``, as
    ``jnp.clip`` is, so that its gradient at 0 and at 6 is 1/2, as in JAX
    (``clamp``'s is 1); the values are the same. The bounds are filled on
    the device: a tensor copied from a host scalar would synchronise the
    stream."""
    clipped = torch.minimum(torch.maximum(proj, proj.new_zeros(())),
                            proj.new_full((), 6.0))
    return clipped / 6.0 * 2.0 - 1.0


def calc_relative_atten_coef_preprocessing(img):
    """The preprocessing tool's unit-less variant,
    ``(clip(img, -1024) + 1024) / 1024``."""
    return (img.clamp(min=-1024.0) + 1024.0) / 1024.0


def poses_from_geometry_csv(csv_path, spacing):
    """Physical emitter positions (mm, a CSV with a header row) -> voxel
    units, ``(P, 3)`` numpy f32."""
    geo = np.genfromtxt(csv_path, delimiter=",")[1:]
    return (geo / np.asarray(spacing)).astype(np.float32)


def synthesize_poses(scan_range_deg, n_proj, width, emitter_y_scale=3.5):
    """Limited-angle emitter poses in voxel units, ``(P, 3)`` numpy f32:
    y = 3.5*W, x = tan(linspace(-r/2, r/2))*3*W, z = linspace(-0.2,0.2)*W."""
    half = scan_range_deg / 2.0
    poses = np.zeros((n_proj, 3), dtype=np.float64)
    poses[:, 1] = emitter_y_scale
    poses[:, 0] = np.tan(np.linspace(-half, half, num=n_proj)
                         / 180.0 * np.pi) * 3.0
    poses[:, 2] = np.linspace(-0.2, 0.2, num=n_proj)
    return (poses * width).astype(np.float32)


def default_resolution(vol_shape, scale=1.5):
    """Detector resolution default: 1.5x the volume's axes 0 and 2."""
    return (int(vol_shape[0] * scale), int(vol_shape[2] * scale))


def _two_tap_matrix(pix, n):
    """``relu(1 - |pix[..., None] - arange(n)|)``: 2-tap linear
    interpolation rows with implicit zeros padding."""
    grid = torch.arange(n, dtype=pix.dtype, device=pix.device)
    return (1.0 - (pix[..., None] - grid).abs()).clamp(min=0.0)


def _linspace(a, b, n, like):
    """``jnp.linspace`` rounded as the JAX package's geometry rounds it
    inside ``jit``, where its projector and lift build it
    (:func:`..coords.linspace_in_jit`), on the device and in the dtype of
    ``like``."""
    return linspace_in_jit(a, b, n).to(device=like.device, dtype=like.dtype)


def forward_geometry(poses, vol_shape, resolution, spacing):
    """Per-plane pixel coordinates of the projector's rays: ``x_pix``
    (P, W, res_d) along axis 0 and ``z_pix`` (P, W, res_h) along axis 2 for
    each coronal plane, and ``dx`` (P, res_d, res_h), the path length per
    plane step in mm. ``poses`` is a (P, 3) f32 tensor on the target
    device. The poses are static, so callers build this once."""
    D, W, H = [int(s) for s in vol_shape]
    res_d, res_h = [int(r) for r in resolution]
    spacing = torch.as_tensor(spacing, dtype=poses.dtype, device=poses.device)
    lin_x = _linspace(-res_d / 2.0, res_d / 2.0 - 1.0, res_d, poses)
    lin_y = _linspace(-res_h / 2.0, res_h / 2.0 - 1.0, res_h, poses)
    planes = _linspace(0.0, W - 1.0, W, poses)

    ex, ey, ez = poses[:, 0], poses[:, 1], poses[:, 2]
    s = (planes[None, :] - ey[:, None]) / (-ey[:, None])             # (P, W)
    px = ex[:, None, None] + s[:, :, None] * (lin_x[None, None, :]
                                              - ex[:, None, None])
    pz = ez[:, None, None] + s[:, :, None] * (lin_y[None, None, :]
                                              - ez[:, None, None])
    x_pix = (px / D + 0.5) * (D - 1.0)                               # (P, W, res_d)
    z_pix = (pz / H + 0.5) * (H - 1.0)                               # (P, W, res_h)

    rx = (lin_x[None, :] - ex[:, None]) / (-ey[:, None])             # (P, res_d)
    rz = (lin_y[None, :] - ez[:, None]) / (-ey[:, None])             # (P, res_h)
    dx = torch.sqrt((rx[:, :, None] * spacing[0]) ** 2
                    + spacing[1] ** 2
                    + (rz[:, None, :] * spacing[2]) ** 2)
    return x_pix.contiguous(), z_pix.contiguous(), dx.contiguous()


def forward_matrices(poses, vol_shape, resolution, spacing):
    """(Rx (P, W, res_d, D), Rz (P, W, res_h, H), dx (P, res_d, res_h)) for
    :func:`project_with_mats`: the dense form of :func:`forward_geometry`."""
    x_pix, z_pix, dx = forward_geometry(poses, vol_shape, resolution, spacing)
    return (_two_tap_matrix(x_pix, int(vol_shape[0])),
            _two_tap_matrix(z_pix, int(vol_shape[2])), dx)


def backward_geometry(poses, vol_shape, proj_shape):
    """Per-plane detector coordinates of the lift: ``u_pix`` (P, W, D) and
    ``v_pix`` (P, W, H), with the reversed coronal axis ``y_world = W-1-j``
    folded in."""
    D, W, H = [int(s) for s in vol_shape]
    proj_w, proj_h = [int(s) for s in proj_shape]
    ex, ey, ez = poses[:, 0], poses[:, 1], poses[:, 2]
    gx = _linspace(-D / 2.0, D / 2.0 - 1.0, D, poses)
    yw = _linspace(W - 1.0, 0.0, W, poses)                           # reversed
    gz = _linspace(-H / 2.0, H / 2.0 - 1.0, H, poses)

    scale = ey[:, None] / (ey[:, None] - yw[None, :])                # (P, W)
    u3 = (gx[None, None, :] - ex[:, None, None]) * scale[:, :, None] \
        + ex[:, None, None]
    v3 = (gz[None, None, :] - ez[:, None, None]) * scale[:, :, None] \
        + ez[:, None, None]
    u_pix = (u3 / proj_w + 0.5) * (proj_w - 1.0)                     # (P, W, D)
    v_pix = (v3 / proj_h + 0.5) * (proj_h - 1.0)                     # (P, W, H)
    return u_pix.contiguous(), v_pix.contiguous()


def backward_matrices(poses, vol_shape, proj_shape):
    """(Bu (P, W, D, proj_w), Bv (P, W, H, proj_h)) for
    :func:`backproject_with_mats`: the dense form of
    :func:`backward_geometry`."""
    u_pix, v_pix = backward_geometry(poses, vol_shape, proj_shape)
    return (_two_tap_matrix(u_pix, int(proj_shape[0])),
            _two_tap_matrix(v_pix, int(proj_shape[1])))


@f32_precision()
def project_with_mats(vol, Rx, Rz, dx, plane_chunk=32):
    """vol (B, D, W, H) attenuation -> (B, P, res_d, res_h), accumulated
    over chunks of coronal planes to bound the intermediate."""
    B, D, W, H = vol.shape
    P, _, res_d, _ = Rx.shape
    res_h = Rz.shape[2]
    total = torch.zeros((B, P, res_d, res_h), dtype=torch.float32,
                        device=vol.device)
    for k0 in range(0, W, plane_chunk):
        k1 = min(k0 + plane_chunk, W)
        kc = k1 - k0
        vol_c = vol[:, :, k0:k1, :].permute(0, 2, 1, 3)              # (B, kc, D, H)
        # (1, P, kc, res_d, D) @ (B, 1, kc, D, H) -> (B, P, kc, res_d, H)
        t = torch.matmul(Rx[None, :, k0:k1], vol_c[:, None])
        t = t.permute(0, 1, 3, 2, 4).reshape(B, P, res_d, kc * H)
        rz = Rz[:, k0:k1].permute(0, 1, 3, 2).reshape(P, kc * H, res_h)
        total = total + torch.matmul(t, rz[None])
    return total * dx[None] * 0.1  # mm -> cm


@f32_precision()
def project_adjoint_with_mats(g, Rx, Rz, dx, plane_chunk=32):
    """The VJP of :func:`project_with_mats` with respect to the volume:
    g (B, P, res_d, res_h) -> dvol (B, D, W, H) = sum_p Rx[p,k]^T @ G[b,p]
    @ Rz[p,k] per coronal plane k, chunked over the planes. The cotangent
    is scaled as autograd of ``total * dx * 0.1`` scales it,
    ``G = (g * 0.1) * dx``."""
    B, P, res_d, _ = g.shape
    W, D = Rx.shape[1], Rx.shape[3]
    H = Rz.shape[3]
    G = g * 0.1 * dx[None]
    dvol = torch.empty((B, D, W, H), dtype=torch.float32, device=g.device)
    for k0 in range(0, W, plane_chunk):
        k1 = min(k0 + plane_chunk, W)
        kc = k1 - k0
        # (B, P, 1, res_d, res_h) @ (1, P, kc, res_h, H)
        #   -> (B, P, kc, res_d, H)
        u = torch.matmul(G[:, :, None], Rz[None, :, k0:k1])
        u = u.permute(0, 2, 1, 3, 4).reshape(B, kc, P * res_d, H)
        # the views and detector rows in one contraction:
        # (1, kc, D, P*res_d) @ (B, kc, P*res_d, H) -> (B, kc, D, H)
        rx = Rx[:, k0:k1].permute(1, 3, 0, 2).reshape(kc, D, P * res_d)
        dvol[:, :, k0:k1, :] = torch.matmul(rx[None], u).permute(0, 2, 1, 3)
    return dvol


@f32_precision()
def backproject_with_mats(proj, Bu, Bv, plane_chunk=16):
    """proj (B, P, proj_w, proj_h) -> (B, P, D, W, H), chunked over the
    coronal axis."""
    B, P = proj.shape[:2]
    W, D = Bu.shape[1], Bu.shape[2]
    H = Bv.shape[2]
    out = torch.empty((B, P, D, W, H), dtype=torch.float32,
                      device=proj.device)
    for j0 in range(0, W, plane_chunk):
        j1 = min(j0 + plane_chunk, W)
        # (1, P, jc, D, pw) @ (B, P, 1, pw, ph) -> (B, P, jc, D, ph)
        t = torch.matmul(Bu[None, :, j0:j1], proj[:, :, None])
        # (B, P, jc, D, ph) @ (1, P, jc, ph, H) -> (B, P, jc, D, H)
        t = torch.matmul(t, Bv[None, :, j0:j1].transpose(-1, -2))
        out[:, :, :, j0:j1, :] = t.permute(0, 1, 3, 2, 4)
    return out
