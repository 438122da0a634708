"""DRR projector and backprojection lift from per-plane pixel coordinates:
the Hopper kernels and their plain PyTorch versions.

The kernels replace ``liftreg_tpu/ops/pallas_drr.py``: ``_proj_kernel`` by
``csrc/drr_project.cu`` and ``_backproj_kernel`` by
``csrc/drr_backproject.cu``. The TPU kernels run dense matmul chains over
the interpolation matrices of ``drr.forward_matrices`` /
``drr.backward_matrices``; every row of those holds at most two taps, so the
Hopper kernels read the coordinates (:func:`.drr.forward_geometry`,
:func:`.drr.backward_geometry`) and gather the taps. The plain versions are
the dense products of :mod:`.drr` on the matrices built from the same
coordinates.

:func:`project_taps` and :func:`backproject_taps` launch the kernels for
CUDA tensors and run the plain versions for CPU tensors; they never fall
back from one to the other. ``.launches`` on each counts kernel launches.
:func:`project` and :func:`backproject` take the poses instead of the
geometry, as ``liftreg_tpu.ops.drr.project``/``backproject`` do.
"""
from __future__ import annotations

import torch

from . import _build, drr


def project_taps_plain(vol, x_pix, z_pix, dx, plane_chunk=32):
    """vol (B, D, W, H) f32, x_pix (P, W, res_d), z_pix (P, W, res_h),
    dx (P, res_d, res_h) -> (B, P, res_d, res_h) f32."""
    return drr.project_with_mats(vol, drr._two_tap_matrix(x_pix, vol.shape[1]),
                                 drr._two_tap_matrix(z_pix, vol.shape[3]), dx,
                                 plane_chunk=plane_chunk)


def backproject_taps_plain(proj, u_pix, v_pix, plane_chunk=16):
    """proj (B, P, pw, ph) f32, u_pix (P, W, D), v_pix (P, W, H) ->
    (B, P, D, W, H) f32."""
    return drr.backproject_with_mats(
        proj, drr._two_tap_matrix(u_pix, proj.shape[2]),
        drr._two_tap_matrix(v_pix, proj.shape[3]), plane_chunk=plane_chunk)


_F32 = (torch.float32,)


def project_taps(vol, x_pix, z_pix, dx, plane_chunk=32):
    """The projector kernel on CUDA tensors, the plain version on CPU
    tensors (``plane_chunk`` only shapes the plain version's products)."""
    tensors = {"vol": vol, "x_pix": x_pix, "z_pix": z_pix, "dx": dx}
    device = _build.inputs_device("project_taps", tensors,
                                  dict.fromkeys(tensors, _F32))
    if vol.dim() != 4 or x_pix.dim() != 3 or z_pix.dim() != 3 \
            or dx.dim() != 3:
        raise ValueError("project_taps: want vol (B, D, W, H), x_pix "
                         "(P, W, res_d), z_pix (P, W, res_h), dx "
                         "(P, res_d, res_h)")
    B, D, W, H = vol.shape
    P, _, res_d = x_pix.shape
    res_h = z_pix.shape[2]
    if x_pix.shape[1] != W or z_pix.shape[:2] != (P, W) \
            or dx.shape != (P, res_d, res_h):
        raise ValueError(f"project_taps: shapes {tuple(vol.shape)}, "
                         f"{tuple(x_pix.shape)}, {tuple(z_pix.shape)}, "
                         f"{tuple(dx.shape)} do not agree")
    if device.type == "cpu":
        return project_taps_plain(vol, x_pix, z_pix, dx, plane_chunk)
    out = torch.empty((B, P, res_d, res_h), dtype=torch.float32,
                      device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_drr_project(vol.data_ptr(), x_pix.data_ptr(),
                                     z_pix.data_ptr(), dx.data_ptr(),
                                     out.data_ptr(), B, P, D, W, H, res_d,
                                     res_h, stream)
    _build.check(rc, "project_taps")
    project_taps.launches += 1
    return out


project_taps.launches = 0


def backproject_taps(proj, u_pix, v_pix, plane_chunk=16):
    """The lift kernel on CUDA tensors, the plain version on CPU tensors
    (``plane_chunk`` only shapes the plain version's products)."""
    tensors = {"proj": proj, "u_pix": u_pix, "v_pix": v_pix}
    device = _build.inputs_device("backproject_taps", tensors,
                                  dict.fromkeys(tensors, _F32))
    if proj.dim() != 4 or u_pix.dim() != 3 or v_pix.dim() != 3:
        raise ValueError("backproject_taps: want proj (B, P, pw, ph), "
                         "u_pix (P, W, D), v_pix (P, W, H)")
    B, P, pw, ph = proj.shape
    _, W, D = u_pix.shape
    H = v_pix.shape[2]
    if u_pix.shape[0] != P or v_pix.shape[:2] != (P, W):
        raise ValueError(f"backproject_taps: shapes {tuple(proj.shape)}, "
                         f"{tuple(u_pix.shape)}, {tuple(v_pix.shape)} do "
                         "not agree")
    if device.type == "cpu":
        return backproject_taps_plain(proj, u_pix, v_pix, plane_chunk)
    out = torch.empty((B, P, D, W, H), dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_drr_backproject(proj.data_ptr(), u_pix.data_ptr(),
                                         v_pix.data_ptr(), out.data_ptr(),
                                         B, P, D, W, H, pw, ph, stream)
    _build.check(rc, "backproject_taps")
    backproject_taps.launches += 1
    return out


backproject_taps.launches = 0


def project(vol, poses, resolution=None, spacing=(2.2, 2.2, 2.2),
            plane_chunk=32):
    """DRR of ``(B, D, W, H)`` (or ``(D, W, H)``) attenuation volumes;
    ``poses`` (P, 3) numpy or tensor in voxel units. Builds the geometry
    on every call; callers with static poses keep
    :func:`.drr.forward_geometry` and call :func:`project_taps`."""
    squeeze = vol.dim() == 3
    if squeeze:
        vol = vol[None]
    if resolution is None:
        resolution = drr.default_resolution(vol.shape[1:])
    poses = torch.as_tensor(poses, dtype=vol.dtype, device=vol.device)
    geometry = drr.forward_geometry(poses, vol.shape[1:], resolution,
                                    spacing)
    out = project_taps(vol.contiguous(), *geometry, plane_chunk=plane_chunk)
    return out[0] if squeeze else out


def backproject(proj, poses, vol_shape, plane_chunk=16):
    """Backproject ``(B, P, proj_w, proj_h)`` (or unbatched) projections
    into ``(B, P, D, W, H)`` feature volumes."""
    squeeze = proj.dim() == 3
    if squeeze:
        proj = proj[None]
    poses = torch.as_tensor(poses, dtype=proj.dtype, device=proj.device)
    geometry = drr.backward_geometry(poses, vol_shape, proj.shape[2:])
    out = backproject_taps(proj.contiguous(), *geometry,
                           plane_chunk=plane_chunk)
    return out[0] if squeeze else out
