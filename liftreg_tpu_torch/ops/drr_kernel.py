"""DRR projector, its adjoint and the backprojection lift from per-plane
pixel coordinates: the Hopper kernels and their plain PyTorch versions.

The kernels replace ``liftreg_tpu/ops/pallas_drr.py``: ``_proj_kernel`` by
``csrc/drr_project.cu`` and ``_backproj_kernel`` by
``csrc/drr_backproject.cu``; ``csrc/drr_project_adjoint.cu`` is the
projector's adjoint, whose JAX counterpart is XLA's autodiff of
``liftreg_tpu/ops/drr.py:project_with_mats``. The TPU kernels run dense
matmul chains over the interpolation matrices of ``drr.forward_matrices`` /
``drr.backward_matrices``; every row of those holds at most two taps, so the
Hopper kernels read the coordinates (:func:`.drr.forward_geometry`,
:func:`.drr.backward_geometry`) and gather the taps. The plain versions are
the dense products of :mod:`.drr` on the matrices built from the same
coordinates.

:func:`project_taps`, :func:`project_adjoint_taps` and
:func:`backproject_taps` launch the kernels for CUDA tensors and run the
plain versions for CPU tensors; they never fall back from one to the other.
The serving path's two, the projector and the lift, are ``torch.library``
operators (:mod:`._library`): ``liftreg::project``, ``liftreg::backproject``
(the lift as a new f32 tensor) and ``liftreg::encoder_input``
(:func:`lift_encoder_input`: the encoder's f32 or bf16 input buffer, made
and filled by one operator, the lift rounded once to its dtype).
``.launches`` on each counts kernel launches, one per call; a projector call
whose plane loop is split runs as two passes on the card (the chunks'
partial sums, then their ordered sum), counted as one launch. The adjoint
reads a plan of its geometry (:func:`project_adjoint_plan`: per geometry
row and voxel index, the run of pixels whose tap reaches it), which a
caller with static poses builds once and passes in; without one,
:func:`project_adjoint_taps` builds it first. :func:`project_taps_ad` is
the projector under autograd: its backward is the adjoint.
:func:`project` (differentiable with respect to the volume) and
:func:`backproject` take the poses instead of the geometry, as
``liftreg_tpu.ops.drr.project``/``backproject`` do.
"""
from __future__ import annotations

import torch

from . import _build, _library, drr


def project_taps_plain(vol, x_pix, z_pix, dx, plane_chunk=32):
    """vol (B, D, W, H) f32, x_pix (P, W, res_d), z_pix (P, W, res_h),
    dx (P, res_d, res_h) -> (B, P, res_d, res_h) f32."""
    return drr.project_with_mats(vol, drr._two_tap_matrix(x_pix, vol.shape[1]),
                                 drr._two_tap_matrix(z_pix, vol.shape[3]), dx,
                                 plane_chunk=plane_chunk)


def project_adjoint_taps_plain(g, x_pix, z_pix, dx, vol_shape,
                               plane_chunk=32):
    """g (B, P, res_d, res_h) f32, the geometry of :func:`project_taps_plain`
    for a volume of ``vol_shape`` (D, W, H) -> dvol (B, D, W, H) f32: the
    dense transposed products."""
    D, _, H = (int(n) for n in vol_shape)
    return drr.project_adjoint_with_mats(
        g, drr._two_tap_matrix(x_pix, D), drr._two_tap_matrix(z_pix, H), dx,
        plane_chunk=plane_chunk)


#: entries of :func:`project_adjoint_plan`: no tap reaches the voxel index,
#: and the geometry row is in no order
PLAN_EMPTY, PLAN_UNORDERED = -1, -2


def project_adjoint_plan_plain(x_pix, z_pix, vol_shape):
    """The plan of the projector's adjoint for a geometry, from the nonzeros
    of the dense interpolation matrices: (P, W, D + H, 2) int32, for each
    row (p, k) of ``x_pix`` (entries ``[:D]``) and of ``z_pix`` (``[D:]``)
    and each voxel index m, ``(start, count)`` of the pixels whose weight
    ``max(0, 1 - |pix - m|)`` is nonzero, which is one run in a row that
    rises or falls; ``(PLAN_EMPTY, 0)`` where there is none, and
    ``(PLAN_UNORDERED, 0)`` for every m of a row in no order."""
    D, _, H = (int(n) for n in vol_shape)

    def runs(pix, n):
        nonzero = drr._two_tap_matrix(pix, n) > 0          # (P, W, R, n)
        count = nonzero.sum(dim=-2, dtype=torch.int32)
        start = nonzero.to(torch.int32).argmax(dim=-2).to(torch.int32)
        start = torch.where(count > 0, start, PLAN_EMPTY)
        step = pix[..., 1:] - pix[..., :-1]
        ordered = ((step >= 0).all(-1) | (step <= 0).all(-1))[..., None]
        return torch.stack([torch.where(ordered, start, PLAN_UNORDERED),
                            torch.where(ordered, count, 0)], dim=-1)

    return torch.cat([runs(x_pix, D), runs(z_pix, H)], dim=2).to(torch.int32)


def backproject_taps_plain(proj, u_pix, v_pix, plane_chunk=16):
    """proj (B, P, pw, ph) f32, u_pix (P, W, D), v_pix (P, W, H) ->
    (B, P, D, W, H) f32."""
    return drr.backproject_with_mats(
        proj, drr._two_tap_matrix(u_pix, proj.shape[2]),
        drr._two_tap_matrix(v_pix, proj.shape[3]), plane_chunk=plane_chunk)


_F32 = (torch.float32,)
#: the lift writes f32, or bf16 into a bf16 encoder input
OUT_DTYPES = (torch.float32, torch.bfloat16)
#: csrc/drr_project.cu: output tile (rows, columns) and batch elements per
#: block; the wrapper splits the plane loop (in chunks of >= 8 planes) until
#: the grid holds about this many blocks per SM: more, shorter blocks ran
#: faster on the H100 than one wave of long ones
_PROJ_TILE = (16, 32)
_PROJ_NB = 4
_PROJ_BLOCKS_PER_SM = 32
#: the most planes one block of csrc/drr_project.cu walks (its shared table)
_PROJ_MAX_PLANES = 64
_INT32_MAX = 2 ** 31 - 1


def _check_int32(name, *counts):
    """The kernels index with 32-bit ints."""
    if max(counts) > _INT32_MAX:
        raise ValueError(f"{name}: {max(counts)} elements exceed the "
                         "kernel's 32-bit indices")


def _plane_chunks(sms, B, P, W, res_d, res_h):
    """Chunks of the projector's plane loop on a card of ``sms`` SMs:
    enough blocks to fill it (a tile alone gives one block per (tile, view,
    batch group)), and at most ``_PROJ_MAX_PLANES`` planes per chunk."""
    tiles = -(-res_d // _PROJ_TILE[0]) * -(-res_h // _PROJ_TILE[1])
    blocks = tiles * P * -(-B // _PROJ_NB)
    return max(1, -(-W // _PROJ_MAX_PLANES),
               min(-(-_PROJ_BLOCKS_PER_SM * sms // blocks), W // 8))


def _project_shapes(vol, x_pix, z_pix, dx):
    """(B, P, D, W, H, res_d, res_h) of a projector call, after checking
    the operands' ranks and shapes."""
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
    return B, P, D, W, H, res_d, res_h


def _project_impl(vol, x_pix, z_pix, dx, plane_chunk):
    """``liftreg::project`` on the CPU (the plain version) and on CUDA (the
    kernel)."""
    tensors = {"vol": vol, "x_pix": x_pix, "z_pix": z_pix, "dx": dx}
    device = _build.inputs_device("project_taps", tensors,
                                  dict.fromkeys(tensors, _F32))
    B, P, D, W, H, res_d, res_h = _project_shapes(vol, x_pix, z_pix, dx)
    if device.type == "cpu":
        return project_taps_plain(vol, x_pix, z_pix, dx, plane_chunk)
    out = torch.empty((B, P, res_d, res_h), dtype=torch.float32,
                      device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = _plane_chunks(sms, B, P, W, res_d, res_h)
    _check_int32("project_taps", vol.numel(), x_pix.numel(), z_pix.numel(),
                 chunks * out.numel())
    # the chunks' partial sums, added in order by the kernel's second pass
    part = out if chunks == 1 else torch.empty((chunks,) + out.shape,
                                               dtype=torch.float32,
                                               device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_drr_project(vol.data_ptr(), x_pix.data_ptr(),
                                     z_pix.data_ptr(), dx.data_ptr(),
                                     out.data_ptr(), part.data_ptr(), B, P, D,
                                     W, H, res_d, res_h, chunks, stream)
    _build.check(rc, "project_taps")
    project_taps.launches += 1
    return out


def _project_fake(vol, x_pix, z_pix, dx, plane_chunk):
    B, P, _, _, _, res_d, res_h = _project_shapes(vol, x_pix, z_pix, dx)
    return vol.new_empty((B, P, res_d, res_h), dtype=torch.float32)


_library.define("project(Tensor vol, Tensor x_pix, Tensor z_pix, Tensor dx, "
                "int plane_chunk) -> Tensor", _project_impl, _project_fake)


def project_taps(vol, x_pix, z_pix, dx, plane_chunk=32):
    """The projector kernel on CUDA tensors, the plain version on CPU
    tensors (``plane_chunk`` only shapes the plain version's products):
    the operator ``liftreg::project``."""
    return torch.ops.liftreg.project(vol, x_pix, z_pix, dx, plane_chunk)


project_taps.launches = 0


def project_adjoint_plan(x_pix, z_pix, vol_shape):
    """The plan of the projector's adjoint (:func:`project_adjoint_plan_plain`
    gives its definition) for the geometry of :func:`project_taps` and a
    volume of ``vol_shape`` (D, W, H): the plan kernel on CUDA tensors, the
    plain version on CPU tensors. It depends on the geometry alone: a
    caller with static poses builds it once and passes it to every
    :func:`project_adjoint_taps`."""
    tensors = {"x_pix": x_pix, "z_pix": z_pix}
    device = _build.inputs_device("project_adjoint_plan", tensors,
                                  dict.fromkeys(tensors, _F32))
    D, W, H = (int(n) for n in vol_shape)
    if x_pix.dim() != 3 or z_pix.dim() != 3 or x_pix.shape[1] != W \
            or z_pix.shape[:2] != x_pix.shape[:2]:
        raise ValueError(f"project_adjoint_plan: want x_pix (P, W, res_d), "
                         f"z_pix (P, W, res_h) for a volume {(D, W, H)}; got "
                         f"{tuple(x_pix.shape)}, {tuple(z_pix.shape)}")
    if device.type == "cpu":
        return project_adjoint_plan_plain(x_pix, z_pix, (D, W, H))
    P, _, res_d = x_pix.shape
    res_h = z_pix.shape[2]
    plan = torch.empty((P, W, D + H, 2), dtype=torch.int32, device=device)
    _check_int32("project_adjoint_plan", x_pix.numel(), z_pix.numel(),
                 plan.numel())
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_drr_adjoint_plan(x_pix.data_ptr(), z_pix.data_ptr(),
                                          plan.data_ptr(), P, W, D, H, res_d,
                                          res_h, stream)
    _build.check(rc, "project_adjoint_plan")
    project_adjoint_plan.launches += 1
    return plan


project_adjoint_plan.launches = 0


def project_adjoint_taps(g, x_pix, z_pix, dx, vol_shape, plane_chunk=32,
                         plan=None, general_tiles=None):
    """The projector's adjoint: the adjoint kernel on CUDA tensors, the
    plain version on CPU tensors (``plane_chunk`` only shapes the plain
    version's products). g (B, P, res_d, res_h) and the geometry of
    :func:`project_taps` for a volume of ``vol_shape`` (D, W, H) -> dvol
    (B, D, W, H) f32.

    On the card, ``plan`` is :func:`project_adjoint_plan` of this geometry
    (built here when None), and ``general_tiles``, if given, a one-element
    int32 tensor on the card to which the kernel adds the number of tiles
    (blocks and view groups) that took its general path; the CPU ignores
    both."""
    tensors = {"g": g, "x_pix": x_pix, "z_pix": z_pix, "dx": dx}
    device = _build.inputs_device("project_adjoint_taps", tensors,
                                  dict.fromkeys(tensors, _F32))
    if g.dim() != 4 or x_pix.dim() != 3 or z_pix.dim() != 3 \
            or dx.dim() != 3 or len(vol_shape) != 3:
        raise ValueError("project_adjoint_taps: want g (B, P, res_d, "
                         "res_h), x_pix (P, W, res_d), z_pix (P, W, res_h), "
                         "dx (P, res_d, res_h), vol_shape (D, W, H)")
    B, P, res_d, res_h = g.shape
    D, W, H = (int(n) for n in vol_shape)
    if x_pix.shape != (P, W, res_d) or z_pix.shape != (P, W, res_h) \
            or dx.shape != (P, res_d, res_h):
        raise ValueError(f"project_adjoint_taps: shapes {tuple(g.shape)}, "
                         f"{tuple(x_pix.shape)}, {tuple(z_pix.shape)}, "
                         f"{tuple(dx.shape)} and volume {(D, W, H)} do not "
                         "agree")
    if device.type == "cpu":
        return project_adjoint_taps_plain(g, x_pix, z_pix, dx, (D, W, H),
                                          plane_chunk)
    if plan is None:
        plan = project_adjoint_plan(x_pix, z_pix, (D, W, H))
    if tuple(plan.shape) != (P, W, D + H, 2) or plan.dtype != torch.int32 \
            or plan.device != device or not plan.is_contiguous():
        raise ValueError(f"project_adjoint_taps: plan must be a contiguous "
                         f"int32 {(P, W, D + H, 2)} tensor on {device}, from "
                         "project_adjoint_plan")
    if general_tiles is not None and (
            general_tiles.dtype != torch.int32 or general_tiles.numel() < 1
            or general_tiles.device != device):
        raise ValueError("project_adjoint_taps: general_tiles must be an "
                         f"int32 tensor on {device}")
    out = torch.empty((B, D, W, H), dtype=torch.float32, device=device)
    _check_int32("project_adjoint_taps", g.numel(), x_pix.numel(),
                 z_pix.numel(), plan.numel(), out.numel())
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_drr_project_adjoint(
            g.data_ptr(), x_pix.data_ptr(), z_pix.data_ptr(), dx.data_ptr(),
            plan.data_ptr(), out.data_ptr(),
            None if general_tiles is None else general_tiles.data_ptr(), B,
            P, D, W, H, res_d, res_h, stream)
    _build.check(rc, "project_adjoint_taps")
    project_adjoint_taps.launches += 1
    return out


project_adjoint_taps.launches = 0


class _ProjectTaps(torch.autograd.Function):
    """:func:`project_taps` whose backward with respect to the volume is
    :func:`project_adjoint_taps` (the kernel on the card, with the plan
    given to the forward, the plain adjoint on the CPU)."""

    @staticmethod
    def forward(ctx, vol, x_pix, z_pix, dx, plane_chunk, plan):
        ctx.save_for_backward(x_pix, z_pix, dx)
        ctx.vol_shape = tuple(vol.shape[1:])
        ctx.plane_chunk = plane_chunk
        ctx.plan = plan
        return project_taps(vol, x_pix, z_pix, dx, plane_chunk)

    @staticmethod
    def backward(ctx, g):
        x_pix, z_pix, dx = ctx.saved_tensors
        dvol = project_adjoint_taps(g.contiguous(), x_pix, z_pix, dx,
                                    ctx.vol_shape, ctx.plane_chunk,
                                    plan=ctx.plan)
        return dvol, None, None, None, None, None


def project_taps_ad(vol, x_pix, z_pix, dx, plane_chunk=32, plan=None):
    """:func:`project_taps`, differentiable with respect to ``vol``; the
    geometry takes no gradient. ``plan``: :func:`project_adjoint_plan` of
    the geometry, for the backward (built there when None)."""
    if not torch.is_grad_enabled():
        return project_taps(vol, x_pix, z_pix, dx, plane_chunk)
    if any(t.requires_grad for t in (x_pix, z_pix, dx)):
        raise NotImplementedError("project_taps_ad: no gradient with "
                                  "respect to the projector's geometry")
    if not vol.requires_grad:
        return project_taps(vol, x_pix, z_pix, dx, plane_chunk)
    return _ProjectTaps.apply(vol, x_pix, z_pix, dx, plane_chunk, plan)


def _lift_shapes(proj, u_pix, v_pix):
    """(B, P, D, W, H) of a lift, after checking the operands' ranks and
    shapes."""
    if proj.dim() != 4 or u_pix.dim() != 3 or v_pix.dim() != 3:
        raise ValueError("backproject_taps: want proj (B, P, pw, ph), "
                         "u_pix (P, W, D), v_pix (P, W, H)")
    B, P = proj.shape[:2]
    _, W, D = u_pix.shape
    H = v_pix.shape[2]
    if u_pix.shape[0] != P or v_pix.shape[:2] != (P, W):
        raise ValueError(f"backproject_taps: shapes {tuple(proj.shape)}, "
                         f"{tuple(u_pix.shape)}, {tuple(v_pix.shape)} do "
                         "not agree")
    return B, P, D, W, H


def _lift_into(proj, u_pix, v_pix, plane_chunk, out):
    """The lift written into ``out``, an f32 or bf16 (B, P, D, W, H) tensor
    made by the operator (a new tensor, or channels 1..P of the encoder's
    input), whose rows are contiguous apart from the batch stride: on the
    CPU the plain version, converted; on CUDA the kernel, one launch."""
    tensors = {"proj": proj, "u_pix": u_pix, "v_pix": v_pix}
    device = _build.inputs_device("backproject_taps", tensors,
                                  dict.fromkeys(tensors, _F32))
    B, P, D, W, H = _lift_shapes(proj, u_pix, v_pix)
    pw, ph = proj.shape[2:]
    if device.type == "cpu":
        out.copy_(backproject_taps_plain(proj, u_pix, v_pix, plane_chunk))
        return
    bstride = out.stride(0) if B > 1 else P * D * W * H
    _check_int32("backproject_taps", proj.numel(), u_pix.numel(),
                 v_pix.numel(), B * bstride)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_drr_backproject(
            proj.data_ptr(), u_pix.data_ptr(), v_pix.data_ptr(),
            out.data_ptr(), int(out.dtype == torch.bfloat16), bstride, B, P,
            D, W, H, pw, ph, stream)
    _build.check(rc, "backproject_taps")
    backproject_taps.launches += 1


def _backproject_impl(proj, u_pix, v_pix, plane_chunk):
    """``liftreg::backproject``: the lift as a new f32 tensor."""
    out = torch.empty(_lift_shapes(proj, u_pix, v_pix), dtype=torch.float32,
                      device=proj.device)
    _lift_into(proj, u_pix, v_pix, plane_chunk, out)
    return out


def _backproject_fake(proj, u_pix, v_pix, plane_chunk):
    return proj.new_empty(_lift_shapes(proj, u_pix, v_pix),
                          dtype=torch.float32)


_library.define("backproject(Tensor proj, Tensor u_pix, Tensor v_pix, "
                "int plane_chunk) -> Tensor", _backproject_impl,
                _backproject_fake)


def backproject_taps(proj, u_pix, v_pix, plane_chunk=16):
    """The lift kernel on CUDA tensors, the plain version on CPU tensors
    (``plane_chunk`` only shapes the plain version's products): the
    operator ``liftreg::backproject``. Returns a new (B, P, D, W, H) f32
    tensor; :func:`lift_encoder_input` writes the lift into the encoder's
    input buffer instead."""
    return torch.ops.liftreg.backproject(proj, u_pix, v_pix, plane_chunk)


backproject_taps.launches = 0


def _encoder_input_shape(moving, proj, u_pix, v_pix, dtype):
    """(B, 1+P, D, W, H) of the encoder's input, after checking the
    operands and the buffer's dtype."""
    B, P, D, W, H = _lift_shapes(proj, u_pix, v_pix)
    if tuple(moving.shape) != (B, 1, D, W, H) or dtype not in OUT_DTYPES:
        raise ValueError(f"encoder_input: want moving {(B, 1, D, W, H)} and "
                         f"an f32 or bf16 buffer; got {tuple(moving.shape)} "
                         f"and {dtype}")
    return B, 1 + P, D, W, H


def _encoder_input_impl(moving, proj, u_pix, v_pix, plane_chunk, dtype):
    """``liftreg::encoder_input``: a new (B, 1+P, D, W, H) buffer of
    ``dtype``, the moving CT in channel 0 and the lift (one launch of the
    lift kernel on CUDA) in channels 1..P."""
    x = torch.empty(_encoder_input_shape(moving, proj, u_pix, v_pix, dtype),
                    dtype=dtype, device=moving.device)
    x[:, :1].copy_(moving)
    _lift_into(proj, u_pix, v_pix, plane_chunk, x[:, 1:])
    return x


def _encoder_input_fake(moving, proj, u_pix, v_pix, plane_chunk, dtype):
    return moving.new_empty(
        _encoder_input_shape(moving, proj, u_pix, v_pix, dtype), dtype=dtype)


_library.define("encoder_input(Tensor moving, Tensor proj, Tensor u_pix, "
                "Tensor v_pix, int plane_chunk, ScalarType dtype) -> Tensor",
                _encoder_input_impl, _encoder_input_fake)


def lift_encoder_input(moving, proj, u_pix, v_pix, dtype=torch.float32,
                       plane_chunk=16):
    """The encoder's (B, 1+P, D, W, H) input of ``dtype`` (f32 or bf16):
    ``moving`` (B, 1, D, W, H) in channel 0 and the lift of ``proj`` by
    :func:`backproject_taps`' kernel (its plain version on the CPU) in
    channels 1..P, each value rounded once to ``dtype``. The operator
    ``liftreg::encoder_input``: it returns the buffer it fills, so an
    exported program holds no in-place write; its lift launch counts in
    ``backproject_taps.launches``."""
    return torch.ops.liftreg.encoder_input(moving, proj, u_pix, v_pix,
                                           plane_chunk, dtype)


def project(vol, poses, resolution=None, spacing=(2.2, 2.2, 2.2),
            plane_chunk=32):
    """DRR of ``(B, D, W, H)`` (or ``(D, W, H)``) attenuation volumes;
    ``poses`` (P, 3) numpy or tensor in voxel units. Differentiable with
    respect to ``vol`` (:func:`project_taps_ad`). Builds the geometry on
    every call; callers with static poses keep
    :func:`.drr.forward_geometry` and call :func:`project_taps_ad`."""
    squeeze = vol.dim() == 3
    if squeeze:
        vol = vol[None]
    if resolution is None:
        resolution = drr.default_resolution(vol.shape[1:])
    poses = torch.as_tensor(poses, dtype=vol.dtype, device=vol.device)
    geometry = drr.forward_geometry(poses, vol.shape[1:], resolution,
                                    spacing)
    out = project_taps_ad(vol.contiguous(), *geometry,
                          plane_chunk=plane_chunk)
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
