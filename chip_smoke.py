#!/usr/bin/env python3
"""On-card smoke run of liftreg_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX or of liftreg_tpu. Phases, each printing one JSON
line with its elapsed seconds:

1. build: compile the port's CUDA kernels (one nvcc per source, started
   together, and one link, into build/);
2. device: the card's name and power limit from nvidia-smi;
3. pca_check / warp_check / drr_check / grad_check: each kernel against
   its plain PyTorch version on the card, at the shapes of the serving
   path (plus ragged shapes, both tap types, both paddings, coordinates
   far outside, on integers and on the edges of the DRR's zero padding,
   a batch of 9 for the PCA expansion, volumes with a spatial dim of 1 for
   the warp and its gradient, a point count that the gradient's points per
   thread do not divide, the PCA backward twice, which must give the same
   bits, and the lift written as bf16 into the encoder's input buffer,
   which must be its f32 output rounded once); the warp and its gradient
   also with phi in its (B, 3, D, W, H) layout, as warp_image passes it
   (B = 1, 4 and 9 at the serving shape, M = 6001 points, phi and the
   cotangent off a 16-byte boundary, unit dims; both tap types, both
   paddings, scale_intensity on and off);
4. main_path: RegistrationPipeline.register at 160^3, B=4, 4 views on a
   240^2 detector, latent 56, bf16 encoder, basis and taps, with random
   seeded weights; the kernels' launch counts are zeroed just before and
   read just after, and must be exactly one each of the projector, the
   lift, the PCA expansion and the warp; then register_projections the
   same way (no projector);
5. refine: register with refine_steps=30 (image domain) at the same
   config on smooth seeded volumes and a smooth basis, counts zeroed just
   before and read just after; the refined objective of each case must not
   exceed its unrefined objective;
6. glue_check: one register call without and one with refinement under
   a dispatch mode that sees every aten op: no op may make a (B, D, W, H,
   3) coordinate buffer or the warp's `out * 2 - 1`, and the moving
   image's tap tensor is cast once per warp_image call outside the
   refinement's steps;
7. reference / refine_reference: the pipeline on the card against the same
   pipeline on the CPU (the kernels' plain versions) at 32^3, without and
   with 5 refinement steps;
8. times: each kernel, its plain version and one PyTorch library call of
   the same function, with CUDA events (the warp and its gradient in both
   layouts and with both tap types; the lift also as the serving path
   runs it, bf16 into the encoder's buffer, with the bound of the bytes it
   writes); the steady-state register time, with and without refinement,
   and peak memory;
9. profile / profile_refine: one register call, without and with
   refinement, under torch.profiler: device time by layer (from kernel
   names) and the device's idle share.

Then the nvidia-smi line, one JSON line of per-kernel numbers
(``launches`` from the refine phase, which runs all six kernels;
``serving_launches`` from main_path's register), and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero; so does a
missing card, and a watchdog after 15 minutes.
"""
import json
import os
import subprocess
import sys
import threading
import time
import weakref

WATCHDOG_S = 900
# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core and f32 peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# f32 operations per output of the warp: 3 axes x (clip, floor, t, two
# weights) and 8 corners x (2 weight products, 1 tap product, 1 sum)
WARP_OPS_PER_OUTPUT = 50
# the warp's coordinate gradient per output: the forward's weights plus
# their derivatives (3 axes x ~8), and 8 corners x 3 axes x (2 weight
# products, 1 multiply-add) per channel
WARP_GRAD_OPS_PER_OUTPUT = 24 + 8 * 3 * 4
# with phi: the pixel coordinates (an add and a multiply per axis) and the
# rescale's multiply and subtract; in the gradient the doubled cotangent and
# dphi's multiply per axis
WARP_PHI_OPS = 3 * 2 + 2
WARP_GRAD_PHI_OPS = 3 * 2 + 1 + 3
# f32 operations of one 2-tap interpolation: 2 x (1 multiply, 1 add). The
# DRR sums are separable, so their least work interpolates one axis per
# pass: per (b, p, plane) the projector needs res_d*H such values along x
# and res_d*res_h along z (accumulated over planes), the lift D*ph along u
# and D*H along v
DRR_OPS_PER_TWO_TAPS = 4

SZ = 160
B = 4
LATENT = 56
REFINE_STEPS = 30
PCA_TOL = 1e-5
WARP_TOL = 1e-6
# the projector sums the planes in another order than the plain dense
# products (relative to the largest line integral); the lift adds <= 4 taps
PROJ_REL_TOL = 1e-5
LIFT_TOL = 1e-6
# the coordinate gradient fuses multiply-adds that the plain version rounds
# twice (relative to the largest component); the PCA backward rounds an f32
# sum taken in another order to bf16 (one bf16 step, plus 1e-4 of the
# largest value for sums that cancel to near zero)
WARP_GRAD_REL_TOL = 1e-5
PCA_GRAD_RTOL, PCA_GRAD_REL_ATOL = 2.0 ** -8, 1e-4
# refinement on the card against the CPU at 32^3 over 5 steps, f32 encoder
# and taps, bf16 basis: the f32 differences of the encoder and the kernels
# reach the Adam updates, and dcoefs can round to the neighbouring bf16
REFINE_REF_TOL = (1e-4, 1e-3)
# card against CPU at 32^3, (phi, warped): the two round the f32 HU
# normalisation differently by an ulp (CUDA divides by a scalar through its
# reciprocal), and the encoder's f32 convolutions sum in another order. With
# f32 taps that stays ~1e-6; with bf16 taps it can flip the rounding of one
# tap in [0.5, 1): 2^-8, doubled by the [0,1] -> [-1,1] rescale.
REF_F32_TOL = (1e-4, 1e-4)
REF_BF16_TOL = (1e-4, 2.0 ** -7)

_state = {"phase": "start", "t0": time.perf_counter()}


def _expire():
    print(json.dumps({"watchdog_s": WATCHDOG_S, "phase": _state["phase"]}),
          flush=True)
    print(f"chip_smoke: watchdog expired in phase {_state['phase']}",
          file=sys.stderr, flush=True)
    os._exit(1)


def _begin(name):
    _state["phase"] = name
    _state["t0"] = time.perf_counter()


def _emit(**fields):
    import torch
    torch.cuda.synchronize()
    line = {"phase": _state["phase"],
            "seconds": round(time.perf_counter() - _state["t0"], 3)}
    line.update(fields)
    print(json.dumps(line), flush=True)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke [{_state['phase']}]: {msg}")


def _cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _max_err(a, b):
    return float((a - b).abs().max())


def _layer(kernel_name):
    """Layer of a device kernel, from its name."""
    name = kernel_name.lower()
    for layer, keys in (("pca_grad", ("pca_grad",)),
                        ("pca_expand", ("pca_expand",)),
                        ("warp_coord_grad", ("warp_coord_grad",)),
                        ("warp_trilinear", ("warp_trilinear",)),
                        ("drr_project", ("drr_project",)),
                        ("drr_backproject", ("drr_backproject",)),
                        ("conv", ("conv", "cudnn", "winograd", "implicit")),
                        ("matmul", ("gemm", "cublas", "cutlass")),
                        ("gather", ("gather", "index")),):
        if any(k in name for k in keys):
            return layer
    return "elementwise/other"


def _smooth_coords(torch, F, g, batch, sz, amp, device):
    """Pixel coords (batch, sz^3, 3): identity plus a smooth displacement of
    up to ~amp voxels; a slab of batch element 0 lies far outside."""
    low = torch.randn((batch, 3, 5, 5, 5), generator=g, device=device)
    disp = F.interpolate(low, size=(sz,) * 3, mode="trilinear",
                         align_corners=True) * amp
    ax = torch.arange(sz, dtype=torch.float32, device=device)
    ident = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"))
    coords = (ident[None] + disp).movedim(1, -1).contiguous()
    coords[0, :2] = 3.0 * sz            # far past the high end
    coords[0, -2:] = -2.0 * sz          # far below zero
    return coords.reshape(batch, -1, 3)


def _phi_of(coords, sz):
    """The normalized map (batch, 3, sz, sz, sz) whose pixel coordinates
    are ``coords`` (batch, sz^3, 3)."""
    half = (sz - 1) * 0.5
    return (coords / half - 1.0).reshape(
        coords.shape[0], sz, sz, sz, 3).movedim(-1, 1).contiguous()


def _unaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the warp kernels' scalar paths)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def warp_phi_cases(torch, F, g, device):
    """The phi-layout cases of warp_check and grad_check: {name: (volume in
    [0, 1] (B, C, D, W, H) f32, phi (B, 3, *out_shape), cotangent
    (B, C, *out_shape))} at the serving shape with B = 1, 4 and 9 (smooth
    fields with slabs far outside, a quarter of batch element 0's points
    converted from integer pixel coordinates), M = 6001 points, phi and the
    cotangent one float off a 16-byte boundary, and volumes with a spatial
    dim of 1."""
    cases = {}
    for batch in (1, B, 9):
        coords = _smooth_coords(torch, F, g, batch, SZ, 4.0, device)
        coords[0, ::4] = torch.floor(coords[0, ::4])
        cases[f"serving_b{batch}"] = (
            torch.rand((batch, 1) + (SZ,) * 3, generator=g, device=device),
            _phi_of(coords, SZ),
            torch.randn((batch, 1) + (SZ,) * 3, generator=g, device=device))
    vol, phi, cot = cases[f"serving_b{B}"]
    cases["unaligned"] = (vol, _unaligned(torch, phi), _unaligned(torch, cot))
    shapes = {"ragged_m": ((37, 29, 41), (6001,)),
              "unit_d": ((1, SZ, SZ),) * 2, "unit_w": ((SZ, 1, SZ),) * 2,
              "unit_h": ((SZ, SZ, 1),) * 2}
    for name, (spatial, out_shape) in shapes.items():
        phi = torch.rand((2, 3) + out_shape, generator=g,
                         device=device) * 2.6 - 1.3
        cases[name] = (
            torch.rand((2, 2) + spatial, generator=g, device=device), phi,
            torch.randn((2, 2) + out_shape, generator=g, device=device))
    return cases


def _smooth_field(torch, F, g, shape, low, device):
    """(shape[0], shape[1], *shape[2:]) smooth random field in [-1, 1]:
    normal noise on a low^3 grid, trilinear up to the full size."""
    coarse = torch.randn(tuple(shape[:2]) + (low,) * 3, generator=g,
                         device=device)
    field = F.interpolate(coarse, size=tuple(shape[2:]), mode="trilinear",
                          align_corners=True)
    return field / field.abs().amax(dim=(2, 3, 4), keepdim=True)


def _smooth_basis(torch, F, g, latent, sz, amp, device):
    """(latent, 3*sz^3) bf16 basis of smooth displacement fields of up to
    ``amp`` in normalized units, built a few rows at a time."""
    rows = []
    for start in range(0, latent, 8):
        n = min(8, latent - start)
        rows.append((_smooth_field(torch, F, g, (n, 3) + (sz,) * 3, 6, device)
                     * amp).reshape(n, -1).to(torch.bfloat16))
    return torch.cat(rows)


def _edge_pix(torch, g, shape, n, device):
    """Uniform coordinates with a third replaced by the edges of the DRR's
    per-tap zero padding: (-1, 0), 0, n-1, (n-1, n) and beyond."""
    pix = torch.rand(shape, generator=g, device=device) * (n + 3.0) - 2.0
    special = torch.tensor([-1.5, -1.0, -0.25, 0.0, 0.5, n - 1.0, n - 0.75,
                            n - 1.5, float(n), n + 2.0], device=device)
    pick = torch.randint(0, len(special), shape, generator=g, device=device)
    mask = torch.rand(shape, generator=g, device=device) < 0.33
    return torch.where(mask, special[pick], pix).contiguous()


def serving_drr_inputs(torch, drr, g, device):
    """The DRR kernels' inputs at the serving shape (SZ^3, B volumes, 4
    views on the default detector): poses, detector resolution, the
    projector's and the lift's geometry, seeded attenuation volumes and
    projections. ``drr`` is the port's ``ops.drr`` module."""
    poses = torch.from_numpy(drr.synthesize_poses(30.0, 4, SZ)).to(device)
    res = drr.default_resolution((SZ,) * 3)
    fwd_geom = drr.forward_geometry(poses, (SZ,) * 3, res, (2.2, 2.2, 2.2))
    bwd_geom = drr.backward_geometry(poses, (SZ,) * 3, res)
    att = torch.rand((B, SZ, SZ, SZ), generator=g, device=device) * 0.2
    proj = torch.rand((B, 4) + res, generator=g, device=device) * 2.0 - 1.0
    return poses, res, fwd_geom, bwd_geom, att, proj


def refine_inputs(torch, F, g, device):
    """The refine phase's seeded inputs at the serving shape: smooth HU
    fields, the target a smooth shift of the source (so that NCC has
    something to align), a lung mask and a smooth bf16 basis. Returns
    (source HU, target HU, segmentation, pca)."""
    shape = (B, 1, SZ, SZ, SZ)
    base_hu = _smooth_field(torch, F, g, shape, 12, device)
    src = (base_hu * 400.0 - 500.0).contiguous()
    tgt = (torch.roll(base_hu, shifts=(2, -3, 1), dims=(2, 3, 4)) * 400.0
           - 500.0 + _smooth_field(torch, F, g, shape, 8, device) * 50.0)
    seg = (_smooth_field(torch, F, g, shape, 4, device) > -0.6).float()
    pca = {"vectors": _smooth_basis(torch, F, g, LATENT, SZ, 0.05, device),
           "mean": torch.zeros((3 * SZ ** 3,), device=device)}
    return src, tgt, seg, pca


def glue_ops(torch, fn, batch, sz):
    """Run ``fn`` under a dispatch mode that sees every aten op, backward
    included, and count: all ops; ops whose result is a coordinate buffer
    (last dim 3 and batch * 3 * sz^3 elements); the warp's rescale, 1
    subtracted from a volume of batch * sz^3 elements that was multiplied
    by 2; and casts of a (batch, 1, sz, sz, sz) volume to bf16, the moving
    image's taps."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    aten = torch.ops.aten
    counts = {"ops": 0, "coordinate_buffers": 0, "rescales": 0,
              "tap_casts": 0}
    doubled = set()
    n_coords = batch * 3 * sz ** 3

    def scalar_of(args, value):
        """``args`` are a tensor and the Python number ``value``."""
        return len(args) > 1 and isinstance(args[0], torch.Tensor) \
            and isinstance(args[1], (int, float)) and args[1] == value

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            counts["ops"] += 1
            for o in tree_leaves(out):
                if isinstance(o, torch.Tensor) and o.dim() >= 2 \
                        and o.shape[-1] == 3 and o.numel() == n_coords:
                    counts["coordinate_buffers"] += 1
            op = func.overloadpacket
            if op is aten.mul and scalar_of(args, 2.0) \
                    and args[0].numel() == batch * sz ** 3:
                doubled.add(id(out))
                weakref.finalize(out, doubled.discard, id(out))
            if op is aten.sub and scalar_of(args, 1.0) \
                    and id(args[0]) in doubled:
                counts["rescales"] += 1
            if op is aten._to_copy and out.dtype == torch.bfloat16 \
                    and tuple(out.shape) == (batch, 1) + (sz,) * 3:
                counts["tap_casts"] += 1
            return out

    with Count():
        fn()
    return counts


def _warp_flags(torch):
    """(taps type, border, scale_intensity) of each phi-layout case."""
    return [(tdt, border, rescale)
            for tdt in (torch.bfloat16, torch.float32)
            for border in (False, True) for rescale in (False, True)]


def _flag_key(tdt, border, rescale):
    return (f"{str(tdt).split('.')[-1]}/{'border' if border else 'zeros'}"
            f"{'/scaled' if rescale else ''}")


def _counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _zero(kernels):
    for fn in kernels.values():
        fn.launches = 0


def main():
    timer = threading.Timer(WATCHDOG_S, _expire)
    timer.daemon = True
    timer.start()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.models.subspace_backproj import mask_lung
    from liftreg_tpu_torch.ops import _build, drr
    from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps,
                                                  backproject_taps_plain,
                                                  project, project_taps,
                                                  project_taps_plain)
    from liftreg_tpu_torch.ops.pca_kernel import (MAX_CHUNK, pca_expand,
                                                  pca_expand_plain, pca_grad,
                                                  pca_grad_plain)
    from liftreg_tpu_torch.ops.warp_kernel import (warp_coord_grad,
                                                   warp_coord_grad_plain,
                                                   warp_trilinear,
                                                   warp_trilinear_plain)
    from liftreg_tpu_torch.pipeline import normalize_hu
    from liftreg_tpu_torch.refine import make_refiner

    KERNELS = {"pca_expand": pca_expand, "pca_grad": pca_grad,
               "warp_trilinear": warp_trilinear,
               "warp_coord_grad": warp_coord_grad,
               "drr_project": project_taps,
               "drr_backproject": backproject_taps}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    _begin("build")
    fresh = not _build.library_path().is_file()
    lib_path = _build.build()
    _build.library()
    _emit(nvcc_processes=(len(_build.SOURCES) + 1) * int(fresh),
          library=os.path.relpath(lib_path))

    _begin("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _emit(name=kind, nvidia_smi=smi, count=torch.cuda.device_count())

    g = torch.Generator(device=dev).manual_seed(0)
    n = 3 * SZ ** 3
    errs = {}

    # -- each kernel against its plain version -----------------------------
    _begin("pca_check")
    coefs = torch.randn((B, LATENT), generator=g, device=dev)
    V = (torch.randn((LATENT, n), generator=g, device=dev) * 0.01).bfloat16()
    mean = torch.randn((n,), generator=g, device=dev) * 0.01
    pca_err = _max_err(pca_expand(coefs, V, mean),
                       pca_expand_plain(coefs, V, mean))
    ragged = {}
    for m in (3 * 50 ** 3, 3 * 49 ** 3):    # partial last block; scalar path
        c2 = torch.randn((3, 13), generator=g, device=dev)
        v2 = (torch.randn((13, m), generator=g, device=dev) * 0.01).bfloat16()
        m2 = torch.randn((m,), generator=g, device=dev) * 0.01
        ragged[m] = _max_err(pca_expand(c2, v2, m2),
                             pca_expand_plain(c2, v2, m2))
    # more rows than one launch holds: one launch per chunk of MAX_CHUNK
    coefs9 = torch.randn((9, LATENT), generator=g, device=dev)
    before = pca_expand.launches
    got9 = pca_expand(coefs9, V, mean)
    chunks9 = pca_expand.launches - before
    batch9_err = _max_err(got9, pca_expand_plain(coefs9, V, mean))
    del got9
    errs["pca_expand"] = max(pca_err, batch9_err, *ragged.values())
    _emit(max_abs_err=pca_err, ragged_max_abs_err=ragged,
          batch9_max_abs_err=batch9_err, batch9_launches=chunks9, tol=PCA_TOL)
    _require(chunks9 == -(-9 // MAX_CHUNK),
             f"B=9 took {chunks9} PCA launches")
    _require(errs["pca_expand"] <= PCA_TOL,
             f"PCA kernel error {errs['pca_expand']} > {PCA_TOL}")

    _begin("warp_check")
    vol01 = torch.rand((B, 1, SZ, SZ, SZ), generator=g, device=dev)
    coords = _smooth_coords(torch, F, g, B, SZ, 4.0, dev)
    warp_errs = {}
    taps = {}
    for tdt in (torch.bfloat16, torch.float32):
        taps[tdt] = vol01.to(tdt)
        for border in (False, True):
            key = f"{str(tdt).split('.')[-1]}/{'border' if border else 'zeros'}"
            warp_errs[key] = _max_err(
                warp_trilinear(taps[tdt], coords, border),
                warp_trilinear_plain(taps[tdt], coords, border))
    # volumes with a spatial dim of 1 (the quad and generic axis modes)
    unit_grad_rel = {}
    for ushape in ((1, SZ, SZ), (SZ, 1, SZ), (SZ, SZ, 1)):
        uvol = torch.rand((2, 1) + ushape, generator=g, device=dev)
        uscale = torch.tensor(ushape, dtype=torch.float32, device=dev)
        ucoords = torch.rand((2, SZ * SZ, 3), generator=g, device=dev) \
            * (uscale + 2.0) - 1.5
        ucoords[:, ::4] = torch.floor(ucoords[:, ::4])
        ucot = torch.randn((2, 1, SZ * SZ), generator=g, device=dev)
        for tdt in (torch.bfloat16, torch.float32):
            for border in (False, True):
                key = (f"{'x'.join(map(str, ushape))}/"
                       f"{str(tdt).split('.')[-1]}/"
                       f"{'border' if border else 'zeros'}")
                ut = uvol.to(tdt)
                warp_errs[key] = _max_err(
                    warp_trilinear(ut, ucoords, border),
                    warp_trilinear_plain(ut, ucoords, border))
                want = warp_coord_grad_plain(ut, ucoords, ucot, border)
                unit_grad_rel[key] = _max_err(
                    warp_coord_grad(ut, ucoords, ucot, border), want) \
                    / float(want.abs().max())
    # phi in its (B, 3, D, W, H) layout, as warp_image passes it
    phi_cases = warp_phi_cases(torch, F, g, dev)
    phi_errs = {}
    for name, (pvol, phi, _) in phi_cases.items():
        for tdt, border, rescale in _warp_flags(torch):
            pt = pvol.to(tdt)
            key = f"phi/{name}/{_flag_key(tdt, border, rescale)}"
            phi_errs[key] = _max_err(
                warp_trilinear(pt, phi, border, normalized=True,
                               scale_intensity=rescale),
                warp_trilinear_plain(pt, phi, border, normalized=True,
                                     scale_intensity=rescale))
    warp_errs.update(phi_errs)
    errs["warp_trilinear"] = max(warp_errs.values())
    _emit(max_abs_err=warp_errs, tol=WARP_TOL,
          unit_dim_grad_rel_err=unit_grad_rel,
          grad_rel_tol=WARP_GRAD_REL_TOL)
    _require(max(unit_grad_rel.values()) <= WARP_GRAD_REL_TOL,
             f"warp gradient kernel on unit dims: {unit_grad_rel}")
    _require(errs["warp_trilinear"] <= WARP_TOL,
             f"warp kernel error {errs['warp_trilinear']} > {WARP_TOL}")

    _begin("drr_check")
    pipe_poses, res, fwd_geom, bwd_geom, att, proj_in = serving_drr_inputs(
        torch, drr, g, dev)
    drr_errs = {}

    def proj_err(vol, geom):
        """(max abs error, that error over the largest line integral)"""
        want = project_taps_plain(vol, *geom)
        err = _max_err(project_taps(vol, *geom), want)
        return err, err / float(want.abs().max())

    def lift_err(p, geom):
        return _max_err(backproject_taps(p, *geom),
                        backproject_taps_plain(p, *geom))

    drr_errs["project_serving"], drr_errs["project_serving_rel"] = \
        proj_err(att, fwd_geom)
    drr_errs["lift_serving"] = lift_err(proj_in, bwd_geom)
    # a ragged shape with coordinates on the edges of the zero padding
    D2, W2, H2, rd, rh = 37, 29, 41, 53, 47
    vol2 = torch.rand((3, D2, W2, H2), generator=g, device=dev)
    geom2 = (_edge_pix(torch, g, (3, W2, rd), D2, dev),
             _edge_pix(torch, g, (3, W2, rh), H2, dev),
             torch.rand((3, rd, rh), generator=g, device=dev) + 1.0)
    drr_errs["project_ragged"], drr_errs["project_ragged_rel"] = \
        proj_err(vol2, geom2)
    p2 = torch.rand((2, 3, rd, rh), generator=g, device=dev)
    geom2b = (_edge_pix(torch, g, (3, W2, D2), rd, dev),
              _edge_pix(torch, g, (3, W2, H2), rh, dev))
    drr_errs["lift_ragged"] = lift_err(p2, geom2b)
    # the lift into the encoder's bf16 input buffer: its f32 values rounded
    # once, bit for bit, channel 0 untouched
    lift_buf = torch.full((B, 5, SZ, SZ, SZ), 3.0, dtype=torch.bfloat16,
                          device=dev)
    backproject_taps(proj_in, *bwd_geom, out=lift_buf[:, 1:])
    lift_bf16_equal = bool(torch.equal(
        lift_buf[:, 1:], backproject_taps(proj_in, *bwd_geom).bfloat16())
        and (lift_buf[:, 0] == 3.0).all())
    drr_errs["lift_bf16_buffer_bit_equal"] = lift_bf16_equal
    errs["drr_project"] = max(drr_errs["project_serving"],
                              drr_errs["project_ragged"])
    errs["drr_backproject"] = max(drr_errs["lift_serving"],
                                  drr_errs["lift_ragged"])
    _emit(max_err=drr_errs, tol={"project_rel": PROJ_REL_TOL,
                                 "lift": LIFT_TOL})
    proj_rel = max(drr_errs["project_serving_rel"],
                   drr_errs["project_ragged_rel"])
    _require(proj_rel <= PROJ_REL_TOL,
             f"projector kernel relative error {proj_rel}")
    _require(errs["drr_backproject"] <= LIFT_TOL,
             f"lift kernel error {errs['drr_backproject']}")
    _require(lift_bf16_equal, "the lift's bf16 buffer is not its f32 output "
             "rounded once")

    _begin("grad_check")
    cot = torch.randn((B, 1, SZ ** 3), generator=g, device=dev)
    grad_errs = {}
    int_coords = torch.floor(coords)
    for tdt in (torch.bfloat16, torch.float32):
        for border in (False, True):
            for name, c in (("smooth", coords), ("integer", int_coords)):
                key = (f"{str(tdt).split('.')[-1]}/"
                       f"{'border' if border else 'zeros'}/{name}")
                want = warp_coord_grad_plain(taps[tdt], c, cot, border)
                err = _max_err(warp_coord_grad(taps[tdt], c, cot, border),
                               want)
                grad_errs[key] = [err, err / float(want.abs().max())]
                del want
    # M not a multiple of the kernel's points per thread (its masked path)
    ragged_m = SZ ** 3 - 1
    c_r = coords[:, :ragged_m].contiguous()
    cot_r = cot[..., :ragged_m].contiguous()
    want = warp_coord_grad_plain(taps[torch.bfloat16], c_r, cot_r, False)
    err = _max_err(warp_coord_grad(taps[torch.bfloat16], c_r, cot_r, False),
                   want)
    grad_errs["bfloat16/zeros/ragged_m"] = [err,
                                            err / float(want.abs().max())]
    del c_r, cot_r, want
    for name, (pvol, phi, pcot) in phi_cases.items():
        for tdt, border, rescale in _warp_flags(torch):
            pt = pvol.to(tdt)
            want = warp_coord_grad_plain(pt, phi, pcot, border,
                                         normalized=True,
                                         scale_intensity=rescale)
            err = _max_err(warp_coord_grad(pt, phi, pcot, border,
                                           normalized=True,
                                           scale_intensity=rescale), want)
            grad_errs[f"phi/{name}/{_flag_key(tdt, border, rescale)}"] = [
                err, err / float(want.abs().max())]
            del want
    del phi_cases
    errs["warp_coord_grad"] = max(e[0] for e in grad_errs.values())
    grad_rel = max(e[1] for e in grad_errs.values())
    cot_pca = torch.randn((B, n), generator=g, device=dev)
    pca_grad_errs = {}
    for key, (cg, vg) in {
            "serving": (cot_pca, V),
            "ragged": (torch.randn((3, 3 * 49 ** 3), generator=g, device=dev),
                       (torch.randn((13, 3 * 49 ** 3), generator=g,
                                    device=dev) * 0.01).bfloat16())}.items():
        want = pca_grad_plain(cg, vg)
        got = pca_grad(cg, vg)
        excess = ((got - want).abs() - PCA_GRAD_RTOL * want.abs()
                  - PCA_GRAD_REL_ATOL * float(want.abs().max())).max()
        pca_grad_errs[key] = {"max_abs_err": _max_err(got, want),
                              "excess_over_tol": float(excess),
                              "bf16_values": bool(torch.equal(
                                  got, got.bfloat16().float())),
                              # no float atomics: a second call, same bits
                              "repeat_bit_equal": bool(torch.equal(
                                  got, pca_grad(cg, vg)))}
    errs["pca_grad"] = max(e["max_abs_err"] for e in pca_grad_errs.values())
    _emit(warp_grad_abs_rel_err=grad_errs,
          warp_grad_rel_tol=WARP_GRAD_REL_TOL,
          pca_grad=pca_grad_errs,
          pca_grad_tol={"rtol": PCA_GRAD_RTOL,
                        "rel_atol": PCA_GRAD_REL_ATOL})
    _require(grad_rel <= WARP_GRAD_REL_TOL,
             f"warp gradient kernel relative error {grad_rel}")
    _require(all(e["excess_over_tol"] <= 0 and e["bf16_values"]
                 and e["repeat_bit_equal"] for e in pca_grad_errs.values()),
             f"PCA backward kernel disagrees: {pca_grad_errs}")

    # -- the main path -----------------------------------------------------
    _begin("main_path")
    torch.manual_seed(0)
    pipe = RegistrationPipeline((SZ,) * 3, latent_dim=LATENT,
                                compute_dtype=torch.bfloat16)
    pca = {"vectors": V, "mean": mean}
    shape = (B, 1, SZ, SZ, SZ)
    src_hu = torch.rand(shape, generator=g, device=dev) * -1000.0
    tgt_hu = torch.rand(shape, generator=g, device=dev) * -1000.0
    seg = (torch.rand(shape, generator=g, device=dev) > 0.4).float()

    _zero(KERNELS)
    warped, phi = pipe.register(pca, src_hu, tgt_hu, seg, seg)
    torch.cuda.synchronize()
    launches = _counts(KERNELS)
    _require(warped.shape == shape and phi.shape == (B, 3, SZ, SZ, SZ),
             f"shapes {tuple(warped.shape)}, {tuple(phi.shape)}")
    _require(bool(torch.isfinite(warped).all() and torch.isfinite(phi).all()),
             "non-finite output")
    # each wrapper counts one launch per call (per chunk of 8 rows for the
    # PCA kernels); the projector, whose plane loop the wrapper splits at
    # this shape, runs as two passes (chunks, then their ordered sum) and
    # counts them as one launch, as the PCA backward does
    serving = {"pca_expand": 1, "pca_grad": 0, "warp_trilinear": 1,
               "warp_coord_grad": 0, "drr_project": 1, "drr_backproject": 1}
    _require(launches == serving,
             f"main path launch counts {launches}, expected {serving}")

    proj = drr.normalize_drr(project(
        drr.calc_relative_atten_coef(tgt_hu[:, 0]), pipe.poses,
        pipe.resolution, pipe.spacing))
    _zero(KERNELS)
    warped_p, phi_p = pipe.register_projections(pca, src_hu, proj, seg)
    torch.cuda.synchronize()
    launches_p = _counts(KERNELS)
    _require(bool(torch.isfinite(warped_p).all()
                  and torch.isfinite(phi_p).all()),
             "non-finite output of register_projections")
    _require(launches_p == dict(serving, drr_project=0),
             f"register_projections launch counts {launches_p}")
    _emit(launches=launches, launches_projections=launches_p,
          warped=list(warped.shape), phi=list(phi.shape),
          phi_range=[float(phi.min()), float(phi.max())])

    # -- per-case refinement at the serving config -------------------------
    _begin("refine")
    r_src, r_tgt, r_seg, r_pca = refine_inputs(torch, F, g, dev)
    pipe_r = RegistrationPipeline((SZ,) * 3, latent_dim=LATENT,
                                  compute_dtype=torch.bfloat16,
                                  refine_steps=REFINE_STEPS)
    pipe_r.model.load_state_dict(pipe.model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _zero(KERNELS)
    t0 = time.perf_counter()
    warped_r, phi_r = pipe_r.register(r_pca, r_src, r_tgt, r_seg, r_seg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    refine_launches = _counts(KERNELS)
    refine_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {"drr_project": 1, "drr_backproject": 1,
                "pca_expand": REFINE_STEPS + 3,
                "pca_grad": REFINE_STEPS + 1,
                "warp_trilinear": REFINE_STEPS + 3,
                "warp_coord_grad": REFINE_STEPS + 1}
    res_r = pipe_r.last_refine
    _require(bool(torch.isfinite(warped_r).all()
                  and torch.isfinite(phi_r).all()),
             "non-finite refined output")
    _require(refine_launches == expected,
             f"launch counts {refine_launches}, expected {expected}")
    # the unrefined objective of each case: the same objective at the
    # encoder's coefficients (a refiner of 0 steps), from the same inputs
    inputs = {"source": normalize_hu(r_src), "target": normalize_hu(r_tgt),
              "target_proj": drr.normalize_drr(project(
                  drr.calc_relative_atten_coef(r_tgt[:, 0]), pipe_r.poses,
                  pipe_r.resolution, pipe_r.spacing)),
              "target_poses": pipe_r.poses[None],
              "source_label": r_seg, "target_label": r_seg}
    with torch.no_grad():
        out0 = pipe_r.model(inputs, r_pca)
    res0 = make_refiner((SZ,) * 3, n_steps=0,
                        warp_taps_dtype=torch.bfloat16)(
        out0["pca_coefs"], r_pca, mask_lung(inputs["source"], r_seg),
        out0["target"])
    unrefined = res0["total_per_sample"]
    refined = res_r["total_per_sample"]
    hist = res_r["total_history"]
    _require(bool(torch.equal(res0["total_history"][0], hist[0])),
             f"unrefined objective {float(res0['total_history'][0])} is not "
             f"the refinement's step 0 {float(hist[0])}")
    _require(bool((refined <= unrefined).all()),
             f"refinement made a case worse: {refined.tolist()} > "
             f"{unrefined.tolist()}")
    _emit(launches=refine_launches, steps=REFINE_STEPS,
          unrefined_total_per_sample=unrefined.tolist(),
          refined_total_per_sample=refined.tolist(),
          total_history=[round(float(x), 6) for x in hist],
          sim_history_first_last=[float(res_r["sim_history"][0]),
                                  float(res_r["sim_history"][-1])],
          first_call_ms=first_ms, peak_memory_gib=refine_peak_gib)
    del out0, res0, inputs

    # -- no glue around the warp on the card --------------------------------
    _begin("glue_check")
    glue = {"register": glue_ops(
                torch, lambda: pipe.register(pca, src_hu, tgt_hu, seg, seg),
                B, SZ),
            "register_refine": glue_ops(
                torch, lambda: pipe_r.register(r_pca, r_src, r_tgt, r_seg,
                                               r_seg), B, SZ)}
    _emit(**glue)
    _require(all(c["coordinate_buffers"] == 0 and c["rescales"] == 0
                 for c in glue.values()),
             f"glue around the warp on the card: {glue}")
    # one cast for the encoder's prediction, one for the refinement's steps
    _require(glue["register"]["tap_casts"] == 1
             and glue["register_refine"]["tap_casts"] == 2,
             f"the tap tensor is built more than once per call: {glue}")

    # -- the card against the CPU at a small size --------------------------
    _begin("reference")
    small, L_small = (32, 32, 32), 8
    n_small = 3 * 32 ** 3
    gc = torch.Generator().manual_seed(1)
    cpu_pca = {"vectors": (torch.randn((L_small, n_small), generator=gc)
                           * 0.01).bfloat16(),
               "mean": torch.randn((n_small,), generator=gc) * 0.01}
    args = [torch.rand((2, 1) + small, generator=gc) * -1000.0,
            torch.rand((2, 1) + small, generator=gc) * -1000.0]
    args += [(torch.rand((2, 1) + small, generator=gc) > 0.4).float()] * 2
    torch.manual_seed(1)
    state = RegistrationPipeline(small, latent_dim=L_small,
                                 device="cpu").model.state_dict()
    ref_errs = {}
    for taps_dtype, tol in ((torch.float32, REF_F32_TOL),
                            (torch.bfloat16, REF_BF16_TOL)):
        outs = {}
        for where in ("cpu", "cuda"):
            p = RegistrationPipeline(small, latent_dim=L_small,
                                     warp_taps_dtype=taps_dtype, device=where)
            p.model.load_state_dict(state)
            pc = {k: v.to(where) for k, v in cpu_pca.items()}
            outs[where] = [t.cpu() for t in
                           p.register(pc, *(a.to(where) for a in args))]
        key = str(taps_dtype).split(".")[-1]
        ref_errs[key] = {"phi": _max_err(outs["cuda"][1], outs["cpu"][1]),
                         "warped": _max_err(outs["cuda"][0], outs["cpu"][0]),
                         "tol": tol}
    _emit(max_abs_err=ref_errs)
    for key, e in ref_errs.items():
        _require(e["phi"] <= e["tol"][0] and e["warped"] <= e["tol"][1],
                 f"pipeline on the card disagrees with the CPU ({key} taps)")

    _begin("refine_reference")
    gs = torch.Generator(device=dev).manual_seed(2)
    small_pca = {k: v.cpu() for k, v in {
        "vectors": _smooth_basis(torch, F, gs, L_small, 32, 0.05, dev),
        "mean": torch.zeros((n_small,), device=dev)}.items()}
    field = _smooth_field(torch, F, gs, (2, 1) + small, 6, dev).cpu()
    s_args = [field * 400.0 - 500.0,
              torch.roll(field, shifts=(1, -2, 1), dims=(2, 3, 4)) * 400.0
              - 500.0] + [torch.ones((2, 1) + small)] * 2
    outs = {}
    for where in ("cpu", "cuda"):
        p = RegistrationPipeline(small, latent_dim=L_small,
                                 warp_taps_dtype=torch.float32,
                                 refine_steps=5, refine_lr=0.02, device=where)
        p.model.load_state_dict(state)
        pc = {k: v.to(where) for k, v in small_pca.items()}
        outs[where] = [t.cpu() for t in
                       p.register(pc, *(a.to(where) for a in s_args))]
        outs[where].append(p.last_refine["total_history"].cpu())
    refine_ref = {"phi": _max_err(outs["cuda"][1], outs["cpu"][1]),
                  "warped": _max_err(outs["cuda"][0], outs["cpu"][0]),
                  "total_history": _max_err(outs["cuda"][2], outs["cpu"][2]),
                  "tol": REFINE_REF_TOL}
    _emit(max_abs_err=refine_ref,
          history_cpu=[float(x) for x in outs["cpu"][2]])
    _require(refine_ref["phi"] <= REFINE_REF_TOL[0]
             and refine_ref["warped"] <= REFINE_REF_TOL[1],
             "refinement on the card disagrees with the CPU")

    # -- times -------------------------------------------------------------
    _begin("times")
    ms, plain_ms, lib_ms = {}, {}, {}
    coefs_bf16 = coefs.to(torch.bfloat16)
    ms["pca_expand"] = _cuda_ms(lambda: pca_expand(coefs, V, mean), 20)
    plain_ms["pca_expand"] = _cuda_ms(
        lambda: pca_expand_plain(coefs, V, mean), 5)
    lib_ms["pca_expand"] = _cuda_ms(lambda: torch.addmm(
        mean, coefs_bf16, V, out_dtype=torch.float32), 20)

    ms["pca_grad"] = _cuda_ms(lambda: pca_grad(cot_pca, V), 20)
    plain_ms["pca_grad"] = _cuda_ms(lambda: pca_grad_plain(cot_pca, V), 5)
    # one cuBLAS call of the same product; it rounds g to bf16 first
    cot_bf16 = cot_pca.bfloat16()
    lib_ms["pca_grad"] = _cuda_ms(lambda: torch.mm(
        cot_bf16, V.T, out_dtype=torch.float32), 20)

    t16 = taps[torch.bfloat16]
    t32 = taps[torch.float32]
    # the same points in phi's layout, and the cotangent of warp_image's
    # (B, 1, D, W, H) output
    phi = _phi_of(coords, SZ)
    cot5 = cot.reshape(B, 1, SZ, SZ, SZ)
    # both warp kernels in both layouts with both tap types; the main path
    # runs phi with bf16 taps and scale_intensity
    layout_ms = {"warp_trilinear": {}, "warp_coord_grad": {}}
    for tname, tt in (("bf16", t16), ("f32", t32)):
        layout_ms["warp_trilinear"][f"phi_{tname}"] = _cuda_ms(
            lambda: warp_trilinear(tt, phi, False, normalized=True,
                                   scale_intensity=True), 20)
        layout_ms["warp_trilinear"][f"pixel_{tname}"] = _cuda_ms(
            lambda: warp_trilinear(tt, coords, False), 20)
        layout_ms["warp_coord_grad"][f"phi_{tname}"] = _cuda_ms(
            lambda: warp_coord_grad(tt, phi, cot5, False, normalized=True,
                                    scale_intensity=True), 20)
        layout_ms["warp_coord_grad"][f"pixel_{tname}"] = _cuda_ms(
            lambda: warp_coord_grad(tt, coords, cot, False), 20)
    ms["warp_trilinear"] = layout_ms["warp_trilinear"]["phi_bf16"]
    plain_ms["warp_trilinear"] = _cuda_ms(
        lambda: warp_trilinear_plain(t16, phi, False, normalized=True,
                                     scale_intensity=True), 3)
    # torch's grid_sample on f32 taps, its (B, D, W, H, 3) grid in its own
    # (x, y, z) order and [-1, 1] units built outside the timed calls: the
    # yardstick of the f32-tap times
    scale = torch.tensor([2.0 / (SZ - 1)] * 3, device=dev)
    grid = (coords * scale - 1.0).flip(-1).reshape(B, SZ, SZ, SZ, 3)
    lib_ms["warp_trilinear"] = _cuda_ms(lambda: F.grid_sample(
        t32, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 10)

    ms["warp_coord_grad"] = layout_ms["warp_coord_grad"]["phi_bf16"]
    plain_ms["warp_coord_grad"] = _cuda_ms(
        lambda: warp_coord_grad_plain(t16, phi, cot5, False, normalized=True,
                                      scale_intensity=True), 3)
    lib_ms["warp_coord_grad"] = _cuda_ms(
        lambda: torch.ops.aten.grid_sampler_3d_backward(
            cot5, t32, grid, 0, 0, True, [False, True]), 10)

    ms["drr_project"] = _cuda_ms(lambda: project_taps(att, *fwd_geom), 20)
    plain_ms["drr_project"] = _cuda_ms(
        lambda: project_taps_plain(att, *fwd_geom), 5)
    Rx, Rz, dx = drr.forward_matrices(pipe_poses, (SZ,) * 3, res,
                                      (2.2, 2.2, 2.2))
    lib_ms["drr_project"] = _cuda_ms(
        lambda: drr.project_with_mats(att, Rx, Rz, dx), 5)
    del Rx, Rz
    ms["drr_backproject"] = _cuda_ms(
        lambda: backproject_taps(proj_in, *bwd_geom), 20)
    # the serving path's variant: bf16 into the encoder's input buffer
    lift_bf16_ms = _cuda_ms(lambda: backproject_taps(
        proj_in, *bwd_geom, out=lift_buf[:, 1:]), 20)
    plain_ms["drr_backproject"] = _cuda_ms(
        lambda: backproject_taps_plain(proj_in, *bwd_geom), 5)
    Bu, Bv = drr.backward_matrices(pipe_poses, (SZ,) * 3, res)
    lib_ms["drr_backproject"] = _cuda_ms(
        lambda: drr.backproject_with_mats(proj_in, Bu, Bv), 5)
    del Bu, Bv

    M = coords.shape[1]
    nbytes = {
        "pca_expand": coefs.numel() * 4 + V.numel() * 2 + mean.numel() * 4
        + B * n * 4,
        "pca_grad": cot_pca.numel() * 4 + V.numel() * 2 + B * LATENT * 4,
        "warp_trilinear": t16.numel() * 2 + phi.numel() * 4 + B * M * 4,
        "warp_coord_grad": t16.numel() * 2 + phi.numel() * 4
        + cot.numel() * 4 + phi.numel() * 4,
        "drr_project": att.numel() * 4 + sum(t.numel() * 4 for t in fwd_geom)
        + B * 4 * res[0] * res[1] * 4,
        "drr_backproject": proj_in.numel() * 4
        + sum(t.numel() * 4 for t in bwd_geom) + B * 4 * SZ ** 3 * 4,
    }
    ops = {
        "pca_expand": (2 * B * LATENT * n, PEAK_BF16_FLOPS),
        "pca_grad": (2 * B * LATENT * n, PEAK_F32_FLOPS),
        "warp_trilinear": ((WARP_OPS_PER_OUTPUT + WARP_PHI_OPS) * B * M,
                           PEAK_F32_FLOPS),
        "warp_coord_grad": ((WARP_GRAD_OPS_PER_OUTPUT + WARP_GRAD_PHI_OPS)
                            * B * M, PEAK_F32_FLOPS),
        "drr_project": (DRR_OPS_PER_TWO_TAPS * B * 4 * SZ * res[0]
                        * (SZ + res[1]), PEAK_F32_FLOPS),
        "drr_backproject": (DRR_OPS_PER_TWO_TAPS * B * 4 * SZ * SZ
                            * (res[1] + SZ), PEAK_F32_FLOPS),
    }
    # the bound of each layout and tap type: the f32 taps move 33 MB more
    layout_times = {
        name: {key: {"ms": t_ms, "bound_ms": (
            nbytes[name] + (t16.numel() * 2 if key.endswith("f32") else 0))
            / HBM_BYTES_PER_S * 1e3} for key, t_ms in times.items()}
        for name, times in layout_ms.items()}
    del vol01, taps, t16, t32, coords, int_coords, grid, cot, cot5, cot_pca
    del phi
    lift_bf16_bytes = nbytes["drr_backproject"] - B * 4 * SZ ** 3 * 2
    lift_bf16 = {"ms": lift_bf16_ms,
                 "bound_ms": lift_bf16_bytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes"}
    del cot_bf16, att, proj_in, lift_buf
    torch.cuda.empty_cache()

    def steady(p, pca_, args_, iters):
        for _ in range(2):
            p.register(pca_, *args_)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            p.register(pca_, *args_)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / iters,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    register_ms, peak_gib = steady(pipe, pca, (src_hu, tgt_hu, seg, seg), 5)
    r_args = (r_src, r_tgt, r_seg, r_seg)
    refine_ms, refine_peak = steady(pipe_r, r_pca, r_args, 3)
    _emit(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          warp_layouts=layout_times, lift_bf16_buffer=lift_bf16,
          register_ms=register_ms, register_per_s=B * 1e3 / register_ms,
          peak_memory_gib=peak_gib, register_refine_ms=refine_ms,
          register_refine_per_s=B * 1e3 / refine_ms,
          refine_ms_per_step=(refine_ms - register_ms) / (REFINE_STEPS + 1),
          refine_peak_memory_gib=refine_peak, batch=B,
          refine_steps=REFINE_STEPS)

    def profile_call(fn):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernel_ms = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernel_ms[e.key] = e.self_device_time_total / 1e3
        by_layer = {}
        for name, t in kernel_ms.items():
            by_layer[_layer(name)] = by_layer.get(_layer(name), 0.0) + t
        busy_ms = sum(kernel_ms.values())
        top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:8]
        # a concatenation's copy kernel (the encoder input is built in place)
        cat_ms = sum(t for name, t in kernel_ms.items() if "CatArray" in name)
        _emit(wall_ms=wall_ms, device_busy_ms=busy_ms,
              device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
              device_ms_by_layer={k: round(v, 4) for k, v in
                                  sorted(by_layer.items(),
                                         key=lambda kv: -kv[1])},
              top_kernels=[[name[:60], round(t, 4)] for name, t in top],
              cat_kernel_ms=cat_ms)

    _begin("profile")
    profile_call(lambda: pipe.register(pca, src_hu, tgt_hu, seg, seg))
    _begin("profile_refine")
    profile_call(lambda: pipe_r.register(r_pca, *r_args))

    replaces = {
        "pca_expand": "liftreg_tpu/ops/pallas_pca.py:30",
        "pca_grad": "liftreg_tpu/ops/pallas_pca.py:78",
        "warp_trilinear": "liftreg_tpu/ops/pallas_warp.py:61",
        "warp_coord_grad": "liftreg_tpu/ops/pallas_warp.py:61",
        "drr_project": "liftreg_tpu/ops/pallas_drr.py:27",
        "drr_backproject": "liftreg_tpu/ops/pallas_drr.py:59",
    }
    sources = {
        "pca_expand": "liftreg_tpu_torch/csrc/pca_expand.cu",
        "pca_grad": "liftreg_tpu_torch/csrc/pca_expand.cu",
        "warp_trilinear": "liftreg_tpu_torch/csrc/warp_trilinear.cu",
        "warp_coord_grad": "liftreg_tpu_torch/csrc/warp_trilinear.cu",
        "drr_project": "liftreg_tpu_torch/csrc/drr_project.cu",
        "drr_backproject": "liftreg_tpu_torch/csrc/drr_backproject.cu",
    }
    kernels = []
    for name in KERNELS:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name][0] / ops[name][1] * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": refine_launches[name], "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms[name]})
        kernels[-1]["serving_launches"] = launches[name]
    next(k for k in kernels if k["name"] == "drr_backproject").update(
        bf16_buffer_ms=lift_bf16["ms"],
        bf16_buffer_bound_ms=lift_bf16["bound_ms"])
    for name, times in layout_times.items():
        next(k for k in kernels if k["name"] == name)["layouts"] = times
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    timer.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
