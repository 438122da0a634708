#!/usr/bin/env python3
"""On-card smoke run of liftreg_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX or of liftreg_tpu. Phases, each printing one JSON
line with its elapsed seconds:

1. build: compile the port's CUDA kernels (one nvcc call, into build/);
2. device: the card's name and power limit from nvidia-smi;
3. pca_check / warp_check: each kernel against its plain PyTorch version
   on the card, at the shapes of the serving path (plus ragged PCA
   lengths, both tap types, both paddings, coordinates far outside);
4. main_path: RegistrationPipeline.register at 160^3, B=4, 4 views on a
   240^2 detector, latent 56, bf16 encoder, basis and taps, with random
   seeded weights; the kernels' launch counts are zeroed just before and
   read just after; then register_projections the same way;
5. reference: the pipeline on the card against the same pipeline on the
   CPU (the kernels' plain versions) at 32^3;
6. times: each kernel, its plain version and one PyTorch library call of
   the same function, with CUDA events; the steady-state register time
   and peak memory;
7. profile: one register call under torch.profiler, device time by layer
   (from kernel names) and the device's idle share.

Then the nvidia-smi line, one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero; so does a
missing card, and a watchdog after 10 minutes.
"""
import json
import os
import subprocess
import sys
import threading
import time

WATCHDOG_S = 600
# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core and f32 peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# f32 operations per output of the warp: 3 axes x (clip, floor, t, two
# weights) and 8 corners x (2 weight products, 1 tap product, 1 sum)
WARP_OPS_PER_OUTPUT = 50

SZ = 160
B = 4
LATENT = 56
PCA_TOL = 1e-5
WARP_TOL = 1e-6
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
    for layer, keys in (("pca_expand", ("pca_expand",)),
                        ("warp_trilinear", ("warp_trilinear",)),
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
    from liftreg_tpu_torch.ops import _build, drr
    from liftreg_tpu_torch.ops.pca_kernel import pca_expand, pca_expand_plain
    from liftreg_tpu_torch.ops.warp_kernel import (warp_trilinear,
                                                   warp_trilinear_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    _begin("build")
    fresh = not _build.library_path().is_file()
    lib_path = _build.build()
    _build.library()
    _emit(nvcc_calls=int(fresh), library=os.path.relpath(lib_path))

    _begin("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _emit(name=kind, nvidia_smi=smi, count=torch.cuda.device_count())

    g = torch.Generator(device=dev).manual_seed(0)
    n = 3 * SZ ** 3

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
    pca_max = max(pca_err, *ragged.values())
    _emit(max_abs_err=pca_err, ragged_max_abs_err=ragged, tol=PCA_TOL)
    _require(pca_max <= PCA_TOL, f"PCA kernel error {pca_max} > {PCA_TOL}")

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
    warp_max = max(warp_errs.values())
    _emit(max_abs_err=warp_errs, tol=WARP_TOL)
    _require(warp_max <= WARP_TOL, f"warp kernel error {warp_max} > "
                                   f"{WARP_TOL}")

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

    pca_expand.launches = warp_trilinear.launches = 0
    warped, phi = pipe.register(pca, src_hu, tgt_hu, seg, seg)
    torch.cuda.synchronize()
    launches = {"pca_expand": pca_expand.launches,
                "warp_trilinear": warp_trilinear.launches}
    _require(warped.shape == shape and phi.shape == (B, 3, SZ, SZ, SZ),
             f"shapes {tuple(warped.shape)}, {tuple(phi.shape)}")
    _require(bool(torch.isfinite(warped).all() and torch.isfinite(phi).all()),
             "non-finite output")
    _require(all(v >= 1 for v in launches.values()),
             f"a kernel was not launched on the main path: {launches}")

    proj = drr.normalize_drr(drr.project(
        drr.calc_relative_atten_coef(tgt_hu[:, 0]), pipe.poses,
        pipe.resolution, pipe.spacing))
    pca_expand.launches = warp_trilinear.launches = 0
    warped_p, phi_p = pipe.register_projections(pca, src_hu, proj, seg)
    torch.cuda.synchronize()
    launches_p = {"pca_expand": pca_expand.launches,
                  "warp_trilinear": warp_trilinear.launches}
    _require(bool(torch.isfinite(warped_p).all()
                  and torch.isfinite(phi_p).all()),
             "non-finite output of register_projections")
    _require(all(v >= 1 for v in launches_p.values()),
             f"a kernel was not launched by register_projections: "
             f"{launches_p}")
    _emit(launches=launches, launches_projections=launches_p,
          warped=list(warped.shape), phi=list(phi.shape),
          phi_range=[float(phi.min()), float(phi.max())])

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

    # -- times -------------------------------------------------------------
    _begin("times")
    coefs_bf16 = coefs.to(torch.bfloat16)
    pca_ms = _cuda_ms(lambda: pca_expand(coefs, V, mean), 20)
    pca_plain_ms = _cuda_ms(lambda: pca_expand_plain(coefs, V, mean), 5)
    pca_lib_ms = _cuda_ms(lambda: torch.addmm(
        mean, coefs_bf16, V, out_dtype=torch.float32), 20)

    t16 = taps[torch.bfloat16]
    t32 = taps[torch.float32]
    warp_ms = _cuda_ms(lambda: warp_trilinear(t16, coords, False), 20)
    warp_plain_ms = _cuda_ms(lambda: warp_trilinear_plain(t16, coords, False),
                             3)
    scale = torch.tensor([2.0 / (SZ - 1)] * 3, device=dev)
    grid = (coords * scale - 1.0).flip(-1).reshape(B, SZ, SZ, SZ, 3)
    warp_lib_ms = _cuda_ms(lambda: F.grid_sample(
        t32, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 10)

    M = coords.shape[1]
    warp_bytes = t16.numel() * 2 + coords.numel() * 4 + B * M * 4
    del vol01, taps, t16, t32, coords, grid
    torch.cuda.empty_cache()
    for _ in range(2):
        pipe.register(pca, src_hu, tgt_hu, seg, seg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.register(pca, src_hu, tgt_hu, seg, seg)
    torch.cuda.synchronize()
    register_ms = (time.perf_counter() - t0) * 1e3 / iters
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _emit(register_ms=register_ms, register_per_s=B * 1e3 / register_ms,
          peak_memory_gib=peak_gib, batch=B)

    _begin("profile")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.register(pca, src_hu, tgt_hu, seg, seg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernel_ms[e.key] = e.self_device_time_total / 1e3
    by_layer = {}
    for name, ms in kernel_ms.items():
        by_layer[_layer(name)] = by_layer.get(_layer(name), 0.0) + ms
    busy_ms = sum(kernel_ms.values())
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:6]
    _emit(wall_ms=wall_ms, device_busy_ms=busy_ms,
          device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
          device_ms_by_layer={k: round(v, 4) for k, v in
                              sorted(by_layer.items(), key=lambda kv: -kv[1])},
          top_kernels=[[name[:60], round(ms, 4)] for name, ms in top])

    def bound(nbytes, ops, peak):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
            "operations"

    pca_bound, pca_by = bound(
        coefs.numel() * 4 + V.numel() * 2 + mean.numel() * 4 + B * n * 4,
        2 * B * LATENT * n, PEAK_BF16_FLOPS)
    warp_bound, warp_by = bound(warp_bytes, WARP_OPS_PER_OUTPUT * B * M,
                                PEAK_F32_FLOPS)
    kernels = [
        {"name": "pca_expand", "route": "cuda",
         "source": "liftreg_tpu_torch/csrc/pca_expand.cu",
         "replaces": "liftreg_tpu/ops/pallas_pca.py:30",
         "launches": launches["pca_expand"], "max_abs_err": pca_max,
         "ms": pca_ms, "plain_ms": pca_plain_ms, "bound_ms": pca_bound,
         "bound_by": pca_by, "library_ms": pca_lib_ms},
        {"name": "warp_trilinear", "route": "cuda",
         "source": "liftreg_tpu_torch/csrc/warp_trilinear.cu",
         "replaces": "liftreg_tpu/ops/pallas_warp.py:61",
         "launches": launches["warp_trilinear"], "max_abs_err": warp_max,
         "ms": warp_ms, "plain_ms": warp_plain_ms, "bound_ms": warp_bound,
         "bound_by": warp_by, "library_ms": warp_lib_ms},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    timer.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
