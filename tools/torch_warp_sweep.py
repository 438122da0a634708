#!/usr/bin/env python3
"""Time variants of the port's warp forward on one card.

    python3 tools/torch_warp_sweep.py [--out build/warp_sweep/results.json]

Builds each variant of ``csrc/warp_trilinear.cu`` (other values of its
forward's compile-time knobs: ``LIFTREG_WARP_POINTS`` and
``LIFTREG_WARP_POINTS_F32`` points a thread with bf16 and f32 taps,
``LIFTREG_WARP_THREADS`` threads a block) and of
``tools/warp_variants/warp_trilinear_knobs.cu``, the same kernels with the
alternatives that lost as knobs (``LIFTREG_WARP_STRIDED=0`` a thread's
points consecutive, ``LIFTREG_WARP_HINTS`` 1 streaming loads and stores of
phi and the output, 2 an L2 evict-first policy for those and an
evict-last policy for the taps, ``LIFTREG_WARP_XPAIR`` the x pair of taps
as one load) into its own
library under ``build/warp_sweep/`` (one ``nvcc`` per variant, all started
together), checks each against the plain PyTorch version at the serving
shape of ``chip_smoke.py`` (160^3, B=4, phi in its (B, 3, D, W, H) layout,
zeros padding, ``scale_intensity``, as ``warp_image`` calls it) with its
tolerance, and prints one JSON line per variant: CUDA-event times in ms
(20 launches after 2 warm-ups) with bf16 and with f32 taps, each beside
the bound of the bytes it must move, the registers per thread from
``ptxas`` and the error. Ablations (``ABLATIONS``: the port's source with
the tap loads, the point loads or the stores taken out) show what the rest
of the kernel costs; their results are not checked. ``--only REGEX`` runs
the variants whose name matches. Needs a CUDA card and nvcc; imports
nothing of JAX.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from torch_drr_sweep import _build_all
from torch_kernel_ab import chip_smoke_module

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = ROOT / "liftreg_tpu_torch" / "csrc" / "warp_trilinear.cu"
# the same kernels with the losing alternatives as knobs: consecutive points
# (LIFTREG_WARP_STRIDED=0), L2 hints (LIFTREG_WARP_HINTS), the x pair as one
# load (LIFTREG_WARP_XPAIR)
KNOBS = ROOT / "tools" / "warp_variants" / "warp_trilinear_knobs.cu"


def _knobs(points=None, threads=None, strided=None, hints=None,
           xpair=None):
    """-D defines of the forward's knobs; ``points`` sets both tap types'."""
    return tuple(f"LIFTREG_WARP_{k}={v}" for k, v in (
        ("POINTS", points), ("POINTS_F32", points), ("THREADS", threads),
        ("STRIDED", strided), ("HINTS", hints), ("XPAIR", xpair))
        if v is not None)


# (name, source, -D defines); the first is the source as built for the port
# (bf16 taps 4 points a thread, f32 taps 2, 32 apart, 256 threads)
WARPS = [("csrc", SRC, ())]
WARPS += [(f"strided_pts{p}_t256", SRC, _knobs(points=p))
          for p in (1, 2, 3, 4, 6, 8)]
WARPS += [(f"strided_pts{p}_t{n}", SRC, _knobs(points=p, threads=n))
          for p in (2, 4) for n in (128, 512, 1024)]
# consecutive points (16-byte loads of phi and stores of the output)
WARPS += [(f"consecutive_pts{p}_t{n}", KNOBS, _knobs(points=p, threads=n,
                                                      strided=0))
          for p, n in ((1, 256), (2, 256), (4, 256), (4, 512), (8, 256))]
WARPS += [(f"hints{h}", KNOBS, _knobs(hints=h)) for h in (1, 2)]
WARPS += [("xpair1", KNOBS, _knobs(xpair=1)),
          ("xpair1_hints2", KNOBS, _knobs(xpair=1, hints=2))]
# ablations: the port's source with one kind of work taken out by a text
# substitution (regex, replacement); their results are wrong by design
ABLATIONS = {
    # the taps become a value of their index
    "no_tap_loads": (SRC, [
        (r"gather_taps<MODES>\(v, z\[p\], y\[p\], x\[p\], W, H, t\);",
         "for (int k = 0; k < 8; ++k) t[k] = static_cast<float>("
         "z[p].i0 + y[p].i0 + x[p].i0 + k);")]),
    # the points become their own voxel, a quarter voxel off: no phi loads
    "no_point_loads": (SRC, [
        (r"load_points_strided<LAYOUT, kPts>\(pts, b, m0, M, scale, c\);",
         "for (int p = 0; p < kPts; ++p) { const int m = m0 + 32 * p; "
         "c[3 * p] = static_cast<float>(m / (W * H)) + 0.25f; "
         "c[3 * p + 1] = static_cast<float>((m / H) % W) + 0.25f; "
         "c[3 * p + 2] = static_cast<float>(m % H) + 0.25f; }")]),
    # the stores happen only for a value that never occurs
    "no_stores": (SRC, [
        (r"if \(m0 \+ 32 \* p < M\) out\[",
         "if (m0 + 32 * p < M && acc[0] == -12345.f) out[")]),
}


def _registers(log_text):
    """{kernel<template arguments>: registers per thread} of the warp
    kernels in a ``ptxas -v`` log (mangled arguments: ``13__nv_bfloat16``
    bf16, ``f`` float, ``Li0E`` 0)."""
    regs, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = re.search(r"(warp_trilinear_kernel|warp_coord_grad_kernel)"
                           r"I(\w*?)EEv", m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[f"{fn.group(1)}<{fn.group(2)}>"] = int(m.group(1))
            fn = None
    return regs


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "warp_sweep"
                                         / "results.json"))
    ap.add_argument("--only", default="",
                    help="run only the variants whose name matches this "
                    "regular expression")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_warp_sweep: no CUDA device", file=sys.stderr)
        return 1
    from liftreg_tpu_torch.ops import _build
    from liftreg_tpu_torch.ops.warp_kernel import (_packed, axis_modes,
                                                   warp_trilinear_plain)
    cs = chip_smoke_module()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    variants = [(n, False) for n, _, _ in WARPS]
    jobs = [("warp", n, src, d) for n, src, d in WARPS]
    out_root = ROOT / "build" / "warp_sweep"
    patched = out_root / "src"
    patched.mkdir(parents=True, exist_ok=True)
    for name, (src, subs) in ABLATIONS.items():
        text = src.read_text()
        for pattern, repl in subs:
            text, count = re.subn(pattern, repl, text)
            if not count:
                raise RuntimeError(f"{name}: {pattern!r} matches nothing")
        (patched / f"{name}.cu").write_text(text)
        jobs.append(("warp", name, patched / f"{name}.cu", ()))
        variants.append((name, True))
    keep = re.compile(args.only)
    jobs = [j for j in jobs if keep.search(j[1])]
    built = _build_all(_build, jobs, out_root, _registers)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, SZ = cs.B, cs.SZ
    vol = torch.rand((B, 1, SZ, SZ, SZ), generator=g, device=dev)
    phi = cs._phi_of(cs._smooth_coords(torch, F, g, B, SZ, 4.0, dev), SZ)
    M = SZ ** 3
    out = torch.empty((B, 1, M), device=dev)
    taps = {dt: vol.to(dt) for dt in (torch.bfloat16, torch.float32)}
    wants = {dt: warp_trilinear_plain(t, phi, False, normalized=True,
                                      scale_intensity=True).reshape(B, 1, M)
             for dt, t in taps.items()}
    modes = _packed(axis_modes((SZ,) * 3, quad_z=False))
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for name, ablation in variants:
        if ("warp", name) not in built:
            continue
        lib_path, regs, err = built[("warp", name)]
        row = {"kernel": "warp_trilinear", "variant": name,
               "registers": regs, "ablation": ablation}
        if err:
            row["build_error"] = err[-400:]
        else:
            lib = _build.load(lib_path)
            for dt, t in taps.items():
                def call():
                    rc = lib.liftreg_warp_trilinear_phi(
                        t.data_ptr(), int(dt == torch.bfloat16),
                        phi.data_ptr(), out.data_ptr(), B, 1, SZ, SZ, SZ, M,
                        0, modes, 1, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                out.fill_(float("nan"))
                call()
                abs_err = float((out - wants[dt]).abs().max())
                ms = cs._cuda_ms(call, 20)
                bound = (t.numel() * t.element_size() + phi.numel() * 4
                         + out.numel() * 4) / cs.HBM_BYTES_PER_S * 1e3
                row[str(dt).split(".")[-1]] = {
                    "ms": ms, "bound_ms": bound, "share": bound / ms,
                    "max_abs_err": abs_err,
                    "ok": ablation or abs_err <= cs.WARP_TOL}
        results.append(row)
        print(json.dumps(row), flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi,
                                          "results": results}, indent=1))
    bad = [r["variant"] for r in results if "build_error" in r or any(
        isinstance(v, dict) and not v.get("ok", True) for v in r.values())]
    print(json.dumps({"failed": bad}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
