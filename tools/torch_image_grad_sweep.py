#!/usr/bin/env python3
"""Time variants of the port's warp image gradient on one card.

    python3 tools/torch_image_grad_sweep.py [--out build/image_grad_sweep/results.json]

Builds each variant of ``csrc/warp_trilinear.cu``, with other values of the
image gradient's constants patched into the source (``kImgTZ``, ``kImgTY``,
``kImgTX``: the tile of output points a block owns; ``kImgThreads``:
threads a block; ``kImgMinBlocks``: blocks an SM must hold, which caps the
registers; ``kImgSmemFloats``: the shared-memory budget of a tile's box of
taps; ``kImgChan``: channels whose cotangents a thread holds in registers),
into its own library under
``build/image_grad_sweep/`` (one ``nvcc`` per variant, all started
together), checks each against the plain
PyTorch version with ``chip_smoke.py``'s tolerance (1e-5 of the largest
value plus 1e-6 of each tap's sum of term magnitudes, each of two calls),
and prints one JSON line per variant: CUDA-event times in ms (20 calls
after 2 warm-ups, each call the zero fill of dtaps and the kernel, as the
wrapper makes them) at ``chip_smoke.py``'s timed inputs (C = 3, 160^3,
B = 1, phi in its (B, 3, D, W, H) layout, zeros padding, its smooth field)
and with one channel, and with 3 channels on a smooth field of up to 0.9
voxels and on the identity, beside the bound of the bytes the function
must move, and the share of points that took the overflow path; then
``regnet``: the sum over the
image-gradient calls of one RegNet2D3D step (its forward, projection loss
and backward at the stage-1 shape, random seeded weights:
``torch_kernel_ab.regnet_step_inputs``), each call's inputs recorded from
the step and replayed through the port's wrapper with the variant's
library; the registers per thread from ``ptxas``. ``DESIGNS`` put other code in the place of the
source's ``add_terms`` (``tools/warp_variants/warp_image_grad_merged.cuh``:
the terms of neighbouring points merged in registers first) and are
checked. Ablations (``ABLATIONS``: the port's source with a part taken out
or forced) show what each part costs; their results are not checked. ``--only REGEX`` runs the variants whose name matches. Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from torch_drr_sweep import _build_all
from torch_kernel_ab import chip_smoke_module, regnet_step_inputs

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = ROOT / "liftreg_tpu_torch" / "csrc" / "warp_trilinear.cu"
# the terms of neighbouring points merged in registers before the atomics,
# put in the place of the source's add_terms
MERGED = ROOT / "tools" / "warp_variants" / "warp_image_grad_merged.cuh"
_ADD_TERMS = r"(?s)__device__ __forceinline__ void add_terms\(.*?\n}\n"


def _set(**values):
    """Patches that give the source's constants ``values``."""
    return [(rf"constexpr int {k} = -?\d+;", f"constexpr int {k} = {v};")
            for k, v in values.items()]


def _tile(tz, ty, tx, threads, min_blocks, channels, smem=None):
    values = dict(kImgTZ=tz, kImgTY=ty, kImgTX=tx, kImgThreads=threads,
                  kImgMinBlocks=min_blocks, kImgChan=channels)
    if smem:
        values["kImgSmemFloats"] = smem
    return _set(**values)


# (name: patches); the first is the source as built for the port, the
# next ones other tiles, threads, registers, channels and budgets
VARIANTS = {"csrc": []}
VARIANTS.update({
    f"t{tz}x{ty}x{tx}_n{n}_mb{b}_ch{c}" + (f"_s{sm}" if sm else ""):
    _tile(tz, ty, tx, n, b, c, sm)
    for tz, ty, tx, n, b, c, sm in (
        (1, 8, 32, 256, 4, 3, None), (1, 8, 32, 256, 6, 3, None),
        (1, 8, 32, 256, 5, 1, None), (1, 8, 32, 256, 4, 3, 12288),
        (1, 16, 32, 512, 3, 3, None), (2, 8, 32, 256, 4, 3, 12288),
        (2, 8, 32, 256, 4, 1, 12288), (2, 16, 32, 512, 2, 3, 12288),
        (4, 8, 32, 256, 3, 3, 12288), (4, 8, 32, 1024, 1, 3, 12288))})
# designs, checked like the variants: the source with its add_terms
# replaced by the terms of neighbouring points merged in registers first;
# and with a 3-D tile whose box spans at most 2 (1) taps more than the tile
# along each axis (a field within a voxel of the identity) sent straight to
# dtaps as the overflow path sends its terms (and counted with it)
_MERGED = [(_ADD_TERMS, lambda _: MERGED.read_text())]


def _near(taps):
    return [(r"\n  if \(cpass == 0\) \{",
             f"\n  if (cpass == 0 || (Do > 0 && zhi - zlo < kImgTZ + {taps} &&"
             f" yhi - ylo < kImgTY + {taps} && xhi - xlo < kImgTX + {taps})) {{")]


DESIGNS = {
    "merged": _MERGED,
    "merged_t2_mb4": _MERGED + _set(kImgTZ=2, kImgMinBlocks=4,
                                    kImgSmemFloats=12288),
    "merged_direct_t4_mb3": _MERGED + _set(kImgTZ=4, kImgSmemFloats=4,
                                           kImgMinBlocks=3),
    "near2": _near(2),
    "near1": _near(1),
}
# ablations: a budget of 4 floats sends every tile to the overflow path
# (every term straight to dtaps: the first design's global atomics, in the
# tiles' order); the others are the port's source with one part changed by
# a text substitution (regex, replacement)
ABLATIONS = {
    "all_overflow": _set(kImgSmemFloats=4),
    "all_overflow_t2_mb4": _tile(2, 8, 32, 256, 4, 3, 4),
    # the kernel returns at once: the zero fill of dtaps and the launch
    "empty": [(r"\n  extern __shared__ float4 box4\[\];",
               "\n  if (C > 0) return;\n  extern __shared__ float4 box4[];")],
    # the points' and cotangents' loads and the taps, then no more
    "loads_only": [(r"\n#pragma unroll\n  for \(int k = 0; k < 6; \+\+k\) "
                    r"ext\[k\] = ",
                    "\n  if (ext[0] == -7 && gv[0][0] == -7.f) dtaps[0] = 1.f;"
                    "\n  if (C > 0) return;"
                    "\n#pragma unroll\n  for (int k = 0; k < 6; ++k) ext[k] = ")],
    # the flush one float at a time
    "scalar_flush": [(r"const int vec =\n\s*H % 4 == 0 &&",
                      "const int vec = 0 &&")],
    # no flush: nothing reaches dtaps from the boxes
    "no_flush": [(r"if \(v\.x == 0\.f && v\.y == 0\.f && v\.z == 0\.f "
                  r"&& v\.w == 0\.f\) continue;",
                  "if (v.x != -12345.f) continue;")],
    # no adds of terms into the boxes: their zero fill and flush remain
    "no_adds": [(r"if \(\(live >> k\) & 1\)\n(\s*)atomicAdd\(bc \+",
                 "if (((live >> k) & 1) && gv[cl][p] == -12345.f)"
                 "\n\\1atomicAdd(bc +")],
}


def patched_source(name, subs):
    """The source with ``subs`` applied; each must match."""
    text = SRC.read_text()
    for pattern, repl in subs:
        text, count = re.subn(pattern, repl, text)
        if not count:
            raise RuntimeError(f"{name}: {pattern!r} matches nothing")
    return text


def _registers(log_text):
    """{warp_image_grad_kernel<template arguments>: registers per thread,
    with the bytes of spill stores where there are any} from a ``ptxas
    -v`` log."""
    regs, fn, spill = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = re.search(r"(warp_image_grad_kernel)I(\w*?)EEv", m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[f"{fn.group(1)}<{fn.group(2)}>"] = (
                int(m.group(1)) if not spill else
                f"{m.group(1)} (spills {spill} bytes)")
            fn, spill = None, 0
    return regs


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "image_grad_sweep"
                                         / "results.json"))
    ap.add_argument("--only", default="",
                    help="run only the variants whose name matches this "
                    "regular expression")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_image_grad_sweep: no CUDA device", file=sys.stderr)
        return 1
    from liftreg_tpu_torch.models.unet2d3d import RegNet2D3D
    from liftreg_tpu_torch.ops import _build, drr, warp_kernel
    from liftreg_tpu_torch.ops.warp_kernel import (image_grad_overflow,
                                                   warp_image_grad_plain)
    cs = chip_smoke_module()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    out_root = ROOT / "build" / "image_grad_sweep"
    patched = out_root / "src"
    patched.mkdir(parents=True, exist_ok=True)
    variants = [(n, subs, False) for n, subs in VARIANTS.items()]
    variants += [(n, subs, False) for n, subs in DESIGNS.items()]
    variants += [(n, subs, True) for n, subs in ABLATIONS.items()]
    keep = re.compile(args.only)
    variants = [v for v in variants if keep.search(v[0])]
    jobs = []
    for name, subs, _ in variants:
        (patched / f"{name}.cu").write_text(patched_source(name, subs))
        jobs.append(("img", name, patched / f"{name}.cu", ()))
    built = _build_all(_build, jobs, out_root, _registers)

    # chip_smoke.py's timed inputs of the image gradient
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    SZ = cs.SZ
    phi = cs._phi_of(cs._smooth_coords(torch, F, g, 1, SZ, 4.0, dev), SZ)
    cot3 = torch.randn((1, 3) + (SZ,) * 3, generator=g, device=dev)
    # the timed field with 3 channels and 1; a field of up to 0.9 voxels and
    # the identity
    near = cs._near_identity_phi(torch, F, g, 1, SZ, 0.9, dev)
    ident = cs._near_identity_phi(torch, F, g, 1, SZ, 0.0, dev)
    cases = {"c3": (phi, cot3), "c1": (phi, cot3[:, :1].contiguous()),
             "c3_near_identity": (near, cot3), "c3_identity": (ident, cot3)}
    calls = {key: ((torch.zeros_like(cot), phi, cot, False),
                   {"normalized": True}) for key, (phi, cot) in cases.items()}
    # the image-gradient calls of one RegNet2D3D step, recorded
    step = regnet_step_inputs(torch, cs, drr, RegNet2D3D, dev)
    kernel = warp_kernel.warp_image_grad
    recorded = []

    def record(*a, **kw):
        recorded.append((tuple(t.clone() if torch.is_tensor(t) else t
                               for t in a), dict(kw)))
        return kernel(*a, **kw)

    record.launches = 0
    warp_kernel.warp_image_grad = record
    try:
        step()
    finally:
        warp_kernel.warp_image_grad = kernel
    del step
    torch.cuda.empty_cache()
    calls.update({f"regnet_{i}": c for i, c in enumerate(recorded)})
    checks = {}
    for key, (a, kw) in calls.items():
        want = warp_image_grad_plain(*a, **kw)
        tol = cs.IMG_GRAD_REL_TOL * float(want.abs().max()) \
            + cs.IMG_GRAD_MAG_TOL * warp_image_grad_plain(
                a[0], a[1], a[2].abs(), *a[3:], **kw)
        checks[key] = (want, tol)
    overflow = image_grad_overflow(dev)
    library = _build.library
    results = []
    for name, _, ablation in variants:
        lib_path, regs, err = built[("img", name)]
        row = {"kernel": "warp_image_grad", "variant": name,
               "registers": regs, "ablation": ablation}
        if err:
            row["build_error"] = err[-400:]
            results.append(row)
            print(json.dumps(row), flush=True)
            continue
        lib = _build.load(lib_path)
        # the port's wrapper (its zero fill of dtaps included) on the
        # variant's library
        _build.library = lambda: lib
        try:
            for key, (a, kw) in calls.items():
                def call():
                    return kernel(*a, **kw)

                overflow.zero_()
                first = call()
                share = int(overflow) / (a[1].numel() // 3)
                second = call()
                want, tol = checks[key]
                excess = max(float(((first - want).abs() - tol).max()),
                             float(((second - first).abs() - tol).max()))
                ms = cs._cuda_ms(call, 20)
                bound = (a[1].numel() + 2 * a[2].numel()) * 4 \
                    / cs.HBM_BYTES_PER_S * 1e3
                row[key] = {"ms": ms, "bound_ms": bound,
                            "share": bound / ms, "overflow_share": share,
                            "max_abs_err": float((first - want).abs().max()),
                            "excess": excess, "ok": ablation or excess <= 0}
                del first, second
        finally:
            _build.library = library
        regnet = [v for k, v in row.items() if k.startswith("regnet_")]
        row["regnet"] = {"calls": len(regnet),
                         "ms": sum(v["ms"] for v in regnet),
                         "ok": all(v["ok"] for v in regnet)}
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
