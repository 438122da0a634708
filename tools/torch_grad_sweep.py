#!/usr/bin/env python3
"""Time variants of the port's PCA backward and warp coordinate gradient on
one card.

    python3 tools/torch_grad_sweep.py [--out build/grad_sweep/results.json]

Builds each variant of the two kernels (``csrc/pca_expand.cu`` and
``csrc/warp_trilinear.cu`` with other values of their ``LIFTREG_*``
compile-time knobs, and the designs under ``tools/pca_variants/`` and
``tools/warp_variants/``) into its
own library under ``build/grad_sweep/`` (one ``nvcc`` per variant, all
started together), checks each against the plain PyTorch version at the
serving shape of ``chip_smoke.py`` (160^3, B=4, latent 56) with its
tolerances, and prints one JSON line per variant: CUDA-event times in ms
(20 launches after 2 warm-ups), the bound of the bytes each must move, the
registers per thread from ``ptxas`` and the error. The PCA backward is timed
at several grid sizes (blocks per SM), the coordinate gradient with bf16
and f32 taps. Ablations (``ABLATIONS``: the port's source with some loads or
the stores taken out) show what the rest of each kernel costs; their
results are not checked. ``--kernels pca`` or ``warp`` runs one kernel's
variants, ``--only REGEX`` the variants whose name matches. Needs a CUDA
card and nvcc; imports nothing of JAX.
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

CSRC = ROOT / "liftreg_tpu_torch" / "csrc"
PCA_SRC = CSRC / "pca_expand.cu"
WARP_SRC = CSRC / "warp_trilinear.cu"
WARP_SHARED = ROOT / "tools" / "warp_variants" / \
    "warp_coord_grad_shared_rows.cu"
PCA_VARIANTS = ROOT / "tools" / "pca_variants"
PCA_LDG = PCA_VARIANTS / "pca_grad_ldg.cu"
PCA_TMA = PCA_VARIANTS / "pca_grad_tma.cu"
PCA_MMA = PCA_VARIANTS / "pca_grad_mma.cu"
PCA_RING = PCA_VARIANTS / "pca_grad_ring.cu"
# (name, source, -D defines); the first of each kernel is the source as
# built for the port. PCA designs (tools/pca_variants/): the cotangent
# through L1 (ldg), the csrc design with a thread per output in the second
# pass (tma), the tensor cores (mma), the basis staged by the TMA too
# (ring); their knobs: basis rows per warp (ROWS), the next tile's operands
# loaded before the current tile is used (PREFETCH), loads that skip L1
# with a 256-byte L2 prefetch (LDNA), warps per block and 16-row tiles per
# warp (WARPS, MT), ring buffers (STAGES)
PCAS = [("csrc", PCA_SRC, ())]
PCAS += [(f"ldg{rows}{pre}", PCA_LDG, tuple(d for d, on in (
    ("LIFTREG_PCA_GRAD_ROWS=4", rows), ("LIFTREG_PCA_GRAD_PREFETCH=1", pre))
    if on)) for rows in ("", "_rows4") for pre in ("", "_prefetch")]
PCAS += [(f"tma_thread_finish{rows}{pre}", PCA_TMA, tuple(d for d, on in (
    ("LIFTREG_PCA_GRAD_ROWS=4", rows), ("LIFTREG_PCA_GRAD_PREFETCH=1", pre))
    if on)) for rows in ("", "_rows4") for pre in ("", "_prefetch")]
PCAS += [("tma_ldna", PCA_TMA, ("LIFTREG_PCA_GRAD_LDNA=1",
                                "LIFTREG_PCA_GRAD_WARP_FINISH=1")),
         ("mma", PCA_MMA, ()),
         ("mma_w4", PCA_MMA, ("LIFTREG_PCA_GRAD_WARPS=4",)),
         ("mma_w16", PCA_MMA, ("LIFTREG_PCA_GRAD_WARPS=16",)),
         ("mma_mt2", PCA_MMA, ("LIFTREG_PCA_GRAD_MT=2",))]
PCAS += [(f"ring_s{st}", PCA_RING, (f"LIFTREG_PCA_GRAD_STAGES={st}",))
         for st in (2, 3, 4)]
PCAS += [("ring_s3_thread_finish", PCA_RING,
          ("LIFTREG_PCA_GRAD_WARP_FINISH=0",))]
PCA_BLOCKS_PER_SM = (1, 2, 3, 4, 6, 8)
# warp: points per thread (POINTS) and threads per block (THREADS), and
# tap rows shared by a thread's points (tools/warp_variants/)
WARPS = [("csrc", WARP_SRC, ()), ("shared_rows", WARP_SHARED, ()),
         ("shared_rows_t256", WARP_SHARED, ("LIFTREG_GRAD_THREADS=256",))]
WARPS += [(f"pts{p}", WARP_SRC, (f"LIFTREG_GRAD_POINTS={p}",))
          for p in (1, 2, 8)]
WARPS += [(f"t{t}", WARP_SRC, (f"LIFTREG_GRAD_THREADS={t}",))
          for t in (128, 256, 1024)]
WARPS += [(f"pts2_t{t}", WARP_SRC, ("LIFTREG_GRAD_POINTS=2",
                                    f"LIFTREG_GRAD_THREADS={t}"))
          for t in (128, 512)]
# ablations: the port's source with one kind of work taken out by a text
# substitution (regex, replacement); their results are wrong by design
ABLATIONS = {
    # the basis loads become a value of their index
    "pca_no_basis_loads": (PCA_SRC, [
        (r"__ldg\(reinterpret_cast<const uint4\*>\(\s*Vw \+ r \* n \+ j0\)\)",
         "make_uint4(static_cast<unsigned>(j0), r, 0u, 0u)")]),
    # no cotangent copies: the tiles read whatever the buffers hold
    "pca_no_cotangent_copies": (PCA_SRC, [
        (r"mbar_wait\(&bar\[k & 1\], [^;]*;", ""),
        (r"if \(mine > 0\) issue\(0\);", ""),
        (r"if \(mine > 1\) issue\(1\);", ""),
        (r"issue\(k \+ 2\);", "")]),
    "pca_ldg_no_basis_loads": (PCA_LDG, [
        (r"__ldg\(reinterpret_cast<const uint4\*>\(\s*Vw \+ r \* n \+ j0\)\)",
         "make_uint4(static_cast<unsigned>(j0), r, 0u, 0u)")]),
    # the cotangent loads become a value of their index
    "pca_ldg_no_cotangent_loads": (PCA_LDG, [
        (r"__ldg\(reinterpret_cast<const float4\*>\(\s*g \+ b \* n \+ j0"
         r"(?: \+ 4)?\)\)", "make_float4(static_cast<float>(j0), 1.f, 2.f, "
         "static_cast<float>(b))")]),
    "pca_mma_no_basis_loads": (PCA_MMA, [
        (r"__ldg\(reinterpret_cast<const uint4\*>\(\s*vrow\[mt\]\[h\] "
         r"\+ j0\)\)", "make_uint4(static_cast<unsigned>(j0), mt, h, 0u)")]),
    # the ring's compute without waiting for (or issuing) the copies
    "pca_ring_no_copies": (PCA_RING, [
        (r"mbar_wait\(&full\[s\], [^;]*;", ""),
        (r"if \(warp == 0\)\s*for \(int64_t k = 0; k < kStages && k < mine;"
         r" \+\+k\) issue\(k\);", ""),
        (r"if \(warp == 0 && k \+ kStages < mine\) issue\(k \+ kStages\);",
         "")]),
    # the taps become their offset, converted
    "warp_no_tap_loads": (WARP_SRC, [
        (r"load_tap\(v, at\[k\]\)", "static_cast<float>(at[k])")]),
    # the stores happen only for a value that never occurs
    "warp_no_stores": (WARP_SRC, [
        (r"store_floats<3 \* kGradPts>\(dcoords",
         "if (grad[0] == -12345.f) store_floats<3 * kGradPts>(dcoords")]),
}


def _registers(log_text):
    """{kernel<template arguments>: registers per thread} of the gradient
    kernels in a ``ptxas -v`` log (mangled arguments: ``Li4E`` is 4,
    ``13__nv_bfloat16`` bf16, ``f`` float)."""
    regs, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = re.search(r"(pca_grad_partial_kernel|warp_coord_grad_kernel)"
                           r"I(\w*?)EEv", m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[f"{fn.group(1)}<{fn.group(2)}>"] = int(m.group(1))
            fn = None
    return regs


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "grad_sweep"
                                         / "results.json"))
    ap.add_argument("--kernels", default="pca,warp",
                    help="which kernels' variants: pca, warp or both")
    ap.add_argument("--only", default="",
                    help="run only the variants whose name matches this "
                    "regular expression")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_grad_sweep: no CUDA device", file=sys.stderr)
        return 1
    from liftreg_tpu_torch.ops import _build
    from liftreg_tpu_torch.ops.pca_kernel import pca_grad_plain
    from liftreg_tpu_torch.ops.warp_kernel import (_packed, axis_modes,
                                                   warp_coord_grad_plain)
    cs = chip_smoke_module()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    kinds = args.kernels.split(",")
    variants = {"pca": [(n, False) for n, _, _ in PCAS],
                "warp": [(n, False) for n, _, _ in WARPS]}
    jobs = [("pca", n, src, d) for n, src, d in PCAS]
    jobs += [("warp", n, src, d) for n, src, d in WARPS]
    patched = ROOT / "build" / "grad_sweep" / "src"
    patched.mkdir(parents=True, exist_ok=True)
    for name, (src, subs) in ABLATIONS.items():
        text = src.read_text()
        for pattern, repl in subs:
            text, count = re.subn(pattern, repl, text)
            if not count:
                raise RuntimeError(f"{name}: {pattern!r} matches nothing")
        (patched / f"{name}.cu").write_text(text)
        kind = name.split("_")[0]
        jobs.append((kind, name, patched / f"{name}.cu", ()))
        variants[kind].append((name, True))
    keep = re.compile(args.only)
    jobs = [j for j in jobs if j[0] in kinds and keep.search(j[1])]
    built = _build_all(_build, jobs, ROOT / "build" / "grad_sweep",
                       _registers)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, SZ, L = cs.B, cs.SZ, cs.LATENT
    n = 3 * SZ ** 3
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = []

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    if "pca" in kinds:
        cot = torch.randn((B, n), generator=g, device=dev)
        V = (torch.randn((L, n), generator=g, device=dev) * 0.01).bfloat16()
        want = pca_grad_plain(cot, V)
        atol = cs.PCA_GRAD_REL_ATOL * float(want.abs().max())
        bound = (cot.numel() * 4 + V.numel() * 2 + B * L * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        out = torch.empty((B, L), device=dev)
        for name, ablation in variants["pca"]:
            if ("pca", name) not in built:
                continue
            lib_path, regs, err = built[("pca", name)]
            row = {"kernel": "pca_grad", "variant": name, "registers": regs,
                   "ablation": ablation, "bound_ms": bound}
            if err:
                row["build_error"] = err[-400:]
                emit(row)
                continue
            lib = _build.load(lib_path)
            for per_sm in PCA_BLOCKS_PER_SM:
                blocks = per_sm * sms
                partial = torch.empty((blocks, L, B), device=dev)

                def call():
                    rc = lib.liftreg_pca_grad(
                        cot.data_ptr(), V.data_ptr(), partial.data_ptr(),
                        out.data_ptr(), B, L, n, 1, blocks, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                out.fill_(float("nan"))
                call()
                first = out.clone()
                excess = float(((out - want).abs() - cs.PCA_GRAD_RTOL
                                * want.abs() - atol).max())
                ms = cs._cuda_ms(call, 20)
                row[f"bpsm{per_sm}"] = {
                    "ms": ms, "share": bound / ms, "excess_over_tol": excess,
                    "repeatable": bool(torch.equal(first, out)),
                    "ok": ablation or (excess <= 0
                                       and bool(torch.equal(first, out)))}
            emit(row)
        del cot, V, want

    if "warp" in kinds:
        vol = torch.rand((B, 1, SZ, SZ, SZ), generator=g, device=dev)
        coords = cs._smooth_coords(torch, F, g, B, SZ, 4.0, dev)
        cot = torch.randn((B, 1, SZ ** 3), generator=g, device=dev)
        M = coords.shape[1]
        out = torch.empty_like(coords)
        taps = {dt: vol.to(dt) for dt in (torch.bfloat16, torch.float32)}
        wants = {dt: warp_coord_grad_plain(t, coords, cot, False)
                 for dt, t in taps.items()}
        for name, ablation in variants["warp"]:
            if ("warp", name) not in built:
                continue
            lib_path, regs, err = built[("warp", name)]
            row = {"kernel": "warp_coord_grad", "variant": name,
                   "registers": regs, "ablation": ablation}
            if err:
                row["build_error"] = err[-400:]
                emit(row)
                continue
            lib = _build.load(lib_path)
            for dt, t in taps.items():
                modes = _packed(axis_modes((SZ,) * 3, dt == torch.float32))

                def call():
                    rc = lib.liftreg_warp_coord_grad(
                        t.data_ptr(), int(dt == torch.bfloat16),
                        coords.data_ptr(), cot.data_ptr(), out.data_ptr(), B,
                        1, SZ, SZ, SZ, M, 0, modes, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                out.fill_(float("nan"))
                call()
                rel = float((out - wants[dt]).abs().max()) \
                    / float(wants[dt].abs().max())
                ms = cs._cuda_ms(call, 20)
                bound = (t.numel() * t.element_size() + coords.numel() * 8
                         + cot.numel() * 4) / cs.HBM_BYTES_PER_S * 1e3
                row[str(dt).split(".")[-1]] = {
                    "ms": ms, "bound_ms": bound, "share": bound / ms,
                    "rel_err": rel,
                    "ok": ablation or rel <= cs.WARP_GRAD_REL_TOL}
            emit(row)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi,
                                          "results": results}, indent=1))
    bad = [r["variant"] for r in results if "build_error" in r or any(
        isinstance(v, dict) and not v.get("ok", True) for v in r.values())]
    print(json.dumps({"failed": bad}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
