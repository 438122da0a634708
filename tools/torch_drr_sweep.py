#!/usr/bin/env python3
"""Time variants of the port's DRR kernels on one card.

    python3 tools/torch_drr_sweep.py [--out build/drr_sweep/results.json]

Builds each variant of ``csrc/drr_project.cu``, ``csrc/drr_backproject.cu``
and ``csrc/drr_project_adjoint.cu`` (the sources with other values of their
``LIFTREG_*`` compile-time knobs, and the designs under
``tools/drr_variants/``) into its own library under ``build/drr_sweep/``
(one ``nvcc`` per variant, all started together), checks each against the
plain PyTorch version at the serving shape of ``chip_smoke.py`` (160^3,
B=4, 4 views on a 240^2 detector) with its tolerances, and prints one JSON
line per variant: CUDA-event times in ms (20 launches after 2 warm-ups),
the registers per thread from ``ptxas``, and the error. Projector variants
are timed at several plane-loop chunk counts (``ks``); the lift in f32 and
as bf16 into the encoder's buffer, which must be its f32 output rounded
once; the adjoint with its plan built once, as the projection refiner
passes it (``plan_ms`` times the plan), at B=4 and B=1, twice with the
same bits, with the count of tiles that took its general path (which must
be 0). Ablations (``ABLATIONS``: the port's source with its loads or its
stores taken out) show what the rest of each kernel costs; their results
are not checked. ``--kernels`` takes a comma-separated list of ``proj``,
``lift`` and ``adjoint``. Needs a CUDA card and nvcc; imports nothing of
JAX.
"""
import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from torch_kernel_ab import chip_smoke_module

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "liftreg_tpu_torch" / "csrc"
VARIANTS = ROOT / "tools" / "drr_variants"
# (name, source, -D defines); the first of each kernel is the
# source as built for the port
PROJECTORS = [
    ("csrc", CSRC / "drr_project.cu", ()),
    ("csrc_sb1", CSRC / "drr_project.cu", ("LIFTREG_PROJ_SLOT_BATCH=1",)),
    ("csrc_sb4", CSRC / "drr_project.cu", ("LIFTREG_PROJ_SLOT_BATCH=4",)),
    ("csrc_w2", CSRC / "drr_project.cu", ("LIFTREG_PROJ_WARPS=2",)),
    ("csrc_w8", CSRC / "drr_project.cu", ("LIFTREG_PROJ_WARPS=8",)),
    ("csrc_ti8_w4", CSRC / "drr_project.cu",
     ("LIFTREG_PROJ_TI=8", "LIFTREG_PROJ_WARPS=4")),
    ("csrc_ti8_w2", CSRC / "drr_project.cu",
     ("LIFTREG_PROJ_TI=8", "LIFTREG_PROJ_WARPS=2")),
    ("prefetch_w8_mb3", VARIANTS / "drr_project_prefetch.cu", ()),
    ("prefetch_w8_mb2", VARIANTS / "drr_project_prefetch.cu",
     ("LIFTREG_PROJ_MIN_BLOCKS=2",)),
    ("prefetch_w4_mb4", VARIANTS / "drr_project_prefetch.cu",
     ("LIFTREG_PROJ_WARPS=4", "LIFTREG_PROJ_MIN_BLOCKS=4")),
    ("phases2", VARIANTS / "drr_project_phases.cu", ()),
    ("phases2_sb4", VARIANTS / "drr_project_phases.cu",
     ("LIFTREG_PROJ_SLOT_BATCH=4",)),
    ("phases2_w8", VARIANTS / "drr_project_phases.cu",
     ("LIFTREG_PROJ_WARPS=8",)),
    ("phases4_ti8_w2", VARIANTS / "drr_project_phases.cu",
     ("LIFTREG_PROJ_PLANES_PER_PHASE=4", "LIFTREG_PROJ_TI=8",
      "LIFTREG_PROJ_WARPS=2")),
    ("phases2_ti8_w2", VARIANTS / "drr_project_phases.cu",
     ("LIFTREG_PROJ_TI=8", "LIFTREG_PROJ_WARPS=2")),
    ("cpasync_w4", VARIANTS / "drr_project_cpasync.cu", ()),
    ("cpasync_w8", VARIANTS / "drr_project_cpasync.cu",
     ("LIFTREG_PROJ_WARPS=8",)),
    ("cpasync_w4_slab24x40", VARIANTS / "drr_project_cpasync.cu",
     ("LIFTREG_PROJ_SLAB_ROWS=24", "LIFTREG_PROJ_SLAB_COLS=40")),
]
PLANE_CHUNKS = (3, 4, 6, 8, 12, 16, 20)
# ablations: the port's source with one kind of work taken out by a text
# substitution (regex, replacement), to see what the rest costs; their
# results are wrong by design and are not checked
ABLATIONS = {
    # the z pass's volume loads become their index, converted
    "proj_no_volume_loads": (CSRC / "drr_project.cu", [
        (r"__ldg\((col[01]) \+ o\)", r"static_cast<float>(o)")]),
    # every plane skipped: the prologue (coordinate table), the epilogue,
    # the chunks' ordered sum and the launches
    "proj_prologue_only": (CSRC / "drr_project.cu", [
        (r"if \(tab\.skip\[kk\]\) continue;", "continue;")]),
    # the detector loads become their index, converted
    "lift_no_image_loads": (CSRC / "drr_backproject.cu", [
        (r"__ldg\(img\[bb\] \+ ([^;]*)\);", r"static_cast<float>(\1);")]),
    # the stores happen only for a value that never occurs
    "lift_no_stores": (CSRC / "drr_backproject.cu", [
        (r"(\n\s*)store_cols<kNH>\(",
         r"\1if (v[0] == -12345.f) store_cols<kNH>(")]),
    # the staged cotangent's loads (g and dx) become their index, converted
    "adj_no_stage_loads": (CSRC / "drr_project_adjoint.cu", [
        (r"__ldg\(g \+ \(\(b0 \+ bb\) \* P \+ p\) \* per_view \+ pix\)",
         r"static_cast<float>(pix)"),
        (r"dv\[q\] = __ldg\(dx \+ p \* per_view \+ pix\);",
         r"dv[q] = 1.f;")]),
    # the staged path's sums skipped: the plan's reads, the staging, the
    # barriers and the stores
    "adj_no_sums": (CSRC / "drr_project_adjoint.cu", [
        (r"if \(q >= nq\) break;", "break;")]),
    # every lane reads the same stage column: the sums without the shared
    # memory's bank conflicts
    "adj_no_conflicts": (CSRC / "drr_project_adjoint.cu", [
        (r"const int js = jst < 0 \? 0 : jst - jlo;", "const int js = 0;")]),
    # the fast path's stores happen only for a value that never occurs
    "adj_no_stores": (CSRC / "drr_project_adjoint.cu", [
        (r"(\n\s*)(dvol\[\(\(\(b0 \+ bb\) \* D \+ dr \+ r\) \* W \+ k\) "
         r"\* H \+ h\] = acc\[r\]\[bb\];)",
         r"\1if (acc[r][bb] == -12345.f) \2")]),
}
# (name, source, -D defines): the staged adjoint's knobs (rows TD of a tile,
# consecutive rows R a thread, planes NK a block, plane slots KG, views V
# staged at once, the stage's floats, staged values a load batch SB, blocks
# an SM the launch bounds ask for), and the first design, a gather per
# voxel
ADJ = CSRC / "drr_project_adjoint.cu"
ADJOINTS = [
    ("csrc", ADJ, ()),
    ("r2_kg1", ADJ, ("LIFTREG_ADJ_ROWS=2", "LIFTREG_ADJ_KG=1")),
    ("r8_kg4", ADJ, ("LIFTREG_ADJ_ROWS=8", "LIFTREG_ADJ_KG=4")),
    ("nk4", ADJ, ("LIFTREG_ADJ_NK=4",)),
    ("nk4_kg1", ADJ, ("LIFTREG_ADJ_NK=4", "LIFTREG_ADJ_KG=1")),
    ("nk16_kg4", ADJ, ("LIFTREG_ADJ_NK=16", "LIFTREG_ADJ_KG=4",
                       "LIFTREG_ADJ_MIN_BLOCKS=1",
                       "LIFTREG_ADJ_STAGE_FLOATS=36864")),
    ("nk16_kg2", ADJ, ("LIFTREG_ADJ_NK=16", "LIFTREG_ADJ_MIN_BLOCKS=1",
                       "LIFTREG_ADJ_STAGE_FLOATS=36864")),
    ("nk16_kg4_sb8", ADJ, ("LIFTREG_ADJ_NK=16", "LIFTREG_ADJ_KG=4",
                           "LIFTREG_ADJ_MIN_BLOCKS=1",
                           "LIFTREG_ADJ_STAGE_FLOATS=36864",
                           "LIFTREG_ADJ_STAGE_BATCH=8")),
    ("td8_kg4", ADJ, ("LIFTREG_ADJ_TD=8", "LIFTREG_ADJ_KG=4",
                      "LIFTREG_ADJ_STAGE_FLOATS=16384")),
    ("td8_kg2_mb3", ADJ, ("LIFTREG_ADJ_TD=8", "LIFTREG_ADJ_MIN_BLOCKS=3",
                          "LIFTREG_ADJ_STAGE_FLOATS=16384")),
    ("td32_kg1", ADJ, ("LIFTREG_ADJ_TD=32", "LIFTREG_ADJ_KG=1",
                       "LIFTREG_ADJ_MIN_BLOCKS=1",
                       "LIFTREG_ADJ_STAGE_FLOATS=45056")),
    ("sb4", ADJ, ("LIFTREG_ADJ_STAGE_BATCH=4",)),
    ("sb8", ADJ, ("LIFTREG_ADJ_STAGE_BATCH=8",)),
    ("sb16", ADJ, ("LIFTREG_ADJ_STAGE_BATCH=16",)),
    ("v2", ADJ, ("LIFTREG_ADJ_VIEWS=2",)),
    ("r2_kg2_mb1", ADJ, ("LIFTREG_ADJ_ROWS=2", "LIFTREG_ADJ_MIN_BLOCKS=1")),
    ("gather", VARIANTS / "drr_project_adjoint_gather.cu", ()),
]
# (name, source, defines): batch elements in registers (NB), columns per
# thread (NH), rows per thread (D, default 8) and threads per block (T,
# default 128, a block spanning more planes k of one d-chunk); then the
# design that stages each block's detector footprint in shared memory
# (planes KB and rows DB per block)
LIFT = CSRC / "drr_backproject.cu"
LIFT_SMEM = VARIANTS / "drr_backproject_smem.cu"
LIFTS = [("csrc", LIFT, ())]
LIFTS += [(f"nb{nb}_nh{nh}", LIFT,
           (f"LIFTREG_LIFT_NB={nb}", f"LIFTREG_LIFT_NH={nh}"))
          for nb in (1, 2, 4) for nh in (1, 2, 4, 8) if (nb, nh) != (4, 4)]
LIFTS += [(f"d{dc}", LIFT, (f"LIFTREG_LIFT_DCHUNK={dc}",))
          for dc in (4, 16, 32)]
LIFTS += [(f"t{t}", LIFT, (f"LIFTREG_LIFT_THREADS={t}",))
          for t in (64, 256, 512)]
LIFTS += [(f"nh2_t{t}", LIFT,
           ("LIFTREG_LIFT_NH=2", f"LIFTREG_LIFT_THREADS={t}"))
          for t in (64, 256)]
LIFTS += [("smem_kb8_db16", LIFT_SMEM, ()),
          ("smem_kb4_db16", LIFT_SMEM,
           ("LIFTREG_LIFT_KB=4", "LIFTREG_LIFT_THREADS=160")),
          ("smem_kb8_db8", LIFT_SMEM, ("LIFTREG_LIFT_DB=8",)),
          ("smem_kb8_db32", LIFT_SMEM,
           ("LIFTREG_LIFT_DB=32", "LIFTREG_LIFT_SMEM_FLOATS=12000")),
          ("smem_kb16_db16", LIFT_SMEM,
           ("LIFTREG_LIFT_KB=16", "LIFTREG_LIFT_THREADS=640")),
          ("smem_kb8_db16_nh2", LIFT_SMEM,
           ("LIFTREG_LIFT_NH=2", "LIFTREG_LIFT_THREADS=640"))]


def _registers(log_text):
    """{kernel: registers per thread} from a ``ptxas -v`` log; a kernel
    instantiated for bf16 output gets ``_bf16`` appended."""
    regs, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            # the kernel's name is the last drr_ or adjoint_ word of the
            # mangled name (the anonymous namespace's name holds the file's)
            names = re.findall(r"\d+((?:drr|adjoint)_[a-z_]+)", fn)
            key = names[-1] if names else fn
            regs[key + ("_bf16" if "bfloat16" in fn else "")] = \
                int(m.group(1))
            fn = None
    return regs


def _build_all(_build, jobs, out_root=ROOT / "build" / "drr_sweep",
               registers=_registers):
    """Compile every (kind, name, source, defines) job into its own
    library under ``out_root``; return {(kind, name): (library path or
    None, ``registers`` of its ptxas log, error)}."""

    def one(job):
        kind, name, src, defines = job
        lib = out_root / f"{kind}_{name}" / "lib.so"
        try:
            _build.compile_library([src], lib, defines)
        except RuntimeError as exc:
            return job[:2], (None, {}, str(exc))
        log = (lib.parent / "build.log").read_text(errors="replace")
        return job[:2], (lib, registers(log), None)

    with ThreadPoolExecutor(max_workers=8) as pool:
        return dict(pool.map(one, jobs))


def _adjoint_rows(torch, cs, _build, built, adjoints, fwd, res, plain, g,
                  dev):
    """Time and check each adjoint variant at the serving shape (with
    B = 4 and B = 1); returns the rows it printed."""
    import ctypes
    B, SZ = cs.B, cs.SZ
    P, res_d, res_h = fwd[2].shape
    W = fwd[0].shape[1]
    cot = torch.randn((B, P) + tuple(res), generator=g, device=dev)
    want = plain(cot, *fwd, (SZ,) * 3)
    scale = float(want.abs().max())
    stream = torch.cuda.current_stream().cuda_stream
    # the bytes the function must move: the cotangent and the geometry read,
    # dvol written (the plan is the kernel's own, derived from the geometry)
    in_bytes = sum(t.numel() * 4 for t in fwd)
    rows = []
    for name, ablation in adjoints:
        lib_path, regs, err = built[("adj", name)]
        row = {"kernel": "drr_project_adjoint", "variant": name,
               "registers": regs, "ablation": ablation}
        if err:
            row["build_error"] = err[-400:]
            rows.append(row)
            print(json.dumps(row), flush=True)
            continue
        lib = _build.load(lib_path)
        plan = torch.empty((P, W, 2 * SZ, 2), dtype=torch.int32, device=dev)
        general = torch.zeros(1, dtype=torch.int32, device=dev)
        if hasattr(lib, "liftreg_drr_adjoint_plan"):
            rc = lib.liftreg_drr_adjoint_plan(
                fwd[0].data_ptr(), fwd[1].data_ptr(), plan.data_ptr(), P, W,
                SZ, SZ, res_d, res_h, stream)
            if rc:
                raise RuntimeError(f"{name}: plan: CUDA error {rc}")
        else:  # the gather design: its own entry point and scratch
            fn = lib.liftreg_drr_project_adjoint_gather
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 7 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            scaled = torch.empty_like(cot)
            order = torch.empty(2 * P * W, dtype=torch.int32, device=dev)
        for batch in (B, 1):
            gb = cot[:batch].contiguous()
            out = torch.empty((batch, SZ, SZ, SZ), device=dev)

            def call():
                if hasattr(lib, "liftreg_drr_adjoint_plan"):
                    rc = lib.liftreg_drr_project_adjoint(
                        gb.data_ptr(), fwd[0].data_ptr(), fwd[1].data_ptr(),
                        fwd[2].data_ptr(), plan.data_ptr(), out.data_ptr(),
                        general.data_ptr(), batch, P, SZ, W, SZ, res_d,
                        res_h, stream)
                else:
                    rc = fn(gb.data_ptr(), fwd[0].data_ptr(),
                            fwd[1].data_ptr(), fwd[2].data_ptr(),
                            out.data_ptr(), scaled.data_ptr(),
                            order.data_ptr(), batch, P, SZ, W, SZ, res_d,
                            res_h, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            out.fill_(float("nan"))
            general.zero_()
            call()
            first = out.clone()
            call()
            rel = float((out - want[:batch]).abs().max()) / scale
            same = bool(torch.equal(first, out))
            tiles = int(general.item())
            ms = cs._cuda_ms(call, 20)
            bound = (in_bytes + gb.numel() * 4 + out.numel() * 4) \
                / cs.HBM_BYTES_PER_S * 1e3
            row[f"b{batch}"] = {
                "ms": ms, "bound_ms": bound, "share": bound / ms,
                "rel_err": rel, "repeat_bits": same, "general_tiles": tiles,
                "ok": ablation or (rel <= cs.ADJ_REL_TOL and same
                                   and tiles == 0)}
        if hasattr(lib, "liftreg_drr_adjoint_plan"):
            row["plan_ms"] = cs._cuda_ms(
                lambda: lib.liftreg_drr_adjoint_plan(
                    fwd[0].data_ptr(), fwd[1].data_ptr(), plan.data_ptr(), P,
                    W, SZ, SZ, res_d, res_h, stream), 20)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "drr_sweep"
                                         / "results.json"))
    ap.add_argument("--kernels", default="proj,lift,adjoint",
                    help="which kernels' variants: a comma-separated list "
                    "of proj, lift and adjoint")
    ap.add_argument("--only", default="",
                    help="run only the variants whose name matches this "
                    "regular expression")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_drr_sweep: no CUDA device", file=sys.stderr)
        return 1
    from liftreg_tpu_torch.ops import _build, drr
    from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps_plain,
                                                  project_adjoint_taps_plain,
                                                  project_taps_plain)
    cs = chip_smoke_module()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    kinds = args.kernels.split(",")
    tables = {"proj": PROJECTORS, "lift": LIFTS, "adj": ADJOINTS}
    kinds = ["adj" if k == "adjoint" else k for k in kinds]
    # (name, ablation) of each kernel's variants to run
    variants = {k: [(n, False) for n, _, _ in tables[k]] if k in kinds
                else [] for k in tables}
    jobs = [(k, n, src, d) for k in kinds for n, src, d in tables[k]]
    patched = ROOT / "build" / "drr_sweep" / "src"
    patched.mkdir(parents=True, exist_ok=True)
    for name, (src, subs) in ABLATIONS.items():
        kind = name.split("_")[0]
        if kind not in kinds:
            continue
        text = src.read_text()
        for pattern, repl in subs:
            text, count = re.subn(pattern, repl, text)
            if not count:
                raise RuntimeError(f"{name}: {pattern!r} matches nothing")
        (patched / f"{name}.cu").write_text(text)
        jobs.append((kind, name, patched / f"{name}.cu", ()))
        variants[kind].append((name, True))
    keep = re.compile(args.only)
    jobs = [j for j in jobs if keep.search(j[1])]
    variants = {k: [v for v in vs if keep.search(v[0])]
                for k, vs in variants.items()}
    projectors, lifts = variants["proj"], variants["lift"]
    built = _build_all(_build, jobs)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    _, res, fwd, bwd, att, proj = cs.serving_drr_inputs(torch, drr, g, dev)
    B, SZ = cs.B, cs.SZ
    want_proj = project_taps_plain(att, *fwd)
    scale = float(want_proj.abs().max())
    want_lift = backproject_taps_plain(proj, *bwd)
    P, res_d, res_h = fwd[2].shape
    W = fwd[0].shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    results = []

    for name, ablation in projectors:
        lib_path, regs, err = built[("proj", name)]
        row = {"kernel": "drr_project", "variant": name, "registers": regs,
               "ablation": ablation}
        if err:
            row["build_error"] = err[-400:]
            results.append(row)
            print(json.dumps(row), flush=True)
            continue
        lib = _build.load(lib_path)
        out = torch.empty((B, P, res_d, res_h), device=dev)
        for ks in PLANE_CHUNKS:
            kper = -(-W // ks)
            chunks = -(-W // kper)
            part = torch.empty((chunks,) + out.shape, device=dev)

            def call():
                rc = lib.liftreg_drr_project(
                    att.data_ptr(), fwd[0].data_ptr(), fwd[1].data_ptr(),
                    fwd[2].data_ptr(), out.data_ptr(), part.data_ptr(), B, P,
                    SZ, SZ, SZ, res_d, res_h, ks, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            out.fill_(float("nan"))
            try:
                call()
            except RuntimeError as exc:  # more planes than the variant holds
                row[f"ks{ks}"] = {"error": str(exc)}
                continue
            rel = float((out - want_proj).abs().max()) / scale
            row[f"ks{ks}"] = {"ms": cs._cuda_ms(call, 20), "rel_err": rel,
                              "ok": ablation or rel <= cs.PROJ_REL_TOL}
        results.append(row)
        print(json.dumps(row), flush=True)

    lift_bytes = {torch.float32: B * 4 * SZ ** 3 * 4,
                  torch.bfloat16: B * 4 * SZ ** 3 * 2}
    in_bytes = proj.numel() * 4 + sum(t.numel() * 4 for t in bwd)
    buf = torch.empty((B, 5, SZ, SZ, SZ), dtype=torch.bfloat16, device=dev)
    for name, ablation in lifts:
        lib_path, regs, err = built[("lift", name)]
        row = {"kernel": "drr_backproject", "variant": name,
               "registers": regs, "ablation": ablation}
        if err:
            row["build_error"] = err[-400:]
            results.append(row)
            print(json.dumps(row), flush=True)
            continue
        lib = _build.load(lib_path)
        out32 = torch.empty((B, 4, SZ, SZ, SZ), device=dev)
        for dtype, out, bstride in ((torch.float32, out32, 4 * SZ ** 3),
                                    (torch.bfloat16, buf[:, 1:],
                                     buf.stride(0))):
            def call():
                rc = lib.liftreg_drr_backproject(
                    proj.data_ptr(), bwd[0].data_ptr(), bwd[1].data_ptr(),
                    out.data_ptr(), int(dtype == torch.bfloat16), bstride, B,
                    4, SZ, SZ, SZ, res[0], res[1], stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            out.fill_(float("nan"))
            call()
            key = str(dtype).split(".")[-1]
            ms = cs._cuda_ms(call, 20)
            bound = (in_bytes + lift_bytes[dtype]) / cs.HBM_BYTES_PER_S * 1e3
            if dtype == torch.float32:
                e = float((out32 - want_lift).abs().max())
                ok = e <= cs.LIFT_TOL
            else:
                e = None
                ok = bool(torch.equal(out, out32.bfloat16()))
            row[key] = {"ms": ms, "bound_ms": bound, "share": bound / ms,
                        "max_abs_err": e, "ok": ablation or ok}
        results.append(row)
        print(json.dumps(row), flush=True)

    results += _adjoint_rows(torch, cs, _build, built, variants["adj"],
                             fwd, res, project_adjoint_taps_plain, g, dev)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi,
                                          "results": results}, indent=1))
    bad = [r["variant"] for r in results if "build_error" in r or any(
        isinstance(v, dict) and not v.get("ok", "error" in v)
        for k, v in r.items() if k != "registers")]
    print(json.dumps({"failed": bad}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
