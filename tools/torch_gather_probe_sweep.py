#!/usr/bin/env python3
"""Time variants of the gather probes' kernels on one card, in turns.

    python3 tools/torch_gather_probe_sweep.py [--reps 20] [--variants a,b]

Each variant is ``liftreg_tpu_torch/csrc/gather_probe.cu`` with a few text
substitutions (``VARIANTS``; ``csrc`` is the source as the port builds
it), compiled by its own ``nvcc`` (all started together) into
``build/gather_probe_sweep/<name>/`` and called through its C entry. Each
probe is timed on its bench tool's seeded f32 inputs
(``tools/torch_bench_mosaic_gather.py``, whose device timer it uses) at
160 x 128: inner 1 at grid 1 (the repro tool's call, beside one
``torch.gather`` or ``torch.roll``), and inner 8 and 64 at one pass of the
tile an SM; and at 1280 x 128, inner 8 and 64 at one pass an SM. Every
timed call is first checked bit for bit against the plain version. The
variants run in turns (csrc, a, b, ..., b, a, csrc) and each time is
listed once a turn. Prints the card's name and power limit, then one
JSON line a variant: ms by setting, the marginal gathered elements a
clock an SM between inner 8 and 64 (from the mean of the turns), and
``mismatch`` for any call that was not bit-equal. Needs a CUDA card and
nvcc; imports nothing of JAX.
"""
import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SOURCE = ROOT / "liftreg_tpu_torch" / "csrc" / "gather_probe.cu"
OUT = ROOT / "build" / "gather_probe_sweep"
# (name, [(text, replacement), ...]): each text must occur in the source
VARIANTS = [
    ("csrc", []),
    # staging by plain loads and stores instead of cp.async
    ("plain_staging", [("const int vec = (L * size) % 16 == 0 &&",
                        "const int vec = 0 && (L * size) % 16 == 0 &&")]),
    # every axis-1 block takes 8 rows (the first version's launch shape)
    ("rows_band_8", [("R = R < 1 ? 1 : R > most ? most : R;",
                      "R = most;")]),
    # the indices of 4 rows an axis-0 warp loaded ahead (the first version's count)
    ("in_flight_4", [("constexpr int kInFlight = 2;",
                      "constexpr int kInFlight = 4;")]),
    # no axis-0 row split (the first version's launch shape)
    ("no_split", [("splits = splits < kMaxSplits ? splits : kMaxSplits;",
                   "splits = 1;")]),
    # 256 threads a block whatever the band
    ("threads_256", [("const int64_t t = blocks >= 4 ? 256 : blocks >= 2 ? "
                      "512 : kMaxThreads;", "const int64_t t = 256;")]),
    # one tap a block, no wrapped copies: the division-free walk alone
    ("unroll_1", [("constexpr int kUnroll = OP == kWarpStep ? 7 : 8;",
                   "constexpr int kUnroll = 1;")]),
    # the floor modulo by an integer division, once an output
    ("division_mod", [("    const unsigned u = static_cast<unsigned>(i) ^ "
                       "0x80000000u;", "    return floor_mod(i, n);\n"
                       "    const unsigned u = static_cast<unsigned>(i) ^ "
                       "0x80000000u;")]),
]
PROBES = ("gather_rows", "gather_lanes", "roll_sum", "warp_step")
OP = {"gather_rows": 0, "gather_lanes": 1, "roll_sum": 2, "warp_step": 3}
SHAPE, LARGE = (160, 128), (1280, 128)


def _mean(values):
    return sum(values) / len(values)


def build(variants):
    """{name: (library path or None, error)} of each variant, compiled all
    at once."""
    from liftreg_tpu_torch.ops import _build
    text = SOURCE.read_text()

    def one(variant):
        name, subs = variant
        src = text
        for old, new in subs:
            if old not in src:
                return name, (None, f"text not in the source: {old!r}")
            src = src.replace(old, new)
        path = OUT / name / "gather_probe.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        lib = path.parent / "lib.so"
        try:
            _build.compile_library([path], lib)
        except RuntimeError as exc:
            return name, (None, str(exc)[-400:])
        return name, (lib, None)

    with ThreadPoolExecutor(max_workers=8) as pool:
        return dict(pool.map(one, variants))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=1,
                    help="times the variants run there and back")
    ap.add_argument("--variants", default="",
                    help="comma-separated names (default: all)")
    args = ap.parse_args(argv)
    import torch
    import torch_bench_mosaic_gather as bench
    from liftreg_tpu_torch.ops import _build
    from liftreg_tpu_torch.ops import gather_probe as gp

    dev = torch.device("cuda")
    print(bench.device_line(dev), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    wanted = set(filter(None, args.variants.split(",")))
    variants = [v for v in VARIANTS
                if not wanted or v[0] in wanted or v[0] == "csrc"]
    built = build(variants)
    libs = {name: _build.load(lib) for name, (lib, err) in built.items()
            if lib is not None}
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, probe, x, idx, inner, grid):
        out = torch.empty_like(x)
        M, L = x.shape
        rc = lib.liftreg_gather_probe(
            OP[probe], x.data_ptr(), int(x.dtype == torch.bfloat16),
            0 if idx is None else idx.data_ptr(), out.data_ptr(), M, L,
            inner, grid, stream)
        if rc:
            raise RuntimeError(f"{probe}: CUDA error {rc}")
        return out

    settings = [(SHAPE, 1, 1), (SHAPE, 8, sms), (SHAPE, 64, sms),
                (LARGE, 8, sms), (LARGE, 64, sms)]
    inputs = {(p, s): bench.probe_inputs(p, *s, "float32", dev)
              for p in PROBES for s in (SHAPE, LARGE)}
    want = {(p, s, n): gp.plain_version(p, *inputs[(p, s)], n)
            for p in PROBES for s, n, _ in settings}
    times = {name: {} for name in libs}
    mismatch = {name: [] for name in libs}
    library = {}
    order = (list(libs) + list(libs)[::-1]) * args.turns
    for name in order:
        lib = libs[name]
        for probe in PROBES:
            for shape, inner, grid in settings:
                x, idx = inputs[(probe, shape)]
                got = call(lib, probe, x, idx, inner, grid)
                ref = want[(probe, shape, inner)]
                if not torch.equal(got.float().view(torch.int32),
                                   ref.float().view(torch.int32)):
                    mismatch[name].append([probe, *shape, inner, grid])
                key = f"{probe} {shape[0]}x{shape[1]} inner{inner} " \
                      f"grid{grid}"
                times[name].setdefault(key, []).append(bench.timed_ms(
                    lambda: call(lib, probe, x, idx, inner, grid), dev,
                    args.reps, warmup=2))
        if name == order[0]:  # the library calls beside the first variant
            x, idx = inputs[("gather_rows", SHAPE)]
            idx64 = idx.long()
            library.setdefault("torch.gather", []).append(bench.timed_ms(
                lambda: torch.gather(x, 0, idx64), dev, args.reps,
                warmup=2))
            library.setdefault("torch.roll", []).append(bench.timed_ms(
                lambda: torch.roll(x, 1, 1), dev, args.reps, warmup=2))
    print(json.dumps({"library_ms": library, "sms": sms,
                      "sm_clock_max_mhz": clock_mhz}), flush=True)
    for name, (lib, err) in built.items():
        row = {"variant": name}
        if err:
            row["build_error"] = err
        else:
            row["ms"] = times[name]
            row["mismatch"] = mismatch[name]
            rate = {}
            for probe in PROBES:
                for M, L in (SHAPE, LARGE):
                    t8, t64 = (_mean(times[name][
                        f"{probe} {M}x{L} inner{n} grid{sms}"])
                        for n in (8, 64))
                    rate[f"{probe} {M}x{L}"] = 56 * M * L / (
                        (t64 - t8) * 1e-3 * clock_mhz * 1e6)
            row["elems_per_clock_sm"] = rate
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
