"""Micro-benchmark of the gather probes on the card: the shared-memory row
gather, the lane gather, the roll and the composed warp inner step
(``liftreg_tpu_torch/ops/gather_probe.py``, ``csrc/gather_probe.cu``); the
port of ``tools/bench_mosaic_gather.py``.

The JAX tool was the go/no-go data for a locality warp (DESIGN.md §3): a
warp that stages its source slab in fast on-chip memory and gathers its
taps there is only worth building if a gather from that memory is
decisively cheaper per element than the warp's gather from device memory.
On the card the same question reads: is a gather from shared memory
decisively cheaper per element than the port's warp forward per tap
(``csrc/warp_trilinear.cu``, whose taps come from L2)? Only the card's
own numbers answer it.

Prints, in this order: the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``); the JAX tool's 17 rows, each as ms a call
and ns per gathered element over the whole card (``grid`` passes of
``inner`` gathers of the (M, L) tile); and a decision line: the best
ns/elem beside the port's warp forward in the same run (bf16 taps, phi
layout, B = 4, 160^3, on ``chip_smoke.py``'s smooth serving-shape field),
given as ns per gathered tap, kernel ms / (B * C * M * 8), with that
field's (dy, dx) window (``warp_kernel.displacement_window``), which sets
the slab height a locality warp would stage: of the whole field, whose
element 0 has slabs far outside the volume, and of its other elements.

Times are the device time between CUDA events around ``--reps`` calls
after one warm-up, their mean; the calls wait behind a spin kernel until
all are enqueued, so that no time the card spends waiting for the host
counts (:func:`timed_ms`; one more call, after the warm-up, sizes the
spin). The default ``--grid`` fills the card: one pass of the tile for
each of its SMs (``multi_processor_count``; the JAX tool ran 64 passes on
one TPU core, one after another). Runs on the CUDA
card; ``--device cpu`` runs the plain versions on the host clock (no
device number), with ``--warp_size`` setting the decision's warp (160 on
the card).

Usage: python tools/torch_bench_mosaic_gather.py [--reps 5] [--inner 8]
       [--grid N] [--device cpu --warp_size 16]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.ops import gather_probe  # noqa: E402
from liftreg_tpu_torch.ops.warp_kernel import (  # noqa: E402
    displacement_window, warp_trilinear)
from torch_kernel_ab import chip_smoke_module  # noqa: E402

#: the JAX tool's rows: (label, probe, M, L, dtype); ``probe`` names the
#: wrapper of gather_probe and the index range is M for the row gather and
#: the warp step, L for the lane gather
ROWS = tuple(
    [(f"dyn_gather sublane ({M},{L}) f32", "gather_rows", M, L, "float32")
     for M, L in ((8, 128), (64, 128), (160, 128), (160, 256), (512, 128),
                  (1280, 128), (160, 160))]
    + [(f"dyn_gather sublane ({M},{L}) bf16", "gather_rows", M, L,
        "bfloat16") for M, L in ((160, 128), (160, 256), (1280, 128))]
    + [(f"dyn_gather lane    ({M},{L}) f32", "gather_lanes", M, L, "float32")
       for M, L in ((160, 128), (160, 256))]
    + [(f"roll lanes         ({M},{L}) f32", "roll_sum", M, L, "float32")
       for M, L in ((160, 128), (160, 256))]
    + [(f"warp inner step    ({M},{L}) f32", "warp_step", M, L, "float32")
       for M, L in ((160, 128), (160, 256), (1280, 128))])
#: the decision's warp: B, C and the volume's edge on the card
WARP_B, WARP_C, WARP_SIZE = 4, 1, 160
#: cycles a second that the timer's spin kernel is sized with: at least
#: the card's SM clock (an H100 SXM's clocks.max.sm is 1980 MHz), so that
#: the spin lasts at least as long as asked
SPIN_CYCLES_PER_S = 2.0e9


def probe_inputs(probe, M, L, dtype, device):
    """The row's seeded tile x (M, L) and int32 indices in [0, M) (the row
    gather and the warp step) or [0, L) (the lane gather); None for the
    roll."""
    gx = torch.Generator(device=device).manual_seed(0)
    gi = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((M, L), generator=gx, device=device).to(
        getattr(torch, dtype))
    if probe == "roll_sum":
        return x, None
    high = L if probe == "gather_lanes" else M
    idx = torch.randint(0, high, (M, L), generator=gi, device=device,
                        dtype=torch.int32)
    return x, idx


def probe_call(probe, x, idx, inner, grid):
    """A zero-argument call of wrapper ``probe`` on the row's inputs."""
    fn = getattr(gather_probe, probe)
    if probe == "roll_sum":
        return lambda: fn(x, inner, grid)
    return lambda: fn(x, idx, inner, grid)


def timed_ms(fn, device, reps, warmup=1):
    """Mean ms a call of ``fn()`` over ``reps`` calls after ``warmup``. On
    the card: the device time between two CUDA events, the calls enqueued
    behind a spin kernel (``torch.cuda._sleep``) that lasts longer than the
    host takes to enqueue them, so that the card never waits for the host
    (a small probe takes less device time than its call takes on the
    host). On the CPU: the host clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    # the host's time for one more call, after the warm-up (whose first
    # call may build the kernels), sizes the spin
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    call_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * reps * call_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def device_line(device):
    """nvidia-smi's name and power limit of the card, or ``cpu``."""
    if device.type != "cuda":
        return "cpu (plain versions; host clock, no device number)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def warp_per_tap(device, size, reps):
    """The port's warp forward (bf16 taps, phi layout, scale_intensity, as
    ``warp_image`` runs it) at B = 4 on ``chip_smoke.py``'s smooth
    serving-shape field of edge ``size``: its ms a call, ns per gathered
    tap and the field's (dy, dx) window."""
    import torch.nn.functional as F
    cs = chip_smoke_module()
    g = torch.Generator(device=device).manual_seed(0)
    taps = torch.rand((WARP_B, WARP_C) + (size,) * 3, generator=g,
                      device=device).bfloat16()
    coords = cs._smooth_coords(torch, F, g, WARP_B, size, 4.0, device)
    phi = cs._phi_of(coords, size)
    grid = coords.reshape((WARP_B,) + (size,) * 3 + (3,))
    # element 0 has slabs far outside the volume, whose clamped starts
    # span it; elements 1.. are the smooth field alone
    window = displacement_window(grid)
    smooth = displacement_window(grid[1:])
    ms = timed_ms(lambda: warp_trilinear(taps, phi, False, normalized=True,
                                         scale_intensity=True), device, reps)
    taps_read = WARP_B * WARP_C * size ** 3 * 8
    return {"ms": ms, "ns_per_tap": ms * 1e6 / taps_read,
            "window": [int(w) for w in window],
            "window_smooth": [int(w) for w in smooth], "size": size,
            "batch": WARP_B}


def main(argv=None, record=None):
    """Prints the rows and the decision line; returns the rows, one dict
    each (label, probe, M, L, dtype, inner, grid, ms, ns_per_elem).
    ``record``, a dict, receives the decision's numbers."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--inner", type=int, default=8,
                    help="gathers an output (the JAX tool's G)")
    ap.add_argument("--grid", type=int, default=0,
                    help="passes over the tile (default: the card's SM "
                         "count; 1 on the CPU)")
    ap.add_argument("--warp_size", type=int, default=WARP_SIZE,
                    help="edge of the decision's warp volume")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the CUDA "
                         "card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = args.grid or sms
        fill = f" ({sms} SMs)"
    else:
        grid, fill = args.grid or 1, ""
    G = args.inner

    print(device_line(device), flush=True)
    print(f"device={device.type} inner={G} grid={grid}{fill} "
          f"reps={args.reps}", flush=True)
    rows = []
    for label, probe, M, L, dtype in ROWS:
        x, idx = probe_inputs(probe, M, L, dtype, device)
        ms = timed_ms(probe_call(probe, x, idx, G, grid), device, args.reps)
        ns = ms * 1e6 / (grid * G * M * L)
        print(f"{label:<44} {ms:8.4f} ms  {ns:8.4f} ns/elem", flush=True)
        rows.append({"label": label, "probe": probe, "M": M, "L": L,
                     "dtype": dtype, "inner": G, "grid": grid, "ms": ms,
                     "ns_per_elem": ns})

    best = min(rows, key=lambda r: r["ns_per_elem"])
    warp = warp_per_tap(device, args.warp_size, args.reps)
    ratio = warp["ns_per_tap"] / best["ns_per_elem"]
    print(f"\nbest ns/elem: {best['ns_per_elem']:.4f} "
          f"({' '.join(best['label'].split())}); port warp forward: "
          f"{warp['ns_per_tap']:.4f} ns/tap ({warp['ms']:.4f} ms, bf16 taps, "
          f"phi, B={warp['batch']}, {warp['size']}^3; window "
          f"dy={warp['window'][0]} dx={warp['window'][1]}, without the "
          f"slabs far outside dy={warp['window_smooth'][0]} "
          f"dx={warp['window_smooth'][1]}); a tap costs "
          f"{ratio:.2f} of the best gathered elements: a locality warp pays "
          f"only if it gathers fewer elements than that for each tap it "
          f"keeps", flush=True)
    if record is not None:
        record.update(best_ns_per_elem=best["ns_per_elem"], ratio=ratio,
                      best_label=best["label"], warp=warp, grid=grid,
                      inner=G, device=device.type)
    return rows


if __name__ == "__main__":
    main()
