"""What the port's timing tools share (``tools/torch_bench_train_step.py``,
``torch_bench_refine.py``, ``torch_profile_refine.py``,
``torch_bench_pallas_frontier.py``, ``torch_bench_stage0.py``,
``torch_bench_ab.py``): the device they run on (the card unless the caller
asks for the CPU), the card's name and power limit, their clocks, the
kernels' launch counts and their one JSON line. It replaces the JAX tools'
readback chain (``tools/_timing.py``): a CUDA call returns before the card
has finished, so a kernel is timed with CUDA events and a whole call with
the host clock ended by ``torch.cuda.synchronize()``. On the CPU the same
functions read the host clock.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

from liftreg_tpu_torch.ops import drr_kernel, pca_kernel, warp_kernel

#: the counted kernels of the system's paths, by chip_smoke.py's names
KERNELS = {"pca_expand": pca_kernel.pca_expand,
           "pca_grad": pca_kernel.pca_grad,
           "warp_trilinear": warp_kernel.warp_trilinear,
           "warp_coord_grad": warp_kernel.warp_coord_grad,
           "warp_image_grad": warp_kernel.warp_image_grad,
           "drr_project": drr_kernel.project_taps,
           "drr_project_adjoint": drr_kernel.project_adjoint_taps,
           "drr_adjoint_plan": drr_kernel.project_adjoint_plan,
           "drr_backproject": drr_kernel.backproject_taps}
#: H100 SXM data sheet: the HBM3 rate and the dense peaks a second
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


def add_device_arg(ap):
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions on the host "
                         "clock; default the CUDA card "
                         "(liftreg_tpu_torch.device.resolve_device raises "
                         "without one)")


def card_line(device):
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return out.strip().splitlines()[index]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_ms(fn, device, reps, warmup=1):
    """Mean ms a call of ``fn()`` over ``reps`` calls after ``warmup``: the
    device time between two CUDA events on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def call_ms(fn, device):
    """Host ms of one call of ``fn()`` to its end on the device."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3


def stream_ms(fn, device, chunks=3, chunk=5):
    """The best of ``chunks`` chunks of ``chunk`` calls, each chunk timed on
    the host clock and ended by one synchronisation: ms a call."""
    best = None
    for _ in range(chunks):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        sync(device)
        ms = (time.perf_counter() - t0) / chunk * 1e3
        best = ms if best is None else min(best, ms)
    return best


def zero_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launches():
    """The counted kernels' launches since the last :func:`zero_launches`,
    those launched at least once."""
    return {k: fn.launches for k, fn in KERNELS.items() if fn.launches}


def counted(fn, device):
    """``(result, launches)`` of one call of ``fn()``."""
    zero_launches()
    out = fn()
    sync(device)
    return out, launches()


def emit(device, tool, **fields):
    """Print the tool's one JSON line: the card's name and power limit
    first, then ``tool``, the device and ``fields``; returns the record."""
    record = {"card": card_line(device), "tool": tool,
              "device": str(device), **fields}
    print(json.dumps(record), flush=True)
    return record
