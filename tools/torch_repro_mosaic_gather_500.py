"""The shape bisect of ``tools/repro_mosaic_gather_500.py`` through the
port's gather probe on the card (``liftreg_tpu_torch/ops/gather_probe.py``
``gather_sum`` at ``inner=1``: one ``take_along_axis`` of an (M, L) tile,
the kernels of ``csrc/gather_probe.cu``).

The JAX tool is the smallest Pallas kernel that crashed Mosaic's compiler
on the TPU for every sublane gather of more than 8 rows and for a lane
gather 256 wide: a rule of one register tile that is Mosaic's alone. Here
each of its 10 shapes (axis 0: 8 to 160 rows of 128 f32 lanes and 8 x 128
in bf16; axis 1: 160 x 128 and 160 x 256 f32) is gathered twice, on the
JAX tool's inputs (an arange source, zero indices) and on seeded random
indices of the axis's range, and each result must equal
``torch.take_along_dim`` bit for bit. Prints one OK or FAIL row a shape in
the JAX tool's format and exits 1 if any row fails.

Runs on the CUDA card; ``--device cpu`` runs the plain version.

Usage: python tools/torch_repro_mosaic_gather_500.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.ops.gather_probe import gather_sum  # noqa: E402

#: the JAX tool's shapes in its order: (section, rows, lanes, axis, dtype)
SHAPES = tuple(
    [("sublane-axis gather, shape bisect over rows:", rows, 128, 0,
      "float32") for rows in (8, 16, 24, 32, 64, 128, 160)]
    + [("lane-axis gather:", 160, lanes, 1, "float32")
       for lanes in (128, 256)]
    + [("bf16 sublane at the working row count:", 8, 128, 0, "bfloat16")])
SEED = 0


def shape_inputs(rows, lanes, axis, dtype, device):
    """The JAX tool's inputs (an arange source, zero indices) and seeded
    random indices in [0, the axis's length)."""
    shape = (rows, lanes)
    src = torch.arange(rows * lanes, dtype=torch.float32,
                       device=device).reshape(shape).to(getattr(torch, dtype))
    zeros = torch.zeros(shape, dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    rand = torch.randint(0, shape[axis], shape, generator=g, device=device,
                         dtype=torch.int32)
    return src, (zeros, rand)


def try_shape(rows, lanes, axis, dtype, device):
    """One row: the gather of both index sets against take_along_dim."""
    tag = f"dynamic_gather axis={axis} {(rows, lanes)} {dtype}"
    src, index_sets = shape_inputs(rows, lanes, axis, dtype, device)
    try:
        for idx in index_sets:
            got = gather_sum(src, idx, 1, axis)
            want = torch.take_along_dim(src, idx.long(), dim=axis)
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{bad} elements differ from "
                                     "take_along_dim")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 - every failure is a FAIL row
        msg = str(e).split("\n")[0][:110]
        print(f"  FAIL  {tag}: {type(e).__name__}: {msg}", flush=True)
        return False
    print(f"  OK    {tag}", flush=True)
    return True


def main(argv=None):
    """Prints the rows; returns 0 when every shape is OK, else 1."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain version; default the CUDA "
                         "card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch {torch.__version__}  device: {name}", flush=True)
    section, ok = None, True
    for head, rows, lanes, axis, dtype in SHAPES:
        if head != section:
            print(head, flush=True)
            section = head
        ok &= try_shape(rows, lanes, axis, dtype, device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
