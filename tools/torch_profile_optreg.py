"""Profile one pyramid level of per-pair registration
(``liftreg_tpu_torch.optreg.make_level``) on the CUDA card: the first
``--batch`` train pairs of a dataset, read as ``tools/torch_build_pca.py``
reads them, bf16 taps. After one warm-up call of the level, one call under
``torch.profiler``: its wall ms, ms a step (the level's n + 1 gradient
evaluations), the device's busy ms and idle share, and the device ms by
layer (``chip_smoke.py``'s layers, with the control grid's upsampling and
its backward apart). Prints one JSON line, with the card's name and power
limit.

    python tools/torch_profile_optreg.py --data DATA --level 20:60:0.02
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from liftreg_tpu_torch import optreg  # noqa: E402
from liftreg_tpu_torch.data.dataset import normalize_intensity  # noqa: E402
from tools.torch_build_pca import parse_levels  # noqa: E402


def _layer_fn():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def layer(name):
        return ("upsample" if "upsample" in name.lower()
                else mod._layer(name))
    return layer


def pairs(data, batch):
    """(moving, target) of the first ``batch`` train pairs, (B, 1, D, W,
    H) f32 in [-1, 1], as the optreg tool reads them."""
    ids = np.load(os.path.join(data, "train", "data_id.npy"))[:batch]
    pre = os.path.join(data, "preprocessed")

    def vol(cid, side):
        v = np.flip(np.load(os.path.join(pre, f"{cid}_{side}.npy")).astype(
            np.float32), axis=1)
        return normalize_intensity(v, linear_clip=True,
                                   clip_range=(-1000, 0))[None, None]

    return tuple(torch.from_numpy(np.concatenate([vol(c, side)
                                                  for c in ids]))
                 for side in ("source", "target"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--level", default="20:60:0.02",
                    help="grid:steps:lr of the profiled level")
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch_profile_optreg needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    (grid, steps, lr), = parse_levels(args.level)
    moving, target = (t.cuda() for t in pairs(args.data, args.batch))
    size = tuple(moving.shape[2:])
    level = optreg.make_level(size, grid, n_steps=steps, lr=lr,
                              warp_taps_dtype=torch.bfloat16)
    z0 = torch.zeros((args.batch, 3) + (grid,) * 3, device="cuda")
    level(z0, moving, target)                       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        level(z0, moving, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    layer = _layer_fn()
    by_layer, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = layer(e.key)
            by_layer[key] = by_layer.get(key, 0.0) \
                + e.self_device_time_total / 1e3
            launches[key] = launches.get(key, 0) + e.count
    busy = sum(by_layer.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"size": size, "batch": args.batch, "level": [grid, steps, lr],
            "wall_ms": wall_ms, "ms_per_step": wall_ms / (steps + 1),
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "device_ms_by_layer": dict(sorted(by_layer.items(),
                                              key=lambda kv: -kv[1])),
            "launches_by_layer": launches, "device": smi}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
