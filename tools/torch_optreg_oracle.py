"""Per-pair oracle with the PyTorch port: does per-pair optimization
recover the TRUE field?

``tools/torch_build_pca.py --from_optreg`` assumes that per-pair
optimization (:class:`liftreg_tpu_torch.optreg.DenseRegisterer`) recovers
deformations close to the ground-truth correspondence, which depends on
the texture: self-similar structure can be aligned by a large, smooth
warp that maps it onto the wrong structure. This tool measures that per
pair, before any PCA or stage-3 training is spent on the fields: it
registers N pairs of a split (bf16 taps) and prints the relative L2 error
of the recovered displacement against the generator's ground truth
(``gt_phi``), and RMS magnitudes in mm. A relative error near 0 means the
texture pins the true correspondence; above ~1 the fields align the
images but not the anatomy, and a basis built from them is poison.

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions.

Usage: python tools/torch_optreg_oracle.py --data DIR [--phase train]
       [--n 3] [--levels 10:80:0.04,20:60:0.02,40:60:0.01] [--spacing 2.2]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.data.dataset import normalize_intensity  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.optreg import DenseRegisterer  # noqa: E402
from tools.torch_basis_oracle import gt_disp  # noqa: E402


def main(argv=None, record=None):
    """Prints the per-pair table and returns the mean relative error.
    ``record``, a list, receives one dict per pair: its id, relative
    error, the RMS magnitudes in mm and ``sim_history`` (numpy)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--phase", default="train")
    ap.add_argument("--n", type=int, default=3, help="pairs to register")
    ap.add_argument("--levels", type=str, default="",
                    help="grid:steps:lr,... (DenseRegisterer default)")
    ap.add_argument("--sim", type=str, default="ncc")
    ap.add_argument("--spacing", type=float, default=2.2)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ids = np.load(os.path.join(args.data, args.phase, "data_id.npy"),
                  allow_pickle=True)[:args.n]
    pre = os.path.join(args.data, "preprocessed")

    def _vol(case_id, side):
        v = np.flip(np.load(os.path.join(pre, f"{case_id}_{side}.npy"))
                    .astype(np.float32), axis=1)
        return normalize_intensity(v, linear_clip=True,
                                   clip_range=(-1000, 0))[None, None]

    probe = _vol(ids[0], "source")
    img_sz = probe.shape[2:]
    to_mm = (img_sz[0] - 1) / 2.0 * args.spacing
    kw = {}
    if args.levels:
        # every field a float, as the JAX tool parses it; DenseRegisterer
        # takes the grid edge and the step count as ints
        kw["levels"] = tuple(tuple(float(x) for x in lv.split(":"))
                             for lv in args.levels.split(","))
    reg = DenseRegisterer(img_sz, sim=args.sim,
                          warp_taps_dtype=torch.bfloat16, **kw)

    print(f"{'case':<10} {'rel err':>8} {'|gt| mm':>8} {'|pred| mm':>9} "
          f"{'err mm':>8} {'sim0->simN':>12}", flush=True)
    rels = []
    for cid in ids:
        out = reg(torch.from_numpy(_vol(cid, "source")).to(device),
                  torch.from_numpy(_vol(cid, "target")).to(device))
        pred = out["disp"][0].cpu().numpy().astype(np.float64).reshape(-1)
        gt = gt_disp(args.data, cid).astype(np.float64).reshape(-1)
        rel = float(np.linalg.norm(pred - gt) / np.linalg.norm(gt))
        rms = lambda x: float(np.sqrt(np.mean(x ** 2))) * to_mm  # noqa: E731
        sims = out["sim_history"].cpu().numpy()
        rels.append(rel)
        if record is not None:
            record.append({"id": str(cid), "rel_err": rel,
                           "gt_mm": rms(gt), "pred_mm": rms(pred),
                           "err_mm": rms(pred - gt), "sim_history": sims})
        print(f"{cid:<10} {rel:>8.4f} {rms(gt):>8.3f} {rms(pred):>9.3f} "
              f"{rms(pred - gt):>8.3f} {sims[0]:>6.4f}->{sims[-1]:.4f}",
              flush=True)
    print(f"{'mean':<10} {np.mean(rels):>8.4f}")
    return float(np.mean(rels))


if __name__ == "__main__":
    main()
