"""A/B the per-pair optimization OBJECTIVE against ground truth, with the
PyTorch port.

After the HU clip a lung CT is dominated by the air (-1) / body (+1)
contrast, so the intra-lung texture (~0.12 amplitude around -0.7) carries
~(0.12/0.85)^2 = 2% of global NCC's gradient: per-pair optimization with
unmasked NCC is nearly blind where the correspondence (and every
landmark) lies. Windowed similarity (LNCC) normalizes contrast per window
and gives the lung interior its share of the gradient; masking the
volumes to the lungs removes the body contrast. This tool measures each
objective's recovered-field error directly,

    rel_err = ||disp_opt - disp_gt|| / ||disp_gt||   (per pair, L2)

for sim in {ncc, lncc} x {unmasked, lung-masked} volumes, each variant
one :class:`liftreg_tpu_torch.optreg.DenseRegisterer` call over all N
pairs (bf16 taps). Runs on the CUDA card; ``--device cpu`` runs the
kernels' plain versions.

Usage: python tools/torch_optreg_objective_ab.py --data DIR [--n 4]
       [--levels 10:80:0.04,20:80:0.02]
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
from tools.torch_build_pca import parse_levels  # noqa: E402


def main(argv=None):
    """Prints one line per variant and the ``BEST:`` line; returns
    ``{variant: per-pair rel_err}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--phase", default="train")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--levels", default="10:80:0.04,20:80:0.02")
    ap.add_argument("--variants", default="ncc,lncc,ncc_masked,lncc_masked")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    levels = parse_levels(args.levels)
    ids = np.load(os.path.join(args.data, args.phase, "data_id.npy"),
                  allow_pickle=True)[:args.n]
    pre = os.path.join(args.data, "preprocessed")

    def _vol(cid, side):
        v = np.flip(np.load(os.path.join(pre, f"{cid}_{side}.npy"))
                    .astype(np.float32), axis=1)
        return normalize_intensity(v, linear_clip=True,
                                   clip_range=(-1000, 0))[None, None]

    def _seg(cid, side):
        return np.flip(np.load(os.path.join(
            pre, f"{cid}_{side}_seg.npy")).astype(np.float32),
            axis=1)[None, None]

    moving = np.concatenate([_vol(c, "source") for c in ids])
    target = np.concatenate([_vol(c, "target") for c in ids])
    m_seg = np.concatenate([_seg(c, "source") for c in ids])
    t_seg = np.concatenate([_seg(c, "target") for c in ids])
    img_sz = moving.shape[2:]
    gt = np.stack([gt_disp(args.data, c).reshape(-1)
                   for c in ids])  # (N, 3*D*W*H)
    gt_norm = np.linalg.norm(gt, axis=1)

    B = len(ids)
    results = {}
    for variant in args.variants.split(","):
        sim = "lncc" if variant.startswith("lncc") else "ncc"
        if variant.endswith("_masked"):
            mv = (moving + 1.0) * m_seg - 1.0
            tv = (target + 1.0) * t_seg - 1.0
        else:
            mv, tv = moving, target
        reg = DenseRegisterer(img_sz, sim=sim, levels=levels,
                              warp_taps_dtype=torch.bfloat16)
        out = reg(torch.from_numpy(mv).to(device),
                  torch.from_numpy(tv).to(device))
        disp = out["disp"].float().cpu().numpy().reshape(B, -1)
        sims = out["sim_history"].cpu().numpy()
        rel = np.linalg.norm(disp - gt, axis=1) / np.maximum(gt_norm, 1e-9)
        results[variant] = rel
        print(f"{variant:<12} sim {sims[0]:.4f}->{sims[-1]:.4f}  "
              f"rel_err/pair {' '.join(f'{r:.3f}' for r in rel)}  "
              f"mean {rel.mean():.3f}", flush=True)
    best = min(results, key=lambda k: results[k].mean())
    print(f"BEST: {best} (mean rel_err {results[best].mean():.3f})")
    return results


if __name__ == "__main__":
    main()
