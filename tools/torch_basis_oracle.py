"""Basis-span oracle with the PyTorch port's tools: how much of the true
deformations a PCA basis can express.

For every ground-truth field in ``<data>/gt_phi`` (the [0, 1] phi maps
that ``tools/torch_make_synthetic_dataset.py`` stores), it projects the
displacement onto the basis by least squares and reports the relative
residual and its size in mm. A residual r bounds the registration error
any model on that basis can reach from below by r * |disp|, before a
training run is spent on it. ``--mask lung`` scores only lung voxels
(``preprocessed/<id>_source_seg.npy > 0``), where displacement is
observable. Host numpy in f64.

Usage: python tools/torch_basis_oracle.py --pca DIR --data DIR
       [--phase test] [--spacing 2.2] [--mask lung|none]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.coords import identity_map_np  # noqa: E402


def gt_disp(data, case_id):
    """[0, 1]-stored ground-truth phi -> displacement in [-1, 1] units."""
    phi = np.load(os.path.join(data, "gt_phi", f"{case_id}_phi.npy"))
    idm = identity_map_np(phi.shape[1:])
    return (phi * 2.0 - 1.0) - idm


def span_residual(x, V, mean, mask=None):
    """Least-squares relative residual of field ``x`` (flat, f64) against
    the rows of ``V`` (not orthonormal once masked)."""
    x = x - mean
    if mask is not None:
        x, V = x[mask], V[:, mask]
    coef, *_ = np.linalg.lstsq(V.T, x, rcond=None)
    return float(np.linalg.norm(x - V.T @ coef) / np.linalg.norm(x))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pca", required=True,
                    help="dir with pca_vectors.npy / pca_mean.npy")
    ap.add_argument("--data", required=True,
                    help="dataset root (gt_phi/, <phase>/data_id.npy)")
    ap.add_argument("--phase", default="test")
    ap.add_argument("--spacing", type=float, default=2.2,
                    help="voxel spacing (mm) for the mm column")
    ap.add_argument("--mask", choices=("none", "lung"), default="none",
                    help="restrict the residual to lung voxels")
    args = ap.parse_args(argv)

    V = np.load(os.path.join(args.pca, "pca_vectors.npy")).astype(np.float64)
    mean = np.load(os.path.join(args.pca, "pca_mean.npy")).astype(np.float64)
    ids = np.load(os.path.join(args.data, args.phase, "data_id.npy"),
                  allow_pickle=True)

    print(f"{'case':<10} {'rel residual':>12} {'|gt| mm':>9} "
          f"{'resid mm':>9}")
    residuals = []
    for cid in ids:
        x = gt_disp(args.data, cid).astype(np.float64).reshape(-1)
        sz = round(len(x) / 3) ** (1 / 3)
        to_mm = (round(sz) - 1) / 2.0 * args.spacing
        mask = None
        if args.mask == "lung":
            # gt_phi lies in the SPR (axis-1-flipped) frame the model
            # predicts in; the stored segmentation is SAR
            seg = np.flip(np.load(os.path.join(
                args.data, "preprocessed", f"{cid}_source_seg.npy")), axis=1)
            mask = np.repeat((seg > 0)[None], 3, 0).reshape(-1)
        rel = span_residual(x, V, mean, mask)
        xm = x if mask is None else x[mask]
        rms_mm = float(np.sqrt(np.mean(xm ** 2))) * to_mm
        residuals.append(rel)
        print(f"{cid:<10} {rel:>12.4f} {rms_mm:>9.3f} "
              f"{rel * rms_mm:>9.3f}")
    print(f"{'mean':<10} {np.mean(residuals):>12.4f}")
    return float(np.mean(residuals))


if __name__ == "__main__":
    main()
