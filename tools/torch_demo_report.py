"""Summarize a demo experiment: its TRE against the identity map's and the
ground truth's, the port's counterpart of ``tools/demo_report.py``.

Runs the landmark TRE evaluation three ways over a synthetic dataset's
test split (``tools/torch_make_synthetic_dataset.py``): with the
experiment's saved maps, with the identity map, and with the stored
ground-truth maps, and prints a compact table::

    python tools/torch_demo_report.py -d DATA -e EXP --dim 64

Host math only (``utils/tre``): no device is used.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.utils import tre  # noqa: E402


def eval_phi(data_path, cid, phi01, dim):
    """TRE (mm) of the [0, 1] map ``phi01`` on case ``cid``: the mean and
    each landmark's."""
    src = tre.read_points(os.path.join(data_path, "landmarks",
                                       f"{cid}_300_eBH_xyz_r1.txt"))
    tgt = tre.read_points(os.path.join(data_path, "landmarks",
                                       f"{cid}_300_iBH_xyz_r1.txt"))
    prop = np.load(os.path.join(data_path, "preprocessed", f"{cid}_prop.npy"),
                   allow_pickle=True).item()
    origin = np.flip(np.asarray(prop["origin"])).copy()
    phi_spacing = np.flip(np.asarray(prop["spacing"])).copy()
    res, _, dists = tre.eval_with_data(src, tgt, phi01[None],
                                       np.full(3, float(dim)), phi_spacing,
                                       origin, phi_spacing)
    return res, dists


def report(data_path, exp_path, dim):
    """The table's rows and every landmark's TRE by map; prints both."""
    test_ids = [str(i) for i in
                np.load(os.path.join(data_path, "test", "data_id.npy"))]
    identity = tre.create_identity(np.full(3, dim))
    rows = []
    all_tre = {"identity": [], "trained": [], "ground_truth": []}
    for cid in test_ids:
        row = {"id": cid}
        row["identity"], d = eval_phi(data_path, cid, identity, dim)
        all_tre["identity"].extend(d)
        phi_file = os.path.join(exp_path, "tests", f"{cid}_phi.npy")
        if os.path.exists(phi_file):
            row["trained"], d = eval_phi(data_path, cid, np.load(phi_file),
                                         dim)
            all_tre["trained"].extend(d)
        gt_file = os.path.join(data_path, "gt_phi", f"{cid}_phi.npy")
        if os.path.exists(gt_file):
            row["ground_truth"], d = eval_phi(
                data_path, cid, np.load(gt_file).astype(np.float64), dim)
            all_tre["ground_truth"].extend(d)
        rows.append(row)

    hdr = ["id", "identity", "trained", "ground_truth"]
    print("\t".join(hdr))
    for r in rows:
        print("\t".join(f"{r.get(k, float('nan')):.3f}"
                        if k != "id" else r[k] for k in hdr))
    print("---")
    for k, v in all_tre.items():
        if v:
            stats = tre.compute_tre_statistics(np.asarray(v))
            print(f"mean TRE {k}: {np.mean(v):.3f} mm  "
                  f"(p50 {stats['percentile_50']:.2f} / "
                  f"p95 {stats['percentile_95']:.2f} / GFR "
                  f"{stats['GFR']:.3f})")
    return rows, all_tre


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_path", "-d", required=True)
    ap.add_argument("--exp_path", "-e", required=True)
    ap.add_argument("--dim", type=int, default=64)
    args = ap.parse_args(argv)
    return report(args.data_path, args.exp_path, args.dim)


if __name__ == "__main__":
    main()
