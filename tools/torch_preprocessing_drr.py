"""DRR generation CLI of the PyTorch port (``liftreg_tpu_torch``), the
port's copy of ``tools/preprocessing_drr.py``: for each case of each
phase, the SAR -> SPR flip, HU -> attenuation and a limited-angle
projection (default 30 deg / 4 views, or poses from a geometry CSV),
saved as ``{id}_{source,target}_proj.npy`` with a shared ``poses.npy``.
The port's projector makes the DRRs: its kernel on the CUDA card, or its
plain version with ``--device cpu``.

    python tools/torch_preprocessing_drr.py --data_path DATA \
        --drr_folder_name drr
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch import coords  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.ops import drr, drr_kernel  # noqa: E402


def generate_drrs(data_path, drr_folder_name, scan_range=30.0, scan_num=4,
                  geo_path="", receptor=None, phases=None,
                  spacing=(2.2, 2.2, 2.2), device=None):
    """DRRs and the shared poses of every case of ``phases``; returns the
    poses. ``device`` None means the CUDA card."""
    device = resolve_device(device)
    task_root = os.path.abspath(data_path)
    preprocessed_path = os.path.join(task_root, "preprocessed")
    assert os.path.exists(preprocessed_path), "No preprocessed folder found."

    drr_folder = os.path.join(task_root, "drr", drr_folder_name, "drr")
    os.makedirs(drr_folder, exist_ok=True)
    phases = phases or ["train", "debug", "val", "test"]

    poses = None
    for p in phases:
        id_file = os.path.join(task_root, p, "data_id.npy")
        if not os.path.exists(id_file):
            continue
        print(f"Processing data in {p} ...")
        for d in np.load(id_file):
            d = str(d)
            for side in ("source", "target"):
                vol = np.load(os.path.join(preprocessed_path,
                                           f"{d}_{side}.npy"))
                vol = coords.flip_sar_to_spr(vol).copy()   # SAR -> SPR
                if poses is None:
                    if geo_path:
                        poses = drr.poses_from_geometry_csv(geo_path, spacing)
                    else:
                        poses = drr.synthesize_poses(
                            scan_range, scan_num, vol.shape[1])
                resolution = (tuple(receptor) if receptor
                              else drr.default_resolution(vol.shape))
                att = drr.calc_relative_atten_coef(
                    torch.from_numpy(vol.astype(np.float32)).to(device))
                proj = drr_kernel.project(att, poses, resolution,
                                          tuple(spacing))
                np.save(os.path.join(drr_folder, f"{d}_{side}_proj.npy"),
                        proj.cpu().numpy())
    if poses is not None:
        np.save(os.path.join(drr_folder, "poses.npy"), poses)
    return poses


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate DRRs for a dataset")
    parser.add_argument("--data_path", required=True, type=str)
    parser.add_argument("--drr_folder_name", required=True, type=str)
    parser.add_argument("--scan_range", required=False, type=float, default=30)
    parser.add_argument("--scan_num", required=False, type=int, default=4)
    parser.add_argument("--geo_path", required=False, type=str, default="")
    parser.add_argument("--receptor_h", required=False, type=int, default=0)
    parser.add_argument("--receptor_w", required=False, type=int, default=0)
    parser.add_argument("--phase", required=False, type=str, default="all")
    parser.add_argument("--spacing", required=False, type=float, nargs=3,
                        default=[2.2, 2.2, 2.2])
    parser.add_argument("-g", "--gpu_id", required=False, type=int, default=0,
                        help="the CUDA card (cuda:N)")
    parser.add_argument("--device", required=False, type=str, default=None,
                        help="'cpu' for the projector's plain version; "
                             "default the CUDA card of -g")
    args = parser.parse_args(argv)

    receptor = ([args.receptor_w, args.receptor_h]
                if args.receptor_h and args.receptor_w else None)
    all_phases = ["train", "debug", "val", "test"]
    if args.phase in all_phases:
        phases = [args.phase]
    else:
        assert args.phase == "all", "Wrong phase value."
        phases = all_phases
    return generate_drrs(args.data_path, args.drr_folder_name,
                         args.scan_range, args.scan_num, args.geo_path,
                         receptor, phases, tuple(args.spacing),
                         device=args.device or f"cuda:{args.gpu_id}")


if __name__ == "__main__":
    main()
