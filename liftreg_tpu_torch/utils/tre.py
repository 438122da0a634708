"""DirLab landmark TRE evaluation: the port's copy of
``liftreg_tpu/utils/tre.py`` (the port imports nothing of the JAX package).

Landmark coordinate transforms (1-indexed landmark mm coordinates ->
crop-origin offset -> SAR->SPR y-flip -> [-1, 1] normalized), sampling of
the displacement map at the source landmarks, TRE in mm with per-axis
means, GFR and percentiles, and the lung Dice of the nearest-warped
segmentation. The host math is numpy f64 in the JAX package's order of
operations, so its results are the same bits. The one device operation is
the nearest warp of the segmentation (the port's ``warp_image(mode=
"nearest")``), on the card unless the caller passes ``device="cpu"``.
``evaluate_result.csv`` is written without pandas, so that evaluation runs
where pandas is not installed, in the text of pandas' ``DataFrame.to_csv``.
"""
from __future__ import annotations

import csv
import math
import os

import numpy as np
import torch

from ..coords import phi_from_01
from ..device import resolve_device
from .metrics import get_multi_metric

# Public DirLab COPDgene voxel spacings (mm), as tabulated in the reference
# (``tools/preprocessing.py:28-37``); these are dataset constants.
COPD_SPACING = {
    "copd1": [0.625, 0.625, 2.5], "copd2": [0.645, 0.645, 2.5],
    "copd3": [0.652, 0.652, 2.5], "copd4": [0.590, 0.590, 2.5],
    "copd5": [0.647, 0.647, 2.5], "copd6": [0.633, 0.633, 2.5],
    "copd7": [0.625, 0.625, 2.5], "copd8": [0.586, 0.586, 2.5],
    "copd9": [0.664, 0.664, 2.5], "copd10": [0.742, 0.742, 2.5],
}

# DirLab 4DCT spacings (``tools/preprocessing.py:48-57``).
FDCT_SPACING = {
    "dct1": [0.97, 0.97, 2.5], "dct2": [1.16, 1.16, 2.5],
    "dct3": [1.15, 1.15, 2.5], "dct4": [1.13, 1.13, 2.5],
    "dct5": [1.10, 1.10, 2.5], "dct6": [0.97, 0.97, 2.5],
    "dct7": [0.97, 0.97, 2.5], "dct8": [0.97, 0.97, 2.5],
    "dct9": [0.97, 0.97, 2.5], "dct10": [0.97, 0.97, 2.5],
}

#: the columns of ``evaluate_result.csv`` after its unnamed index column
CSV_COLUMNS = ("id", "dist", "dist_x", "dist_y", "dist_z", "dice")


def read_points(path, expect_count=None):
    """Read a DirLab landmark txt (tab-separated x y z per line). Tolerates
    CRLF line endings, trailing whitespace and runs of whitespace between
    columns; parsing stops at the first blank line. ``expect_count`` (e.g.
    300 for DirLab) raises unless the file holds exactly that many points.
    Returns (N, 3) f32."""
    pts = []
    with open(path, newline="") as f:
        for lineno, line in enumerate(f.read().split("\n"), start=1):
            line = line.replace("\r", "").strip()
            if not line:
                break
            vals = line.split()
            if len(vals) < 3:
                raise ValueError(
                    f"{path}:{lineno}: expected 3 whitespace-separated "
                    f"coordinates, got {len(vals)}: {line!r}")
            try:
                pts.append([float(vals[0]), float(vals[1]), float(vals[2])])
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: non-numeric landmark "
                                 f"coordinate in {line!r}") from e
    if expect_count is not None and len(pts) != expect_count:
        raise ValueError(f"{path}: expected {expect_count} landmarks, "
                         f"parsed {len(pts)}")
    return np.asarray(pts, dtype=np.float32)


def _sample_phi_at_points(phi, pts_norm):
    """Trilinear sample of ``phi`` (3, D, W, H) at normalized points (N, 3)
    in torch grid order (pts[:, 0] indexes H, pts[:, 1] W, pts[:, 2] D),
    align_corners=True, zeros padding, f64. Returns (3, N)."""
    phi = np.asarray(phi, dtype=np.float64)
    _, D, W, H = phi.shape
    sizes = np.array([H, W, D], dtype=np.float64)
    pix = (pts_norm.astype(np.float64) + 1.0) * 0.5 * (sizes - 1.0)
    out = np.zeros((phi.shape[0], pts_norm.shape[0]), dtype=np.float64)
    f = np.floor(pix)
    frac = pix - f
    fi = f.astype(np.int64)
    for corner in range(8):
        w = np.ones(pts_norm.shape[0], dtype=np.float64)
        idx = []
        ok = np.ones(pts_norm.shape[0], dtype=bool)
        for d, n in enumerate([H, W, D]):
            hi = (corner >> d) & 1
            j = fi[:, d] + hi
            ok &= (j >= 0) & (j <= n - 1)
            w *= frac[:, d] if hi else (1.0 - frac[:, d])
            idx.append(np.clip(j, 0, n - 1))
        # idx[0] indexes H (axis 3), idx[1] W (axis 2), idx[2] D (axis 1)
        vals = phi[:, idx[2], idx[1], idx[0]]
        out += vals * (w * ok)[None, :]
    return out


def calc_warped_points(source_pts_norm, phi, dim, phi_spacing):
    """Sampled map -> physical mm positions: sample, flip the channels,
    scale by (dim - 1) * phi_spacing."""
    sampled = _sample_phi_at_points(phi, source_pts_norm)     # (3, N)
    flipped = sampled[::-1].T                                  # (N, 3)
    return flipped * (np.asarray(dim, np.float64) - 1.0) * phi_spacing


def eval_with_data(source_list, target_list, phi, dim, spacing, origin,
                   phi_spacing):
    """TRE between warped source landmarks and target landmarks in mm.
    ``phi`` (1, 3, D, W, H) in the stored [0, 1] form, sampled without
    rescaling (a sampled value times (N - 1) * phi_spacing is a position in
    mm). Returns (mean TRE, [mean |dx|, |dy|, |dz|], per-landmark TRE)."""
    dim = np.asarray(dim, dtype=np.float64)
    spacing = np.asarray(spacing, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    phi_spacing = np.asarray(phi_spacing, dtype=np.float64)

    # (pts - 1) in the landmarks' f32 before the f64 upcast, in the
    # reference's order of operations
    target_t = (target_list - 1.0) * spacing - origin * phi_spacing
    source_t = (source_list - 1.0) * spacing - origin * phi_spacing
    # SAR -> SPR: flip the y (anterior/posterior) axis
    target_t[:, 1] = (dim[1] - 1) * phi_spacing[1] - target_t[:, 1]
    source_t[:, 1] = (dim[1] - 1) * phi_spacing[1] - source_t[:, 1]

    source_norm = source_t / phi_spacing / (dim - 1.0) * 2.0 - 1.0
    warped_t = calc_warped_points(source_norm, phi[0], dim, phi_spacing)

    # torch.nn.PairwiseDistance's default eps=1e-6 on the difference vector
    dist = np.linalg.norm(target_t - warped_t + 1e-6, axis=1)
    per_axis = [float(np.mean(np.abs(target_t[:, i] - warped_t[:, i])))
                for i in range(3)]
    return float(np.mean(dist)), per_axis, dist


def eval_with_file(source_file, target_file, phi_file, dim, spacing, origin,
                   phi_spacing):
    """:func:`eval_with_data` of landmark files and a stored [0, 1] map
    (3, D, W, H) in a ``.npy`` file."""
    source_list = read_points(source_file)
    target_list = read_points(target_file)
    phi = np.expand_dims(np.load(phi_file), axis=0)
    return eval_with_data(source_list, target_list, phi, dim, spacing,
                          origin, phi_spacing)


def compute_tre_statistics(tre_values):
    """GFR (the share above 10 mm) and the 50/75/95th percentiles."""
    tre = np.asarray(tre_values)
    gfr = float(np.sum(tre > 10) / tre.shape[0])
    perc = np.percentile(tre, (50, 75, 95))
    return {"GFR": gfr, "percentile_50": float(perc[0]),
            "percentile_75": float(perc[1]), "percentile_95": float(perc[2])}


def create_identity(shape):
    """[0, 1]-stored identity map with the reference's meshgrid quirk (axes
    0 and 1 swapped by ``np.meshgrid``'s default indexing)."""
    shape = np.asarray(shape)
    x = np.linspace(0, 1, shape[0])
    y = np.linspace(0, 1, shape[1])
    z = np.linspace(0, 1, shape[2])
    xv, yv, zv = np.meshgrid(x, y, z)
    return np.stack([yv, xv, zv], axis=0)


def warped_seg_dice(source_seg, target_seg, phi01, device=None):
    """Lung Dice of the nearest-warped source segmentation. Segmentations
    (D, W, H) in SAR orientation (flipped to SPR here); ``phi01`` (3, D, W,
    H) stored in [0, 1]. The warp runs on ``device`` (the CUDA card when
    None, see :func:`..device.resolve_device`)."""
    from ..ops.resample import warp_image

    device = resolve_device(device)
    src = np.flip(source_seg, axis=1).astype(np.float32)[None, None]
    tgt = np.flip(target_seg, axis=1).astype(np.float32)[None, None]
    phi = phi_from_01(np.asarray(phi01, np.float32))[None]
    warped = warp_image(torch.from_numpy(src).to(device),
                        torch.from_numpy(phi).to(device), mode="nearest",
                        zero_boundary=True, scale_intensity=False)
    metric = get_multi_metric(warped.cpu().numpy(), tgt)
    return float(metric["batch_avg_res"]["dice"][0, 1])


def _csv_field(value):
    """A cell as pandas' ``to_csv`` writes it: a float as its shortest
    repr, NaN as an empty field, anything else as ``str``."""
    if isinstance(value, float):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def write_results_csv(path, results):
    """``results`` (dicts with :data:`CSV_COLUMNS`) as the text of
    ``pandas.DataFrame(results, columns=CSV_COLUMNS).to_csv(path)``: an
    unnamed index column first, ``\\n`` line ends, minimal quoting."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["", *CSV_COLUMNS])
        for i, row in enumerate(results):
            writer.writerow([i, *(_csv_field(row[c]) for c in CSV_COLUMNS)])


def eval_copd_highres(dataset_path, exp_path, spacing_table=None,
                      dim=(160, 160, 160), device=None):
    """Evaluate every test case of an experiment: per-case TRE (and its x,
    y and z means), the lung Dice, the aggregate GFR and percentiles, and
    ``evaluate_result.csv``. The Dice's warp runs on ``device`` (the CUDA
    card when None). Returns the list of per-case result dicts."""
    spacing_table = spacing_table or COPD_SPACING
    test_list = np.sort(np.load(os.path.join(dataset_path,
                                             "test/data_id.npy")))
    landmark_folder = os.path.join(dataset_path, "landmarks")
    seg_folder = os.path.join(dataset_path, "preprocessed")
    disp_folder = os.path.join(exp_path, "tests")

    results, tre_list = [], []
    for case in test_list:
        case = str(case)
        copd_id = case.split("_")[0]
        phi_file = os.path.join(disp_folder, case + "_phi.npy")
        if not os.path.exists(phi_file):
            continue
        source_file = os.path.join(landmark_folder,
                                   f"{copd_id}_300_iBH_xyz_r1.txt")
        target_file = os.path.join(landmark_folder,
                                   f"{copd_id}_300_eBH_xyz_r1.txt")

        prop_file = os.path.join(seg_folder, case + "_prop.npy")
        if os.path.exists(prop_file):
            prop = np.load(prop_file, allow_pickle=True).item()
            origin = np.flip(np.asarray(prop["origin"])).copy()
            phi_spacing = np.flip(np.asarray(prop["spacing"])).copy()
        else:
            origin = np.zeros(3)
            phi_spacing = np.full(3, 2.2)

        # DirLab landmark files are in the original scan's voxel spacing;
        # other datasets (e.g. synthetic) store them at the volume spacing
        spacing = spacing_table.get(copd_id, phi_spacing)
        # phi (not its inverse) is stored, so the source and target
        # landmark files swap roles; the stored [0, 1] map is used as is
        phi01 = np.load(phi_file)
        src_pts = read_points(target_file)
        tgt_pts = read_points(source_file)
        res, res_sep, _ = eval_with_data(src_pts, tgt_pts, phi01[None],
                                         np.asarray(dim), spacing, origin,
                                         phi_spacing)
        print("%s: TRE: %f, TRE(x,y,z): %f, %f, %f"
              % (case, res, res_sep[0], res_sep[1], res_sep[2]))
        tre_list.append(res)

        dice = np.nan
        src_seg_file = os.path.join(seg_folder, f"{copd_id}_source_seg.npy")
        tgt_seg_file = os.path.join(seg_folder, f"{copd_id}_target_seg.npy")
        if os.path.exists(src_seg_file) and os.path.exists(tgt_seg_file):
            dice = warped_seg_dice(np.load(src_seg_file),
                                   np.load(tgt_seg_file), phi01, device)
        results.append({"id": case, "dist": res, "dist_x": res_sep[0],
                        "dist_y": res_sep[1], "dist_z": res_sep[2],
                        "dice": dice})

    write_results_csv(os.path.join(exp_path, "evaluate_result.csv"), results)
    stats = compute_tre_statistics(np.array(tre_list)) if tre_list else {}
    print(f"GFR:{stats.get('GFR')}")
    perc = [stats.get(f"percentile_{q}") for q in (50, 75, 95)]
    print(f"0.5, 0.75, 0.95 percentile:{perc}")
    if tre_list:
        print("The mean errors: {}".format(np.mean(tre_list)))
    return results
