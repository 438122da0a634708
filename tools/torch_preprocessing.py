"""CT preprocessing CLI of the PyTorch port (``liftreg_tpu_torch``), the
port's copy of ``tools/preprocessing.py``: DirLab COPD/4DCT raw volumes ->
resampled (2.2 mm iso), background-stripped, lung-segmented,
160^3-centre-cropped npy sets + train/val/test id lists, through
``liftreg_tpu_torch.data.preprocessing`` (numpy and scipy on the host).

    python tools/torch_preprocessing.py -o OUT -d NAME --raw_train_path RAW
"""
from __future__ import annotations

import argparse
import enum
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.data.preprocessing import process_case  # noqa: E402
from liftreg_tpu_torch.utils.tre import (COPD_SPACING,  # noqa: E402
                                         FDCT_SPACING)


class FILE_TYPE(enum.Enum):
    nii = 1
    copd = 2
    dct = 3
    copd_highres = 4


# Public DirLab volume shapes (``tools/preprocessing.py:38-47,58-68``).
COPD_SHAPE = {
    "copd1": [121, 512, 512], "copd2": [102, 512, 512],
    "copd3": [126, 512, 512], "copd4": [126, 512, 512],
    "copd5": [131, 512, 512], "copd6": [119, 512, 512],
    "copd7": [112, 512, 512], "copd8": [115, 512, 512],
    "copd9": [116, 512, 512], "copd10": [135, 512, 512],
}
FDCT_SHAPE = {
    "dct1": [94, 256, 256], "dct2": [112, 256, 256], "dct3": [104, 256, 256],
    "dct4": [99, 256, 256], "dct5": [106, 256, 256], "dct6": [128, 512, 512],
    "dct7": [136, 512, 512], "dct8": [128, 512, 512], "dct9": [128, 512, 512],
    "dct10": [120, 512, 512],
}


def read_copd_data_list(data_folder_path):
    cases = []
    for case in sorted(os.listdir(data_folder_path)):
        case_dir = os.path.join(data_folder_path, case, case)
        cases.append({
            "id": case,
            "source": os.path.join(case_dir, case + "_iBHCT.img"),
            "target": os.path.join(case_dir, case + "_eBHCT.img"),
        })
    return cases


def read_dct_data_list(data_folder_path):
    cases = []
    for case in sorted(os.listdir(data_folder_path)):
        cid = case.lower()[:case.find("Pack")]
        case_dir = os.path.join(data_folder_path, case, "Images")
        cases.append({
            "id": "dct" + cid[4:],
            "source": os.path.join(case_dir, cid + "_T00.img"),
            "target": os.path.join(case_dir, cid + "_T50.img"),
        })
    return cases


def preprocess(data_folder_path, preprocessed_path, file_type, case_num=200,
               target_size=(160, 160, 160), target_spacing=(2.2, 2.2, 2.2),
               shape_override=None, spacing_override=None, seconds=None):
    """``shape_override``/``spacing_override`` replace the public DirLab
    per-case tables for every case (raw z,y,x shape / z,y,x spacing in mm) —
    used for non-DirLab raw layouts and small-scale rehearsals.
    ``seconds``, a dict, receives each case's seconds (host clock, its
    files written)."""
    if not os.path.exists(data_folder_path):
        print(f"Did not find data list file at {data_folder_path}")
        return []
    if file_type == FILE_TYPE.copd:
        file_list = read_copd_data_list(data_folder_path)
        spacing_tab, shape_tab = COPD_SPACING, COPD_SHAPE
    elif file_type == FILE_TYPE.dct:
        file_list = read_dct_data_list(data_folder_path)
        spacing_tab, shape_tab = FDCT_SPACING, FDCT_SHAPE
    else:
        raise ValueError(f"unsupported file type {file_type}")
    file_list = file_list[:case_num]

    ids = []
    for i, case in enumerate(file_list):
        t0 = time.perf_counter()
        cid = case["id"]
        ids.append(cid)
        print(f"Preprocessing {i}/{len(file_list)} {cid}")
        spacing = (np.asarray(spacing_override, np.float64)
                   if spacing_override is not None
                   else np.flipud(spacing_tab[cid]))
        shape = (list(shape_override) if shape_override is not None
                 else shape_tab[cid])
        src, tgt, src_seg, tgt_seg, origin, new_spacing = process_case(
            case["source"], case["target"], shape, spacing,
            target_size=tuple(target_size),
            target_spacing=tuple(target_spacing),
            seg_bg=True)
        np.save(os.path.join(preprocessed_path, f"{cid}_source.npy"), src)
        np.save(os.path.join(preprocessed_path, f"{cid}_target.npy"), tgt)
        np.save(os.path.join(preprocessed_path, f"{cid}_source_seg.npy"), src_seg)
        np.save(os.path.join(preprocessed_path, f"{cid}_target_seg.npy"), tgt_seg)
        np.save(os.path.join(preprocessed_path, f"{cid}_prop.npy"),
                {"origin": origin, "spacing": new_spacing})
        if seconds is not None:
            seconds[cid] = time.perf_counter() - t0
    return ids


def save_id_list(task_root, file_name, case_id_list, mode="train"):
    """80/20 train/val split or all->test (``tools/preprocessing.py:354-379``)."""
    case_id_list = list(case_id_list)
    if mode == "train":
        np.random.shuffle(case_id_list)
        n = len(case_id_list)
        # 80/20, but never an empty train split: with 1-4 cases the 4//5
        # floor would zero it out and the trainer fails with an
        # unrelated-looking "empty dataset for phase train"; small-corpus
        # smoke runs (tools/dirlab_e2e.py single-case rehearsal) reuse the
        # cases for val instead
        n_train = max(1, n * 4 // 5)
        train = case_id_list[:n_train]
        val = case_id_list[n_train:] or list(train)
        for sub, lst in (("train", train), ("debug", train), ("val", val)):
            os.makedirs(os.path.join(task_root, sub), exist_ok=True)
            np.save(os.path.join(task_root, sub, file_name), lst)
    else:
        os.makedirs(os.path.join(task_root, "test"), exist_ok=True)
        np.save(os.path.join(task_root, "test", file_name), case_id_list)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Prepare data for training")
    parser.add_argument("-o", "--output_path", required=True, type=str)
    parser.add_argument("-d", "--dataset_name", required=True, type=str)
    parser.add_argument("--raw_train_path", type=str, default="",
                        help="folder of raw training cases")
    parser.add_argument("--raw_val_path", type=str, default="",
                        help="folder of raw DirLab COPD cases for evaluation")
    parser.add_argument("--file_type", type=str, default="copd",
                        choices=["copd", "dct"])
    parser.add_argument("--data_type", type=str, default="all",
                        choices=["train", "val", "all"])
    args = parser.parse_args()

    task_root = os.path.join(os.path.abspath(args.output_path),
                             args.dataset_name)
    preprocessed_path = os.path.join(task_root, "preprocessed")
    os.makedirs(preprocessed_path, exist_ok=True)
    ftype = FILE_TYPE[args.file_type]

    if args.data_type in ("train", "all") and args.raw_train_path:
        ids = preprocess(args.raw_train_path, preprocessed_path, ftype,
                         case_num=1000)
        save_id_list(task_root, "data_id", ids, mode="train")
    if args.data_type in ("val", "all") and args.raw_val_path:
        ids = preprocess(args.raw_val_path, preprocessed_path, ftype,
                         case_num=1000)
        save_id_list(task_root, "data_id", ids, mode="test")
