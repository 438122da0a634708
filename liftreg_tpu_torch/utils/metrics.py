"""Segmentation overlap metrics: the port's copy of
``liftreg_tpu/utils/metrics.py`` (numpy only; the port imports nothing of
the JAX package).

Vectorized re-implementation of the reference's per-label iou / dice /
recall / precision with label auto-discovery and the ``-1`` sentinel
averaging (``src/liftreg/utils/metrics.py:6-121``). The per-voxel set
arithmetic of ``cal_metric`` becomes boolean reductions — identical values,
no python sets.
"""
from __future__ import annotations

import numpy as np


def cal_metric(label_pred, label_gt):
    """Binary metric tuple for two flat 0/1 arrays (``metrics.py:83-121``)."""
    eps = 1e-11
    pred = np.asarray(label_pred).astype(bool)
    gt = np.asarray(label_gt).astype(bool)
    tp = float(np.count_nonzero(pred & gt))
    fp = float(np.count_nonzero(pred & ~gt))
    fn = float(np.count_nonzero(~pred & gt))
    union = tp + fp + fn
    if gt.any():
        return {
            "iou": tp / (union + eps),
            "dice": 2 * tp / (2 * tp + fn + fp + eps),
            "recall": tp / (tp + fn + eps),
            "precision": tp / (tp + fp + eps),
        }
    val = 0.0 if pred.any() else 1.0
    return {"iou": val, "dice": val, "recall": val, "precision": val}


def get_multi_metric(pred, gt, eval_label_list=None, rm_bg=False,
                     verbose=True):
    """Per-label per-batch-item metrics dict (``metrics.py:6-80``)."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    label_list = sorted(set(np.unique(gt).tolist())
                        | set(np.unique(pred).tolist()))
    if verbose and len(label_list) > len(np.unique(gt)):
        extra = set(np.unique(pred).tolist()) - set(np.unique(gt).tolist())
        print(f"Warning, label {extra} is in prediction map but not in the "
              "ground truth map")
    if rm_bg:
        label_list = label_list[1:]
    if eval_label_list is not None and eval_label_list[0] != -100:
        for label in eval_label_list:
            assert label in label_list, f"label {label} is not in label_list"
        label_list = list(eval_label_list)

    metrics = ["iou", "dice", "recall", "precision"]
    num_label = len(label_list)
    num_batch = pred.shape[0]
    multi = {m: np.zeros([num_batch, num_label]) for m in metrics}
    label_avg = {m: np.zeros([num_batch, 1]) for m in metrics}
    batch_avg = {m: np.zeros([1, num_label]) for m in metrics}
    batch_label_avg = {m: np.zeros(1) for m in metrics}
    label_batch_avg = {m: np.zeros(1) for m in metrics}

    if num_label == 0:
        print("Warning, there is no label in current img")
        return {"multi_metric_res": multi,
                "label_avg_res": {m: np.ones([num_batch, 1]) for m in metrics},
                "batch_avg_res": {m: np.ones([1, 0]) for m in metrics},
                "label_list": label_list,
                "batch_label_avg_res": {m: 1.0 for m in metrics},
                "label_batch_avg_res": {m: 1.0 for m in metrics}}

    for li, label in enumerate(label_list):
        lp = (pred == label)
        lg = (gt == label)
        for b in range(num_batch):
            res = cal_metric(lp[b].reshape(-1), lg[b].reshape(-1))
            for m in metrics:
                multi[m][b][li] = res[m]

    for m in metrics:
        for b in range(num_batch):
            keep = multi[m][b] != -1
            label_avg[m][b] = float(np.mean(multi[m][b][keep]))
        batch_label_avg[m] = float(np.mean(label_avg[m]))
        for li in range(num_label):
            keep = multi[m][:, li] != -1
            batch_avg[m][:, li] = float(np.mean(multi[m][:, li][keep]))
        label_batch_avg[m] = float(np.mean(batch_avg[m]))

    return {"multi_metric_res": multi, "label_avg_res": label_avg,
            "batch_avg_res": batch_avg, "label_list": label_list,
            "batch_label_avg_res": batch_label_avg,
            "label_batch_avg_res": label_batch_avg}
