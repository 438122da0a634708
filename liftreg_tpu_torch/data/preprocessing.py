"""CT preprocessing: raw readers, resampling, body and lung segmentation;
the port's copy of ``liftreg_tpu/data/preprocessing.py`` (numpy and scipy
on the host, the same arithmetic, so the same arrays on the same input).

* :func:`load_img_raw` — little-endian int16 raw reader;
* :func:`resample_volume` — linear resample to a target spacing (out size
  ``ceil(in*old/new)``, samples at ``i*new/old``);
* :func:`seg_bg_mask` / :func:`seg_lung_mask` — a two-cluster KMeans
  threshold (its own seeded iteration), morphology, connected components
  and per-slice convex hulls (a Delaunay in-hull test);
* :func:`pad_crop_to` — centre pad (-1024) or crop with origin tracking;
* :func:`process_case` — the whole per-case pipeline of
  ``tools/torch_preprocessing.py``.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def load_img_raw(file_path, shape):
    """Read a DirLab-style raw ``<i2`` volume (``load_IMG``)."""
    data = np.fromfile(file_path, dtype=np.dtype("<i2"))
    return data.reshape(shape)


def resample_volume(img, spacing, new_spacing, order=1):
    """Linear resample onto a grid with ``new_spacing``; returns
    (resampled, realized_spacing, resize_factor) like the reference."""
    img = np.asarray(img, dtype=np.float32)
    spacing = np.asarray(spacing, dtype=np.float64)
    new_spacing = np.asarray(new_spacing, dtype=np.float64)
    out_shape = np.ceil(np.asarray(img.shape) * spacing / new_spacing
                        ).astype(int)
    coords = np.meshgrid(*[np.arange(n) * new_spacing[d] / spacing[d]
                           for d, n in enumerate(out_shape)], indexing="ij")
    out = ndimage.map_coordinates(img, np.stack(coords), order=order,
                                  mode="nearest")
    resize_factor = np.asarray(img.shape) / out_shape
    return out.astype(np.float32), tuple(new_spacing), resize_factor


def _kmeans2_threshold(values, seed=0):
    """Two-cluster 1D KMeans threshold = mean of the two centers
    (replaces sklearn KMeans on the middle-region intensities)."""
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    c = np.array([v.min(), v.max()])
    for _ in range(50):
        assign = np.abs(v[:, None] - c[None, :]).argmin(axis=1)
        new_c = np.array([v[assign == k].mean() if np.any(assign == k)
                          else c[k] for k in range(2)])
        if np.allclose(new_c, c):
            break
        c = new_c
    return float(np.mean(sorted(c)))


def _convex_hull_slice(mask2d):
    """Filled convex hull of a 2D boolean mask (replaces
    ``skimage.morphology.convex_hull_image``)."""
    pts = np.argwhere(mask2d)
    if len(pts) < 3:
        return mask2d.astype(mask2d.dtype)
    from scipy.spatial import Delaunay, QhullError
    try:
        tri = Delaunay(pts)
    except QhullError:
        return mask2d.astype(mask2d.dtype)
    yy, xx = np.mgrid[0:mask2d.shape[0], 0:mask2d.shape[1]]
    grid = np.stack([yy.ravel(), xx.ravel()], axis=1)
    inside = tri.find_simplex(grid) >= 0
    return inside.reshape(mask2d.shape).astype(mask2d.dtype)


def _regionprops(labels):
    """Minimal regionprops: list of (label, area, bbox) for labels >= 1."""
    out = []
    objects = ndimage.find_objects(labels)
    for lab, sl in enumerate(objects, start=1):
        if sl is None:
            continue
        area = int(np.count_nonzero(labels[sl] == lab))
        bbox = tuple(s.start for s in sl) + tuple(s.stop for s in sl)
        out.append({"label": lab, "area": area, "bbox": bbox})
    return out


def seg_bg_mask(img):
    """Whole-body mask (BG=0) + bbox; algorithm of ``seg_bg_mask:58-137``."""
    D, W, H = img.shape
    img_n = (img - np.mean(img)) / np.std(img)
    middle = img_n[D // 5:D * 4 // 5, W // 5:W * 4 // 5, H // 5:H * 4 // 5]
    threshold = _kmeans2_threshold(middle)
    thresh = (img_n < threshold).astype(np.float64)

    cube = np.ones((4, 4, 4), dtype=bool)
    eroded = ndimage.binary_erosion(
        ndimage.binary_dilation(thresh.astype(bool), cube), cube)

    # largest non-"background-label" region over inverted mask
    labels, _ = ndimage.label(~eroded)
    regions = _regionprops(labels)
    roi_label = max(regions, key=lambda r: r["area"])["label"] if regions else 0
    body = labels == roi_label

    # per-axial-slice convex hull between first and last occupied slices
    occupied = np.where(body.any(axis=(1, 2)))[0]
    hull = body.astype(np.int64)
    if len(occupied):
        for i in range(occupied[0], occupied[-1] + 1):
            hull[i] = _convex_hull_slice(body[i])

    # strip components touching the volume corners
    labels2, _ = ndimage.label(hull)
    corners = [(0, 0, 0), (-1, 0, 0), (0, -1, 0), (-1, -1, 0),
               (0, -1, -1), (0, 0, -1), (-1, 0, -1), (-1, -1, -1)]
    bg_labels = {labels2[c] for c in corners}
    mask = ~np.isin(labels2, list(bg_labels))
    mask = mask.astype(np.int64)

    roi_labels, _ = ndimage.label(mask)
    bbox = (0, 0, 0, D, W, H)
    for r in _regionprops(roi_labels):
        if r["label"] == 1:
            bbox = r["bbox"]
    return mask, bbox


def seg_lung_mask(img):
    """Lung mask + bbox; algorithm of ``seg_lung_mask:139-223``."""
    D, W, H = img.shape
    img_n = (img - np.mean(img)) / np.std(img)
    middle = img_n[D // 5:D * 4 // 5, W // 5:W * 4 // 5, H // 5:H * 4 // 5]
    mean = np.mean(middle)
    img_n = np.where(img_n == img_n.max(), mean, img_n)
    img_n = np.where(img_n == img_n.min(), mean, img_n)
    threshold = _kmeans2_threshold(middle)
    thresh = img_n < threshold

    cube = np.ones((4, 4, 4), dtype=bool)
    dil = ndimage.binary_dilation(ndimage.binary_erosion(thresh, cube), cube)
    labels, _ = ndimage.label(dil)
    regions = _regionprops(labels)

    good = []
    for r in regions:
        B = r["bbox"]
        if (B[4] - B[1] < W / 20 * 18 and B[4] - B[1] > W / 5 and
                B[4] < W / 20 * 16 and B[1] > W / 10 and
                B[5] - B[2] < H / 20 * 18 and B[5] - B[2] > H / 20 and
                B[2] > H / 10 and B[5] < H / 20 * 19 and B[3] - B[0] > D / 4):
            good.append(r)
            continue
        if (B[4] - B[1] < W / 20 * 18 and B[4] - B[1] > W / 6 and
                B[4] < W / 20 * 18 and B[1] > W / 20 and
                B[5] - B[2] < H / 20 * 18 and B[5] - B[2] > H / 20):
            good.append(r)
            continue
        if (B[4] - B[1] < W / 20 * 18 and B[4] - B[1] > W / 20 and
                B[4] < W / 20 * 18 and B[1] > W / 20):
            good.append(r)

    good = sorted(good, key=lambda r: r["area"], reverse=True)
    mask = np.zeros((D, W, H), dtype=np.int8)
    bbox = [D / 2, W / 2, H / 2, D / 2, W / 2, H / 2]
    for r in good[:2]:
        mask = mask + (labels == r["label"]).astype(np.int8)
        for i in range(3):
            bbox[i] = min(bbox[i], r["bbox"][i])
            bbox[i + 3] = max(bbox[i + 3], r["bbox"][i + 3])
    mask = ndimage.binary_erosion(
        ndimage.binary_dilation(mask.astype(bool), cube), cube
    ).astype(np.int8)
    return mask, bbox


def pad_crop_to(vol, size, pad_value=-1024.0):
    """Center pad/crop to ``size``; returns (out, new_origin) with the
    reference's origin bookkeeping (``tools/preprocessing.py:154-177``)."""
    vol = np.asarray(vol)
    size = np.asarray(size)
    new_origin = np.zeros(3, dtype=np.int64)

    diff = size - np.asarray(vol.shape)
    diff = np.maximum(diff, 0)
    pad = [[int(d / 2), d - int(d / 2)] for d in diff]
    out = np.pad(vol, pad, constant_values=pad_value)
    new_origin[diff > 0] = -np.asarray(pad)[diff > 0, 0]

    diff = np.asarray(out.shape) - size
    box = [[int(d / 2), int(d / 2) + s] for d, s in zip(diff, size)]
    out = out[box[0][0]:box[0][1], box[1][0]:box[1][1], box[2][0]:box[2][1]]
    new_origin[diff > 0] = np.asarray(box)[diff > 0, 0]
    return out, new_origin


def process_case(source_path, target_path, shape, spacing_in,
                 target_size=(160, 160, 160), target_spacing=(2.2, 2.2, 2.2),
                 seg_bg=True):
    """Full per-case pipeline of ``process_single_file``
    (``tools/preprocessing.py:125-180``): raw load, -1024 HU shift, resample,
    background strip, lung seg, pad/crop, origin tracking."""
    src = load_img_raw(source_path, shape).astype(np.float32) - 1024
    tgt = load_img_raw(target_path, shape).astype(np.float32) - 1024
    src, _, _ = resample_volume(src, spacing_in, target_spacing)
    tgt, new_spacing, _ = resample_volume(tgt, spacing_in, target_spacing)
    src = np.maximum(src, -1024)
    tgt = np.maximum(tgt, -1024)

    if seg_bg:
        for vol in (src, tgt):
            bg, _ = seg_bg_mask(vol)
            vol[bg == 0] = vol.min()
    src_seg, _ = seg_lung_mask(src)
    tgt_seg, _ = seg_lung_mask(tgt)

    src, origin = pad_crop_to(src, target_size)
    tgt, _ = pad_crop_to(tgt, target_size)
    src_seg, _ = pad_crop_to(src_seg, target_size, pad_value=0)
    tgt_seg, _ = pad_crop_to(tgt_seg, target_size, pad_value=0)
    return (src, tgt, src_seg.astype(np.float32), tgt_seg.astype(np.float32),
            origin, new_spacing)
