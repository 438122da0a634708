"""Registration result figures: the port's copy of
``liftreg_tpu/utils/visualize.py``. Matplotlib is imported only inside the
plotting functions, so the module imports where matplotlib is absent.

Compact equivalent of ``utils/visualize_registration_results.py``: per-batch
panels of source / target / warped center slices along the three axes (plus
labels when present), written to ``byname/`` and ``byiter/`` directories
(``show_current_images:494-562``). 2D inputs (projections) get a row per
view. Matplotlib 'Agg' only; no interactive viewers.
"""
from __future__ import annotations

import os

import numpy as np

from .io_utils import make_dir


def _center_slices(vol):
    """vol: (D, W, H) -> three center slices."""
    d, w, h = vol.shape
    return [vol[d // 2], vol[:, w // 2], vol[:, :, h // 2]]


def show_current_images(iter_count, iS, iT, iW, iSL=None, iTL=None, iWL=None,
                        phiWarped=None, visual_param=None, vizImages=None,
                        vizName=None, extraImages=None, extraName=None, **_):
    """Save a grid figure for up to ``save_fig_num`` batch items.

    Rows: source / target / warped / checkerboard(warped, target)
    (``visualize_registration_results.py:141-143,223-225``), optional
    ``vizImages``/``extraImages`` rows (``:283-491`` extra-image panels,
    one row of axis slices per image), then label rows. The warped row
    overlays phi iso-contours when ``phiWarped`` is given.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    visual_param = visual_param or {}
    if not visual_param.get("save_fig", True):
        return
    n_show = min(int(visual_param.get("save_fig_num", 4)),
                 np.asarray(iS).shape[0])
    pair_names = visual_param.get("pair_name") or [str(i) for i in range(n_show)]
    tag = visual_param.get("iter", f"iter_{iter_count}")
    byname = visual_param.get("save_fig_path_byname")
    byiter = visual_param.get("save_fig_path_byiter")
    for p in (byname, byiter):
        if p:
            make_dir(p)

    # 1D registration results: line-plot panels, the reference's
    # _show_current_images_1d layout (``:21-85``) — source / target /
    # warped-overlay (+ phi, + viz) per batch item
    if np.asarray(iS).ndim - 2 == 1:
        for b in range(n_show):
            _show_1d(np.asarray(iS)[b, 0], np.asarray(iT)[b, 0],
                     np.asarray(iW)[b, 0],
                     None if phiWarped is None else np.asarray(phiWarped)[b],
                     None if vizImages is None else np.asarray(vizImages)[b],
                     vizName, pair_names[b], tag, byname, byiter, plt)
        return

    arrs = {"source": np.asarray(iS), "target": np.asarray(iT),
            "warped": np.asarray(iW)}
    labels = {}
    if iSL is not None and iTL is not None and iWL is not None:
        labels = {"source_label": np.asarray(iSL),
                  "target_label": np.asarray(iTL),
                  "warped_label": np.asarray(iWL)}
    extras = {}
    if vizImages is not None:
        extras[vizName or "viz"] = np.asarray(vizImages)
    if extraImages is not None:
        extras[extraName or "extra"] = np.asarray(extraImages)

    for b in range(n_show):
        rows = []
        row_names = []
        for name, arr in {**arrs, **extras, **labels}.items():
            img = arr[b, 0] if arr.ndim == 5 else arr[b]
            if img.ndim == 3:
                rows.append(_center_slices(img))
            elif img.ndim == 2:
                rows.append([img])
            row_names.append(name)
        # checkerboard(warped, target) composite row (ref :141-143,223-225)
        w_row = rows[row_names.index("warped")]
        t_row = rows[row_names.index("target")]
        cb_at = row_names.index("warped") + 1
        rows.insert(cb_at, [checkerboard_2d(w, t)
                            for w, t in zip(w_row, t_row)])
        row_names.insert(cb_at, "checkerboard")
        # map iso-contours on the warped panels
        # (``visualize_registration_results.py`` overlays phi contours)
        phi_slices = None
        if phiWarped is not None:
            phi = np.asarray(phiWarped)[b]          # (3, D, W, H)
            d, w, h = phi.shape[1:]
            phi_slices = [  # the two in-plane components per center slice
                [phi[1][d // 2], phi[2][d // 2]],
                [phi[0][:, w // 2], phi[2][:, w // 2]],
                [phi[0][:, :, h // 2], phi[1][:, :, h // 2]],
            ]
        ncols = max(len(r) for r in rows)
        fig, axes = plt.subplots(len(rows), ncols,
                                 figsize=(3 * ncols, 3 * len(rows)),
                                 squeeze=False)
        for ri, (row, name) in enumerate(zip(rows, row_names)):
            for ci in range(ncols):
                ax = axes[ri][ci]
                ax.axis("off")
                if ci < len(row):
                    ax.imshow(row[ci], cmap="gray")
                    if name == "warped" and phi_slices is not None \
                            and ci < len(phi_slices):
                        for comp in phi_slices[ci]:
                            ax.contour(comp, levels=16, colors="g",
                                       linewidths=0.3)
                    if ci == 0:
                        ax.set_title(name, fontsize=8)
        fig.tight_layout()
        fname = f"{pair_names[b]}_{tag}.png"
        if byname:
            fig.savefig(os.path.join(byname, fname), dpi=120)
        if byiter:
            fig.savefig(os.path.join(byiter, f"{tag}_{pair_names[b]}.png"),
                        dpi=120)
        plt.close(fig)


def _show_1d(s, t, w, phi, viz, viz_name, pair_name, tag, byname, byiter,
             plt):
    """1D panel (reference ``_show_current_images_1d:21-85``): source,
    target, warped overlaid on both, optional phi[0] and viz rows."""
    n_panels = 3 + (phi is not None) + (viz is not None)
    fig, axes = plt.subplots(1, n_panels, figsize=(3 * n_panels, 3),
                             squeeze=False)
    axes = axes[0]
    axes[0].plot(s)
    axes[0].set_title("source image", fontsize=8)
    axes[1].plot(t)
    axes[1].set_title("target image", fontsize=8)
    axes[2].plot(t, "g", linestyle=":")
    axes[2].plot(s, "r", linestyle="--")
    axes[2].plot(w, linestyle=":")
    axes[2].set_title("warped image", fontsize=8)
    k = 3
    if phi is not None:
        axes[k].plot(np.asarray(phi)[0])
        axes[k].set_title("phi", fontsize=8)
        k += 1
    if viz is not None:
        axes[k].plot(np.atleast_1d(np.asarray(viz)).reshape(-1))
        axes[k].set_title(viz_name or "viz", fontsize=8)
    fig.tight_layout()
    if byname:
        fig.savefig(os.path.join(byname, f"{pair_name}_{tag}.png"), dpi=120)
    if byiter:
        fig.savefig(os.path.join(byiter, f"{tag}_{pair_name}.png"), dpi=120)
    plt.close(fig)


def checkerboard_2d(img1, img2, tiles=8):
    """Checkerboard composite of two equally-shaped 2D images
    (``visualize_registration_results.checkerboard_2d:86-103``): square
    tiles of side ``min(shape)//tiles``; img1 on the even tiles."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    h, w = img1.shape
    ts = max(1, min(h, w) // tiles)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((yy // ts) + (xx // ts)) % 2 == 0
    return np.where(mask, img1, img2)
