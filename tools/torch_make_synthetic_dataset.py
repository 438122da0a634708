"""Generate a synthetic 2D/3D registration dataset in the reference's disk
layout, with DRRs and a PCA deformation basis, through the PyTorch port
(``liftreg_tpu_torch``): the port's copy of
``tools/make_synthetic_dataset.py``.

The numpy random draws are the JAX tool's, in the same order, so the same
seed gives the same phantoms, deformation fields and masks; the upsampling
of the noise fields, the warps and the DRRs go through the port (on the
CUDA card unless ``--device cpu``), which round their last bits otherwise
than the JAX package. Deformed lung-like phantoms stand in for clinical
CTs:

  <out>/preprocessed/{id}_{source,target,source_seg,target_seg,prop}.npy
  <out>/{train,val,test,debug}/data_id.npy
  <out>/drr/drr/drr/{id}_{source,target}_proj.npy + poses.npy
  <out>/landmarks/{id}_300_{iBH,eBH}_xyz_r1.txt
  <out>/gt_phi/{id}_phi.npy
  <out>/pca/pca_vectors.npy + pca_mean.npy
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch import coords, pca as pca_lib  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.ops import drr, drr_kernel, resample  # noqa: E402


def smooth_noise(rng, shape, scale, smooth=4, device=None):
    """Smooth random field: normal draws at 1/``smooth`` of ``shape``,
    upsampled (align_corners trilinear) on ``device``."""
    low = tuple(max(2, s // smooth) for s in shape)
    x = rng.normal(size=low).astype(np.float32)
    t = torch.from_numpy(x).to(resolve_device(device))[None, None]
    up = resample.resize_trilinear(t, shape)
    return up[0, 0].cpu().numpy() * scale


def broadband_noise(rng, shape, scale, device=None):
    """Octaves of 2-16 voxels with amplitudes falling ~1/f, normalised to
    ~unit std: broadband texture that local windows can rank."""
    out = np.zeros(shape, np.float32)
    for s, a in ((2, 0.5), (4, 0.35), (8, 0.25), (16, 0.18)):
        out += smooth_noise(rng, shape, a, smooth=s, device=device)
    out /= max(float(out.std()), 1e-6)
    return out * scale


def anatomical_noise(rng, shape, scale, device=None):
    """Broadband octaves plus coarse 32-64-voxel "lobar" octaves, which
    give every region a unique coarse intensity signature (so the true
    correspondence is the unique optimum of dense registration); the fine
    2-8-voxel octaves keep ~65% of the energy, so NCC feels displacements
    of a few voxels."""
    out = np.zeros(shape, np.float32)
    for s, a in ((2, 0.5), (4, 0.4), (8, 0.3), (16, 0.25),
                 (32, 0.3), (64, 0.35)):
        out += smooth_noise(rng, shape, a, smooth=s, device=device)
    out /= max(float(out.std()), 1e-6)
    return out * scale


def blob_anchors(rng, shape, lung_mask, n_blobs, sz):
    """Bright nodule/bifurcation-like Gaussian anchors at unique random
    positions inside the lung — the discrete, individually identifiable
    landmarks (vessel bifurcations, nodules) that real parenchyma offers
    a registration algorithm. Returns an additive HU map."""
    vol = np.zeros(shape, np.float32)
    idxs = np.argwhere(lung_mask)
    if len(idxs) == 0:
        return vol
    D, W, H = shape
    take = idxs[rng.choice(len(idxs), size=min(n_blobs, len(idxs)),
                           replace=False)]
    for c in take:
        r = rng.uniform(0.015, 0.04) * sz
        ri = max(2, int(np.ceil(2 * r)))
        z, y, x = int(c[0]), int(c[1]), int(c[2])
        zlo, ylo, xlo = max(z - ri, 0), max(y - ri, 0), max(x - ri, 0)
        zhi, yhi, xhi = min(z + ri + 1, D), min(y + ri + 1, W), min(x + ri + 1, H)
        g = np.mgrid[zlo - z:zhi - z, ylo - y:yhi - y, xlo - x:xhi - x]
        d2 = (g.astype(np.float32) ** 2).sum(0)
        amp = rng.uniform(250.0, 500.0)
        vol[zlo:zhi, ylo:yhi, xlo:xhi] = np.maximum(
            vol[zlo:zhi, ylo:yhi, xlo:xhi],
            amp * np.exp(-d2 / (2.0 * r * r)).astype(np.float32))
    return vol


def vascular_tree(rng, shape, roots, n_roots=4, steps=None, branch_p=0.06,
                  radius0=None):
    """Branching-random-walk vessel tree density in [0, 1].

    Real lung parenchyma owes its registrability to the vascular tree:
    bright (≈ soft-tissue HU) branching tubes across scales give every
    local window unambiguous structure — exactly what band-limited noise
    lacks (DESIGN.md §2a "when refinement helps"). Walks start near the
    hilum (``roots``), persist in direction with smooth turning, deposit
    spherical splats of decaying radius, and branch with probability
    ``branch_p`` per step (child radius × 0.75, direction deflected).
    """
    D, W, H = shape
    steps = steps or int(3.0 * max(shape))
    radius0 = radius0 or max(1.5, 0.018 * max(shape))
    vol = np.zeros(shape, np.float32)
    # precompute a small splat ball per integer radius
    splats = {}

    def splat(r):
        ri = max(1, int(np.ceil(r)))
        if ri not in splats:
            g = np.mgrid[-ri:ri + 1, -ri:ri + 1, -ri:ri + 1].astype(np.float32)
            d2 = (g ** 2).sum(0)
            splats[ri] = np.maximum(0.0, 1.0 - d2 / (ri * ri)).astype(np.float32)
        return ri, splats[ri]

    stack = []
    for _ in range(n_roots):
        pos = np.asarray(roots) + rng.normal(scale=0.03 * max(shape), size=3)
        dirn = rng.normal(size=3)
        dirn /= np.linalg.norm(dirn) + 1e-6
        stack.append((pos, dirn, radius0, steps))
    while stack:
        pos, dirn, r, n = stack.pop()
        for _ in range(int(n)):
            pos = pos + dirn * max(1.0, 0.6 * r)
            if not ((0 <= pos) & (pos < np.asarray(shape))).all():
                break
            ri, ball = splat(r)
            z, y, x = (int(pos[0]), int(pos[1]), int(pos[2]))
            zlo, ylo, xlo = max(z - ri, 0), max(y - ri, 0), max(x - ri, 0)
            zhi, yhi, xhi = (min(z + ri + 1, D), min(y + ri + 1, W),
                             min(x + ri + 1, H))
            vol[zlo:zhi, ylo:yhi, xlo:xhi] = np.maximum(
                vol[zlo:zhi, ylo:yhi, xlo:xhi],
                ball[zlo - (z - ri):zhi - (z - ri),
                     ylo - (y - ri):yhi - (y - ri),
                     xlo - (x - ri):xhi - (x - ri)])
            turn = rng.normal(scale=0.25, size=3)
            dirn = dirn + turn
            dirn /= np.linalg.norm(dirn) + 1e-6
            r *= 0.999
            if rng.uniform() < branch_p and r > 0.8:
                child = dirn + rng.normal(scale=0.8, size=3)
                child /= np.linalg.norm(child) + 1e-6
                stack.append((pos.copy(), child, r * 0.75, n * 0.5))
            if r < 0.6:
                break
    return np.clip(vol, 0.0, 1.0)


def make_phantom(rng, sz, texture="banded", device=None):
    """Lung-like CT phantom in HU, SAR orientation, (D, W, H)."""
    D = W = H = sz
    zz, yy, xx = np.mgrid[0:D, 0:W, 0:H].astype(np.float32)
    ct = np.full((D, W, H), -1024.0, np.float32)
    cx = sz / 2 + rng.uniform(-2, 2, 3)
    body = (((zz - cx[0]) / (0.42 * sz)) ** 2 + ((yy - cx[1]) / (0.36 * sz)) ** 2
            + ((xx - cx[2]) / (0.36 * sz)) ** 2) < 1.0
    ct[body] = 30.0
    seg = np.zeros_like(ct)
    for side in (-1, 1):
        lc = cx + np.array([0, -0.05 * sz, side * 0.17 * sz])
        lung = (((zz - lc[0]) / (0.28 * sz)) ** 2 + ((yy - lc[1]) / (0.2 * sz)) ** 2
                + ((xx - lc[2]) / (0.13 * sz)) ** 2) < 1.0
        if texture == "anatomical":
            tex = anatomical_noise(rng, ct.shape, 1.0, device)
        elif texture in ("broadband", "vascular"):
            tex = broadband_noise(rng, ct.shape, 1.0, device)
        else:
            tex = smooth_noise(rng, ct.shape, 1.0, device=device)
        if texture == "anatomical":
            # Realistic parenchyma contrast. The +-60 HU first cut left
            # intra-lung texture at ~0.12 amplitude after the [-1000,0]
            # clip — ~2% of global NCC's gradient against the air/body
            # contrast — and per-pair optimization recovered fields
            # ORTHOGONAL to ground truth under every objective tried
            # (ncc/lncc x masked/unmasked all rel_err ~ 1.0,
            # RESULTS/r5_optreg_objective_ab.log): smooth boundaries
            # constrain only the normal displacement component (aperture
            # problem) and faint texture pins nothing. Real lungs span
            # hundreds of HU (vessels -200..0 against -900 parenchyma),
            # so v3 uses -700 +- 220 HU texture plus bright trees and
            # anchors — structure strong enough for intensity descent to
            # feel interior correspondence.
            ct[lung] = -700.0 + 220.0 * tex[lung]
            anchors = blob_anchors(rng, ct.shape, lung, max(8, sz // 8), sz)
            ct[lung] = ct[lung] + anchors[lung]
            hilum = lc + np.array([0.0, 0.0, -side * 0.10 * sz])
            vess = vascular_tree(rng, ct.shape, hilum)
            ct[lung] = ct[lung] + 500.0 * vess[lung]
        else:
            ct[lung] = -850.0 + 60 * tex[lung]
        if texture == "vascular":
            # vessel tree rooted at the hilum (medial lung edge): bright
            # branching tubes toward soft-tissue HU, the structure that
            # makes local similarity rank registrations in real CT
            hilum = lc + np.array([0.0, 0.0, -side * 0.10 * sz])
            vess = vascular_tree(rng, ct.shape, hilum)
            ct[lung] = ct[lung] + 800.0 * vess[lung]
        seg[lung] = 1.0
    return ct, seg


def random_disp(rng, sz, magnitude=0.06, smooth=6, device=None):
    """Smooth random displacement field (3, D, W, H) in normalized units.

    ``smooth`` is the feature wavelength in voxels. The historical
    default (6) produces fields far harsher than respiratory motion —
    displacement ≈ feature scale — which round 5 measured as a second
    independent cause of stage-1 ill-posedness (no local window can
    disambiguate a 5-voxel displacement that varies every 6 voxels).
    Respiratory-like fields use ``smooth ≈ sz/4`` (diaphragm-scale)."""
    return np.stack([smooth_noise(rng, (sz, sz, sz), magnitude,
                                  smooth=smooth, device=device)
                     for _ in range(3)])


class LowRankDeformationModel:
    """Deformations sampled from a shared low-dimensional smooth subspace:
    ``disp = sum_k c_k B_k`` with a fixed bank of ``rank`` smooth basis
    fields and per-case coefficients ``c ~ N(0, 1)``.

    This matches the statistical-deformation-model premise LiftReg is built
    on (respiratory motion is low-dimensional; the PCA subspace can span
    it). Independent per-case random fields — the round-1 phantom — give
    48 mutually orthogonal fields that no 24-component basis can span, and
    the projections->coefficients regression has no shared structure to
    learn; training measurably stalls (see DEMO.md).
    """

    def __init__(self, rng, sz, rank=16, magnitude=0.06, smooth=6,
                 device=None):
        norm = 1.0 / np.sqrt(rank)
        self.basis = np.stack([random_disp(rng, sz, magnitude * norm,
                                           smooth=smooth, device=device)
                               for _ in range(rank)])  # (K, 3, D, W, H)
        self.rank = rank

    def sample(self, rng):
        c = rng.normal(size=self.rank).astype(np.float32)
        return np.tensordot(c, self.basis, axes=(0, 0))  # (3, D, W, H)


def generate(out, n_train=8, n_val=2, n_test=2, sz=64, n_proj=4,
             scan_range=30.0, latent=8, seed=0, deformation_rank=0,
             texture="banded", deformation_smooth=6,
             deformation_magnitude=0.06, device=None):
    """Write the dataset under ``out``. ``deformation_rank > 0`` draws
    every case's deformation from a shared ``deformation_rank``-dimensional
    smooth subspace; 0 keeps independent random fields. ``device`` None
    means the CUDA card."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    deform_model = (LowRankDeformationModel(rng, sz, deformation_rank,
                                            magnitude=deformation_magnitude,
                                            smooth=deformation_smooth,
                                            device=device)
                    if deformation_rank else None)
    pre = os.path.join(out, "preprocessed")
    os.makedirs(pre, exist_ok=True)
    drr_dir = os.path.join(out, "drr", "drr", "drr")
    os.makedirs(drr_dir, exist_ok=True)
    lm_dir = os.path.join(out, "landmarks")
    os.makedirs(lm_dir, exist_ok=True)

    poses = drr.synthesize_poses(scan_range, n_proj, sz)
    resolution = drr.default_resolution((sz, sz, sz))
    idm = coords.identity_map_np((sz, sz, sz))
    spacing = np.array([2.2, 2.2, 2.2])

    splits = [("train", n_train), ("val", n_val), ("test", n_test)]
    disp_bank = []
    counter = 0
    for phase, count in splits:
        ids = []
        for _ in range(count):
            cid = f"syn{counter:03d}"
            counter += 1
            ids.append(cid)
            ct, seg = make_phantom(rng, sz, texture=texture, device=device)
            disp = (deform_model.sample(rng) if deform_model is not None
                    else random_disp(rng, sz, deformation_magnitude,
                                     smooth=deformation_smooth,
                                     device=device))
            phi = torch.from_numpy((idm + disp).astype(np.float32)).to(
                device)[None]
            # target = source warped by phi (SAR; the warp is
            # orientation-free)
            ct_t = torch.from_numpy(ct).to(device)[None, None]
            tgt = (resample.warp_image(ct_t / 1024.0, phi,
                                       zero_boundary=False,
                                       scale_intensity=False)[0, 0]
                   * 1024.0).cpu().numpy()
            tgt_seg = resample.warp_image(
                torch.from_numpy(seg).to(device)[None, None], phi,
                mode="nearest", zero_boundary=True,
                scale_intensity=False)[0, 0].cpu().numpy()
            np.save(os.path.join(pre, f"{cid}_source.npy"), ct)
            np.save(os.path.join(pre, f"{cid}_target.npy"), tgt)
            np.save(os.path.join(pre, f"{cid}_source_seg.npy"), seg)
            np.save(os.path.join(pre, f"{cid}_target_seg.npy"), tgt_seg)
            np.save(os.path.join(pre, f"{cid}_prop.npy"),
                    {"origin": np.zeros(3), "spacing": spacing})

            # DRRs of the SPR-flipped volumes (the DRR tool's convention)
            for name, vol in (("source", ct), ("target", tgt)):
                spr = coords.flip_sar_to_spr(vol).copy()
                att = drr.calc_relative_atten_coef(
                    torch.from_numpy(spr).to(device))
                proj = drr_kernel.project(att, poses, resolution,
                                          tuple(spacing))
                np.save(os.path.join(drr_dir, f"{cid}_{name}_proj.npy"),
                        proj.cpu().numpy())

            # Landmarks with exact correspondence: integer target-side
            # voxels v_t inside the (warped) lung and their source position
            # v_s = phi(v_t) = v_t + disp(v_t) in voxel units; 1-indexed
            # (x, y, z) = (H, W, D) SAR coordinates, DIR-Lab's convention
            vox = np.argwhere(tgt_seg > 0)
            if len(vox) == 0:
                vox = np.argwhere(seg > 0)
            take = vox[rng.choice(len(vox), size=min(60, len(vox)),
                                  replace=False)]
            d_at = disp[:, take[:, 0], take[:, 1], take[:, 2]].T  # (N,3) DWH
            vs = take + d_at * (sz - 1) / 2.0                     # source pos
            tgt_pts = take[:, ::-1].astype(np.float64) + 1.0      # eBH = v_t
            src_pts = vs[:, ::-1] + 1.0                           # iBH = v_s
            for suffix, pts in (("iBH", src_pts), ("eBH", tgt_pts)):
                with open(os.path.join(lm_dir,
                                       f"{cid}_300_{suffix}_xyz_r1.txt"),
                          "w") as f:
                    for p in pts:
                        f.write(f"{p[0]:.4f}\t{p[1]:.4f}\t{p[2]:.4f}\n")

            # the ground-truth map in the model's SPR frame, stored in
            # [0, 1]: phi_spr = mirror_y . phi_sar . mirror_y; the PCA bank
            # holds SPR-frame displacements, the frame the model predicts in
            phi_sar = idm + disp
            phi_spr = phi_sar[:, :, ::-1, :].copy()
            phi_spr[1] = -phi_spr[1]
            disp_bank.append((phi_spr - idm).reshape(-1))
            gt_dir = os.path.join(out, "gt_phi")
            os.makedirs(gt_dir, exist_ok=True)
            np.save(os.path.join(gt_dir, f"{cid}_phi.npy"),
                    ((phi_spr + 1.0) / 2.0).astype(np.float32))
        phase_dir = os.path.join(out, phase)
        os.makedirs(phase_dir, exist_ok=True)
        np.save(os.path.join(phase_dir, "data_id.npy"), np.array(ids))
        if phase == "train":
            dbg = os.path.join(out, "debug")
            os.makedirs(dbg, exist_ok=True)
            np.save(os.path.join(dbg, "data_id.npy"), np.array(ids))
    np.save(os.path.join(drr_dir, "poses.npy"), poses)

    # stddev-scaled components: the coefficients a network regresses are
    # ~N(0, 1)
    vectors, mean = pca_lib.fit_pca(np.stack(disp_bank), latent,
                                    scale_by_stddev=True)
    pca_lib.save_pca(os.path.join(out, "pca"), vectors, mean)
    print(f"synthetic dataset written to {out} "
          f"({n_train} train / {n_val} val / {n_test} test, {sz}^3, "
          f"{n_proj} views, latent {latent})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", "-o", required=True)
    ap.add_argument("--n_train", type=int, default=8)
    ap.add_argument("--n_val", type=int, default=2)
    ap.add_argument("--n_test", type=int, default=2)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--n_proj", type=int, default=4)
    ap.add_argument("--latent", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deformation_rank", type=int, default=0,
                    help="draw deformations from a shared low-rank smooth "
                         "subspace (0 = independent fields)")
    ap.add_argument("--texture",
                    choices=("banded", "broadband", "vascular", "anatomical"),
                    default="banded",
                    help="lung texture: one 4-voxel octave (banded), 2-16 "
                         "voxel octaves (broadband), broadband + vessel "
                         "trees (vascular), or broadband + coarse lobar "
                         "octaves + anchors + vessel trees (anatomical)")
    ap.add_argument("--deformation_magnitude", type=float, default=0.06,
                    help="deformation field scale in normalized units "
                         "(0.12 reaches the DirLab-COPD regime)")
    ap.add_argument("--deformation_smooth", type=int, default=6,
                    help="deformation feature wavelength in voxels "
                         "(~sz/4 is respiratory-like)")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the kernels' plain versions; default "
                         "the CUDA card")
    a = ap.parse_args(argv)
    generate(a.out, a.n_train, a.n_val, a.n_test, a.size, a.n_proj,
             latent=a.latent, seed=a.seed,
             deformation_rank=a.deformation_rank, texture=a.texture,
             deformation_smooth=a.deformation_smooth,
             deformation_magnitude=a.deformation_magnitude,
             device=a.device)


if __name__ == "__main__":
    main()
