"""A cell's inputs and weights, drawn from ``--seed`` on the device in a
few large calls: lung-like CT phantoms in HU (the arithmetic of
``tools/torch_make_synthetic_dataset.py``'s banded phantom), each target
the source under a smooth respiratory-scale displacement, their lung
masks, the target DRRs by the benchmark's own projector
(:mod:`portbench.reference.liftreg`), a basis of smooth displacement
modes upsampled from a coarse seeded field, and the encoder's weights
with torch's default initialisation bounds.

Every seed draws the same sizes; only the values change. Each kind of
draw has a generator of its own, so that a larger pool of batches does
not change the weights.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import liftreg as ref

#: the generator streams of a seed
WEIGHTS, BASIS, VOLUMES = 0, 1, 2
#: the phantoms' respiratory displacement: normalized amplitude, and the
#: coarse grid of its smooth field (about a quarter of the volume apart)
DISP_AMPLITUDE, DISP_GRID = 0.04, 4
#: the phantoms' lung texture grid, a quarter of the volume's size
TEXTURE_SMOOTH = 4


def generator(seed, stream, device):
    """A generator on ``device`` for draw ``stream`` of ``seed`` (any whole
    number)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 63, stream])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]) % 2 ** 63)
    return g


def smooth_field(g, shape, low, device):
    """(n, c, *sz) normal draws on a ``low``^3 grid, trilinear (align
    corners) up to ``sz``."""
    coarse = torch.randn(tuple(shape[:2]) + (low,) * 3, generator=g,
                         device=device)
    return F.interpolate(coarse, size=tuple(shape[2:]), mode="trilinear",
                         align_corners=True)


def _ellipsoid(zz, yy, xx, centre, radii):
    return (((zz - centre[0]) / radii[0]) ** 2
            + ((yy - centre[1]) / radii[1]) ** 2
            + ((xx - centre[2]) / radii[2]) ** 2) < 1.0


def phantoms(g, n, sz, device):
    """``n`` source/target pairs of (n, 1, sz, sz, sz) HU volumes and lung
    masks: air at -1024, a body at 30 HU, two lungs at -850 + 60 x a
    smooth texture; the target is the source under a smooth displacement
    (border padding), its mask the warped mask over 1/2."""
    ar = torch.arange(sz, dtype=torch.float32, device=device)
    zz, yy, xx = ar.view(1, -1, 1, 1), ar.view(1, 1, -1, 1), \
        ar.view(1, 1, 1, -1)
    centre = sz / 2.0 + torch.rand((n, 3), generator=g, device=device) * 4.0 \
        - 2.0
    c = [centre[:, k].view(-1, 1, 1, 1) for k in range(3)]
    body = _ellipsoid(zz, yy, xx, c, (0.42 * sz, 0.36 * sz, 0.36 * sz))
    ct = torch.where(body, 30.0, -1024.0)
    seg = torch.zeros_like(ct)
    low = max(2, sz // TEXTURE_SMOOTH)
    for side in (-1.0, 1.0):
        lc = (c[0], c[1] - 0.05 * sz, c[2] + side * 0.17 * sz)
        lung = _ellipsoid(zz, yy, xx, lc, (0.28 * sz, 0.2 * sz, 0.13 * sz))
        tex = smooth_field(g, (n, 1, sz, sz, sz), low, device)[:, 0]
        ct = torch.where(lung, -850.0 + 60.0 * tex, ct)
        seg = torch.where(lung, 1.0, seg)
    ct, seg = ct[:, None], seg[:, None]
    disp = smooth_field(g, (n, 3, sz, sz, sz), DISP_GRID, device) \
        * DISP_AMPLITUDE
    phi = disp + ref.identity_map((sz,) * 3, device)[None]
    target = ref.warp(ct / 1024.0, phi, border=True) * 1024.0
    target_seg = (ref.warp(seg, phi, border=True) > 0.5).float()
    return {"source_hu": ct.contiguous(), "source_seg": seg.contiguous(),
            "target_hu": target.contiguous(),
            "target_seg": target_seg.contiguous()}


def serve_pool(seed, cfg, batch, pool, reference, device, chunk=4):
    """``pool`` batches of ``batch`` pairs: HU volumes, masks and the
    targets' normalized DRRs by ``reference``'s projector."""
    g = generator(seed, VOLUMES, device)
    sz = int(cfg["img_sz"][0])
    out = []
    for _ in range(pool):
        parts = [phantoms(g, min(chunk, batch - b0), sz, device)
                 for b0 in range(0, batch, chunk)]
        item = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        item["target_proj"] = torch.cat([
            reference.drr(item["target_hu"][b0:b0 + chunk])
            for b0 in range(0, batch, chunk)])
        out.append(item)
    return out


def train_pool(seed, cfg, batch, pool, reference, device):
    """``pool`` device batches of ``batch`` distinct cases, as the
    trainer's loaders give them: normalized CTs, lung masks, the target's
    normalized DRRs and the poses."""
    items = serve_pool(seed, cfg, batch, pool, reference, device)
    poses = reference.poses.to(device)
    return [{"source": ref.normalize_hu(it["source_hu"]),
             "target": ref.normalize_hu(it["target_hu"]),
             "source_label": it["source_seg"],
             "target_label": it["target_seg"],
             "target_proj": it["target_proj"],
             "target_poses": poses[None].expand(batch, -1, -1).contiguous()}
            for it in items]


def encoder_shapes(cfg):
    """[(out, in) of each convolution], [(out, in) of each fully
    connected layer] of the encoder for ``cfg``."""
    filters = [int(f) for f in cfg["enc_filters"]]
    convs, c = [], 1 + int(cfg["n_proj"])
    for f in filters:
        convs.append((f, c))
        c = f
    spatial = 1
    for n in cfg["img_sz"]:
        n = int(n)
        for _ in range(len(filters) - 1):
            n = (n - 1) // 2 + 1
        spatial *= n
    fcs, width = [], c * spatial
    for w in list(cfg["fc_widths"]) + [int(cfg["latent_dim"])]:
        fcs.append((int(w), width))
        width = int(w)
    return convs, fcs


def weights(seed, cfg, device):
    """The encoder's f32 weights: each tensor uniform in
    +-1/sqrt(fan_in), from one draw. ``{"convs": [(w, b)], "fcs":
    [(w, b)]}``."""
    convs, fcs = encoder_shapes(cfg)
    shapes = []
    for co, ci in convs:
        shapes += [((co, ci, 3, 3, 3), ci * 27), ((co,), ci * 27)]
    for co, ci in fcs:
        shapes += [((co, ci), ci), ((co,), ci)]
    total = sum(math.prod(s) for s, _ in shapes)
    flat = torch.rand(total, generator=generator(seed, WEIGHTS, device),
                      device=device) * 2.0 - 1.0
    tensors, at = [], 0
    for shape, fan_in in shapes:
        n = math.prod(shape)
        tensors.append((flat[at:at + n] / math.sqrt(fan_in)).view(shape))
        at += n
    pairs = list(zip(tensors[::2], tensors[1::2]))
    return {"convs": pairs[:len(convs)], "fcs": pairs[len(convs):]}


def state_dict(w):
    """The weights under the port's parameter names
    (``LiftRegSubspaceBackproj``'s encoder)."""
    sd = {}
    for i, (wt, b) in enumerate(w["convs"]):
        sd[f"encoder.convs.{i}.conv.weight"] = wt
        sd[f"encoder.convs.{i}.conv.bias"] = b
    for j, (wt, b) in enumerate(w["fcs"]):
        sd[f"encoder.fcs.{j}.linear.weight"] = wt
        sd[f"encoder.fcs.{j}.linear.bias"] = b
    return sd


def basis(seed, cfg, device, rows=8):
    """(vectors (L, 3*D*W*H) in the configuration's basis type, mean
    (3*D*W*H,) f32): each mode a coarse normal field on a
    ``basis_grid``^3 grid, trilinear up to the volume, scaled to a largest
    value of ``basis_amplitude``; the mean the same at
    ``mean_amplitude``."""
    g = generator(seed, BASIS, device)
    sz = tuple(int(n) for n in cfg["img_sz"])
    L, low = int(cfg["latent_dim"]), int(cfg["basis_grid"])
    dtype = getattr(torch, cfg["pca_dtype"])

    def modes(n, amp):
        f = smooth_field(g, (n, 3) + sz, low, device)
        f = f / f.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
        return (f * amp).reshape(n, -1)

    vectors = torch.cat([modes(min(rows, L - r0),
                               float(cfg["basis_amplitude"])).to(dtype)
                         for r0 in range(0, L, rows)])
    mean = modes(1, float(cfg["mean_amplitude"]))[0].contiguous()
    return vectors.contiguous(), mean
