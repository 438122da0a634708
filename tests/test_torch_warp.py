"""The port's trilinear warp (liftreg_tpu_torch.ops.warp_kernel plain version
and .ops.resample) against liftreg_tpu on the CPU.

Tolerances: bf16 taps against ``_trilinear_oct_bf16`` atol 1e-6 (same bf16
taps, same f32 weight and sum order; only XLA's fusion of the f32
arithmetic differs); f32 taps against ``_trilinear_quad`` atol 1e-5 (quad
masks z where oct clamps its start, equal in exact arithmetic); against
the Pallas kernel in interpret mode atol 1e-5, on a field inside its
window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu import coords as jcoords
from liftreg_tpu.ops import pallas_warp
from liftreg_tpu.ops import resample as jresample
from liftreg_tpu_torch.ops import resample as tresample
from liftreg_tpu_torch.ops.warp_kernel import (warp_trilinear,
                                               warp_trilinear_plain)


def _field(rng, shape, B, amp, far=0):
    """Pixel coords (B, D, W, H, 3) = identity + smooth displacement of
    ``amp`` voxels; ``far`` positions per batch element are sent up to 60
    voxels outside the volume."""
    import scipy.ndimage as ndi
    D, W, H = shape
    grid = np.stack(np.meshgrid(*[np.arange(n, dtype=np.float32)
                                  for n in shape], indexing="ij"), -1)
    out = np.empty((B, D, W, H, 3), np.float32)
    for b in range(B):
        g = rng.normal(0, 1, (3, 3, 3, 3)).astype(np.float32)
        disp = np.stack([ndi.zoom(g[c], (D / 3, W / 3, H / 3), order=1)
                         for c in range(3)], -1)
        out[b] = grid + amp * disp
        if far:
            flat = out[b].reshape(-1, 3)
            pick = rng.choice(flat.shape[0], far, replace=False)
            flat[pick] = rng.uniform(-60, 60 + max(shape), (far, 3))
    return out


SHAPE = (10, 12, 14)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("taps,ref,atol", [
    ("bfloat16", "oct", 1e-6),
    ("float32", "quad", 1e-5),
])
def test_plain_matches_jax(padding, taps, ref, atol):
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 1, (2, 2) + SHAPE).astype(np.float32)
    px = _field(rng, SHAPE, 2, amp=3.0, far=40)
    jfn = jresample._trilinear_oct_bf16 if ref == "oct" \
        else jresample._trilinear_quad
    want = np.asarray(jfn(jnp.asarray(vol), jnp.asarray(px), padding))
    tdt = getattr(torch, taps)
    got = warp_trilinear_plain(torch.from_numpy(vol).to(tdt),
                               torch.from_numpy(px).reshape(2, -1, 3),
                               border=padding == "border")
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               atol=atol, rtol=0)


def test_plain_matches_pallas_kernel_in_window():
    rng = np.random.default_rng(1)
    shape = (8, 12, 16)
    vol = rng.uniform(-1, 1, (1, 1) + shape).astype(np.float32)
    px = _field(rng, shape, 1, amp=1.0)
    dy, dx = pallas_warp.displacement_window(jnp.asarray(px))
    assert float(dy) <= 3 and float(dx) <= 3
    want = np.asarray(pallas_warp.warp_plane_gather(
        jnp.asarray(vol), jnp.asarray(px), padding="zeros", dy_max=3,
        dx_max=3, interpret=True))
    got = warp_trilinear_plain(torch.from_numpy(vol).bfloat16(),
                               torch.from_numpy(px).reshape(1, -1, 3), False)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               atol=1e-5)


@pytest.mark.parametrize("taps", [None, "bfloat16"])
@pytest.mark.parametrize("zero_boundary", [True, False])
def test_warp_image_matches_jax(taps, zero_boundary):
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (2, 1) + SHAPE).astype(np.float32)
    disp = rng.normal(0, 0.05, (2, 3) + SHAPE).astype(np.float32)
    phi = jcoords.identity_map_np(SHAPE)[None] + disp
    want = np.asarray(jresample.warp_image(
        jnp.asarray(img), jnp.asarray(phi), zero_boundary=zero_boundary,
        taps_dtype=None if taps is None else jnp.bfloat16))
    got = tresample.warp_image(
        torch.from_numpy(img), torch.from_numpy(phi),
        zero_boundary=zero_boundary,
        taps_dtype=None if taps is None else torch.bfloat16)
    # f32: 1e-5 as above, doubled by the [0,1] -> [-1,1] rescale
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-6 if taps else 2e-5)


def test_grid_sample_other_out_shape():
    rng = np.random.default_rng(3)
    vol = rng.uniform(0, 1, (1, 1) + SHAPE).astype(np.float32)
    pts = rng.uniform(-2, 14, (1, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jresample.grid_sample(jnp.asarray(vol),
                                            jnp.asarray(pts)))
    got = tresample.grid_sample(torch.from_numpy(vol), torch.from_numpy(pts))
    assert got.shape == (1, 1, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    taps = torch.zeros((1, 1) + SHAPE)
    pts = torch.zeros((1, 4, 3))
    with pytest.raises(TypeError):
        warp_trilinear(taps.double(), pts, False)
    with pytest.raises(ValueError):
        warp_trilinear(torch.zeros(1, 1, 1, 4, 4), pts, False)
    with pytest.raises(ValueError):
        warp_trilinear(taps, torch.zeros((2, 4, 3)), False)
    with pytest.raises(ValueError):
        tresample.grid_sample(taps, pts.reshape(1, 4, 1, 3), padding="wrap")
