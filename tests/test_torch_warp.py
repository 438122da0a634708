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
from liftreg_tpu_torch.ops.warp_kernel import (check_grad_offsets,
                                               warp_trilinear,
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
        warp_trilinear(torch.zeros(1, 1, 0, 4, 4), pts, False)
    with pytest.raises(ValueError):
        warp_trilinear(taps, torch.zeros((2, 4, 3)), False)
    with pytest.raises(ValueError):
        tresample.grid_sample(taps, pts.reshape(1, 4, 1, 3), padding="wrap")


def _coords_with_kinks(rng, shape, B, M):
    """(B, M, 3) pixel coords spread over each axis and a voxel beyond it,
    a quarter of them on integers (the kinks); an axis of one voxel gets
    coordinates in [-1.5, 1.5] with some exactly 0."""
    cols = []
    for n in shape:
        c = rng.uniform(-1.5, n + 0.5, (B, M)).astype(np.float32)
        cols.append(np.where(rng.uniform(size=(B, M)) < 0.25, np.floor(c), c))
    return np.stack(cols, -1).astype(np.float32)


def _grid_sample_both(vol, coords, cot, padding, taps_dtype):
    """Value and the coordinate gradient of sum(cot * grid_sample) from
    both packages."""
    import jax

    def jfn(c):
        return jnp.sum(jnp.asarray(cot) * jresample.grid_sample(
            jnp.asarray(vol), c, padding=padding, taps_dtype=taps_dtype))

    jc = jnp.asarray(coords)
    want = jresample.grid_sample(jnp.asarray(vol), jc, padding=padding,
                                 taps_dtype=taps_dtype)
    want_grad = jax.grad(jfn)(jc)
    tc = torch.from_numpy(coords).requires_grad_(True)
    got = tresample.grid_sample(torch.from_numpy(vol), tc, padding=padding,
                                taps_dtype=taps_dtype)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), tc)
    return (got.detach().numpy(), np.asarray(want), got_grad.numpy(),
            np.asarray(want_grad))


@pytest.mark.parametrize("shape", [(6, 5, 7), (1, 6, 7), (5, 1, 7),
                                   (5, 6, 1), (1, 1, 4)])
@pytest.mark.parametrize("taps_dtype", ["bfloat16", "float32", None])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_taps_names_and_unit_dims_match_jax(shape, taps_dtype,
                                                        padding):
    """The taps type given by name, as configs carry it, and volumes with a
    spatial dim of 1 (JAX's quad path for D = 1, its generic path for W or
    H = 1, f32 taps there whatever was asked): value and the gradient with
    respect to the coordinates, integer coordinates included. Tolerances:
    value atol 1e-6 (<= 8 f32 products summed in another order), gradient
    atol 1e-5 of its largest component."""
    rng = np.random.default_rng(7)
    vol = rng.uniform(0, 1, (2, 2) + shape).astype(np.float32)
    coords = _coords_with_kinks(rng, shape, 2, 300)
    cot = rng.normal(size=(2, 2, 300)).astype(np.float32)
    got, want, got_grad, want_grad = _grid_sample_both(vol, coords, cot,
                                                       padding, taps_dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def test_grid_sample_rejects_unknown_taps_name():
    with pytest.raises(ValueError):
        tresample.grid_sample(torch.zeros((1, 1, 2, 2, 2)),
                              torch.zeros((1, 4, 3)), taps_dtype="bfloat17")


@pytest.mark.parametrize("taps_shape,M,fits", [
    ((4, 1, 160, 160, 160), 160 ** 3, True),
    ((2, 3, 1024, 1024, 2047), 10 ** 6, True),
    ((1, 1, 1024, 1024, 2048), 10 ** 6, False),
    ((1, 1, 8, 8, 8), 2 ** 31, False),
    ((2 ** 16, 1, 8, 8, 8), 512, False),
])
def test_grad_offset_check_is_a_function_of_the_shape(taps_shape, M, fits):
    """The coordinate-gradient kernel's 32-bit offsets, checked from the
    shape alone (no such volume is allocated)."""
    if fits:
        check_grad_offsets(taps_shape, M)
    else:
        with pytest.raises(ValueError):
            check_grad_offsets(taps_shape, M)
