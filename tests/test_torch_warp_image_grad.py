"""The warp's gradient with respect to the image (ROADMAP B2) against
liftreg_tpu on the CPU: ``jax.vjp`` of ``resample.warp_image`` and
``resample.grid_sample`` with f32 taps (the path RegNet2D3D
differentiates: XLA's autodiff of ``_quad_plain``, or of the generic path
when W or H is 1), against :func:`warp_image_grad_plain` and autograd of
the port's ``warp_image``.

The volumes have 9/17/9 voxels so that ``(phi + 1) * (n - 1) / 2`` is
exact in f32 in both frameworks and integer coordinates stay integers.
Tolerance: atol 1e-6 * max|grad|, rtol 0 (each tap sums up to a few dozen
f32 terms in another order than XLA's scatter).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.ops import resample as jresample
from liftreg_tpu_torch.ops import resample
from liftreg_tpu_torch.ops.warp_kernel import (warp_image_grad,
                                               warp_image_grad_plain,
                                               warp_trilinear_ad)

SZ = (9, 17, 9)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _pix(rng, B, spatial, out_shape, kind):
    """(B, *out_shape, 3) pixel coordinates: smooth values around the
    volume, integers (inside, on the faces and beyond), or points far
    outside mixed with points on the edges."""
    n = np.array(spatial, np.float32)
    shape = (B,) + tuple(out_shape) + (3,)
    if kind == "smooth":
        return (rng.uniform(-1.5, 1.0, shape)
                + rng.uniform(0, 1, shape) * (n - 1) + 0.37).astype(
                    np.float32)
    if kind == "integer":
        return rng.integers(-2, 3, shape).astype(np.float32) \
            + np.floor(rng.uniform(0, 1, shape) * n).astype(np.float32)
    pts = rng.uniform(-1, 1, shape).astype(np.float32) * 3 * n
    # -1, -0.5, 0 and n - 1, n - 0.5, n on each axis
    edges = np.array([-1.0, -0.5, 0.0], np.float32)
    pick = rng.integers(0, 6, shape)
    special = np.where(pick < 3, edges[pick % 3], n - 1 - edges[pick % 3])
    return np.where(rng.uniform(size=shape) < 0.5, special, pts).astype(
        np.float32)


@pytest.mark.parametrize("spatial", [SZ, (1, 17, 9), (9, 1, 9), (9, 17, 1)])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", ["smooth", "integer", "far"])
def test_grid_sample_image_grad_matches_jax(spatial, padding, C, kind):
    rng = np.random.default_rng(zlib.crc32(repr((spatial, padding, C,
                                                  kind)).encode()))
    B, out_shape = 2, (5, 7, 3)
    vol = rng.uniform(-1, 1, (B, C) + spatial).astype(np.float32)
    pix = _pix(rng, B, spatial, out_shape, kind)
    g = rng.normal(size=(B, C) + out_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jresample.grid_sample(
        v, jnp.asarray(pix), padding=padding), jnp.asarray(vol))
    (want,) = vjp(jnp.asarray(g))
    got = warp_image_grad_plain(torch.from_numpy(vol),
                                torch.from_numpy(pix).reshape(B, -1, 3),
                                torch.from_numpy(g).reshape(B, C, -1),
                                border=padding == "border")
    _close(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version
    again = warp_image_grad(torch.from_numpy(vol),
                            torch.from_numpy(pix).reshape(B, -1, 3),
                            torch.from_numpy(g).reshape(B, C, -1),
                            padding == "border")
    assert torch.equal(got, again)
    # and so is autograd of the port's grid_sample
    v_t = torch.from_numpy(vol).requires_grad_(True)
    out = resample.grid_sample(v_t, torch.from_numpy(pix), padding=padding)
    (out * torch.from_numpy(g)).sum().backward()
    _close(v_t.grad.numpy(), want)


@pytest.mark.parametrize("zero_boundary", [True, False])
@pytest.mark.parametrize("scale_intensity", [True, False])
@pytest.mark.parametrize("C", [1, 3])
def test_warp_image_grad_matches_jax_vjp(zero_boundary, scale_intensity, C):
    """Both the image and phi differentiated, as in RegNet2D3D's inverse
    flow: the image gradient through the phi layout and the
    ``scale_intensity`` glue."""
    rng = np.random.default_rng(7 + C + 2 * zero_boundary
                                + 4 * scale_intensity)
    B = 2
    img = rng.uniform(-1, 1, (B, C) + SZ).astype(np.float32)
    axes = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32)
                         for n in SZ], indexing="ij")
    phi = (np.stack(axes)[None] + rng.uniform(-0.3, 0.3, (B, 3) + SZ)
           ).astype(np.float32)
    phi[0, :, 0] = 2.5                      # a plane far outside
    g = rng.normal(size=(B, C) + SZ).astype(np.float32)
    _, vjp = jax.vjp(lambda i, p: jresample.warp_image(
        i, p, zero_boundary=zero_boundary, scale_intensity=scale_intensity),
        jnp.asarray(img), jnp.asarray(phi))
    want_img, want_phi = vjp(jnp.asarray(g))
    i_t = torch.from_numpy(img).requires_grad_(True)
    p_t = torch.from_numpy(phi).requires_grad_(True)
    out = resample.warp_image(i_t, p_t, zero_boundary=zero_boundary,
                              scale_intensity=scale_intensity)
    (out * torch.from_numpy(g)).sum().backward()
    _close(i_t.grad.numpy(), want_img)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want_phi),
                               rtol=0,
                               atol=2e-5 * np.abs(np.asarray(want_phi)).max())
    # the plain version in the phi layout, with the glue's factors
    dtaps = warp_image_grad_plain(
        resample.warp_taps(torch.from_numpy(img), scale_intensity),
        torch.from_numpy(phi), torch.from_numpy(g), not zero_boundary,
        normalized=True, scale_intensity=scale_intensity)
    factor = 0.5 if scale_intensity else 1.0
    _close(dtaps.numpy() * factor, want_img)


def test_zero_padding_masks_add_exactly_zero():
    """Points far outside under zeros padding reach no tap: the gradient
    is exactly 0; under border padding they land on the faces."""
    vol = torch.zeros((1, 2) + SZ)
    pix = torch.tensor([[[40.0, 50.0, -30.0], [-9.0, 8.0, 4.0],
                         [4.0, -1.0, 100.0]]])
    g = torch.ones((1, 2, 3))
    assert torch.count_nonzero(warp_image_grad_plain(vol, pix, g, False)) \
        == 0
    border = warp_image_grad_plain(vol, pix, g, True)
    assert float(border.sum()) == pytest.approx(6.0)


def test_bf16_taps_image_gradient_raises():
    img = torch.zeros((1, 1, 4, 4, 4), dtype=torch.bfloat16,
                      requires_grad=True)
    coords = torch.zeros((1, 8, 3))
    with pytest.raises(NotImplementedError, match="B2"):
        warp_trilinear_ad(img, coords, False)
    with pytest.raises(NotImplementedError, match="B2"):
        warp_image_grad(img.detach(), coords, torch.zeros((1, 1, 8)), False)
