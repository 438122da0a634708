"""The plain versions of the DRR kernels (``ops/drr_kernel.py``) against
liftreg_tpu on the CPU: the Pallas projector and lift in interpret mode and
the XLA products at HIGHEST precision, with ragged plane counts, and pixel
coordinates on the edges of the per-tap zero padding.

Tolerances: atol/rtol 1e-5 (tests/test_pallas_drr.py's), as the two
packages build the pixel coordinates with f32 operations in another order
(an ulp of a coordinate near 26 moves a weight by 2e-6) and sum the f32
products in another order; on coordinates both packages share, the lift
keeps the Pallas test's atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.ops import drr as jdrr
from liftreg_tpu.ops.pallas_drr import (backproject_with_mats_pallas,
                                        project_with_mats_pallas)
from liftreg_tpu_torch.ops import drr
from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps,
                                              backproject_taps_plain,
                                              lift_encoder_input,
                                              project_taps,
                                              project_taps_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
SHARED_LIFT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,res,chunk", [((2, 20, 18, 22), (30, 28), 5),
                                             ((1, 12, 13, 14), (18, 20), 4)])
def test_projector_matches_pallas_and_xla(shape, res, chunk):
    rng = np.random.default_rng(sum(shape))
    B, D, W, H = shape
    vol = rng.uniform(0, 0.4, shape).astype(np.float32)
    poses = jdrr.synthesize_poses(30.0, 3, W)
    spacing = (2.2, 2.0, 2.4)
    Rx, Rz, dx = jdrr.forward_matrices(poses, (D, W, H), res, spacing)
    want_xla = np.asarray(jdrr.project_with_mats(jnp.asarray(vol), Rx, Rz, dx,
                                                 plane_chunk=chunk))
    want_pallas = np.asarray(project_with_mats_pallas(
        jnp.asarray(vol), Rx, Rz, dx, plane_chunk=chunk, interpret=True))
    geometry = drr.forward_geometry(torch.from_numpy(poses), (D, W, H), res,
                                    spacing)
    got = project_taps(torch.from_numpy(vol), *geometry).numpy()
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("vol_shape,det,chunk", [((16, 18, 20), (24, 26), 5),
                                                 ((10, 7, 9), (15, 13), 3)])
def test_lift_matches_pallas_and_xla(vol_shape, det, chunk):
    rng = np.random.default_rng(sum(vol_shape))
    proj = rng.uniform(-1, 1, (2, 3) + det).astype(np.float32)
    poses = jdrr.synthesize_poses(30.0, 3, vol_shape[1])
    Bu, Bv = jdrr.backward_matrices(poses, vol_shape, det)
    want_xla = np.asarray(jdrr.backproject_with_mats(jnp.asarray(proj), Bu,
                                                     Bv, plane_chunk=chunk))
    want_pallas = np.asarray(backproject_with_mats_pallas(
        jnp.asarray(proj), Bu, Bv, plane_chunk=chunk, interpret=True))
    geometry = drr.backward_geometry(torch.from_numpy(poses), vol_shape, det)
    got = backproject_taps(torch.from_numpy(proj), *geometry).numpy()
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def _edge_pix(rng, shape, n):
    """Coordinates in (-1, 0), exactly 0 and n-1, in (n-1, n), beyond, and
    ordinary interior values."""
    special = np.array([-1.5, -1.0, -0.25, 0.0, 0.5, n - 1.0, n - 0.75,
                        n - 1.5, n, n + 2.0], np.float32)
    pix = rng.uniform(-2, n + 1, shape).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.5
    pix[mask] = rng.choice(special, int(mask.sum()))
    return pix


def test_projector_edge_coordinates_match_xla():
    rng = np.random.default_rng(11)
    B, D, W, H, P, rd, rh = 2, 7, 5, 6, 2, 9, 8
    vol = rng.uniform(0, 1, (B, D, W, H)).astype(np.float32)
    x_pix = _edge_pix(rng, (P, W, rd), D)
    z_pix = _edge_pix(rng, (P, W, rh), H)
    dx = rng.uniform(1, 3, (P, rd, rh)).astype(np.float32)
    want = np.asarray(jdrr.project_with_mats(
        jnp.asarray(vol), jdrr._two_tap_matrix(jnp.asarray(x_pix), D),
        jdrr._two_tap_matrix(jnp.asarray(z_pix), H), jnp.asarray(dx)))
    got = project_taps_plain(*map(torch.from_numpy, (vol, x_pix, z_pix, dx)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_lift_edge_coordinates_match_xla():
    rng = np.random.default_rng(12)
    B, P, pw, ph, D, W, H = 2, 2, 7, 6, 5, 4, 9
    proj = rng.uniform(-1, 1, (B, P, pw, ph)).astype(np.float32)
    u_pix = _edge_pix(rng, (P, W, D), pw)
    v_pix = _edge_pix(rng, (P, W, H), ph)
    want = np.asarray(jdrr.backproject_with_mats(
        jnp.asarray(proj), jdrr._two_tap_matrix(jnp.asarray(u_pix), pw),
        jdrr._two_tap_matrix(jnp.asarray(v_pix), ph)))
    got = backproject_taps_plain(*map(torch.from_numpy,
                                      (proj, u_pix, v_pix)))
    np.testing.assert_allclose(got.numpy(), want, **SHARED_LIFT_TOL)


def test_geometry_is_the_dense_matrices():
    poses = drr.synthesize_poses(30.0, 2, 8)
    t = torch.from_numpy(poses)
    x_pix, z_pix, dx = drr.forward_geometry(t, (6, 8, 7), (9, 10),
                                            (2.2,) * 3)
    Rx, Rz, dx2 = drr.forward_matrices(t, (6, 8, 7), (9, 10), (2.2,) * 3)
    assert x_pix.shape == (2, 8, 9) and z_pix.shape == (2, 8, 10)
    assert torch.equal(Rx, drr._two_tap_matrix(x_pix, 6))
    assert torch.equal(Rz, drr._two_tap_matrix(z_pix, 7))
    assert torch.equal(dx, dx2)
    u_pix, v_pix = drr.backward_geometry(t, (6, 8, 7), (9, 10))
    assert u_pix.shape == (2, 8, 6) and v_pix.shape == (2, 8, 7)


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        project_taps(torch.zeros((1, 4, 5, 6)), torch.zeros((2, 4, 3)),
                     torch.zeros((2, 5, 3)), torch.zeros((2, 3, 3)))
    with pytest.raises(ValueError):
        backproject_taps(torch.zeros((1, 2, 4, 4)), torch.zeros((3, 5, 6)),
                         torch.zeros((3, 5, 7)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lift_into_buffer_is_plain_rounded_once(dtype):
    """lift_encoder_input writes the plain lift into channels 1..P, rounded
    once to the buffer's dtype, and the moving CT into channel 0 (exact
    equality)."""
    rng = np.random.default_rng(11)
    vol_shape, det, P = (12, 10, 14), (18, 16), 3
    proj = torch.from_numpy(rng.uniform(-1, 1, (2, P) + det)
                            .astype(np.float32))
    moving = torch.from_numpy(rng.uniform(-1, 1, (2, 1) + vol_shape)
                              .astype(np.float32))
    poses = torch.from_numpy(drr.synthesize_poses(30.0, P, vol_shape[1]))
    geometry = drr.backward_geometry(poses, vol_shape, det)
    buf = lift_encoder_input(moving, proj, *geometry, dtype=dtype)
    assert buf.dtype == dtype and buf.shape == (2, 1 + P) + vol_shape
    want = backproject_taps_plain(proj, *geometry).to(dtype)
    assert torch.equal(buf[:, 1:], want)
    assert torch.equal(buf[:, :1], moving.to(dtype))


def test_lift_rejects_bad_buffers():
    """lift_encoder_input refuses a buffer of another dtype and a moving CT
    whose shape does not match the lift's."""
    proj = torch.zeros((2, 3, 8, 8))
    poses = torch.from_numpy(drr.synthesize_poses(30.0, 3, 6))
    geometry = drr.backward_geometry(poses, (5, 6, 7), (8, 8))
    for moving, dtype in ((torch.zeros((2, 1, 5, 6, 7)), torch.float16),
                          (torch.zeros((2, 1, 5, 6, 8)), torch.float32),
                          (torch.zeros((2, 2, 5, 6, 7)), torch.bfloat16)):
        with pytest.raises(ValueError):
            lift_encoder_input(moving, proj, *geometry, dtype=dtype)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_encoder_input_is_cat_then_cast(compute_dtype):
    """The model's encoder input, built in one buffer by the lift, equals
    the concatenation of the moving CT and the f32 lift cast once, as JAX's
    concatenate(...).astype(compute_dtype)."""
    from liftreg_tpu_torch.models.subspace_backproj import (
        LiftRegSubspaceBackproj)
    rng = np.random.default_rng(12)
    img, det, P = (12, 10, 14), (18, 16), 4
    model = LiftRegSubspaceBackproj(img, latent_dim=3, drr_feature_num=P,
                                    compute_dtype=compute_dtype)
    moving = torch.from_numpy(rng.uniform(-1, 1, (2, 1) + img)
                              .astype(np.float32))
    proj = torch.from_numpy(rng.uniform(-1, 1, (2, P) + det)
                            .astype(np.float32))
    poses = torch.from_numpy(drr.synthesize_poses(30.0, P, img[1]))
    got = model.encoder_input(moving, proj, poses)
    want = torch.cat([moving, model.lift(proj, poses)], dim=1)
    if compute_dtype is not None:
        want = want.to(compute_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("B,P,res", [(4, 4, (240, 240)), (1, 3, (17, 19)),
                                     (30, 4, (240, 240))])
def test_projector_plane_chunks_fit_the_kernel(B, P, res):
    """The projector's wrapper splits the plane loop so that, as the kernel
    splits it (ceil(W / chunks) planes per chunk), no chunk holds more than
    the kernel's table of planes, for any plane count."""
    from liftreg_tpu_torch.ops import drr_kernel
    for W in range(1, 700):
        chunks = drr_kernel._plane_chunks(132, B, P, W, *res)
        assert 1 <= chunks <= W
        assert -(-W // -(-W // chunks)) <= chunks
        assert -(-W // chunks) <= drr_kernel._PROJ_MAX_PLANES
