"""liftreg_tpu_torch.coords and .ops.drr against liftreg_tpu on the CPU.

Same numpy inputs through both packages; f32 throughout, atol/rtol 1e-5
(the projections are sums of up to W 2-tap products, taken in another
order than XLA's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu import coords as jcoords
from liftreg_tpu.ops import drr as jdrr
from liftreg_tpu_torch import coords as tcoords
from liftreg_tpu_torch.ops import drr as tdrr
from liftreg_tpu_torch.ops import drr_kernel as tdrrk

TOL = dict(atol=1e-5, rtol=1e-5)
VOL = (12, 16, 10)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_identity_map():
    np.testing.assert_allclose(_np(tcoords.identity_map(VOL)),
                               np.asarray(jcoords.identity_map(VOL)), **TOL)


@pytest.mark.parametrize("sz", [(2, 2, 2), (3, 3, 3), (16, 16, 16),
                                (160, 2, 160), (240, 3, 240),
                                (256, 256, 2), (7, 160, 33)])
def test_identity_map_bit_equal(sz):
    """The identity map rounds as jnp.linspace does: bit-equal, not close
    (its pixel coordinates sit on integers, where the warp's gradient
    jumps)."""
    got = tcoords.identity_map(sz)
    np.testing.assert_array_equal(_np(got), np.asarray(jcoords.identity_map(sz)))
    assert tcoords.identity_map(sz, device="cpu") is got


def test_linspace_bit_equal_every_n():
    for n in range(1, 257):
        np.testing.assert_array_equal(
            _np(tcoords.linspace(-1.0, 1.0, n)),
            np.asarray(jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)),
            err_msg=f"n={n}")


@pytest.mark.parametrize("n", [16, 20, 24, 30, 32, 48, 96, 160, 240])
def test_drr_linspace_bit_equal_at_geometry_ranges(n):
    """The ranges of drr.forward_geometry / backward_geometry: detector
    and volume grids centred on 0, and the (reversed) coronal planes."""
    like = torch.zeros(1)
    for lo, hi in ((-n / 2.0, n / 2.0 - 1.0), (n - 1.0, 0.0), (0.0, n - 1.0)):
        np.testing.assert_array_equal(
            _np(tdrr._linspace(lo, hi, n, like)),
            np.asarray(jnp.linspace(lo, hi, n, dtype=jnp.float32)),
            err_msg=f"linspace({lo}, {hi}, {n})")


@pytest.mark.parametrize("fn", ["norm_to_pixel", "pixel_to_norm"])
def test_pixel_norm(fn):
    x = np.random.default_rng(0).uniform(-3, 20, (50,)).astype(np.float32)
    got = getattr(tcoords, fn)(torch.from_numpy(x), 17)
    want = getattr(jcoords, fn)(jnp.asarray(x), 17)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn,lo,hi", [
    ("calc_relative_atten_coef", -1500.0, 500.0),
    ("normalize_drr", -2.0, 8.0),
])
def test_elementwise(fn, lo, hi):
    x = np.random.default_rng(1).uniform(lo, hi, (3, 40)).astype(np.float32)
    got = getattr(tdrr, fn)(torch.from_numpy(x))
    want = getattr(jdrr, fn)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_poses_and_resolution():
    np.testing.assert_array_equal(tdrr.synthesize_poses(30.0, 4, 160),
                                  jdrr.synthesize_poses(30.0, 4, 160))
    assert tdrr.default_resolution((160, 160, 160)) == \
        jdrr.default_resolution((160, 160, 160)) == (240, 240)


def _poses():
    return jdrr.synthesize_poses(30.0, 3, VOL[1])


def test_forward_matrices():
    res = (18, 15)
    got = tdrr.forward_matrices(torch.from_numpy(_poses()), VOL, res,
                                (2.2, 2.0, 1.8))
    want = jdrr.forward_matrices(_poses(), VOL, res, (2.2, 2.0, 1.8))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_backward_matrices():
    got = tdrr.backward_matrices(torch.from_numpy(_poses()), VOL, (18, 15))
    want = jdrr.backward_matrices(_poses(), VOL, (18, 15))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("plane_chunk", [4, 7, 32])
def test_project(plane_chunk):
    vol = np.random.default_rng(2).uniform(0, 0.3, (2,) + VOL).astype(
        np.float32)
    got = tdrrk.project(torch.from_numpy(vol), _poses(), (18, 15),
                       (2.2, 2.2, 2.2), plane_chunk=plane_chunk)
    want = jdrr.project(jnp.asarray(vol), _poses(), (18, 15),
                        (2.2, 2.2, 2.2), plane_chunk=plane_chunk)
    assert got.shape == (2, 3, 18, 15)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("plane_chunk", [5, 16])
def test_backproject(plane_chunk):
    proj = np.random.default_rng(3).uniform(-1, 1, (2, 3, 18, 15)).astype(
        np.float32)
    got = tdrrk.backproject(torch.from_numpy(proj), _poses(), VOL,
                           plane_chunk=plane_chunk)
    want = jdrr.backproject(jnp.asarray(proj), _poses(), VOL,
                            plane_chunk=plane_chunk)
    assert got.shape == (2, 3) + VOL
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_unbatched_project_and_backproject():
    vol = np.random.default_rng(4).uniform(0, 0.3, VOL).astype(np.float32)
    got = tdrrk.project(torch.from_numpy(vol), _poses(), (18, 15))
    want = jdrr.project(jnp.asarray(vol), _poses(), (18, 15))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got = tdrrk.backproject(got, _poses(), VOL)
    want = jdrr.backproject(want, _poses(), VOL)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
