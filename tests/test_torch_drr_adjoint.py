"""The projector's adjoint and the projector under autograd, against
liftreg_tpu on the CPU: ``jax.vjp`` of ``drr.project`` (XLA's autodiff of
the einsum chain, the projection refiner's gradient), ``jax.grad`` through
it, and ``normalize_drr``'s gradient at the ends of its clip.

The plain adjoint (``project_adjoint_taps`` on CPU tensors) runs on ragged
shapes, 3 and 4 views and B = 1, 2 and 5, from poses and from pixel
coordinates on the edges of the per-tap zero padding, on integers, in
falling order and in no order (the kernel's run search handles rising,
falling and unordered rows alike; ``tests/test_torch_cuda.py`` holds it to
this plain version).

The adjoint's plan (``project_adjoint_plan`` on CPU tensors: per geometry
row and voxel index, the run of pixels whose tap reaches it) equals a
brute-force search of the nonzeros of JAX's ``_two_tap_matrix``, exactly.

Tolerances: atol/rtol 1e-5 (tests/test_torch_drr_kernels.py's): the two
packages build the coordinates from poses with f32 operations in another
order and sum the f32 products in another order. Gradients through
``project``: rtol 1e-5, atol 1e-6 of the largest component.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.ops import drr as jdrr
from liftreg_tpu_torch.ops import drr
from liftreg_tpu_torch.ops.drr_kernel import (PLAN_EMPTY, PLAN_UNORDERED,
                                              project, project_adjoint_plan,
                                              project_adjoint_taps,
                                              project_adjoint_taps_plain,
                                              project_taps, project_taps_ad)

TOL = dict(rtol=1e-5, atol=1e-5)
SPACING = (2.2, 2.0, 2.4)
# (B, (D, W, H), detector)
SHAPES = [(2, (20, 17, 22), (30, 27)), (1, (13, 9, 11), (21, 19)),
          (5, (12, 10, 14), (18, 16))]


def _pix(rng, shape, n, kind):
    """Pixel coordinates of ``kind``: edge values ((-1, 0), 0, n-1,
    (n-1, n), beyond) among uniform ones, sorted along the detector axis
    (rising, as poses make them) or reversed (falling) or left in no order;
    or integers from -2 to n + 1, sorted."""
    if kind == "integer":
        return np.sort(rng.integers(-2, n + 2, shape), -1).astype(np.float32)
    special = np.array([-1.5, -1.0, -0.25, 0.0, 0.5, n - 1.0, n - 0.75,
                        n - 1.5, n, n + 2.0], np.float32)
    pix = rng.uniform(-2, n + 1, shape).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.4
    pix[mask] = rng.choice(special, int(mask.sum()))
    if kind == "edges":
        return np.sort(pix, -1)
    if kind == "falling":
        return np.sort(pix, -1)[..., ::-1].copy()
    return pix


@pytest.mark.parametrize("B,vol_shape,res", SHAPES)
@pytest.mark.parametrize("views", [3, 4])
@pytest.mark.parametrize("geometry", ["poses", "edges", "integer", "falling",
                                      "unordered"])
def test_adjoint_matches_jax_vjp(B, vol_shape, res, views, geometry):
    rng = np.random.default_rng(sum(vol_shape) + views)
    D, W, H = vol_shape
    vol = rng.uniform(0, 0.4, (B,) + vol_shape).astype(np.float32)
    g = rng.normal(size=(B, views) + res).astype(np.float32)
    if geometry == "poses":
        poses = jdrr.synthesize_poses(30.0, views, W)

        def jfwd(v):
            return jdrr.project(v, poses, res, SPACING)

        geom = drr.forward_geometry(torch.from_numpy(poses), vol_shape, res,
                                    SPACING)
    else:
        x_pix = _pix(rng, (views, W, res[0]), D, geometry)
        z_pix = _pix(rng, (views, W, res[1]), H, geometry)
        dx = rng.uniform(1, 3, (views,) + res).astype(np.float32)
        Rx = jdrr._two_tap_matrix(jnp.asarray(x_pix), D)
        Rz = jdrr._two_tap_matrix(jnp.asarray(z_pix), H)

        def jfwd(v):
            return jdrr.project_with_mats(v, Rx, Rz, jnp.asarray(dx))

        geom = tuple(map(torch.from_numpy, (x_pix, z_pix, dx)))
    _, vjp = jax.vjp(jfwd, jnp.asarray(vol))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = project_adjoint_taps(torch.from_numpy(g), *geom, vol_shape)
    assert got.shape == (B,) + vol_shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("batched", [True, False])
def test_project_gradient_matches_jax(batched):
    """tests/test_drr_grad.py's problem: the gradient of a weighted sum of
    the DRR with respect to the volume, through ``project``."""
    sz, P, res = 10, 2, (15, 15)
    rng = np.random.default_rng(1)
    poses = jdrr.synthesize_poses(20.0, P, sz)
    shape = ((2,) if batched else ()) + (sz, sz, sz)
    vol = rng.uniform(0, 0.4, shape).astype(np.float32)
    w = rng.normal(size=shape[:-3] + (P,) + res).astype(np.float32)

    def jloss(v):
        return jnp.sum(jdrr.project(v, poses, res, (2.2, 2.2, 2.2))
                       * jnp.asarray(w))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(vol)))
    vt = torch.from_numpy(vol).requires_grad_(True)
    loss = (project(vt, poses, res, (2.2, 2.2, 2.2))
            * torch.from_numpy(w)).sum()
    (got,) = torch.autograd.grad(loss, vt)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_normalize_drr_gradient_at_the_clip_matches_jax():
    """jnp.clip's gradient is 1/2 at 0 and at 6; so is the port's."""
    x = np.array([0.0, 3.0, 6.0, -1.0, 7.0, 0.5, 6.0, 0.0], np.float32)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jdrr.normalize_drr(p)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    drr.normalize_drr(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(
        want, np.array([0.5, 1, 0.5, 0, 0, 1, 0.5, 0.5], np.float32) / 3.0)
    np.testing.assert_array_equal(
        drr.normalize_drr(torch.from_numpy(x)).numpy(),
        np.asarray(jdrr.normalize_drr(jnp.asarray(x))))


def test_autograd_backward_is_the_adjoint():
    """The backward of ``project_taps_ad`` is ``project_adjoint_taps`` of
    the cotangent (bit for bit), its forward ``project_taps``; without grad
    it is ``project_taps``."""
    rng = np.random.default_rng(2)
    vol_shape, res, P = (9, 8, 10), (13, 12), 3
    poses = torch.from_numpy(drr.synthesize_poses(30.0, P, vol_shape[1]))
    geom = drr.forward_geometry(poses, vol_shape, res, SPACING)
    vol = torch.from_numpy(rng.uniform(0, 0.4, (2,) + vol_shape)
                           .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, P) + res).astype(np.float32))
    vt = vol.clone().requires_grad_(True)
    out = project_taps_ad(vt, *geom)
    assert torch.equal(out.detach(), project_taps(vol, *geom))
    (dvol,) = torch.autograd.grad(out, vt, g)
    assert torch.equal(dvol, project_adjoint_taps(g, *geom, vol_shape))
    assert torch.equal(dvol, project_adjoint_taps_plain(g, *geom, vol_shape))
    with torch.no_grad():
        assert not project_taps_ad(vt, *geom).requires_grad


def test_adjoint_checks_its_inputs():
    P, W, rd, rh = 2, 5, 7, 6
    x_pix, z_pix = torch.zeros((P, W, rd)), torch.zeros((P, W, rh))
    dx = torch.ones((P, rd, rh))
    with pytest.raises(ValueError):
        project_adjoint_taps(torch.zeros((1, P, rd, rh)), x_pix, z_pix, dx,
                             (4, W + 1, 3))
    with pytest.raises(ValueError):
        project_adjoint_taps(torch.zeros((1, P + 1, rd, rh)), x_pix, z_pix,
                             dx, (4, W, 3))
    geom = (x_pix.requires_grad_(True), z_pix, dx)
    with pytest.raises(NotImplementedError):
        project_taps_ad(torch.zeros((1, 4, W, 3), requires_grad=True), *geom)


def _brute_force_plan(pix, n):
    """(start, count) per row and voxel index from the nonzeros of JAX's
    dense matrix; every entry of a row in no order is PLAN_UNORDERED."""
    nonzero = np.asarray(jdrr._two_tap_matrix(jnp.asarray(pix), n)) > 0
    want = np.zeros(pix.shape[:2] + (n, 2), np.int32)
    for p_ in range(pix.shape[0]):
        for k in range(pix.shape[1]):
            step = np.diff(pix[p_, k])
            if not ((step >= 0).all() or (step <= 0).all()):
                want[p_, k] = (PLAN_UNORDERED, 0)
                continue
            for m in range(n):
                (hits,) = np.nonzero(nonzero[p_, k, :, m])
                if len(hits) == 0:
                    want[p_, k, m] = (PLAN_EMPTY, 0)
                    continue
                # a row in order reaches each voxel from one run of pixels
                assert (np.diff(hits) == 1).all()
                want[p_, k, m] = (hits[0], len(hits))
    return want


@pytest.mark.parametrize("B,vol_shape,res", SHAPES)
@pytest.mark.parametrize("views", [3, 4])
@pytest.mark.parametrize("geometry", ["poses", "edges", "integer", "falling",
                                      "unordered"])
def test_adjoint_plan_matches_brute_force(B, vol_shape, res, views,
                                          geometry):
    rng = np.random.default_rng(sum(vol_shape) + 2 * views)
    D, W, H = vol_shape
    if geometry == "poses":
        poses = torch.from_numpy(drr.synthesize_poses(30.0, views, W))
        x_pix, z_pix, _ = (t.numpy() for t in drr.forward_geometry(
            poses, vol_shape, res, SPACING))
    else:
        x_pix = _pix(rng, (views, W, res[0]), D, geometry)
        z_pix = _pix(rng, (views, W, res[1]), H, geometry)
    got = project_adjoint_plan(torch.from_numpy(x_pix),
                               torch.from_numpy(z_pix), vol_shape)
    assert got.shape == (views, W, D + H, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[:, :, :D].numpy(),
                                  _brute_force_plan(x_pix, D))
    np.testing.assert_array_equal(got[:, :, D:].numpy(),
                                  _brute_force_plan(z_pix, H))


@pytest.mark.parametrize("geometry", ["poses", "falling"])
def test_project_taps_ad_with_a_plan_matches_jax_vjp(geometry):
    """The projector under autograd with the plan built once, as the
    projection refiner passes it: its backward against ``jax.vjp``."""
    rng = np.random.default_rng(3)
    B, vol_shape, res, P = 2, (14, 11, 12), (20, 17), 3
    D, W, H = vol_shape
    vol = rng.uniform(0, 0.4, (B,) + vol_shape).astype(np.float32)
    g = rng.normal(size=(B, P) + res).astype(np.float32)
    if geometry == "poses":
        geom = drr.forward_geometry(
            torch.from_numpy(jdrr.synthesize_poses(30.0, P, W)), vol_shape,
            res, SPACING)
    else:
        geom = tuple(torch.from_numpy(a) for a in (
            _pix(rng, (P, W, res[0]), D, "falling"),
            _pix(rng, (P, W, res[1]), H, "falling"),
            rng.uniform(1, 3, (P,) + res).astype(np.float32)))
    Rx, Rz = (jdrr._two_tap_matrix(jnp.asarray(t.numpy()), n)
              for t, n in ((geom[0], D), (geom[1], H)))
    _, vjp = jax.vjp(lambda v: jdrr.project_with_mats(
        v, Rx, Rz, jnp.asarray(geom[2].numpy())), jnp.asarray(vol))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    plan = project_adjoint_plan(geom[0], geom[1], vol_shape)
    vt = torch.from_numpy(vol).requires_grad_(True)
    (got,) = torch.autograd.grad(project_taps_ad(vt, *geom, plan=plan), vt,
                                 torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_adjoint_plan_checks_its_inputs():
    with pytest.raises(ValueError):
        project_adjoint_plan(torch.zeros((2, 5, 7)), torch.zeros((2, 4, 6)),
                             (3, 5, 3))
    with pytest.raises(ValueError):
        project_adjoint_plan(torch.zeros((2, 5, 7)), torch.zeros((2, 5, 6)),
                             (3, 6, 3))
