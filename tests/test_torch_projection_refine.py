"""Projection-domain refinement of the port against liftreg_tpu on the
CPU: ``make_projection_refiner`` on tests/test_refine.py's CBCT-free
problem (the target is the DRR of the attenuation warped by a known
subspace field), ``RegistrationPipeline(refine_domain="projection")``
through ``register`` and ``register_projections`` at 16^3 with the flax
weights carried by ``params_from_jax``, and ``make_refiner`` with LNCC.

Each step differentiates the projector (the plain adjoint here) and, with
``proj_norm="drr"``, the clip, whose ties at 0 are common: a ray that meets
only air projects to exactly 0.

Tolerances: NCC over 10 Adam steps as tests/test_torch_refine.py's
(coefs 1e-4, phi and histories 1e-5, warped 1e-5: the warped attenuation is
~0.2, measured 5e-6, 1e-6, 3e-7 and 7e-7). NGF normalises gradients with
``sqrt(|g|^2 + 1e-10)``, so its slope in flat regions is ~1e5 and f32
differences grow faster over the steps: 4 steps, coefs 5e-4, phi 1e-4,
warped 1e-4, histories 1e-5 (measured 1e-4, 1.7e-5, 1.5e-5 and 7e-7). LNCC
over 5 steps: coefs 1e-4, the rest 1e-5. The pipeline adds the encoder:
phi 1e-4, warped 1e-3, as the image-domain pipeline test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.coords import identity_map as jidentity_map
from liftreg_tpu.models.subspace_backproj import expand_pca as jexpand
from liftreg_tpu.ops import drr as jdrr
from liftreg_tpu.ops import resample as jresample
from liftreg_tpu.refine import make_projection_refiner as jmake_projection
from liftreg_tpu.refine import make_refiner as jmake_refiner
from liftreg_tpu_torch.refine import make_projection_refiner, make_refiner
from test_refine import LATENT, SZ, _problem
from test_torch_refine import KEYS, _batched_problem, _pipeline_case

IMG = (SZ, SZ, SZ)
RES, SPACING = (24, 24), (2.2, 2.2, 2.2)
NCC_TOL = {"coefs": 1e-4, "phi": 1e-5, "warped": 1e-5}
NGF_TOL = {"coefs": 5e-4, "phi": 1e-4, "warped": 1e-4}
HISTORY_TOL = 1e-5


def _projection_problem(proj_norm, batch=2):
    """test_refine's CBCT-free problem for a batch: the moving
    attenuation, and target projections (normalized per ``proj_norm``) of
    the attenuation warped by the subspace field of ``z_true``; element 1
    of a batch of 2 has another field. Starts from small random
    coefficients. Returns numpy (pca, poses, moving attenuation, target
    projections, z0)."""
    pca, moving, _, z_true = _problem(4)
    poses = jdrr.synthesize_poses(30.0, 4, SZ)
    atten = jdrr.calc_relative_atten_coef((jnp.asarray(moving) - 1.0)
                                          * 500.0)
    atten = jnp.concatenate([atten] * batch)
    z_true = jnp.concatenate([z_true, -0.5 * z_true])[:batch]
    disp = jexpand(z_true, pca["vectors"], pca["mean"], IMG)
    warped = jresample.warp_image(atten, disp + jidentity_map(IMG)[None],
                                  zero_boundary=True, scale_intensity=False)
    proj = jdrr.project(warped[:, 0], poses, RES, SPACING)
    if proj_norm == "drr":
        proj = jdrr.normalize_drr(proj)
    elif proj_norm == "minmax":
        proj = (proj - proj.min()) / (proj.max() - proj.min()) * 2.0 - 1.0
    z0 = (np.random.default_rng(1).normal(size=(batch, LATENT)) * 0.05
          ).astype(np.float32)
    return ({k: np.array(v) for k, v in pca.items()}, poses,
            np.array(atten), np.array(proj), z0)


def _run_both(pca, poses, atten, target, z0, **kw):
    want = jmake_projection(IMG, poses, RES, SPACING, **kw)(
        jnp.asarray(z0), {k: jnp.asarray(v) for k, v in pca.items()},
        jnp.asarray(atten), jnp.asarray(target))
    got = make_projection_refiner(IMG, poses, RES, SPACING, **kw)(
        torch.from_numpy(z0), {k: torch.from_numpy(v) for k, v in pca.items()},
        torch.from_numpy(atten), torch.from_numpy(target))
    return got, want


def _assert_close(got, want, tol):
    assert set(got) == set(want)
    for key in KEYS:
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol.get(key, HISTORY_TOL),
                                   err_msg=key)


@pytest.mark.parametrize("sim,proj_norm,steps", [
    ("ncc", "drr", 10), ("ncc", "minmax", 10), ("ncc", None, 10),
    ("ngf", "drr", 4)])
def test_projection_refiner_matches_jax(sim, proj_norm, steps):
    pca, poses, atten, target, z0 = _projection_problem(proj_norm)
    got, want = _run_both(pca, poses, atten, target, z0, sim=sim,
                          proj_norm=proj_norm, n_steps=steps, lr=0.1)
    assert set(got) == set(KEYS)
    assert got["warped"].shape == atten.shape
    _assert_close(got, want, NCC_TOL if sim == "ncc" else NGF_TOL)
    hist = got["total_history"].numpy()
    assert hist[-1] < hist[0]


def test_projection_refiner_early_stop_matches_jax():
    pca, poses, atten, target, z0 = _projection_problem("drr")
    got, want = _run_both(pca, poses, atten, target, z0, n_steps=30, lr=0.1,
                          early_stop_patience=2, early_stop_tol=1e-3)
    steps = int(want["steps_run"])
    assert got["steps_run"] == steps and 1 < steps < 31
    _assert_close(got, want, NCC_TOL)


def test_projection_refiner_rejects_lncc():
    poses = jdrr.synthesize_poses(30.0, 2, SZ)
    with pytest.raises(ValueError, match="3D-volume-only"):
        make_projection_refiner(IMG, poses, RES, sim="lncc")
    with pytest.raises(ValueError, match="proj_norm"):
        make_projection_refiner(IMG, poses, RES, proj_norm="max")


def test_refiner_lncc_matches_jax():
    """Image-domain refinement with the target training configuration's
    similarity, its pre-smoothing and two scales."""
    pca, moving, target, z0 = _batched_problem()
    opts = {"win": 5, "smooth": 3, "scales": [1, 2]}
    want = jmake_refiner(IMG, sim="lncc", sim_opts=opts, n_steps=5, lr=0.1)(
        jnp.asarray(z0), {k: jnp.asarray(v) for k, v in pca.items()},
        jnp.asarray(moving), jnp.asarray(target))
    got = make_refiner(IMG, sim="lncc", sim_opts=opts, n_steps=5, lr=0.1)(
        torch.from_numpy(z0), {k: torch.from_numpy(v) for k, v in pca.items()},
        torch.from_numpy(moving), torch.from_numpy(target))
    _assert_close(got, want, {"coefs": 1e-4, "phi": 1e-5, "warped": 1e-5})
    hist = got["total_history"].numpy()
    assert hist[-1] < hist[0]


@pytest.mark.parametrize("entry", ["register", "register_projections"])
def test_pipeline_projection_refinement_matches_jax(entry):
    jp, params, jpca, tp, tpca, args = _pipeline_case(
        5, refine_lr=0.005, refine_domain="projection")
    src, tgt, seg, _ = args
    if entry == "register":
        jw, jphi = jp.register(params, jpca, *args)
        tw, tphi = tp.register(tpca, *map(torch.from_numpy, args))
    else:
        proj = np.array(jdrr.normalize_drr(jdrr.project(
            jdrr.calc_relative_atten_coef(jnp.asarray(tgt))[:, 0], jp.poses,
            jp.resolution, jp.spacing)))
        jw, jphi = jp.register_projections(params, jpca, src, proj, seg)
        tw, tphi = tp.register_projections(
            tpca, *map(torch.from_numpy, (src, proj, seg)))
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-3)
    res = tp.last_refine
    hist = res["total_history"]
    assert hist.shape == (6,) and bool(hist[-1] <= hist[0])
    # ``warped`` of the refiner is the attenuation; the pipeline returns
    # the masked CT rewarped by the refined phi
    assert res["warped"].shape == tw.shape
    assert float(res["warped"].min()) >= 0.0 and float(tw.min()) < 0.0
    assert torch.equal(res["phi"], tphi)
    assert all(p.grad is None for p in tp.model.parameters())
