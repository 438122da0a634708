"""Refinement on the port's data mesh against the JAX package's on the
CPU: ``make_refiner`` with early stop on 2 gloo ranks against
liftreg_tpu's ``make_refiner(mesh=make_mesh(2))`` on the same batch of 4
sharded over the conftest's CPU devices (tests/test_refine.py's problem:
rows 0-1, rank 0's, to register, rows 2-3, rank 1's, already aligned, so
that the ranks alone would stop at other steps),
``make_projection_refiner`` with ``proj_norm="minmax"`` (the extremes of
the simulated projections over the global batch) on 2 ranks against
JAX's with ``mesh=make_mesh(2)`` (tests/test_torch_projection_refine.py's
problem at B = 4: four fields of the subspace, targets min-max
normalised over the batch), a refined
``RegistrationPipeline.register`` with early stop on 2 ranks against the
JAX pipeline with ``mesh=make_mesh(2)``, both at 16^3 from the same flax
weights (``params_from_jax``), and a two-level ``DenseRegisterer`` (bf16
taps, B = 4 at 24^3) on 2 ranks against JAX's with ``mesh=make_mesh(2)``.

The mesh's refiner divides each rank's objective by the global batch and
stops when no row of either rank improved: its steps, histories (global
means) and every row's output are JAX's. The negative control runs the
same refiner on each rank with no collective: the ranks then stop at
other steps; and the projection refiner likewise, each rank normalising
by its own extremes, which moves the coefficients by ~0.5 (measured 1.2e-6
from JAX with the mesh's). The projection case refines by NGF with eps
1e-2, not the defaults' NCC or NGF: those are invariant to a positive
affine map of each row, so no min-max could change their result.

Tolerances as tests/test_torch_refine.py's: coefs 1e-4, phi and
histories 1e-5, warped 1e-4 for the refiner; the projection refiner's
(NGF with eps 1e-2, 10 steps) tests/test_torch_projection_refine.py's
NCC ones (coefs 1e-4, phi, warped and histories 1e-5), tighter than its
NGF ones; the pipeline phi 1e-4 and warped 1e-3; the registerer's
as tests/test_torch_optreg.py's: grids, phi and disp 1e-4, warped 5e-4,
histories 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liftreg_tpu import optreg as joptreg
from liftreg_tpu.coords import identity_map as jidentity_map
from liftreg_tpu.models.subspace_backproj import expand_pca as jexpand
from liftreg_tpu.ops import drr as jdrr
from liftreg_tpu.ops import resample as jresample
from liftreg_tpu.parallel import mesh as jmesh
from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline
from liftreg_tpu.refine import make_projection_refiner as jmake_projection
from liftreg_tpu.refine import make_refiner as jmake_refiner
from liftreg_tpu_torch import params_from_jax
from liftreg_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks
from test_refine import LATENT, SZ, _problem, _smooth_basis
from test_torch_optreg import SZ as OPTREG_SZ
from test_torch_optreg import _pair
from test_torch_projection_refine import HISTORY_TOL, NCC_TOL, RES, SPACING
from test_torch_refine import KEYS, TOL

IMG = (SZ, SZ, SZ)
ROWS = ("coefs", "phi", "warped", "total_per_sample", "sim_per_sample")
REFINE_OPTS = dict(n_steps=30, lr=0.1, early_stop_patience=2,
                   early_stop_tol=2e-2)
PIPELINE_OPTS = dict(latent_dim=LATENT, refine_steps=30, refine_lr=0.005,
                     refine_early_stop_patience=2,
                     refine_early_stop_tol=1e-4)
OPTREG_LEVELS = ((6, 3, 0.04), (12, 3, 0.02))
# NGF with an eps near the projections' squared gradients: the NCC and
# NGF of the defaults are invariant to a positive affine map of each
# row, and so to the min-max normalisation's extremes; this one is not
PROJECTION_OPTS = dict(sim="ngf", sim_opts={"eps": 1e-2},
                       proj_norm="minmax", n_steps=10, lr=0.1)


def _refine_inputs():
    pca, moving, target, _ = _problem(2)
    moving4 = np.concatenate([np.asarray(moving)] * 4)
    target4 = np.concatenate([np.asarray(target)] * 2
                             + [np.asarray(moving)] * 2)
    z0 = (np.random.default_rng(1).normal(size=(4, LATENT)) * 0.05
          ).astype(np.float32)
    return {k: np.array(v) for k, v in pca.items()}, (z0, moving4, target4)


def _projection_inputs():
    """tests/test_torch_projection_refine.py's CBCT-free problem at B = 4:
    the moving attenuation, scaled by another factor in each row (so that
    rank 1's rows lack the global maximum; every row has the minimum 0 of
    the rays that miss the volume), target projections of it warped by
    four multiples of the subspace field of ``z_true``, min-max normalised
    over the batch, small random starts. Returns numpy (pca, poses, (z0,
    atten, target))."""
    pca, moving, _, z_true = _problem(4)
    poses = np.asarray(jdrr.synthesize_poses(30.0, 4, SZ))
    atten = jdrr.calc_relative_atten_coef((jnp.asarray(moving) - 1.0)
                                          * 500.0)
    atten = jnp.concatenate([s * atten for s in (1.0, 0.9, 0.7, 0.6)])
    z = jnp.concatenate([s * z_true for s in (1.0, -0.5, 0.25, -1.0)])
    disp = jexpand(z, pca["vectors"], pca["mean"], IMG)
    warped = jresample.warp_image(atten, disp + jidentity_map(IMG)[None],
                                  zero_boundary=True, scale_intensity=False)
    proj = jdrr.project(warped[:, 0], poses, RES, SPACING)
    proj = (proj - proj.min()) / (proj.max() - proj.min()) * 2.0 - 1.0
    z0 = (np.random.default_rng(5).normal(size=(4, LATENT)) * 0.05
          ).astype(np.float32)
    return ({k: np.array(v) for k, v in pca.items()}, poses,
            (z0, np.array(atten), np.array(proj)))


def _pipeline_inputs():
    rng = np.random.default_rng(3)
    V = np.asarray(_smooth_basis(rng, LATENT, SZ)) * 100.0
    pca = {"vectors": V, "mean": np.zeros(3 * SZ ** 3, np.float32)}

    def smooth(v):
        for ax in (2, 3, 4):
            v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3.0
        return v.astype(np.float32)

    src = smooth(rng.uniform(-1000, 0, (4, 1) + IMG))
    tgt = smooth(rng.uniform(-1000, 0, (4, 1) + IMG))
    seg = (rng.uniform(size=(4, 1) + IMG) > 0.2).astype(np.float32)
    return pca, (src, tgt, seg, seg)


@pytest.fixture(scope="module")
def runs():
    mesh = jmesh.make_mesh(2)
    sharded = lambda arrays: [jax.device_put(  # noqa: E731
        jnp.asarray(a), jmesh.batch_sharding(mesh)) for a in arrays]
    pca, refine_inputs = _refine_inputs()
    jpca = {k: jnp.asarray(v) for k, v in pca.items()}
    want_refine = jmake_refiner(IMG, mesh=mesh, **REFINE_OPTS)(
        *sharded(refine_inputs[:1]), jpca, *sharded(refine_inputs[1:]))
    proj_pca, poses, proj_inputs = _projection_inputs()
    want_projection = jmake_projection(
        IMG, poses, RES, SPACING, mesh=mesh, **PROJECTION_OPTS)(
        *sharded(proj_inputs[:1]),
        {k: jnp.asarray(v) for k, v in proj_pca.items()},
        *sharded(proj_inputs[1:]))
    ppca, pipeline_inputs = _pipeline_inputs()
    jp = JPipeline(IMG, mesh=mesh, **PIPELINE_OPTS)
    jppca = {k: jnp.asarray(v) for k, v in ppca.items()}
    params = jp.init_params(jax.random.PRNGKey(2), jppca)
    want_pipe = jp.register(params, jppca, *sharded(pipeline_inputs))
    optreg_inputs = _pair(1, B=4)
    want_optreg = joptreg.DenseRegisterer(
        OPTREG_SZ, levels=OPTREG_LEVELS, warp_taps_dtype=jnp.bfloat16,
        mesh=mesh)(*sharded(optreg_inputs))
    case = {"img": IMG, "pca": pca, "refine_inputs": refine_inputs,
            "refine_opts": REFINE_OPTS, "rows": ROWS,
            "projection": {"pca": proj_pca, "poses": poses, "res": RES,
                           "spacing": SPACING, "opts": PROJECTION_OPTS,
                           "inputs": proj_inputs},
            "pipeline_opts": PIPELINE_OPTS, "pipeline_pca": ppca,
            "pipeline_inputs": pipeline_inputs,
            "optreg": {"img": OPTREG_SZ, "levels": OPTREG_LEVELS,
                       "inputs": optreg_inputs},
            "state": {k: v.numpy() for k, v in params_from_jax(
                jax.tree_util.tree_map(np.asarray, params)).items()}}
    return {"ranks": launch(ranks.refine_suite, 2, device="cpu",
                            args=(case,)),
            "refine": want_refine, "projection": want_projection,
            "pipeline": want_pipe,
            "optreg": want_optreg}


def test_sharded_refiner_matches_jax_mesh(runs):
    want = runs["refine"]
    steps = int(want["steps_run"])
    assert 1 < steps < REFINE_OPTS["n_steps"] + 1
    for r in runs["ranks"]:
        got = r["refiner"]
        assert got["steps_run"] == steps
        for key in KEYS:
            a, b = got[key], np.asarray(want[key])
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL[key],
                                       err_msg=key)


def test_rank_local_early_stop_fails(runs):
    """Negative control: without the early stop's reduction the ranks stop
    at different steps, and not both at JAX's."""
    local = [r["rank_local_steps_run"] for r in runs["ranks"]]
    assert local[0] != local[1]
    assert local != [int(runs["refine"]["steps_run"])] * 2


def test_sharded_projection_refiner_matches_jax_mesh(runs):
    """The min-max normalisation takes the extremes of the global batch:
    each rank's own extremes would move every row of the rank that lacks
    the global minimum or maximum."""
    want = runs["projection"]
    proj = runs["ranks"][0]["projection"]
    assert set(proj) == set(KEYS)
    for r in runs["ranks"]:
        got = r["projection"]
        for key in KEYS:
            a, b = got[key], np.asarray(want[key])
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=NCC_TOL.get(key, HISTORY_TOL),
                                       err_msg=key)
    hist = proj["total_history"]
    assert hist[-1] < hist[0]


def test_rank_local_extremes_fail(runs):
    """Negative control: each rank normalising by its own rows' extremes
    moves the refined coefficients past the tolerance."""
    want = np.asarray(runs["projection"]["coefs"])
    for r in runs["ranks"]:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(r["rank_local_projection_coefs"],
                                       want, rtol=0, atol=NCC_TOL["coefs"])


def test_sharded_register_matches_jax_mesh(runs):
    jw, jphi = runs["pipeline"]
    got = [r["pipeline"] for r in runs["ranks"]]
    assert got[0]["steps_run"] == got[1]["steps_run"]
    assert got[0]["steps_run"] < PIPELINE_OPTS["refine_steps"] + 1
    for g in got:
        np.testing.assert_allclose(g["phi"], np.asarray(jphi), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g["warped"], np.asarray(jw), rtol=0,
                                   atol=1e-3)


def test_sharded_dense_registerer_matches_jax_mesh(runs):
    want = runs["optreg"]
    for r in runs["ranks"]:
        got = r["optreg"]
        for key in ("z", "coefs", "phi", "disp"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=0, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(got["warped"], np.asarray(want["warped"]),
                                   rtol=0, atol=5e-4)
        for key in ("total_history", "sim_history", "total_per_sample"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=0, atol=2e-6, err_msg=key)
