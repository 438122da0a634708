"""Per-case refinement of the port against liftreg_tpu on the CPU:
``make_refiner`` on ``tests/test_refine.py``'s problem and
``RegistrationPipeline(refine_steps=...)`` at 16^3 with the flax weights
carried by ``params_from_jax``.

The port's identity map rounds as the JAX package's does inside ``jit``
(``liftreg_tpu_torch/coords.py:linspace_in_jit``, held bit-equal in
tests/test_torch_coords_drr.py and test_torch_linspace_jit.py), so a refinement from zero coefficients,
where phi is the identity map and its pixel coordinates sit on integers
(the warp's kinks), takes the same subgradients in both packages:
``test_refiner_from_zero_matches_jax``. The kink conventions themselves
are held in tests/test_torch_grads.py. The batched tests start from small
random coefficients: element 1 of the batched problem is already aligned,
so from zero Adam's first step would normalise a near-zero gradient.

Tolerances: f32 basis and taps, 10 Adam steps: coefs atol 1e-4, phi and
histories atol 1e-5, warped atol 1e-4 (measured 7e-6, 2e-6 and 1.3e-5: f32
sums in another order, compounded over the steps). The pipeline adds the
encoder (f32 convolutions in another order): coefs and phi atol 1e-4,
warped atol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline
from liftreg_tpu.refine import make_refiner as jmake_refiner
from liftreg_tpu_torch import RegistrationPipeline, params_from_jax
from liftreg_tpu_torch.refine import _build_refine, make_refiner
from test_refine import LATENT, SZ, _problem, _smooth_basis

IMG = (SZ, SZ, SZ)
KEYS = ("coefs", "phi", "warped", "total_history", "sim_history",
        "total_per_sample", "sim_per_sample")
TOL = {"coefs": 1e-4, "phi": 1e-5, "warped": 1e-4, "total_history": 1e-5,
       "sim_history": 1e-5, "total_per_sample": 1e-5,
       "sim_per_sample": 1e-5}


def _batched_problem():
    """test_refine's batched case: element 1 is already aligned."""
    pca, moving, target, _ = _problem(2)
    moving2 = np.concatenate([np.asarray(moving)] * 2)
    target2 = np.concatenate([np.asarray(target), np.asarray(moving)])
    z0 = (np.random.default_rng(1).normal(size=(2, LATENT)) * 0.05
          ).astype(np.float32)
    return {k: np.array(v) for k, v in pca.items()}, moving2, target2, z0


def _run_both(pca, moving, target, z0, **kw):
    want = jmake_refiner(IMG, **kw)(
        jnp.asarray(z0), {k: jnp.asarray(v) for k, v in pca.items()},
        jnp.asarray(moving), jnp.asarray(target))
    got = make_refiner(IMG, **kw)(
        torch.from_numpy(z0), {k: torch.from_numpy(v) for k, v in pca.items()},
        torch.from_numpy(moving), torch.from_numpy(target))
    return got, want


@pytest.mark.parametrize("fast_vjp", [False, True])
def test_refiner_matches_jax(fast_vjp):
    got, want = _run_both(*_batched_problem(), n_steps=10, lr=0.1,
                          fast_vjp=fast_vjp)
    assert set(got) == set(want) == set(KEYS)
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=TOL[key], err_msg=key)
    hist = got["total_history"].numpy()
    assert hist[-1] <= hist[0]


def test_refiner_from_zero_matches_jax():
    """test_refine's single-case problem (sample 0) from zero coefficients:
    phi starts at the identity map, on the warp's kinks."""
    pca, moving, target, _ = _problem(0)
    z0 = np.zeros((1, LATENT), np.float32)
    got, want = _run_both({k: np.array(v) for k, v in pca.items()},
                          np.asarray(moving), np.asarray(target), z0,
                          n_steps=10, lr=0.1)
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=TOL[key], err_msg=key)
    hist = got["total_history"].numpy()
    assert hist[-1] < hist[0]


def test_refiner_early_stop_matches_jax():
    pca, moving, target, z0 = _batched_problem()
    got, want = _run_both(pca, moving, target, z0, n_steps=30, lr=0.1,
                          early_stop_patience=2, early_stop_tol=2e-2)
    steps = int(want["steps_run"])
    assert got["steps_run"] == steps and 1 < steps < 31
    for key in KEYS:
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL[key], err_msg=key)


def test_refiner_bf16_basis_and_taps_matches_jax():
    """The serving types: bf16 basis (PCA kernel and its backward on the
    card) and bf16 taps. The backward rounds dcoefs to bf16, so the Adam
    trajectories agree less tightly: coefs atol 1e-3, the rest 1e-4."""
    pca, moving, target, z0 = _batched_problem()
    jp = {"vectors": jnp.asarray(pca["vectors"], jnp.bfloat16),
          "mean": jnp.asarray(pca["mean"])}
    want = jmake_refiner(IMG, n_steps=5, lr=0.1,
                         warp_taps_dtype=jnp.bfloat16)(
        jnp.asarray(z0), jp, jnp.asarray(moving), jnp.asarray(target))
    tp = {"vectors": torch.from_numpy(pca["vectors"]).bfloat16(),
          "mean": torch.from_numpy(pca["mean"])}
    got = make_refiner(IMG, n_steps=5, lr=0.1,
                       warp_taps_dtype=torch.bfloat16)(
        torch.from_numpy(z0), tp, torch.from_numpy(moving),
        torch.from_numpy(target))
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-3 if key == "coefs"
                                   else 1e-4, err_msg=key)


def test_best_iterate_is_per_sample_and_skips_nan():
    """Sample 0's objective is NaN anywhere but at z_0: it keeps z_0;
    sample 1 improves."""
    target = torch.tensor([[1.0, -2.0], [0.5, 0.5]])
    calls = []

    def losses(z):
        per = ((z - target) ** 2).sum(dim=1)
        moved = bool((z[0] != 0).any())
        per = torch.stack([per[0] * (float("nan") if moved else 1.0),
                           per[1]])
        calls.append(1)
        return per, (per, z, z)

    z0 = torch.zeros((2, 2))
    res = _build_refine(losses, 0.1, 4)(z0)
    assert torch.equal(res["coefs"][0], z0[0])
    assert not torch.equal(res["coefs"][1], z0[1])
    assert len(calls) == 4 + 1 + 1
    assert res["total_per_sample"][0] == (target[0] ** 2).sum()
    assert res["total_per_sample"][1] < (target[1] ** 2).sum()


@pytest.mark.parametrize("taps", [None, "bfloat16"])
def test_hoisted_taps_match_taps_built_every_step(monkeypatch, taps):
    """make_refiner builds the moving image's tap tensor once per call,
    outside the step loop; the result is bit-equal to the same loop
    building it in every step through resample.warp_image (the port's
    losses written out)."""
    from liftreg_tpu_torch.coords import identity_map
    from liftreg_tpu_torch.losses.registration import displacement_reg
    from liftreg_tpu_torch.losses.similarity import ncc_loss
    from liftreg_tpu_torch.models.subspace_backproj import expand_pca
    from liftreg_tpu_torch.ops import resample

    pca, moving, target, z0 = _batched_problem()
    tp = {k: torch.from_numpy(v) for k, v in pca.items()}
    tdt = None if taps is None else torch.bfloat16
    args = (torch.from_numpy(z0), tp, torch.from_numpy(moving),
            torch.from_numpy(target))

    def every_step(coefs, pca_, moving_, target_):
        disp = expand_pca(coefs, pca_["vectors"], pca_["mean"], IMG)
        phi = disp + identity_map(IMG)[None]
        warped = resample.warp_image(moving_, phi, taps_dtype=tdt)
        sim = ncc_loss(warped, target_, reduction="none")
        total = sim + 1e-3 * displacement_reg(disp, reduction="none")
        return total, (sim, phi, warped)

    want = _build_refine(every_step, 0.1, 4)(*args)
    built = []
    warp_taps = resample.warp_taps
    monkeypatch.setattr(resample, "warp_taps",
                        lambda *a, **kw: built.append(1) or warp_taps(*a,
                                                                      **kw))
    got = make_refiner(IMG, n_steps=4, lr=0.1, warp_taps_dtype=tdt)(*args)
    assert len(built) == 1
    for key in KEYS:
        assert torch.equal(got[key], want[key]), key


def _pipeline_case(refine_steps, **kw):
    rng = np.random.default_rng(3)
    n = 3 * SZ ** 3
    V = np.asarray(_smooth_basis(rng, LATENT, SZ)) * 100.0
    mean = np.zeros(n, np.float32)

    def smooth(v):
        for ax in (2, 3, 4):
            v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3.0
        return v.astype(np.float32)

    src = smooth(rng.uniform(-1000, 0, (2, 1) + IMG))
    tgt = smooth(rng.uniform(-1000, 0, (2, 1) + IMG))
    seg = (rng.uniform(size=(2, 1) + IMG) > 0.2).astype(np.float32)
    jp = JPipeline(IMG, latent_dim=LATENT, refine_steps=refine_steps, **kw)
    jpca = {"vectors": jnp.asarray(V), "mean": jnp.asarray(mean)}
    params = jp.init_params(jax.random.PRNGKey(2), jpca)
    tp = RegistrationPipeline(IMG, latent_dim=LATENT,
                              refine_steps=refine_steps, device="cpu", **kw)
    tp.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tpca = {"vectors": torch.from_numpy(V), "mean": torch.from_numpy(mean)}
    return jp, params, jpca, tp, tpca, (src, tgt, seg, seg)


def test_pipeline_refinement_matches_jax():
    jp, params, jpca, tp, tpca, args = _pipeline_case(5, refine_lr=0.005)
    jw, jphi = jp.register(params, jpca, *args)
    tw, tphi = tp.register(tpca, *map(torch.from_numpy, args))
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-3)
    res = tp.last_refine
    assert res["total_history"].shape == (6,)
    assert bool((res["total_history"][-1] <= res["total_history"][0]))
    # the refinement moved phi away from the encoder's prediction
    base = RegistrationPipeline(IMG, latent_dim=LATENT, device="cpu")
    base.model.load_state_dict(tp.model.state_dict())
    _, phi0 = base.register(tpca, *map(torch.from_numpy, args))
    assert float((phi0 - tphi).abs().max()) > 1e-3
    assert all(p.grad is None for p in tp.model.parameters())


def test_pipeline_refinement_options():
    """Projection-domain refinement builds its refiner (register and
    register_projections through it: tests/test_torch_projection_refine.py);
    an unknown domain raises; register_projections refuses image-domain
    refinement, which needs a target CT."""
    tp = RegistrationPipeline(IMG, latent_dim=LATENT, refine_steps=2,
                              refine_domain="projection", device="cpu")
    assert tp.refiner is not None and tp.refine_domain == "projection"
    zeros = {"vectors": torch.zeros((LATENT, 3 * SZ ** 3)),
             "mean": torch.zeros(3 * SZ ** 3)}
    src = torch.full((1, 1) + IMG, -500.0)
    target_proj = torch.zeros((1, 4) + tp.resolution)
    warped, phi = tp.register_projections(zeros, src, target_proj)
    assert warped.shape == src.shape and phi.shape == (1, 3) + IMG
    assert tp.last_refine["total_history"].shape == (3,)
    with pytest.raises(ValueError):
        RegistrationPipeline(IMG, latent_dim=LATENT, refine_steps=2,
                             refine_domain="volume", device="cpu")
    tp = RegistrationPipeline(IMG, latent_dim=LATENT, refine_steps=2,
                              device="cpu")
    src = torch.zeros((1, 1) + IMG)
    with pytest.raises(ValueError, match="refine_domain='projection'"):
        tp.register_projections(
            {"vectors": torch.zeros((LATENT, 3 * SZ ** 3)),
             "mean": torch.zeros(3 * SZ ** 3)},
            src, torch.zeros((1, 4) + tp.resolution))
