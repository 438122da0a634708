"""LiftRegSubspace (the subspace model without the backprojection lift) of
the port against liftreg_tpu's on the CPU, from the same parameters
(``params_from_jax``): its outputs with an f32 and a bf16 basis, with and
without the lung mask, and the gradient of the subspace loss with respect
to every parameter.

Tolerances: ``phi`` atol 1e-5 and ``warped`` atol 1e-4, as the backproj
model's (f32 convolutions summed in another order); the coefficients rtol
1e-4; with a bf16 basis the same (the PCA expansion's f32 sums of bf16
products in another order); each parameter's gradient atol 1e-3 of that
leaf's largest value (the encoder's sums carry on through the coefficients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.losses import registration as jreg
from liftreg_tpu.models import LiftRegSubspace as JModel
from liftreg_tpu.ops import pallas_pca as jpallas_pca
from liftreg_tpu_torch.losses import registration as treg
from liftreg_tpu_torch.models import LiftRegSubspace, get_model
from liftreg_tpu_torch.params import params_from_jax

SZ, P, L, B = (16, 12, 16), 2, 4, 2
OPT = {"initial_reg_factor": 1.0, "min_reg_factor": 1e-3, "sim_class": "ncc"}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    seg = (rng.uniform(size=(B, 1) + SZ) > 0.3).astype(np.float32)
    return {
        "source": rng.uniform(-1, 1, (B, 1) + SZ).astype(np.float32),
        "target": rng.uniform(-1, 1, (B, 1) + SZ).astype(np.float32),
        "target_proj": rng.uniform(-1, 1, (B, P, 24, 21)).astype(np.float32),
        "target_poses": np.array([[-8.0, 56.0, -3.0], [8.0, 56.0, 3.0]],
                                 np.float32),
        "source_label": seg, "target_label": seg[::-1].copy(),
    }


def _pca(seed=1):
    rng = np.random.default_rng(seed)
    n = 3 * int(np.prod(SZ))
    return {"vectors": (rng.standard_normal((L, n)) * 0.02).astype(
        np.float32), "mean": (rng.standard_normal(n) * 0.01).astype(
        np.float32)}


_STREAMED = jpallas_pca.expand_pca_streamed


def _interpret(coefs, vectors, mean):
    return _STREAMED(coefs, vectors, mean, 32768, True)


@pytest.fixture(scope="module")
def case():
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    pca = {k: jnp.asarray(v) for k, v in _pca().items()}
    params = jax.jit(JModel(SZ, latent_dim=L, drr_feature_num=P).init)(
        jax.random.PRNGKey(0), inp, pca)
    return jax.tree_util.tree_map(np.asarray, params)


def _torch_model(params, **kw):
    tm = get_model("liftreg.models.LiftRegDeformSubspace.model")(
        img_sz=SZ, latent_dim=L, drr_feature_num=P, **kw)
    tm.load_state_dict(params_from_jax(params))
    return tm


@pytest.mark.parametrize("basis", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_ct", [True, False])
def test_outputs_match_jax(case, basis, mask_ct, monkeypatch):
    """With a bf16 basis the JAX model streams it through the Pallas PCA
    kernel (``pca_expand_pallas``), run in interpret mode as the JAX
    package's own tests run it on the CPU."""
    monkeypatch.setattr(jpallas_pca, "expand_pca_streamed", _interpret)
    inp, pca = _inputs(), _pca()
    jdt = jnp.bfloat16 if basis == "bfloat16" else jnp.float32
    jm = JModel(SZ, latent_dim=L, drr_feature_num=P, mask_ct=mask_ct,
                pca_expand_pallas=basis == "bfloat16")
    want = jm.apply(case, {k: jnp.asarray(v) for k, v in inp.items()},
                    {"vectors": jnp.asarray(pca["vectors"], jdt),
                     "mean": jnp.asarray(pca["mean"])})
    tm = _torch_model(case, mask_ct=mask_ct,
                      pca_expand_pallas=basis == "bfloat16")
    tdt = getattr(torch, basis)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in inp.items()},
                 {"vectors": torch.from_numpy(pca["vectors"]).to(tdt),
                  "mean": torch.from_numpy(pca["mean"])})
    assert set(got) == set(want)
    np.testing.assert_allclose(got["pca_coefs"].numpy(),
                               np.asarray(want["pca_coefs"]), rtol=1e-4,
                               atol=1e-6)
    for key, tol in (("phi", 1e-5), ("params", 1e-5), ("warped", 1e-4),
                     ("target", 0.0)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=tol, err_msg=key)


def test_loss_gradients_match_jax(case):
    inp, pca = _inputs(), _pca()
    jm = JModel(SZ, latent_dim=L, drr_feature_num=P)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    jpca = {k: jnp.asarray(v) for k, v in pca.items()}
    jloss = jreg.SubspaceLoss(OPT)
    value, g = jax.value_and_grad(
        lambda p: jloss(jm.apply(p, jin, jpca), 0.5)["total_loss"])(case)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    tm = _torch_model(case)
    total = treg.SubspaceLoss(OPT)(
        tm({k: torch.from_numpy(v) for k, v in inp.items()},
           {k: torch.from_numpy(v) for k, v in pca.items()}), 0.5)[
        "total_loss"]
    total.backward()
    assert float(total.detach()) == pytest.approx(float(value), rel=1e-5)
    for k, p in tm.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


def test_lift_is_the_nearest_resize_broadcast():
    """The encoder's input channels 1..P: each projection resized to
    (D, H) by ``resize_nearest_2d`` and repeated along W."""
    tm = LiftRegSubspace(SZ, latent_dim=L, drr_feature_num=P)
    seen = {}
    tm.encoder.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0]))
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.no_grad():
        tm(inp, {k: torch.from_numpy(v) for k, v in _pca().items()})
    x = seen["x"]
    assert x.shape == (B, 1 + P) + SZ
    assert torch.equal(x[:, :1], inp["source"])
    assert torch.equal(x[:, 1:, :, 0], x[:, 1:, :, -1])
