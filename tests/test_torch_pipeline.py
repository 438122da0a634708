"""The port's encoder, model and RegistrationPipeline against liftreg_tpu on
the CPU, with the flax weights imported through params_from_jax and the
same PCA basis.

The JAX side runs with its default XLA PCA path: with
``pca_expand_pallas=True`` it raises on the CPU backend, and
tests/test_pallas_pca.py holds the Pallas kernel equal to the XLA path.

Tolerances: f32 config phi atol 1e-5, warped atol 1e-4 (f32 products in
another order; the warped image is the volume's gradient times the phi
difference). bf16 serving config phi atol 5e-5, warped atol 5e-3: the two
frameworks round the bf16 encoder's convolutions and dense layers at
other places, which moves the coefficients by ~1e-3 relative; measured
here at 32^3 as phi 8.6e-6 and warped 1.1e-3 (random-noise volumes, whose
gradient reaches 2 per voxel)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.models.subspace_backproj import SubspaceEncoder as JEncoder
from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline
from liftreg_tpu_torch import RegistrationPipeline, params_from_jax
from liftreg_tpu_torch.models import SubspaceEncoder

SZ = (32, 32, 32)
L = 8
B = 2
CONFIGS = {
    "f32": dict(jdt=None, tdt=None, basis="float32", phi=1e-5, warped=1e-4),
    "bf16": dict(jdt=jnp.bfloat16, tdt=torch.bfloat16, basis="bfloat16",
                 phi=5e-5, warped=5e-3),
    # the bf16 config with the compute type given by name, as JSON
    # configs carry it, to both pipelines
    "bf16_name": dict(jdt="bfloat16", tdt="bfloat16", basis="bfloat16",
                      phi=5e-5, warped=5e-3),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_matches_flax(dtype):
    cfg = CONFIGS[dtype]
    sz = (16, 16, 16)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3) + sz).astype(
        np.float32)
    jenc = JEncoder(latent_dim=6, dtype=cfg["jdt"])
    xj = jnp.moveaxis(jnp.asarray(x), 1, -1)
    params = jenc.init(jax.random.PRNGKey(0), xj)
    want = np.asarray(jenc.apply(params, xj))
    tenc = SubspaceEncoder(3, 6, sz, dtype=cfg["tdt"])
    tenc.load_state_dict({k[len("encoder."):]: v for k, v in params_from_jax(
        {"encoder": _np_tree(params["params"])}).items()})
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * scale if dtype == "f32"
                               else 2e-2 * scale)


def test_params_from_jax_layouts():
    jp = JPipeline(SZ, latent_dim=L)
    pca = {"vectors": jnp.zeros((L, 3 * 32 ** 3)),
           "mean": jnp.zeros(3 * 32 ** 3)}
    tree = _np_tree(jp.init_params(jax.random.PRNGKey(0), pca))
    sd = params_from_jax(tree)
    enc = tree["params"]["encoder"]
    k0 = enc["CheckpointConvBlock_0"]["Conv_0"]["kernel"]       # (3,3,3,5,16)
    np.testing.assert_array_equal(sd["encoder.convs.0.conv.weight"][3, 1],
                                  k0[:, :, :, 1, 3])
    d0 = enc["FullyConnectBlock_0"]["Dense_0"]["kernel"]        # (32, 800)
    np.testing.assert_array_equal(sd["encoder.fcs.0.linear.weight"], d0.T)
    model = RegistrationPipeline(SZ, latent_dim=L, device="cpu").model
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)


def _case(dtype, sz=SZ, latent=L):
    cfg = CONFIGS[dtype]
    rng = np.random.default_rng(0)
    n = 3 * int(np.prod(sz))
    V = (rng.standard_normal((latent, n)) * 0.01).astype(np.float32)
    mean = (rng.standard_normal(n) * 0.01).astype(np.float32)
    vols = [rng.uniform(-1000, 0, (B, 1) + sz).astype(np.float32)
            for _ in range(2)]
    seg = (rng.uniform(size=(B, 1) + sz) > 0.4).astype(np.float32)
    jp = JPipeline(sz, latent_dim=latent, compute_dtype=cfg["jdt"])
    jpca = {"vectors": jnp.asarray(V, getattr(jnp, cfg["basis"])),
            "mean": jnp.asarray(mean)}
    params = jp.init_params(jax.random.PRNGKey(1), jpca)
    tp = RegistrationPipeline(sz, latent_dim=latent,
                              compute_dtype=cfg["tdt"], device="cpu")
    tp.model.load_state_dict(params_from_jax(_np_tree(params)))
    tpca = {"vectors": torch.from_numpy(V).to(getattr(torch, cfg["basis"])),
            "mean": torch.from_numpy(mean)}
    return cfg, jp, params, jpca, tp, tpca, vols, seg


def _check(cfg, got, want, sz=SZ):
    (tw, tphi), (jw, jphi) = got, want
    assert tw.shape == (B, 1) + sz and tphi.shape == (B, 3) + sz
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi),
                               atol=cfg["phi"], rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               atol=cfg["warped"], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_register_matches_jax(dtype):
    cfg, jp, params, jpca, tp, tpca, (src, tgt), seg = _case(dtype)
    want = jp.register(params, jpca, src, tgt, seg, seg)
    got = tp.register(tpca, torch.from_numpy(src), torch.from_numpy(tgt),
                      torch.from_numpy(seg), torch.from_numpy(seg))
    _check(cfg, got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_register_projections_matches_jax(dtype):
    cfg, jp, params, jpca, tp, tpca, (src, _), seg = _case(dtype)
    proj = np.random.default_rng(5).uniform(
        -1, 1, (B, 4) + jp.resolution).astype(np.float32)
    want = jp.register_projections(params, jpca, src, proj, seg)
    got = tp.register_projections(tpca, torch.from_numpy(src),
                                  torch.from_numpy(proj),
                                  torch.from_numpy(seg))
    _check(cfg, got, want)


def test_register_projections_other_detector_matches_jax():
    # projections of another size than the pipeline's DRR resolution: the
    # lift must follow the projections' own detector, as the JAX model does
    cfg, jp, params, jpca, tp, tpca, (src, _), seg = _case("f32")
    det = (40, 44)
    assert det != tuple(jp.resolution)
    proj = np.random.default_rng(6).uniform(
        -1, 1, (B, 4) + det).astype(np.float32)
    want = jp.register_projections(params, jpca, src, proj, seg)
    got = tp.register_projections(tpca, torch.from_numpy(src),
                                  torch.from_numpy(proj),
                                  torch.from_numpy(seg))
    _check(cfg, got, want)


def test_register_without_segmentation_matches_jax():
    cfg, jp, params, jpca, tp, tpca, (src, tgt), _ = _case("f32")
    want = jp.register(params, jpca, src, tgt)
    got = tp.register(tpca, torch.from_numpy(src), torch.from_numpy(tgt))
    _check(cfg, got, want)


def test_register_compute_dtype_by_name_matches_jax():
    sz = (16, 16, 16)
    cfg, jp, params, jpca, tp, tpca, (src, tgt), seg = _case(
        "bf16_name", sz=sz, latent=4)
    assert tp.model.compute_dtype == torch.bfloat16
    want = jp.register(params, jpca, src, tgt, seg, seg)
    got = tp.register(tpca, torch.from_numpy(src), torch.from_numpy(tgt),
                      torch.from_numpy(seg), torch.from_numpy(seg))
    _check(cfg, got, want, sz=sz)


@pytest.mark.parametrize("field", ["compute_dtype", "warp_taps_dtype"])
def test_unknown_dtype_name_raises_at_construction(field):
    with pytest.raises(ValueError, match=field):
        RegistrationPipeline((16, 16, 16), latent_dim=4, device="cpu",
                             **{field: "bfloat17"})
