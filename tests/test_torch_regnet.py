"""RegNet2D3D of the port against liftreg_tpu's on the CPU: the forward
outputs from the same parameters (``params_from_jax``), and the gradients
of ``RegNet2D3DLoss`` and ``RegNetImageLoss`` with respect to every
parameter against ``jax.grad``; with the resizes it needs alone.

The case is 16^3, B = 1, 2 views on a 24^2 detector, the full encoder and
decoder widths and 7 inverse steps, from one numpy seed. The detector is
wider than the volume's shadow, so each projection has many pixels at its
minimum 0: both frameworks split the minimum's gradient evenly among
them (``test_tied_minima``).

Tolerances (the f32 convolutions sum in another order, and the 7-step
inverse iteration carries the differences on): ``phi``, ``disp`` and
``disp_inv`` atol 1e-6; the warped volume and the normalised projections
atol 1e-5; each parameter's gradient atol 1e-4 of that leaf's largest
value; ``resize_trilinear`` atol 1e-6 of the largest value (one pass
against three matrix products); ``resize_nearest_2d`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.losses import registration as jreg
from liftreg_tpu.models import RegNet2D3D as JRegNet
from liftreg_tpu.ops import drr as jdrr
from liftreg_tpu.ops import resample as jresample
from liftreg_tpu_torch.losses import registration as treg
from liftreg_tpu_torch.models import RegNet2D3D, get_model
from liftreg_tpu_torch.ops import resample
from liftreg_tpu_torch.params import params_from_jax

SZ, P, DET = 16, 2, 24
REG = 0.5
OPT = {"initial_reg_factor": 1.0, "min_reg_factor": 1e-3, "sim_class": "ncc"}
LOSSES = ("RegNet2D3DLoss", "RegNetImageLoss")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    vol = (1, 1) + (SZ,) * 3
    src = rng.uniform(-1, 1, vol).astype(np.float32)
    # a smooth attenuation with its support inside the volume
    att = np.zeros(vol, np.float32)
    att[..., 3:13, 2:14, 4:12] = rng.uniform(0.05, 0.3, (10, 12, 8))
    return {
        "source": src,
        "target": np.roll(src, 1, axis=2).copy(),
        "target_proj": rng.uniform(-1, 1, (1, P, DET, DET)).astype(
            np.float32),
        "target_poses": jdrr.synthesize_poses(30.0, P, SZ)[None].astype(
            np.float32),
        "spacing": np.full((1, 3), 2.2, np.float32),
        "original_source": att,
        "source_label": (rng.uniform(size=vol) > 0.3).astype(np.float32),
        "target_label": (rng.uniform(size=vol) > 0.3).astype(np.float32),
    }


def _jax_params(model, inputs, seed):
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), inputs)
    # the flow head's N(0, 0.001) leaves the field near 0: scaled up to
    # about a voxel, so that the inverse iteration and the warps move
    # voxels (a rough field of 3 voxels makes the 7-step iteration
    # non-contractive, and it then amplifies the frameworks' last-bit
    # differences to ~2e-5 in disp_inv)
    flow = params["params"]["Conv_0"]
    flow["kernel"] = flow["kernel"] * 100.0
    return params


@pytest.fixture(scope="module")
def case():
    inputs = _inputs(0)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jm = JRegNet(img_sz=(SZ,) * 3, drr_feature_num=P)
    params = _jax_params(jm, jin, 0)
    out = jax.jit(jm.apply)(params, jin)
    want = {k: np.asarray(v) for k, v in out.items() if k != "params"}
    want["disp"], want["disp_inv"] = (np.asarray(t) for t in out["params"])
    grads = {}
    for name in LOSSES:
        loss = getattr(jreg, name)(OPT)

        def total(p, loss=loss):
            return loss(jm.apply(p, jin), REG)["total_loss"]

        value, g = jax.jit(jax.value_and_grad(total))(params)
        grads[name] = (float(value), params_from_jax(
            jax.tree_util.tree_map(np.asarray, g)))
    tm = RegNet2D3D((SZ,) * 3, drr_feature_num=P)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return tm, tin, want, grads


def test_registry_resolves_regnet():
    assert get_model("regnet2d3d") is RegNet2D3D
    assert get_model("liftreg.models.previous.RegNet2D3D.model") \
        is RegNet2D3D


def test_forward_outputs_match_jax(case):
    tm, tin, want, _ = case
    with torch.no_grad():
        got = tm(tin)
    assert set(got) == set(want) - {"disp", "disp_inv"} | {"params"}
    got = dict(got, disp=got["params"][0], disp_inv=got["params"][1])
    # the inverse iteration really moves: disp_inv is not -disp
    assert np.abs(want["disp_inv"] + want["disp"]).max() > 1e-4
    for key, tol in (("phi", 1e-6), ("disp", 1e-6), ("disp_inv", 1e-6),
                     ("warped", 1e-5), ("warped_proj", 1e-5),
                     ("warped_proj_inv", 1e-5), ("source_proj", 1e-5),
                     ("target", 0.0), ("target_proj", 0.0)):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_loss_gradients_match_jax(case, loss_name):
    tm, tin, _, grads = case
    want_value, want = grads[loss_name]
    loss = getattr(treg, loss_name)(OPT)
    tm.zero_grad()
    total = loss(tm(tin), REG)["total_loss"]
    total.backward()
    assert float(total.detach()) == pytest.approx(want_value, rel=1e-5)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_tied_minima(case):
    """Many detector pixels lie outside the volume's shadow and tie at the
    minimum 0 of each projection; the minimum's gradient is split evenly
    among them in both frameworks (the loss gradients above cover it)."""
    _, _, want, _ = case
    for key in ("warped_proj", "warped_proj_inv", "source_proj"):
        p = want[key]
        assert (p == p.min()).sum() > 10, key


@pytest.mark.parametrize("shape_in,shape_out", [
    ((1, 1, 1), (2, 2, 2)), ((2, 3, 5), (4, 6, 10)), ((5, 5, 5), (10, 10, 10)),
    ((4, 4, 4), (4, 8, 4))])
def test_resize_trilinear_matches_jax(shape_in, shape_out):
    rng = np.random.default_rng(sum(shape_in))
    x = rng.normal(size=(2, 3) + shape_in).astype(np.float32)
    want = np.asarray(jresample.resize_trilinear(jnp.asarray(x), shape_out))
    got = resample.resize_trilinear(torch.from_numpy(x), shape_out).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("hw,out", [((24, 24), (16, 16)),
                                    ((240, 240), (160, 160)),
                                    ((37, 53), (160, 160)),
                                    ((7, 9), (100, 33))])
def test_resize_nearest_2d_matches_jax(hw, out):
    x = np.random.default_rng(hw[0]).normal(size=(2, 3) + hw).astype(
        np.float32)
    want = np.asarray(jresample.resize_nearest_2d(jnp.asarray(x), out))
    got = resample.resize_nearest_2d(torch.from_numpy(x), out).numpy()
    assert np.array_equal(got, want)


def test_s2d_encoder_params_give_the_same_outputs():
    """A JAX RegNet2D3D with ``s2d_encoder`` and the port's with the option
    on, both running their encoder's stages 0 and 1 as space-to-depth
    convolutions (stage 0 unpacked for the skip) from the same flax
    parameters: the outputs within the tolerances above."""
    inputs = _inputs(1)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jm = JRegNet(img_sz=(SZ,) * 3, drr_feature_num=P, s2d_encoder=True)
    params = _jax_params(jm, jin, 1)
    out = jax.jit(jm.apply)(params, jin)
    tm = get_model("regnet2d3d")((SZ,) * 3, drr_feature_num=P,
                                 s2d_encoder=True)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in inputs.items()})
    for key, tol in (("phi", 1e-6), ("warped", 1e-5), ("warped_proj", 1e-5),
                     ("warped_proj_inv", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(out[key]),
                                   rtol=0, atol=tol, err_msg=key)
    for got_t, want_t, tol in zip(got["params"], out["params"], (1e-6, 1e-6)):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                                   atol=tol)


def test_s2d_loss_gradients_match_jax():
    """With ``s2d_encoder`` on in both packages: RegNet2D3DLoss and its
    gradient with respect to every parameter against ``jax.grad``, within
    the tolerances above."""
    inputs = _inputs(2)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jm = JRegNet(img_sz=(SZ,) * 3, drr_feature_num=P, s2d_encoder=True)
    params = _jax_params(jm, jin, 2)
    jloss = jreg.RegNet2D3DLoss(OPT)
    value, g = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm.apply(p, jin), REG)["total_loss"]))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    tm = RegNet2D3D((SZ,) * 3, drr_feature_num=P, s2d_encoder=True)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    total = treg.RegNet2D3DLoss(OPT)(
        tm({k: torch.from_numpy(v) for k, v in inputs.items()}), REG)[
        "total_loss"]
    total.backward()
    assert float(total.detach()) == pytest.approx(float(value), rel=1e-5)
    for k, p in tm.named_parameters():
        w = want[k].numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
