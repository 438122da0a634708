"""The training losses of the port against liftreg_tpu on the CPU: each
loss class (values and the gradient of the total), ``get_loss`` and its
registry, ``sigmoid_decay`` and ``RegFactorSchedule``, ``gradient_loss``,
``jacobian_determinant`` and ``compute_jacobi_map``, and the nearest mode
of the warp (half-integer coordinates included).

Tolerances: losses, gradients and determinants rtol 1e-5, atol 1e-6 (f32
sums in another order); the folding metric rtol 1e-5, atol 1e-6 of the
sum (the port sums in f64, numpy in f32); the schedules and the nearest
warp exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.losses import registration as jreg
from liftreg_tpu.losses import similarity as jsim
from liftreg_tpu.ops import fd as jfd
from liftreg_tpu.ops import resample as jres
from liftreg_tpu_torch.losses import registration as treg
from liftreg_tpu_torch.losses import similarity as tsim
from liftreg_tpu_torch.ops import fd as tfd
from liftreg_tpu_torch.ops import resample as tres

TOL = dict(rtol=1e-5, atol=1e-6)
OPT = {"initial_reg_factor": 0.5, "min_reg_factor": 1e-3,
       "reg_factor_decay_from": 2, "sim_class": "ncc"}


def _volumes(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _outputs(rng, name):
    """The model output dict each loss reads, as numpy."""
    shape = (3, 1, 6, 7, 8)
    out = {"warped": _volumes(rng, shape), "target": _volumes(rng, shape),
           "warped_proj": _volumes(rng, (3, 2, 9, 10)),
           "target_proj": _volumes(rng, (3, 2, 9, 10))}
    disp = (rng.standard_normal((3, 3, 6, 7, 8)) * 0.05).astype(np.float32)
    if jreg.LOSS_REGISTRY[name].__name__ in ("RegNet2D3DLoss",
                                             "RegNetImageLoss"):
        out["params"] = (disp, (disp[::-1] * 0.5).copy())
        out["source_proj"] = _volumes(rng, (3, 2, 9, 10))
        out["warped_proj_inv"] = _volumes(rng, (3, 2, 9, 10))
    else:
        out["params"] = disp
    return out


def _map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(fn(t) for t in tree)
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize("name", sorted(jreg.LOSS_REGISTRY))
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_classes(name, weighted):
    """Every entry of the registry: the three losses and the gradient of
    the total with respect to the displacement, with and without pad
    weights."""
    rng = np.random.default_rng(3)
    out = _outputs(rng, name)
    w = np.array([1.0, 1.0, 0.0], np.float32) if weighted else None
    jl = jreg.get_loss(name)(OPT)
    tl = treg.get_loss(name)(OPT)
    assert tl.factor(4) == jl.factor(4)
    factor = jl.factor(3)

    def jtotal(disp):
        o = dict(_map(jnp.asarray, out))
        o["params"] = disp
        return jl(o, jnp.float32(factor),
                  weights=None if w is None else jnp.asarray(w))

    jdisp = _map(jnp.asarray, out["params"])
    want = jtotal(jdisp)
    want_g = jax.grad(lambda d: jtotal(d)["total_loss"])(jdisp)
    o = _map(torch.from_numpy, out)
    o["params"] = _map(lambda t: t.clone().requires_grad_(True), o["params"])
    got = tl(o, factor, weights=None if w is None else torch.from_numpy(w))
    for k in ("total_loss", "sim_loss", "reg_loss"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **TOL, err_msg=k)
    got["total_loss"].backward()
    params = o["params"] if isinstance(o["params"], tuple) else (o["params"],)
    wants = want_g if isinstance(want_g, tuple) else (want_g,)
    for p, g in zip(params, wants):
        # a field the loss does not read has no gradient here, zeros in JAX
        got_g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(g), **TOL)


def test_loss_registry_and_sim_opts():
    assert set(treg.LOSS_REGISTRY) == set(jreg.LOSS_REGISTRY)
    for name, cls in jreg.LOSS_REGISTRY.items():
        assert treg.get_loss(name).__name__ == cls.__name__
    with pytest.raises(KeyError):
        treg.get_loss("nope")
    # sim_opts reach the similarity (lncc's window)
    rng = np.random.default_rng(4)
    a, b = _volumes(rng, (2, 1, 8, 8, 8)), _volumes(rng, (2, 1, 8, 8, 8))
    opt = dict(OPT, sim_class="lncc", sim_opts={"win": 3})
    want = jreg.SubspaceLoss(opt).sim(jnp.asarray(a), jnp.asarray(b))
    got = treg.SubspaceLoss(opt).sim(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_schedules():
    for ep in range(0, 40, 3):
        for static, k in ((5, 5), (2, 2.0), (0, 3)):
            assert treg.sigmoid_decay(ep, static, k) == \
                jreg.sigmoid_decay(ep, static, k)
    sched = dict(initial=0.01, minimum=0.01, decay_from=2)
    for ep in range(30):
        assert treg.RegFactorSchedule(**sched)(ep) == \
            jreg.RegFactorSchedule(**sched)(ep)
        assert treg.RegFactorSchedule()(ep) == jreg.RegFactorSchedule()(ep)


def test_gradient_loss():
    """Not in either registry; value and gradient."""
    rng = np.random.default_rng(5)
    x, y = _volumes(rng, (2, 1, 7, 8, 9)), _volumes(rng, (2, 1, 7, 8, 9))
    with pytest.raises(KeyError):
        tsim.get_similarity("gradient")
    want = jsim.gradient_loss(jnp.asarray(x), jnp.asarray(y))
    want_g = jax.grad(jsim.gradient_loss)(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tsim.gradient_loss(xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **TOL)


def _folded_map(rng, shape, amp):
    """An identity map plus noise of ``amp`` (normalized units): enough
    noise folds some voxels."""
    axes = [np.linspace(-1, 1, n) for n in shape]
    ident = np.stack(np.meshgrid(*axes, indexing="ij"))
    noise = rng.standard_normal((2, 3) + shape) * amp
    return (ident[None] + noise).astype(np.float32)


@pytest.mark.parametrize("amp", [0.0, 0.02, 0.2])
def test_jacobian_and_folding(amp):
    rng = np.random.default_rng(6)
    shape = (9, 10, 11)
    phi = _folded_map(rng, shape, amp)
    spacing = 1.0 / (np.asarray(shape) - 1)
    sp = spacing * 2.0
    np.testing.assert_allclose(
        tfd.jacobian_determinant(torch.from_numpy(phi), sp).numpy(),
        np.asarray(jfd.jacobian_determinant(jnp.asarray(phi), sp)), **TOL)
    for use_01 in (False, True):
        want = jfd.compute_jacobi_map(phi, spacing, crop_boundary=True,
                                      use_01=use_01)
        for given in (phi, torch.from_numpy(phi)):
            got = tfd.compute_jacobi_map(given, spacing, crop_boundary=True,
                                         use_01=use_01)
            assert got[1] == want[1]
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                                       atol=1e-6 * max(1.0, abs(want[0])))
    if amp == 0.2:
        assert want[1] > 0


@pytest.mark.parametrize("zero_boundary", [True, False])
@pytest.mark.parametrize("scale_intensity", [False, True])
def test_warp_nearest(zero_boundary, scale_intensity):
    """Labels through the nearest warp: coordinates on half-integers
    (where floor(x + 0.5) rounds up and torch's nearest would round to
    even), on integers, in between and outside."""
    rng = np.random.default_rng(7)
    shape = (5, 6, 7)
    img = rng.integers(0, 4, (2, 2) + shape).astype(np.float32)
    if scale_intensity:
        img = img / 2.0 - 1.0
    # pixel coordinates: half-integers, integers, random, outside
    pix = rng.uniform(-1.5, 7.5, (2, 3) + shape)
    pix[:, :, :2] = np.round(pix[:, :, :2] * 2.0) / 2.0
    pix[:, :, 2] = np.floor(pix[:, :, 2]) + 0.5
    pix[:, :, 3] = np.round(pix[:, :, 3])
    scale = np.array([(n - 1) * 0.5 for n in shape]).reshape(1, 3, 1, 1, 1)
    phi = (pix / scale - 1.0).astype(np.float32)
    want = jres.warp_image(jnp.asarray(img), jnp.asarray(phi),
                           mode="nearest", zero_boundary=zero_boundary,
                           scale_intensity=scale_intensity)
    got = tres.warp_image(torch.from_numpy(img), torch.from_numpy(phi),
                          zero_boundary=zero_boundary,
                          scale_intensity=scale_intensity, mode="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the half-integers are exact in f32 and round up, not to even
    c = (torch.from_numpy(phi).movedim(1, -1) + 1.0) * torch.tensor(
        [(n - 1) * 0.5 for n in shape])
    assert bool((c[:, 2] == torch.floor(c[:, 2]) + 0.5).any())
