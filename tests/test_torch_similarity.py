"""NGF and LNCC of the port against liftreg_tpu on the CPU: values and
gradients, in the style of tests/test_torch_grads.py's
``test_similarity_values_and_gradients``.

NGF scores 2D images (B, C, H, W), the projection refiner's; LNCC scores
(B, 1, D, W, H) volumes, with ``smooth`` 0 and 3, ``scales`` None and
[1, 2] (the second scale's axes are shorter than the window: the box sums'
explicit padding), an even and an odd window, ``weights`` and both
reductions.

Tolerances: values and gradients rtol 1e-5, atol 1e-6 (f32 sums in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.losses import similarity as jsim
from liftreg_tpu_torch.losses import similarity as tsim

TOL = dict(rtol=1e-5, atol=1e-6)


def _check(name, x, y, reduction, **opts):
    """Value and gradient with respect to x of similarity ``name`` in both
    packages, without and with per-sample weights (one of them 0)."""
    w = np.ones(x.shape[0], np.float32)
    w[1] = 0.0
    jfn, tfn = jsim.get_similarity(name), tsim.get_similarity(name)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)

        def jl(a):
            return jnp.sum(jfn(a, jnp.asarray(y), weights=jw,
                               reduction=reduction, **opts))

        want_v = np.asarray(jfn(jnp.asarray(x), jnp.asarray(y), weights=jw,
                                reduction=reduction, **opts))
        want_g = np.asarray(jax.grad(jl)(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        got_v = tfn(xt, torch.from_numpy(y), weights=tw, reduction=reduction,
                    **opts)
        got_v.sum().backward()
        np.testing.assert_allclose(got_v.detach().numpy(), want_v, **TOL)
        assert np.abs(want_g).max() > 0
        np.testing.assert_allclose(xt.grad.numpy(), want_g, **TOL)


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("flat", [False, True])
def test_ngf_values_and_gradients(reduction, flat):
    """``flat``: a third of the pixels at -1, as a normalized DRR is where
    a ray meets only air (zero gradients, where eps sets the slope)."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (3, 2, 9, 11)).astype(np.float32)
    y = (0.6 * x + 0.4 * rng.uniform(-1, 1, x.shape)).astype(np.float32)
    if flat:
        x[:, :, :3] = -1.0
        y[:, :, :, :4] = -1.0
    _check("ngf", x, y, reduction)


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("scales", [None, [1, 2]])
@pytest.mark.parametrize("smooth", [0, 3])
def test_lncc_values_and_gradients(smooth, scales, reduction):
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (3, 1, 12, 10, 14)).astype(np.float32)
    y = (0.6 * x + 0.4 * rng.uniform(-1, 1, x.shape)).astype(np.float32)
    _check("lncc", x, y, reduction, smooth=smooth, scales=scales)


@pytest.mark.parametrize("win,eps", [(4, 1e-5), (5, 1e-3), (7, 1e-5)])
def test_lncc_windows(win, eps):
    """An even window (SAME pads it unevenly), and an odd one longer than
    the last axis."""
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, (2, 1, 7, 9, 6)).astype(np.float32)
    y = (0.5 * x + 0.5 * rng.uniform(-1, 1, x.shape)).astype(np.float32)
    _check("lncc", x, y, "mean", win=win, eps=eps)


def test_lncc_constant_windows():
    """Constant regions, as outside a lung mask: the variances' clamp at 0
    takes JAX's tie (torch.maximum), values and gradients agree."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (2, 1, 10, 10, 10)).astype(np.float32)
    y = (0.5 * x + 0.5 * rng.uniform(-1, 1, x.shape)).astype(np.float32)
    x[:, :, :5] = -1.0
    y[:, :, :4] = -1.0
    _check("lncc", x, y, "none", win=3, smooth=3)


@pytest.mark.parametrize("smooth", [2, 1.5, -1])
def test_lncc_rejects_a_smooth_width_that_is_not_odd(smooth):
    x = torch.zeros((1, 1, 5, 5, 5))
    with pytest.raises(ValueError, match="odd"):
        tsim.lncc_loss(x, x, smooth=smooth)
