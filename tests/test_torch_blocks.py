"""The port's building blocks (``models/blocks.py``: ``ConvBlock`` with
batch norm and the residual conv, ``ConvResBlock``, ``gaussian_smooth``;
``models/legacy_blocks.py``) against the JAX package's flax blocks on the
CPU, from the same flax variables carried by ``params_from_jax``.

The JAX blocks are channels-last, the port's channels-first. Tolerance:
outputs and the updated batch statistics within 1e-5 of the largest value
plus 1e-5 relative (the convolutions and the batch means sum in another
order); ``ProjLayer`` within 1e-5 of the largest line integral.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.models import blocks as jblocks
from liftreg_tpu.models import legacy_blocks as jlegacy
from liftreg_tpu_torch import params_from_jax
from liftreg_tpu_torch.models import blocks, legacy_blocks


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-6))


def _last(x):
    """channels-first numpy -> channels-last"""
    return np.moveaxis(x, 1, -1)


def _variables(jmod, x, seed, *extra):
    """flax variables of ``jmod`` at input ``x`` (channels-last), with every
    batch-norm scale, bias and statistic drawn at random, so that none is
    the identity."""
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), *extra)
    rng = np.random.default_rng(seed)

    def perturb(tree, stats=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                bn = "scale" in v or "mean" in v
                out[k] = ({kk: jnp.asarray(rng.uniform(0.5, 1.5, vv.shape)
                                           if kk in ("scale", "var")
                                           else rng.normal(0, 0.2, vv.shape),
                                           jnp.float32)
                           for kk, vv in v.items()} if bn
                          else perturb(v, stats))
            else:
                out[k] = v
        return out

    variables = {k: perturb(v) for k, v in variables.items()}
    return jax.tree_util.tree_map(np.asarray, variables)


def _check(jmod, tmod, x, seed, train_modes=(False, True)):
    """Outputs in eval and train mode, and the batch statistics after the
    train-mode call."""
    variables = _variables(jmod, _last(x), seed)
    for train in train_modes:
        tmod.load_state_dict(params_from_jax(variables, tmod))
        got = tmod(torch.from_numpy(x), train=train)
        if train and "batch_stats" in variables:
            want, new = jmod.apply(variables, jnp.asarray(_last(x)),
                                   train=True, mutable=["batch_stats"])
            state = tmod.state_dict()
            want_state = params_from_jax({"params": variables["params"],
                                          **jax.tree_util.tree_map(
                                              np.asarray, new)}, tmod)
            for k, v in want_state.items():
                _close(state[k].numpy(), v.numpy())
        else:
            want = jmod.apply(variables, jnp.asarray(_last(x)), train=train)
        _close(np.moveaxis(got.detach().numpy(), 1, -1), want)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("batchnorm,residual", [(True, True), (True, False),
                                                (False, True)])
def test_conv_block(ndim, stride, batchnorm, residual):
    x = _x((2, 3) + (6,) * ndim, ndim + stride)
    jm = jblocks.ConvBlock(4, ndim=ndim, stride=stride, batchnorm=batchnorm,
                           residual=residual)
    tm = blocks.ConvBlock(3, 4, stride=stride, ndim=ndim,
                          batchnorm=batchnorm, residual=residual)
    _check(jm, tm, x, 1)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("residual", [True, False])
def test_conv_res_block(ndim, residual):
    x = _x((2, 3) + (6,) * ndim, 5 + ndim)
    jm = jblocks.ConvResBlock(4, ndim=ndim, stride=2, batchnorm=True,
                              residual=residual)
    tm = blocks.ConvResBlock(3, 4, stride=2, ndim=ndim, batchnorm=True,
                             residual=residual)
    _check(jm, tm, x, 2)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("size,sigma", [(3, 1.0), (4, 0.8),
                                        ((5, 3, 3), (1.5, 0.7, 1.0))])
def test_gaussian_smooth(ndim, size, sigma):
    """Odd and even kernels, and per-axis sizes (padded by the first
    axis's half size on every axis, as in JAX)."""
    if isinstance(size, tuple):
        size, sigma = list(size[:ndim]), list(sigma[:ndim])
    x = _x((2, 3) + (7,) * ndim, 9)
    want = jblocks.gaussian_smooth(jnp.asarray(x), size, sigma)
    got = blocks.gaussian_smooth(torch.from_numpy(x), size, sigma)
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("has_bn", [False, True])
def test_conv_nd_block(ndim, has_bn):
    x = _x((2, 3) + (6,) * ndim, 11)
    _check(jlegacy.ConvNdBlock(4, ndim=ndim, kernel_size=3, stride=2,
                               padding=1, has_bn=has_bn),
           legacy_blocks.ConvNdBlock(3, 4, ndim=ndim, kernel_size=3,
                                     stride=2, padding=1, has_bn=has_bn),
           x, 3)


@pytest.mark.parametrize("kernel_size,stride,padding",
                         [(1, 1, 1), (3, 2, 1), (3, 2, 0), (2, 2, 1),
                          (3, 2, -1)])
@pytest.mark.parametrize("has_bn", [False, True])
def test_deconv_nd_block(kernel_size, stride, padding, has_bn):
    """(1, 1, 1) is the block's default, an output of n + 2 per axis. No
    case leaves most outputs at the bias alone (a kernel narrower than the
    stride): there flax's batch variance, ``E[x^2] - E[x]^2``, cancels to a
    few ulps of ``E[x]^2`` in either framework."""
    x = _x((2, 3, 5, 6, 4), 13)
    jm = jlegacy.DeconvNdBlock(4, ndim=3, kernel_size=kernel_size,
                               stride=stride, padding=padding, has_bn=has_bn)
    tm = legacy_blocks.DeconvNdBlock(3, 4, ndim=3, kernel_size=kernel_size,
                                     stride=stride, padding=padding,
                                     has_bn=has_bn)
    _check(jm, tm, x, 4)
    if (kernel_size, stride, padding) == (1, 1, 1):
        assert tm(torch.from_numpy(x)).shape == (2, 4, 7, 8, 6)


def test_deconv_2d_default():
    x = _x((2, 3, 5, 6), 14)
    _check(jlegacy.DeconvNdBlock(4, ndim=2, has_bn=True),
           legacy_blocks.DeconvNdBlock(3, 4, ndim=2, has_bn=True), x, 5)


def test_resize_conv3d():
    x = _x((2, 3, 4, 5, 3), 15)
    _check(jlegacy.ResizeConv3D((7, 8, 6), 4, has_bn=True),
           legacy_blocks.ResizeConv3D(3, (7, 8, 6), 4, has_bn=True), x, 6)


def test_res_block_2d():
    x = _x((2, 3, 8, 8), 16)
    _check(jlegacy.ResBlock2D(4), legacy_blocks.ResBlock2D(3, 4), x, 7)


def test_trans_layer():
    x = _x((2, 8, 4, 4), 17)
    jm = jlegacy.TransLayer(2)
    variables = _variables(jm, _last(x), 8)
    tm = legacy_blocks.TransLayer(8, 2)
    tm.load_state_dict(params_from_jax(variables, tm))
    want = jm.apply(variables, jnp.asarray(_last(x)))
    got = tm(torch.from_numpy(x))
    _close(np.moveaxis(got.detach().numpy(), 1, -1), want)


def test_proj_layer():
    vol = np.random.default_rng(18).uniform(0, 0.2, (2, 8, 10, 8)).astype(
        np.float32)
    kw = dict(volume_spacing=(2.2, 2.2, 2.2), scan_range=30.0, proj_num=3,
              in_shape=(8, 10, 8))
    jm = jlegacy.ProjLayer(**kw)
    want = np.asarray(jm.apply({}, jnp.asarray(vol)))
    tm = legacy_blocks.ProjLayer(**kw)
    v_t = torch.from_numpy(vol).requires_grad_(True)
    got = tm(v_t)
    assert got.shape == want.shape == (2, 3, 12, 12)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # differentiable, through the projector's adjoint
    got.sum().backward()
    assert v_t.grad.shape == vol.shape and float(v_t.grad.abs().sum()) > 0
