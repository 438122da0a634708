"""Gradients of the port against liftreg_tpu on the CPU: the warp's
coordinate gradient, the PCA backward, NCC and the displacement
regulariser (NGF and LNCC: tests/test_torch_similarity.py).

The refinement differentiates ``resample.warp_image`` with XLA's autodiff,
so that is the reference, kinks included: coordinates on integers and on
the border clip follow JAX's conventions (``d|t|/dt = 1`` at 0, ties of
``max``/``clip`` split in halves, the f32 path's z axis differentiates
``floor``-based weights). The volumes have 9/17/9 voxels so that
``(phi + 1) * (n - 1) / 2`` is exact in f32 in both frameworks and the
integer coordinates really are integers.

Tolerances: the warp gradient atol 2e-5 * max|grad| (f32 sums of 8 taps in
another order); the Pallas ``warp_plane_sample`` in interpret mode, off
kinks, the same; dcoefs with a bf16 basis one bf16 step (rtol 2^-8: the
f32 sums run in another order before the rounding to bf16, atol 1e-4 *
max for sums that cancel to near zero), with an f32 basis rtol 1e-5;
losses and their gradients rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.losses import registration as jreg
from liftreg_tpu.losses import similarity as jsim
from liftreg_tpu.models.subspace_backproj import expand_pca as jexpand
from liftreg_tpu.ops import resample as jresample
from liftreg_tpu_torch.losses import registration as treg
from liftreg_tpu_torch.losses import similarity as tsim
from liftreg_tpu_torch.models.subspace_backproj import expand_pca
from liftreg_tpu_torch.ops import resample
from liftreg_tpu_torch.ops.pca_kernel import pca_grad, pca_grad_plain
from liftreg_tpu_torch.ops.warp_kernel import (warp_coord_grad,
                                               warp_trilinear_ad)

SZ = (9, 17, 9)
B, C = 2, 1


def _image(rng):
    img = rng.uniform(-1, 1, (B, C) + SZ).astype(np.float32)
    return np.clip(img, -1, 1)


def _phi(rng, kind):
    """(B, 3, *SZ) normalized map whose pixel coordinates are smooth
    off-kink values, exact integers (inside, on the faces and beyond), or
    values beyond and on the border clip."""
    n = np.array(SZ, np.float32)[:, None, None, None]
    axes = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SZ],
                       indexing="ij")
    ident = np.stack(axes)[None]
    if kind == "off_kink":
        pix = ident + rng.uniform(-1.5, 1.5, (B, 3) + SZ).astype(np.float32)
        pix = pix + 0.123           # no integer by construction of uniform
    elif kind == "integer":
        pix = ident + rng.integers(-2, 3, (B, 3) + SZ).astype(np.float32)
    else:                           # clipped: at, and beyond, both bounds
        pix = ident + rng.choice(np.array([-30.0, 0.0, 30.0], np.float32),
                                 (B, 3) + SZ)
        pix[:, :, 0] = 0.0
        pix[:, :, -1] = n[0, 0, 0, 0] - 1.0
        pix[0, 1, 1] = n[1, 0, 0, 0] - 1.0
        pix[1, 2, 2] = 0.0
    scale = (n - 1.0) / 2.0
    return (pix / scale - 1.0).astype(np.float32)


@pytest.mark.parametrize("taps", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("kind", ["off_kink", "integer", "clipped"])
def test_warp_coord_grad_matches_jax_autodiff(taps, padding, kind):
    rng = np.random.default_rng(sum(map(ord, taps + padding + kind)))
    img, phi = _image(rng), _phi(rng, kind)
    g = rng.normal(size=(B, C) + SZ).astype(np.float32)
    zero = padding == "zeros"
    jt = None if taps == "float32" else jnp.bfloat16
    tt = None if taps == "float32" else torch.bfloat16

    def jloss(ph, fast_vjp):
        w = jresample.warp_image(jnp.asarray(img), ph, zero_boundary=zero,
                                 taps_dtype=jt, fast_vjp=fast_vjp)
        return jnp.sum(w * g)

    want = {fv: np.asarray(jax.grad(jloss)(jnp.asarray(phi), fv))
            for fv in (False, True)}
    phi_t = torch.from_numpy(phi).requires_grad_(True)
    w = resample.warp_image(torch.from_numpy(img), phi_t, zero_boundary=zero,
                            taps_dtype=tt)
    (w * torch.from_numpy(g)).sum().backward()
    got = phi_t.grad.numpy()
    scale = np.abs(want[False]).max()
    assert scale > 0
    for fv in (False, True):
        np.testing.assert_allclose(got, want[fv], rtol=0, atol=2e-5 * scale,
                                   err_msg=f"fast_vjp={fv}")


def _phi_mixed(rng, shape, batch):
    """(batch, 3, *shape) normalized map: smooth off-kink values, a third of
    the voxels on integer pixel coordinates (the kinks; (n - 1) / 2 is a
    power of two or 0.5 on every axis, so they are exact) and a few far
    outside the volume."""
    n = np.array(shape, np.float32).reshape(3, 1, 1, 1)
    axes = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                       indexing="ij")
    pix = np.stack(axes)[None] + rng.uniform(
        -1.5, 1.5, (batch, 3) + shape).astype(np.float32) + 0.123
    pix = np.where(rng.uniform(size=pix.shape) < 0.33, np.round(pix), pix)
    far = rng.uniform(size=pix.shape) < 0.05
    pix = np.where(far, rng.choice(np.array([-40.0, 70.0], np.float32),
                                   pix.shape), pix)
    scale = np.maximum(n - 1.0, 1.0) / 2.0
    return (pix / scale - 1.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 9, 17), (1, 5, 9), (5, 9, 1)])
@pytest.mark.parametrize("taps", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("scale_intensity", [True, False])
def test_warp_image_phi_layout_matches_jax(shape, taps, padding,
                                           scale_intensity):
    """warp_image reads phi in its (B, 3, D, W, H) layout (on the CPU the
    plain version of the kernel's phi entry): its value and its gradient
    with respect to phi against JAX's warp_image and jax.grad of it, with
    and without scale_intensity, for M = D*W*H not a multiple of the
    kernels' 4 points a thread (5*9*17), spatial dims of 1 (D = 1: JAX's
    quad path; H = 1: its generic path, f32 taps whatever was asked), and
    phi on integers and far outside. Value atol 2e-6 with bf16 taps and
    2e-5 with f32 taps (tests/test_torch_warp.py), gradient atol 2e-5 of its
    largest component."""
    rng = np.random.default_rng(sum(map(ord, f"{shape}{taps}{padding}")))
    img = rng.uniform(-1, 1, (2, 2) + shape).astype(np.float32)
    phi = _phi_mixed(rng, shape, 2)
    g = rng.normal(size=(2, 2) + shape).astype(np.float32)
    zero = padding == "zeros"
    jt = jnp.bfloat16 if taps == "bfloat16" else None
    tt = torch.bfloat16 if taps == "bfloat16" else None

    def jwarp(ph):
        return jresample.warp_image(jnp.asarray(img), ph, zero_boundary=zero,
                                    scale_intensity=scale_intensity,
                                    taps_dtype=jt)

    want = np.asarray(jwarp(jnp.asarray(phi)))
    want_grad = np.asarray(jax.grad(lambda ph: jnp.sum(jwarp(ph) * g))(
        jnp.asarray(phi)))
    phi_t = torch.from_numpy(phi).requires_grad_(True)
    got = resample.warp_image(torch.from_numpy(img), phi_t,
                              zero_boundary=zero,
                              scale_intensity=scale_intensity, taps_dtype=tt)
    (got * torch.from_numpy(g)).sum().backward()
    bf16_taps = taps == "bfloat16" and min(shape) >= 2
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2e-6 if bf16_taps else 2e-5)
    scale = np.abs(want_grad).max()
    assert scale > 0
    np.testing.assert_allclose(phi_t.grad.numpy(), want_grad, rtol=0,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("taps", ["float32", "bfloat16"])
def test_warp_coord_grad_matches_pallas_with_grad(taps):
    """Off kinks the TPU kernel's with_grad variant (interpret mode, a
    window that covers the field) gives the same gradient."""
    rng = np.random.default_rng(7)
    sz = (6, 9, 9)
    img = rng.uniform(-1, 1, (1, 1) + sz).astype(np.float32)
    axes = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in sz],
                       indexing="ij")
    pix = np.stack(axes, -1)[None] + rng.uniform(
        -0.9, 0.9, (1,) + sz + (3,)).astype(np.float32) + 0.0123
    g = rng.normal(size=(1, 1) + sz).astype(np.float32)
    jt = jnp.bfloat16 if taps == "bfloat16" else None

    def jloss(c):
        w = jresample.grid_sample(jnp.asarray(img), c, padding="zeros",
                                  taps_dtype=jt, plane_window=(3, 3))
        return jnp.sum(w * g)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(pix)))
    c_t = torch.from_numpy(pix).requires_grad_(True)
    tt = torch.bfloat16 if taps == "bfloat16" else None
    w = resample.grid_sample(torch.from_numpy(img), c_t, padding="zeros",
                             taps_dtype=tt)
    (w * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(c_t.grad.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_warp_rejects_image_gradient():
    """f32 taps take an image gradient (ROADMAP B2, ported); bf16 taps
    still raise, naming B2."""
    img = torch.ones((1, 1, 4, 4, 4), requires_grad=True)
    coords = torch.full((1, 8, 3), 1.5, requires_grad=True)
    warp_trilinear_ad(img, coords, False).sum().backward()
    assert float(img.grad.sum()) == pytest.approx(8.0)
    with pytest.raises(NotImplementedError, match="B2"):
        warp_trilinear_ad(img.detach().bfloat16().requires_grad_(True),
                          coords, False)
    with pytest.raises(ValueError):
        warp_coord_grad(img.detach(), coords.detach(),
                        torch.zeros((1, 1, 7)), False)


@pytest.mark.parametrize("basis", ["bfloat16", "float32"])
def test_pca_backward_matches_jax_vjp(basis):
    rng = np.random.default_rng(3)
    L, sz = 6, (5, 6, 7)
    n = 3 * 5 * 6 * 7
    coefs = rng.normal(size=(B, L)).astype(np.float32)
    V = (rng.normal(size=(L, n)) * 0.1).astype(np.float32)
    mean = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
    g = rng.normal(size=(B, 3) + sz).astype(np.float32)
    jdt = jnp.bfloat16 if basis == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(lambda c: jexpand(c, jnp.asarray(V, jdt),
                                       jnp.asarray(mean), sz),
                     jnp.asarray(coefs))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tdt = torch.bfloat16 if basis == "bfloat16" else torch.float32
    c_t = torch.from_numpy(coefs).requires_grad_(True)
    disp = expand_pca(c_t, torch.from_numpy(V).to(tdt),
                      torch.from_numpy(mean), sz)
    (disp * torch.from_numpy(g)).sum().backward()
    got = c_t.grad.numpy()
    if basis == "bfloat16":
        # both are bf16 values; they may differ by one rounding step
        np.testing.assert_array_equal(got, got.astype(jnp.bfloat16)
                                      .astype(np.float32))
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=1e-4 * np.abs(want).max())
        plain = pca_grad_plain(torch.from_numpy(g).reshape(B, n),
                               torch.from_numpy(V).bfloat16())
        np.testing.assert_array_equal(got, plain.numpy())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pca_backward_rejects_a_trainable_basis():
    V = torch.zeros((3, 12), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError):
        expand_pca(torch.zeros((1, 3), requires_grad=True), V,
                   torch.zeros(12), (1, 2, 2))
    with pytest.raises(ValueError):
        pca_grad(torch.zeros((1, 11)), V.detach())


@pytest.mark.parametrize("name", ["ncc", "ncc_sqr"])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_similarity_values_and_gradients(name, reduction):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 2, 6, 7, 8)).astype(np.float32)
    y = (0.6 * x + 0.4 * rng.uniform(-1, 1, x.shape)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    jfn, tfn = jsim.get_similarity(name), tsim.get_similarity(name)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)

        def jl(a):
            return jnp.sum(jfn(a, jnp.asarray(y), weights=jw,
                               reduction=reduction))

        want_v = np.asarray(jfn(jnp.asarray(x), jnp.asarray(y), weights=jw,
                                reduction=reduction))
        want_g = np.asarray(jax.grad(jl)(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        got_v = tfn(xt, torch.from_numpy(y), weights=tw, reduction=reduction)
        got_v.sum().backward()
        np.testing.assert_allclose(got_v.detach().numpy(), want_v,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-6)


def test_similarity_registry():
    """Every name of the JAX registry resolves to the port's function of
    the same name; ``"gradient"``, in neither registry, raises KeyError as
    in JAX."""
    assert set(tsim.SIMILARITY_REGISTRY) == set(jsim.SIMILARITY_REGISTRY)
    for name, fn in jsim.SIMILARITY_REGISTRY.items():
        assert tsim.get_similarity(name).__name__ == fn.__name__, name
    assert tsim.get_similarity("liftreg.layers.losses.NCCLoss") \
        is tsim.ncc_loss
    assert tsim.get_similarity("ngf") is tsim.ngf_loss
    assert tsim.get_similarity("liftreg.layers.losses.NGFLoss") \
        is tsim.ngf_loss
    assert tsim.get_similarity("lncc") is tsim.lncc_loss
    for name in ("gradient", "nope"):
        with pytest.raises(KeyError):
            jsim.get_similarity(name)
        with pytest.raises(KeyError):
            tsim.get_similarity(name)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_displacement_reg_values_and_gradients(reduction):
    rng = np.random.default_rng(6)
    disp = (rng.normal(size=(2, 3, 5, 6, 7)) * 0.05).astype(np.float32)
    w = np.array([0.0, 1.0], np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        want_v = np.asarray(jreg.displacement_reg(jnp.asarray(disp),
                                                  reduction, jw))
        want_g = np.asarray(jax.grad(lambda d: jnp.sum(
            jreg.displacement_reg(d, reduction, jw)))(jnp.asarray(disp)))
        dt = torch.from_numpy(disp).requires_grad_(True)
        got_v = treg.displacement_reg(dt, reduction, tw)
        got_v.sum().backward()
        np.testing.assert_allclose(got_v.detach().numpy(), want_v,
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(dt.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-6)
