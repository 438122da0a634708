"""The port's space-to-depth encoder stages (``liftreg_tpu_torch/models/
s2d.py``) against ``liftreg_tpu.models.s2d`` on the CPU, and the three
models' use of them.

Inputs come from a numpy seed at ``tests/test_s2d.py``'s shapes. The port
is channels-first: its tensors are JAX's with the channel axis moved to
1, its conv weights (O, I, kz, ky, kx) JAX's (kz, ky, kx, I, O)
transposed.

Tolerances: the packing, the unpacking and the 2^3 kernels bit for bit
(data movement, and sums of one nonzero term); the convolutions in f32
within 1e-5 of the largest output value (f32 sums in another order), in
bf16 within 2^-6 of it (the two frameworks round a bf16 conv's output and
its bias at other places, one bf16 step of stage 0's output carried
through stage 1; measured here: at most 6.0e-7 in f32 and 7.1e-3 in
bf16); gradients in f32 within 1e-5 of each leaf's largest value. The
port's s2d encoder against its plain encoder on the same parameters:
outputs and parameter gradients within 1e-5 of the largest value (the
same operator, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.models import s2d as js
from liftreg_tpu_torch.models import (LiftRegSubspace,
                                      LiftRegSubspaceBackproj, RegNet2D3D,
                                      SubspaceEncoder, s2d)

SHAPES = [(8, 5, 16, 32), (12, 3, 8, 8), (16, 5, 16, 32)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}


def _pair(D, C, F, G, B=2, seed=0):
    """x (B, D, D, D, C) and the two stages' (3, 3, 3, I, O) kernels and
    biases, numpy f32."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, D, D, D, C).astype(np.float32),
            (rng.randn(3, 3, 3, C, F) * 0.1).astype(np.float32),
            (rng.randn(F) * 0.1).astype(np.float32),
            (rng.randn(3, 3, 3, F, G) * 0.1).astype(np.float32),
            (rng.randn(G) * 0.1).astype(np.float32))


def _to_torch(x, w0, b0, w1, b1, dtype=torch.float32):
    """The port's layouts of ``_pair``'s arrays, in ``dtype``."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return (t(np.moveaxis(x, -1, 1)), t(w0.transpose(4, 3, 0, 1, 2)), t(b0),
            t(w1.transpose(4, 3, 0, 1, 2)), t(b1))


def _to_jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D,C,F,G", SHAPES)
def test_pack_and_unpack_match_jax(D, C, F, G, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    arrays = _pair(D, C, F, G)
    x = _to_torch(*arrays, dtype=tdt)[0]
    want = np.moveaxis(_np(js.pack_s2d(_to_jax(arrays, jdt)[0])), -1, 1)
    got = s2d.pack_s2d(x)
    assert got.dtype == tdt
    assert got.shape == (2, 8 * C) + (D // 2 + 1,) * 3
    np.testing.assert_array_equal(_np(got), want)
    packed = np.random.RandomState(1).randn(
        2, D // 2, D // 2, D // 2, 8 * F).astype(np.float32)
    want = _np(js.unpack_s2d(jnp.asarray(packed, jdt)))
    got = s2d.unpack_s2d(torch.from_numpy(np.moveaxis(packed, -1, 1)).to(
        tdt))
    assert got.shape == (2, F) + (D,) * 3
    np.testing.assert_array_equal(_np(got), np.moveaxis(want, -1, 1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D,C,F,G", SHAPES)
def test_stage_weights_bit_equal_to_jax(D, C, F, G, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    arrays = _pair(D, C, F, G)
    _, w0, _, w1, _ = _to_torch(*arrays, dtype=tdt)
    _, jw0, _, jw1, _ = _to_jax(arrays, jdt)
    got0, got1 = s2d.stage0_weights(w0), s2d.stage1_weights(w1)
    assert got0.shape == (8 * F, 8 * C, 2, 2, 2) and got0.dtype == tdt
    assert got1.shape == (G, 8 * F, 2, 2, 2) and got1.dtype == tdt
    np.testing.assert_array_equal(
        _np(got0), _np(js.stage0_weights(jw0)).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        _np(got1), _np(js.stage1_weights(jw1)).transpose(4, 3, 0, 1, 2))
    # (4/3)^3 of the plain taps are zero, the rest are the plain taps
    assert int((got0 != 0).sum()) == 27 * 8 * F * C


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D,C,F,G", SHAPES)
def test_convs_match_jax(D, C, F, G, dtype):
    """conv0_s2d and conv_pair_s2d with f32 parameters cast to the compute
    type, as the encoders call them."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _pair(D, C, F, G)
    x, w0, b0, w1, b1 = _to_torch(*arrays)
    jx, jw0, jb0, jw1, jb1 = _to_jax(arrays)
    want0 = np.moveaxis(_np(js.conv0_s2d(jx.astype(jdt), jw0, jb0,
                                         dtype=jdt)), -1, 1)
    got0 = s2d.conv0_s2d(x.to(tdt), w0, b0, dtype=tdt)
    assert got0.dtype == tdt and got0.shape == (2, 8 * F) + (D // 2,) * 3
    np.testing.assert_allclose(_np(got0), want0, rtol=0,
                               atol=tol * np.abs(want0).max())
    want = np.moveaxis(_np(js.conv_pair_s2d(jx.astype(jdt), jw0, jb0, jw1,
                                            jb1, dtype=jdt)), -1, 1)
    got = s2d.conv_pair_s2d(x.to(tdt), w0, b0, w1, b1, dtype=tdt)
    assert got.dtype == tdt and got.shape == (2, G) + (D // 2,) * 3
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("D,C,F,G", SHAPES)
def test_pair_gradients_match_jax(D, C, F, G):
    """The gradients of a squared error of conv_pair_s2d with respect to
    the input, both kernels and both biases, against ``jax.grad``."""
    arrays = _pair(D, C, F, G, seed=2)
    tgt = np.random.RandomState(3).randn(2, D // 2, D // 2, D // 2,
                                         G).astype(np.float32)

    def jloss(*a):
        return jnp.mean((js.conv_pair_s2d(*a) - jnp.asarray(tgt)) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_to_jax(arrays))
    leaves = [t.requires_grad_() for t in _to_torch(*arrays)]
    loss = ((s2d.conv_pair_s2d(*leaves)
             - torch.from_numpy(np.moveaxis(tgt, -1, 1))) ** 2).mean()
    loss.backward()
    layouts = (lambda a: np.moveaxis(a, -1, 1),
               lambda a: a.transpose(4, 3, 0, 1, 2), lambda a: a,
               lambda a: a.transpose(4, 3, 0, 1, 2), lambda a: a)
    for name, t, w, layout in zip(("x", "w0", "b0", "w1", "b1"), leaves,
                                  want, layouts):
        w = layout(np.asarray(w))
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _encoders(sz, enc=(8, 8, 8), seed=0):
    torch.manual_seed(seed)
    plain = SubspaceEncoder(5, 4, (sz,) * 3, enc, fc_widths=(16,))
    fast = SubspaceEncoder(5, 4, (sz,) * 3, enc, fc_widths=(16,),
                           s2d_stage01=True)
    fast.load_state_dict(plain.state_dict())
    return plain, fast


def _outputs_and_grads(enc, x):
    enc.zero_grad()
    out = enc(x)
    (out * torch.arange(1.0, out.shape[1] + 1.0)).sum().backward()
    return out.detach(), {k: p.grad.clone()
                          for k, p in enc.named_parameters()}


def test_encoder_s2d_against_its_plain_form():
    """The port's encoder with s2d on and off, on the same parameters (the
    state dict is the same): outputs and every parameter's gradient."""
    plain, fast = _encoders(16)
    assert plain.state_dict().keys() == fast.state_dict().keys()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 5, 16, 16, 16)).astype(np.float32))
    want, want_g = _outputs_and_grads(plain, x)
    got, got_g = _outputs_and_grads(fast, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    for k, w in want_g.items():
        assert float(w.abs().max()) > 0, k
        np.testing.assert_allclose(got_g[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=k)


class _Spy:
    """Counts the calls of one of s2d's functions, then calls it."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(s2d, name)

        def spy(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(s2d, name, spy)


@pytest.mark.parametrize("sz", [15, 2])
def test_ineligible_shapes_fall_back(monkeypatch, sz):
    """Odd or too small spatial dims are ineligible: the flag then runs
    the plain ConvBlocks, bit for bit the plain encoder."""
    assert s2d.eligible((1, 5, 14, 14, 14), (16, 32))
    assert not s2d.eligible((1, 5, sz, sz, sz), (16, 32))
    assert not s2d.eligible((1, 5, 14, 14, 14), (16,))
    assert not s2d.eligible((1, 5, 14, 14, 15), (16, 32))
    spy = _Spy(monkeypatch, "conv_pair_s2d")
    plain, fast = _encoders(sz, enc=(8, 8))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, 5, sz, sz, sz)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(fast(x), plain(x))
    assert spy.calls == 0


def _backproj_inputs(sz=16, P=2, B=1, seed=0):
    rng = np.random.default_rng(seed)
    seg = (rng.uniform(size=(B, 1) + (sz,) * 3) > 0.3).astype(np.float32)
    arrays = {
        "source": rng.uniform(-1, 1, (B, 1) + (sz,) * 3),
        "target": rng.uniform(-1, 1, (B, 1) + (sz,) * 3),
        "target_proj": rng.uniform(-1, 1, (B, P, 24, 24)),
        "target_poses": np.array([[-8.0, 56.0, -3.0], [8.0, 56.0, 3.0]]),
        "source_label": seg, "target_label": seg,
        "spacing": np.full((B, 3), 2.2),
        "original_source": rng.uniform(0.0, 0.3, (B, 1) + (sz,) * 3)}
    n = 3 * sz ** 3
    pca = {"vectors": rng.standard_normal((4, n)) * 0.01,
           "mean": rng.standard_normal(n) * 0.01}
    as_t = lambda d: {k: torch.from_numpy(v.astype(np.float32))  # noqa: E731
                      for k, v in d.items()}
    return as_t(arrays), as_t(pca)


MODELS = {
    "subspace_backproj": (lambda s2d_on: LiftRegSubspaceBackproj(
        (16,) * 3, latent_dim=4, drr_feature_num=2,
        enc_filters=(8, 8, 8, 8, 8), s2d_encoder=s2d_on),
        ("conv_pair_s2d",)),
    "subspace": (lambda s2d_on: LiftRegSubspace(
        (16,) * 3, latent_dim=4, drr_feature_num=2,
        enc_filters=(8, 8, 8, 8, 8), s2d_encoder=s2d_on),
        ("conv_pair_s2d",)),
    "regnet2d3d": (lambda s2d_on: RegNet2D3D(
        (16,) * 3, drr_feature_num=2, enc_filters=(8, 8, 8, 8, 8),
        dec_filters=(8, 8, 8, 8, 8, 8), inverse_iters=2,
        s2d_encoder=s2d_on), ("conv0_s2d", "unpack_s2d", "conv1_s2d")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_take_the_s2d_path(monkeypatch, name):
    """With ``s2d_encoder=True`` at an eligible shape each model calls the
    s2d functions once a forward (and not the first two ConvBlocks), with
    it off never; both give the same outputs from the same state dict."""
    build, fns = MODELS[name]
    spies = {fn: _Spy(monkeypatch, fn) for fn in fns}
    torch.manual_seed(0)
    plain = build(False)
    fast = build(True)
    fast.load_state_dict(plain.state_dict())
    blocks = []
    for conv in (fast.encoder.convs if name != "regnet2d3d"
                 else fast.convs)[:2]:
        conv.register_forward_hook(lambda *a: blocks.append(1))
    inputs, pca = _backproj_inputs()
    with torch.no_grad():
        want = plain(inputs, pca)
        assert all(s.calls == 0 for s in spies.values())
        got = fast(inputs, pca)
    assert {fn: s.calls for fn, s in spies.items()} == dict.fromkeys(fns, 1)
    assert not blocks
    np.testing.assert_allclose(got["phi"].numpy(), want["phi"].numpy(),
                               rtol=0, atol=1e-5)
