"""The port's PCA expansion (liftreg_tpu_torch.ops.pca_kernel plain version,
models.expand_pca, pca.load_pca) against liftreg_tpu on the CPU.

Tolerances: atol/rtol 1e-5 against the Pallas kernel in interpret mode
(same bf16-rounded coefficients and bf16 basis, f32 sums taken in another
order); 1e-5 for the f32 basis against XLA at HIGHEST."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.models.subspace_backproj import expand_pca as jexpand
from liftreg_tpu.ops.pallas_pca import expand_pca_streamed
from liftreg_tpu_torch.models.subspace_backproj import expand_pca as texpand
from liftreg_tpu_torch.ops.pca_kernel import pca_expand, pca_expand_plain
from liftreg_tpu_torch.pca import load_pca


def _rand(B, L, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L)).astype(np.float32),
            (rng.standard_normal((L, n)) * 0.01).astype(np.float32),
            (rng.standard_normal(n) * 0.01).astype(np.float32))


# 3*16^3 is divided by the block; 3*5^3 = 375 has no power-of-two block
# divisor >= 128, where the TPU wrapper takes its XLA formulation
@pytest.mark.parametrize("n", [3 * 16 ** 3, 3 * 5 ** 3])
def test_plain_matches_pallas_interpret(n):
    coefs, V, mean = _rand(3, 7, n)
    want = np.asarray(expand_pca_streamed(
        jnp.asarray(coefs), jnp.asarray(V, jnp.bfloat16), jnp.asarray(mean),
        2048, True))
    got = pca_expand(torch.from_numpy(coefs),
                     torch.from_numpy(V).bfloat16(), torch.from_numpy(mean))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("basis", ["bfloat16", "float32"])
def test_expand_pca_matches_jax(basis):
    sz = (4, 5, 6)
    coefs, V, mean = _rand(2, 5, 3 * 4 * 5 * 6, seed=1)
    want = np.asarray(jexpand(jnp.asarray(coefs),
                              jnp.asarray(V, getattr(jnp, basis)),
                              jnp.asarray(mean), sz))
    got = texpand(torch.from_numpy(coefs),
                  torch.from_numpy(V).to(getattr(torch, basis)),
                  torch.from_numpy(mean), sz)
    assert got.shape == (2, 3) + sz
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_rounds_coefs_to_bf16():
    coefs = torch.tensor([[1.0 + 2 ** -10]])
    out = pca_expand_plain(coefs, torch.ones((1, 3), dtype=torch.bfloat16),
                           torch.zeros(3))
    assert torch.equal(out, torch.ones((1, 3)))


def test_load_pca(tmp_path):
    _, V, mean = _rand(1, 4, 30, seed=2)
    np.save(tmp_path / "pca_vectors.npy", V)
    np.save(tmp_path / "pca_mean.npy", mean)
    f32 = load_pca(str(tmp_path), device="cpu")
    bf = load_pca(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(f32["vectors"].numpy(), V)
    assert bf["vectors"].dtype == torch.bfloat16
    assert bf["mean"].dtype == torch.float32
    np.testing.assert_array_equal(bf["mean"].numpy(), mean)
    np.testing.assert_array_equal(
        bf["vectors"].float().numpy(),
        np.asarray(jnp.asarray(V, jnp.bfloat16).astype(jnp.float32)))
