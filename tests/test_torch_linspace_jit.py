"""C4 inside jit: the port's identity map against the JAX package's as its
callers build it, inside ``jit`` (``liftreg_tpu/models/subspace_backproj.py
:192``, ``models/subspace.py:71``, ``models/unet2d3d.py:143``,
``refine.py:205,292``), bit for bit: alone for every axis length from 2 to
1024, fused into ``disp + identity_map`` with a traced zero ``disp`` as
the models add it, and as the phi of the jitted
``RegistrationPipeline.register`` / ``register_projections`` with a zero
basis and a zero mean (phi is then the identity map as the pipeline
compiles it) against the port's pipeline on the CPU. The rule
(``coords.linspace_in_jit``) follows XLA's CPU code generation, so these
tests compare with a live ``jax.jit`` and keep no stored values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu import coords as jcoords
from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline
from liftreg_tpu_torch import RegistrationPipeline, params_from_jax
from liftreg_tpu_torch import coords

_JIT_IDENTITY = jax.jit(jcoords.identity_map, static_argnums=0)


@pytest.mark.parametrize("first", list(range(2, 1025, 128)))
def test_identity_map_inside_jit_every_axis_length(first):
    """Every axis length from 2 to 1024, 128 lengths a case."""
    for n in range(first, min(first + 128, 1025)):
        np.testing.assert_array_equal(
            coords.identity_map((n,)).numpy(),
            np.asarray(_JIT_IDENTITY((n,))), err_msg=f"n={n}")


@pytest.mark.parametrize("sz", [(32, 32, 32), (160, 160, 160), (7, 9, 11),
                                (400, 8, 8), (8, 8, 400), (8, 720, 4),
                                (3, 5, 1024), (64, 64)])
def test_identity_map_fused_into_displacement(sz):
    """``d + identity_map(sz)[None]`` with a traced zero ``d``: XLA fuses
    the identity map into the add, as in the models."""
    d = jnp.zeros((1, len(sz)) + sz, jnp.float32)
    want = jax.jit(lambda d: d + jcoords.identity_map(sz)[None])(d)
    np.testing.assert_array_equal(coords.identity_map(sz).numpy(),
                                  np.asarray(want)[0])


@pytest.mark.parametrize("entry", ["register", "register_projections"])
def test_pipeline_phi_with_zero_basis(entry):
    """The jitted pipeline's phi at 32^3 with a zero basis and zero mean,
    against the port's pipeline on the CPU from the same weights."""
    sz, latent = (32, 32, 32), 4
    n = 3 * int(np.prod(sz))
    rng = np.random.default_rng(0)
    src = rng.uniform(-1000, 0, (1, 1) + sz).astype(np.float32)
    tgt = rng.uniform(-1000, 0, (1, 1) + sz).astype(np.float32)
    jp = JPipeline(sz, latent_dim=latent)
    jpca = {"vectors": jnp.zeros((latent, n)), "mean": jnp.zeros(n)}
    params = jp.init_params(jax.random.PRNGKey(0), jpca)
    tp = RegistrationPipeline(sz, latent_dim=latent, device="cpu")
    tp.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tpca = {"vectors": torch.zeros((latent, n)), "mean": torch.zeros(n)}
    if entry == "register":
        _, want = jp.register(params, jpca, src, tgt)
        _, got = tp.register(tpca, torch.from_numpy(src),
                             torch.from_numpy(tgt))
    else:
        proj = rng.uniform(-1, 1, (1, 4) + jp.resolution).astype(np.float32)
        _, want = jp.register_projections(params, jpca, src, proj)
        _, got = tp.register_projections(tpca, torch.from_numpy(src),
                                         torch.from_numpy(proj))
    want = np.asarray(want)
    np.testing.assert_array_equal(want[0], np.asarray(_JIT_IDENTITY(sz)))
    np.testing.assert_array_equal(got.numpy(), want)
