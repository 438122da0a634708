"""Dense per-pair registration (``liftreg_tpu_torch/optreg.py``) and the
refinement loop's best-iterate selection on control grids, against
``liftreg_tpu`` on the CPU.

Tolerances (absolute, f32):
- ``upsample_grid`` against ``jax.image.resize(method="linear")``: 5e-7 of
  the largest value (the port interpolates in one pass, JAX in per-axis
  products; a few ulps);
- one ``make_level`` (f32 taps, 3 steps): the best grid, phi and disp
  1e-5, warped 1e-4, the histories and per-sample totals 1e-6;
- a two-level ``DenseRegisterer`` with bf16 taps (as
  ``tools/torch_build_pca.py`` runs it): grid, phi and disp 1e-4, warped
  5e-4, histories 2e-6. The first Adam step of a level moves every grid
  node by about ``lr`` in the sign of its gradient, so a node whose
  gradient is near 0 (far from any intensity edge) amplifies last-bit
  differences: with f32 taps a second level already moves such a node by
  2 lr in one framework and not the other, which is why the two-level
  check runs the tool's bf16 taps;
- ``disp`` is ``phi`` minus the identity map that JAX builds outside
  ``jit``: the port's eager rule (``coords.linspace_eager``) is held
  bit-equal to an eager ``jnp.linspace``, and ``phi - disp`` to it;
- ``_build_refine`` on a 5-D grid: 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from liftreg_tpu import optreg as joptreg
from liftreg_tpu import refine as jrefine
from liftreg_tpu.coords import identity_map as jidentity_map
from liftreg_tpu_torch import optreg, refine
from liftreg_tpu_torch.coords import identity_map, linspace_eager

SZ = (24, 24, 24)


@pytest.mark.parametrize("g,n", [(10, 160), (20, 160), (40, 160),
                                 (10, 20), (20, 40)])
def test_upsample_grid_matches_jax_image_resize(g, n):
    z = (np.random.default_rng(g + n).normal(size=(1, 3, g, g, g)) * 0.05
         ).astype(np.float32)
    want = np.asarray(joptreg.upsample_grid(jnp.asarray(z), (n, n, n)))
    got = optreg.upsample_grid(torch.from_numpy(z), (n, n, n)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-7 * np.abs(want).max())


@pytest.mark.parametrize("n", list(range(2, 41)) + [64, 96, 128, 160, 352,
                                                    353, 512])
def test_eager_identity_map_rule(n):
    """The identity map JAX builds outside ``jit`` (``DenseRegisterer``'s
    ``disp``): bit-equal."""
    want = np.asarray(jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32))
    np.testing.assert_array_equal(linspace_eager(-1.0, 1.0, n).numpy(),
                                  want)


def _pair(seed, B=2):
    """Smooth seeded moving images in [-1, 1] and a shifted target."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.normal(size=(B, 1, 6, 6, 6)).astype(
        np.float32))
    mov = F.interpolate(low, size=SZ, mode="trilinear",
                        align_corners=True).clamp(-1, 1).numpy()
    return mov, np.roll(mov, (1, -1, 1), axis=(2, 3, 4)).copy()


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_make_level_matches_jax():
    mov, tgt = _pair(0)
    z0 = np.zeros((2, 3, 6, 6, 6), np.float32)
    want = joptreg.make_level(SZ, 6, n_steps=3, lr=0.04)(
        jnp.asarray(z0), jnp.asarray(mov), jnp.asarray(tgt))
    got = optreg.make_level(SZ, 6, n_steps=3, lr=0.04)(
        torch.from_numpy(z0), torch.from_numpy(mov), torch.from_numpy(tgt))
    for key in ("coefs", "phi"):
        _close(got[key], want[key], 1e-5)
    _close(got["warped"], want["warped"], 1e-4)
    for key in ("total_history", "sim_history", "total_per_sample",
                "sim_per_sample"):
        _close(got[key], want[key], 1e-6)


def test_dense_registerer_matches_jax():
    mov, tgt = _pair(1)
    levels = ((6, 3, 0.04), (12, 3, 0.02))
    want = joptreg.DenseRegisterer(SZ, levels=levels,
                                   warp_taps_dtype=jnp.bfloat16)(
        jnp.asarray(mov), jnp.asarray(tgt))
    reg = optreg.DenseRegisterer(SZ, levels=levels,
                                 warp_taps_dtype=torch.bfloat16)
    got = reg(torch.from_numpy(mov), torch.from_numpy(tgt))
    assert reg.launches() == (5 + 5, 4 + 4)
    for key in ("z", "coefs", "phi", "disp"):
        _close(got[key], want[key], 1e-4)
    _close(got["warped"], want["warped"], 5e-4)
    for key in ("total_history", "sim_history", "total_per_sample"):
        _close(got[key], want[key], 2e-6)
    # disp = phi - the eager identity map, JAX's rule outside jit
    idm = np.asarray(jidentity_map(SZ))
    np.testing.assert_array_equal(identity_map(SZ, eager=True).numpy(), idm)
    np.testing.assert_array_equal(got["disp"].numpy(),
                                  (got["phi"] - torch.from_numpy(idm))
                                  .numpy())
    hist = got["total_history"].numpy()
    assert hist[-1] <= hist[0]


def test_build_refine_selects_per_sample_on_a_5d_grid():
    """The repaired selection: a (2, 3, 4, 4, 4) iterate whose two samples
    reach their minima at different steps (Adam moves each element by about
    lr a step towards 0.25 and 0.65), against JAX's ``_build_refine`` with
    ``optax.adam``."""
    target = np.zeros((2, 3, 4, 4, 4), np.float32)
    target[0], target[1] = 0.25, 0.65
    scale = np.array([1.0, 2.0], np.float32)

    def jlosses(z, a):
        per = jnp.mean((z - a) ** 2, axis=(1, 2, 3, 4)) * scale
        return per, (per * 0.5, z * 2.0, z + 1.0)

    def tlosses(z, a):
        per = ((z - a) ** 2).mean(dim=(1, 2, 3, 4)) * torch.from_numpy(scale)
        return per, (per * 0.5, z * 2.0, z + 1.0)

    z0 = np.zeros_like(target)
    want = jrefine._build_refine(jlosses, optax.adam(0.1), 10)(
        jnp.asarray(z0), jnp.asarray(target))
    got = refine._build_refine(tlosses, 0.1, 10)(torch.from_numpy(z0),
                                                 torch.from_numpy(target))
    # the two samples' best iterates come from different steps
    best = np.asarray(want["coefs"])
    assert not np.allclose(best[0] - 0.25, best[1] - 0.65, atol=1e-3)
    for key in ("coefs", "total_history", "sim_history",
                "total_per_sample", "phi", "warped"):
        _close(got[key], want[key], 1e-6)
