"""C4, continued from test_torch_linspace_long.py: n from 641 to 1024,
the short n on the ranges besides (-1, 1), and the DRR geometry's ranges
and the identity map of long axes as the JAX package builds them, inside
jit (``coords.linspace_in_jit``), bit for bit."""
import jax
import numpy as np
import pytest
import torch

from liftreg_tpu_torch import coords
from liftreg_tpu_torch.ops import drr as tdrr

from test_torch_linspace_long import _check_jit, _jit_linspace, _ranges


@pytest.mark.parametrize("first", list(range(641, 1025, 64)))
def test_linspace_bit_equal_longest(first):
    """n from 641 to 1024 on every range, 64 sizes a case."""
    _check_jit(range(first, first + 64), list(_ranges(2)))


@pytest.mark.parametrize("name", ["centred", "centred_reversed", "zero_one",
                                  "wide", "planes_reversed", "planes"])
def test_linspace_bit_equal_short(name):
    """n from 2 to 256 on the ranges besides (-1, 1) (which
    test_torch_coords_drr.py holds)."""
    _check_jit(range(2, 257), [name])


@pytest.mark.parametrize("n", [236, 240, 256, 300, 352, 353, 360, 480, 512,
                               720, 1024])
def test_drr_geometry_ranges_inside_jit(n):
    """The geometry's ranges as the JAX package builds them, inside jit
    with constant ends: bit-equal."""
    like = torch.zeros(1)
    for name in ("centred", "planes_reversed", "planes"):
        lo, hi = _ranges(n)[name]
        np.testing.assert_array_equal(
            tdrr._linspace(lo, hi, n, like).numpy(), _jit_linspace(lo, hi, n),
            err_msg=name)


@pytest.mark.parametrize("first", list(range(2, 1025, 128)))
def test_drr_centred_range_inside_jit_every_n(first):
    """The detector's and the volume's centred range (-n/2, n/2 - 1)
    inside jit, bit-equal for every n from 2 to 1024, 128 sizes a case."""
    like = torch.zeros(1)
    for n in range(first, min(first + 128, 1025)):
        lo, hi = _ranges(n)["centred"]
        np.testing.assert_array_equal(
            tdrr._linspace(lo, hi, n, like).numpy(), _jit_linspace(lo, hi, n),
            err_msg=f"linspace({lo}, {hi}, {n})")


@pytest.mark.parametrize("n", [353, 400, 513, 1024])
def test_identity_map_long_axis(n):
    """The identity map of an axis >= 353 voxels is the JAX package's,
    built inside jit as its models and refiners build it, bit for bit."""
    from liftreg_tpu import coords as jcoords
    sz = (n, 2, 3)
    want = jax.jit(jcoords.identity_map, static_argnums=0)(sz)
    np.testing.assert_array_equal(coords.identity_map(sz).numpy(),
                                  np.asarray(want))

