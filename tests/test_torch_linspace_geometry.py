"""C4, continued from test_torch_linspace_long.py (which states the
rules and tolerances): n from 641 to 1024, the short n on the ranges
besides (-1, 1), the DRR geometry's ranges inside jit and the identity map
of long axes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu_torch import coords
from liftreg_tpu_torch.ops import drr as tdrr

from test_torch_linspace_long import _check_eager, _ranges


@pytest.mark.parametrize("first", list(range(641, 1025, 64)))
def test_linspace_bit_equal_longest(first):
    """n from 641 to 1024 on every range, 64 sizes a case."""
    _check_eager(range(first, first + 64), list(_ranges(2)))


@pytest.mark.parametrize("name", ["centred", "centred_reversed", "zero_one",
                                  "wide", "planes_reversed", "planes"])
def test_linspace_bit_equal_short(name):
    """n from 2 to 256 on the ranges besides (-1, 1) (which
    test_torch_coords_drr.py holds), including the small n where element 1
    takes the other contraction."""
    _check_eager(range(2, 257), [name])


@pytest.mark.parametrize("n", [236, 240, 256, 300, 352, 353, 360, 480, 512,
                               720, 1024])
def test_drr_geometry_ranges_inside_jit(n):
    """The geometry's ranges as the JAX package builds them, inside jit
    with constant ends: the reversed and plane ranges bit-equal, the
    centred range within 1 ulp of n/2 (0 to 1 ulp measured for n from 236
    to 1024)."""
    like = torch.zeros(1)
    for name in ("centred", "planes_reversed", "planes"):
        lo, hi = _ranges(n)[name]
        want = np.asarray(jax.jit(functools.partial(
            jnp.linspace, lo, hi, n, dtype=jnp.float32))())
        got = tdrr._linspace(lo, hi, n, like).numpy()
        if name == "centred":
            ulp = np.spacing(np.float32(n / 2.0))
            assert np.abs(got - want).max() <= ulp, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n", [353, 400, 513, 1024])
def test_identity_map_long_axis(n):
    """The identity map of an axis >= 353 voxels is the eager jnp
    linspace, bit for bit (C4 broke it from 353 on)."""
    from liftreg_tpu import coords as jcoords
    sz = (n, 2, 3)
    np.testing.assert_array_equal(coords.identity_map(sz).numpy(),
                                  np.asarray(jcoords.identity_map(sz)))
