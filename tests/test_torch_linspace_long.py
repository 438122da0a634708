"""C4: liftreg_tpu_torch.coords.linspace_in_jit against ``jnp.linspace``
compiled by ``jax.jit`` with constant ends, as the JAX package builds its
identity map and DRR geometry (``liftreg_tpu/ops/drr.py:125-127,165-167``),
for long axes, on the CPU: bit-equal for every n from 2 to 1024 on
``(-1, 1)``, the centred range ``(-n/2, n/2 - 1)``, its reverse,
``(0, 1)``, ``(-1.1n, 0.7n)``, and the geometry's ``(n - 1, 0)`` and
``(0, n - 1)`` (the short n and n from 641 are in
test_torch_linspace_geometry.py). The rule follows XLA's CPU code
generation, so these tests compare with a live ``jax.jit`` and keep no
stored values."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liftreg_tpu_torch import coords


def _ranges(n):
    return {"unit": (-1.0, 1.0), "centred": (-n / 2.0, n / 2.0 - 1.0),
            "centred_reversed": (n / 2.0 - 1.0, -n / 2.0),
            "zero_one": (0.0, 1.0), "wide": (-1.1 * n, 0.7 * n),
            "planes_reversed": (n - 1.0, 0.0), "planes": (0.0, n - 1.0)}


def _jit_linspace(lo, hi, n):
    return np.asarray(jax.jit(functools.partial(
        jnp.linspace, lo, hi, n, dtype=jnp.float32))())


def _check_jit(ns, names):
    for n in ns:
        for name in names:
            lo, hi = _ranges(n)[name]
            np.testing.assert_array_equal(
                coords.linspace_in_jit(lo, hi, n).numpy(),
                _jit_linspace(lo, hi, n),
                err_msg=f"{name} linspace({lo}, {hi}, {n})")


@pytest.mark.parametrize("first", list(range(257, 641, 64)))
def test_linspace_bit_equal_long(first):
    """n from 257 to 640 on every range, 64 sizes a case (641 to 1024 are
    in test_torch_linspace_geometry.py)."""
    _check_jit(range(first, first + 64), list(_ranges(2)))
