"""C4: liftreg_tpu_torch.coords.linspace against a live jnp.linspace, for
long axes and the DRR geometry's ranges, on the CPU.

Outside ``jit`` (a CPU call, as the JAX package's tests and eager callers
make it) the port is bit-equal to ``jnp.linspace`` for every n from 2 to
1024 on ``(-1, 1)``, the centred range ``(-n/2, n/2 - 1)``, its reverse,
``(0, 1)``, ``(-1.1n, 0.7n)``, and the geometry's ``(n - 1, 0)`` and
``(0, n - 1)``. Inside ``jit``, where the JAX package builds its DRR
geometry (``liftreg_tpu/ops/drr.py:125-127,165-167``) with the ranges'
ends as constants, XLA rounds the centred range otherwise: the port is
held there to 1 ulp of ``n/2`` (the exception its docstring names), and
bit-equal on the reversed and plane ranges. The rule follows XLA's CPU
code generation, so these tests compare with a live ``jnp.linspace`` and
keep no stored values."""
import jax.numpy as jnp
import numpy as np
import pytest

from liftreg_tpu_torch import coords


def _ranges(n):
    return {"unit": (-1.0, 1.0), "centred": (-n / 2.0, n / 2.0 - 1.0),
            "centred_reversed": (n / 2.0 - 1.0, -n / 2.0),
            "zero_one": (0.0, 1.0), "wide": (-1.1 * n, 0.7 * n),
            "planes_reversed": (n - 1.0, 0.0), "planes": (0.0, n - 1.0)}


def _check_eager(ns, names):
    for n in ns:
        for name in names:
            lo, hi = _ranges(n)[name]
            np.testing.assert_array_equal(
                coords.linspace(lo, hi, n).numpy(),
                np.asarray(jnp.linspace(lo, hi, n, dtype=jnp.float32)),
                err_msg=f"{name} linspace({lo}, {hi}, {n})")


@pytest.mark.parametrize("first", list(range(257, 641, 64)))
def test_linspace_bit_equal_long(first):
    """n from 257 to 640 on every range, 64 sizes a case (641 to 1024 are
    in test_torch_linspace_geometry.py)."""
    _check_eager(range(first, first + 64), list(_ranges(2)))
