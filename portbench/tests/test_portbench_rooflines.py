"""Each operation's roofline count at the serving shapes (160^3, B = 4,
4 views on 240^2, latent 56, bf16 basis, taps and encoder input) gives
the bound of the port's kernel table in PERF.md."""
import pytest

from portbench.lib import catalog, flops, readers

SERVE = {"B": 4, "D": 160, "W": 160, "H": 160, "L": 56, "P": 4, "rd": 240,
         "rh": 240, "taps_bytes": 2, "basis_bytes": 2,
         "basis_dtype": "bfloat16", "lift_bytes": 2}
BOUND_MS = {"pca_expand": 0.484, "pca_grad": 0.470, "warp_trilinear": 0.088,
            "warp_coord_grad": 0.147, "drr_project": 0.0213,
            "drr_project_adjoint": 0.0213, "encoder_input": 0.0698}


@pytest.mark.parametrize("op", sorted(BOUND_MS))
def test_bound_at_serving_shapes(op):
    mod = catalog.rooflines()[op]
    ms = readers.bound_s(*mod.cost(SERVE)) * 1e3
    assert ms == pytest.approx(BOUND_MS[op], rel=2e-3)
    assert mod.COUNTER and mod.PATTERNS


def test_every_roofline_is_counted():
    assert set(catalog.rooflines()) == set(BOUND_MS)


def test_model_flops():
    cfg = catalog.config("liftreg160_serve_bf16")
    # stage 0 alone: 5 -> 16 channels, 3^3 taps, 160^3 outputs, B = 4
    stage0 = 2 * 16 * 5 * 27 * 160 ** 3 * 4
    fwd = flops.model_flops(cfg, 4)
    assert stage0 < fwd < 3 * stage0
    assert flops.model_flops(cfg, 4, train=True) > 2 * fwd
