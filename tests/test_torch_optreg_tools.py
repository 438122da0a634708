"""The port's per-pair optimization tools against the JAX package's on the
CPU: ``tools/torch_optreg_oracle.py`` against ``tools/optreg_oracle.py``
and ``tools/torch_optreg_objective_ab.py`` against
``tools/optreg_objective_ab.py``, on one seeded 24^3 dataset (the
``datasets`` fixture's settings in ``tests/test_torch_learned_basis.py``),
two pairs, two levels of 2 steps, bf16 taps.

Tolerances: each pair's relative error within 1e-3 (the registered fields
agree within 5e-4 of the field: ``tests/test_torch_optreg.py``,
``tests/test_torch_learned_basis.py``; the JAX oracle's printed errors
carry 4 decimals, so 1e-3 + 5e-5 there); the printed case ids, the ground
truth's RMS in mm and the ``BEST:`` variant equal. Without ``--device``
and without a card each tool raises before it registers anything.

One exception, where the reference itself is ill-conditioned: a pair
whose relative error in the JAX tool moves by more than 1e-3 when its
target changes by one ulp (``np.nextafter``, every voxel, up or down). There
the port is held within that spread, the reference's own reproducibility,
and within 1e-2 (the bound this pair had before its cause was shown).
On this dataset lncc_masked's first pair is such a pair: its LNCC gradient
at the identity, on one warped image, is dominated by f32 rounding in both
packages (``test_lncc_gradient_as_accurate_as_jax``), the optimisation
follows it, and the JAX tool's error moves by 3.6e-2 under a one-ulp
change of the target, against 2.7e-5 for the second pair; the two tools
differ by 5.8e-3 there. At most one pair may pass 1e-3.

``test_lncc_gradient_as_accurate_as_jax``: on the moving image warped by
JAX at the identity, the port's f32 LNCC gradient lies within twice JAX's
own f32 error of the f64 gradient, per pair (so the port's LNCC is no less
accurate than the reference's, where that error is ~90% of the gradient
as well as where it is ~5e-5 of it).
"""
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SZ = 24
LEVELS = "4:2:0.04,8:2:0.02"
REL_TOL = 1e-3
# the excepted pair is also held no looser than before its cause was shown
EXCEPTION_CAP = 1e-2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A seeded 24^3 dataset from the port's synthetic-dataset tool."""
    from tools import torch_make_synthetic_dataset as tgen
    root = tmp_path_factory.mktemp("optreg_tools") / "data"
    tgen.generate(str(root), n_train=3, n_val=1, n_test=1, sz=SZ, n_proj=3,
                  latent=2, seed=3, deformation_rank=2, texture="anatomical",
                  deformation_smooth=6, deformation_magnitude=0.1,
                  device="cpu")
    return root


def _rows(text):
    """The oracle table's rows after its header: [case, rel, gt, pred,
    err, sims]."""
    return [line.split() for line in text.strip().splitlines()[1:]]


def test_oracle_matches_jax(dataset, capsys):
    from tools.optreg_oracle import main as jmain
    from tools.torch_optreg_oracle import main
    args = ["--data", str(dataset), "--n", "2", "--levels", LEVELS]
    want = jmain(args)
    jrows = _rows(capsys.readouterr().out)
    record = []
    got = main(args + ["--device", "cpu"], record=record)
    trows = _rows(capsys.readouterr().out)
    assert abs(got - want) <= REL_TOL
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert [r["id"] for r in record] == [r[0] for r in jrows[:-1]]
    for rec, jrow, trow in zip(record, jrows, trows):
        assert abs(rec["rel_err"] - float(jrow[1])) <= REL_TOL + 5e-5
        assert trow[2] == jrow[2]                 # |gt| mm: the same field
        hist = rec["sim_history"]
        assert np.isfinite(rec["rel_err"]) and hist[-1] <= hist[0]


def _volumes(data, n, variant, dtype=np.float32):
    """The moving and target volumes of ``variant``'s first ``n`` pairs, as
    the A/B tools load them."""
    from liftreg_tpu_torch.data.dataset import normalize_intensity
    pre = data / "preprocessed"
    ids = np.load(data / "train" / "data_id.npy")[:n]

    def vol(side):
        v = np.stack([np.flip(np.load(pre / f"{c}_{side}.npy"), 1)
                      for c in ids]).astype(np.float32)[:, None]
        v = normalize_intensity(v, linear_clip=True, clip_range=(-1000, 0))
        if variant.endswith("_masked"):
            seg = np.stack([np.flip(np.load(pre / f"{c}_{side}_seg.npy"), 1)
                            for c in ids]).astype(np.float32)[:, None]
            v = (v + 1.0) * seg - 1.0
        return v

    return vol("source"), vol("target")


def _jax_ulp_spread(data, n, variant, want):
    """Per pair, how far the JAX A/B's relative error moves when the
    target changes by one ulp, up or down; checks first that the unchanged
    target gives ``want``, the JAX tool's errors."""
    import jax.numpy as jnp

    from liftreg_tpu.optreg import DenseRegisterer
    from tools.basis_oracle import gt_disp
    moving, target = _volumes(data, n, variant)
    ids = np.load(data / "train" / "data_id.npy")[:n]
    gt = np.stack([gt_disp(str(data), c).reshape(-1) for c in ids])
    levels = [(int(g), int(s), float(lr)) for g, s, lr in
              (lv.split(":") for lv in LEVELS.split(","))]
    reg = DenseRegisterer((SZ,) * 3, sim=variant.split("_")[0],
                          levels=levels, warp_taps_dtype=jnp.bfloat16)

    def rel(t):
        out = reg(jnp.asarray(moving), jnp.asarray(t))
        disp = np.asarray(out["disp"], np.float32).reshape(n, -1)
        return np.linalg.norm(disp - gt, axis=1) / np.linalg.norm(gt, axis=1)

    base = rel(target)
    np.testing.assert_allclose(base, want, rtol=0, atol=1e-6)
    return np.max([np.abs(rel(np.nextafter(target, np.float32(side)))
                          - base) for side in (np.inf, -np.inf)], axis=0)


def test_objective_ab_matches_jax(dataset, capsys):
    from tools.optreg_objective_ab import main as jmain
    from tools.torch_optreg_objective_ab import main
    args = ["--data", str(dataset), "--n", "2", "--levels", LEVELS]
    want = jmain(args)
    jbest = capsys.readouterr().out.strip().splitlines()[-1].split()[1]
    got = main(args + ["--device", "cpu"])
    tbest = capsys.readouterr().out.strip().splitlines()[-1].split()[1]
    assert list(got) == list(want) == ["ncc", "lncc", "ncc_masked",
                                       "lncc_masked"]
    over = []
    for variant in want:
        assert got[variant].shape == (2,)
        diff = np.abs(got[variant] - want[variant])
        if (diff <= REL_TOL).all():
            continue
        spread = _jax_ulp_spread(dataset, 2, variant, want[variant])
        for pair in np.flatnonzero(diff > REL_TOL):
            # only where the reference moves by more under one ulp
            assert spread[pair] > REL_TOL, (variant, pair, diff, spread)
            assert diff[pair] <= min(spread[pair], EXCEPTION_CAP), (
                variant, pair, diff, spread)
            over.append((variant, int(pair)))
    # the exception is the measured one, not a broader one
    assert len(over) <= 1, over
    assert tbest == jbest


@pytest.mark.parametrize("tool", ["torch_optreg_oracle",
                                  "torch_optreg_objective_ab"])
def test_tool_needs_a_card(dataset, monkeypatch, tool):
    from liftreg_tpu_torch import optreg
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(optreg.DenseRegisterer, "__call__",
                        lambda self, *a: calls.append(a))
    main = importlib.import_module(f"tools.{tool}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data", str(dataset), "--n", "1", "--levels", LEVELS])
    assert calls == []
    assert os.path.isdir(dataset)


@pytest.mark.parametrize("variant", ["lncc", "lncc_masked"])
def test_lncc_gradient_as_accurate_as_jax(dataset, variant):
    import jax
    import jax.numpy as jnp

    from liftreg_tpu.coords import identity_map
    from liftreg_tpu.losses.similarity import get_similarity as jax_sim
    from liftreg_tpu.ops.resample import warp_image
    from liftreg_tpu_torch.losses.similarity import get_similarity
    moving, target = _volumes(dataset, 2, variant)
    phi = jnp.broadcast_to(identity_map((SZ,) * 3)[None], (2, 3) + (SZ,) * 3)
    warped = np.array(jax.jit(lambda m, p: warp_image(
        m, p, zero_boundary=True, scale_intensity=True,
        taps_dtype=jnp.bfloat16))(jnp.asarray(moving), phi))
    lncc = jax_sim("lncc")
    want = np.asarray(jax.jit(jax.grad(lambda w: lncc(
        w, jnp.asarray(target), reduction="none").sum()))(
            jnp.asarray(warped)), np.float64)

    def port(dtype):
        w = torch.from_numpy(warped).to(dtype).requires_grad_(True)
        loss = get_similarity("lncc")(
            w, torch.from_numpy(target).to(dtype), reduction="none").sum()
        grad, = torch.autograd.grad(loss, w)
        return grad.double().numpy()

    got, exact = port(torch.float32), port(torch.float64)
    for pair in range(2):
        jax_err = np.abs(want[pair] - exact[pair]).max()
        port_err = np.abs(got[pair] - exact[pair]).max()
        assert port_err <= 2 * jax_err, (pair, port_err, jax_err)
