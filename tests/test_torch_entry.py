"""The port's entry points (liftreg_tpu_torch/entry.py) against
``__graft_entry__.py`` on the CPU: the seeded example inputs bit for bit,
one forward of the flagship model at 16^3 from the JAX model's initial
parameters (carried across by ``params_from_jax``), the refusal to run
without a card, and the dry run on a mesh of CPU ranks from a fresh
process that sees a card's id in ``CUDA_VISIBLE_DEVICES``.

Tolerances (tests/test_torch_subspace_model.py's): ``phi`` and the
displacement atol 1e-5 and ``warped`` atol 1e-4 (f32 convolutions summed
in another order), the coefficients rtol 1e-4.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from liftreg_tpu.models import LiftRegSubspaceBackproj as JModel
from liftreg_tpu_torch import entry as tentry
from liftreg_tpu_torch import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SZ, P, L = 16, 2, 4


def test_example_inputs_bit_equal_to_jax():
    j_in, j_pca = jentry._example_inputs(sz=SZ, n_proj=P, latent=L, batch=2)
    t_in, t_pca = tentry._example_inputs(sz=SZ, n_proj=P, latent=L, batch=2,
                                         device="cpu")
    for want, got in ((j_in, t_in), (j_pca, t_pca)):
        assert set(want) == set(got)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), k


@pytest.fixture(scope="module")
def jax_forward():
    inputs, pca = jentry._example_inputs(sz=SZ, n_proj=P, latent=L)
    model = JModel(img_sz=(SZ,) * 3, latent_dim=L, drr_feature_num=P)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), inputs, pca)
    out = model.apply(params, inputs, pca)
    return (jax.tree_util.tree_map(np.asarray, params),
            {k: np.asarray(v) for k, v in out.items()})


@pytest.mark.parametrize("form", ["module", "state_dict"])
def test_entry_forward_matches_jax(jax_forward, form):
    """``fn`` takes the model, or a state dict as JAX's ``apply`` takes
    its parameters."""
    params, want = jax_forward
    fn, (model, inputs, pca) = tentry.entry(device="cpu", sz=SZ, n_proj=P,
                                            latent=L)
    state = params_from_jax(params)
    if form == "module":
        model.load_state_dict(state)
        arg = model
    else:
        arg = state
    with torch.no_grad():
        got = fn(arg, inputs, pca)
    np.testing.assert_allclose(got["pca_coefs"].numpy(), want["pca_coefs"],
                               rtol=1e-4, atol=1e-6)
    for key, tol in (("phi", 1e-5), ("params", 1e-5), ("warped", 1e-4)):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=tol, err_msg=key)


def test_entry_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry._example_inputs(sz=SZ)


def _dryrun(n):
    """``dryrun_multichip(n)`` from a fresh interpreter whose environment
    names a card and sets no path to the repository."""
    # a rank that aborts prints every thread's Python stack
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", PYTHONFAULTHANDLER="1")
    env.pop("_LIFTREG_TORCH_DRYRUN_CHILD", None)
    env.pop("PYTHONPATH", None)
    code = ("import sys; sys.path.insert(0, '.'); "
            "from liftreg_tpu_torch.entry import dryrun_multichip; "
            f"dryrun_multichip({n})")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        pytest.fail(f"rc {proc.returncode}\n--- stdout ---\n"
                    f"{proc.stdout[-4000:]}\n--- stderr ---\n"
                    f"{proc.stderr[-12000:]}", pytrace=False)
    assert f"dryrun_multichip({n}) ok" in proc.stdout
    assert "devices=[" + ", ".join(["'cpu'"] * n) + "]" in proc.stdout


def test_dryrun_multichip_2():
    _dryrun(2)


@pytest.mark.slow
def test_dryrun_multichip_8():
    _dryrun(8)
