"""The port's trainer with the other two models against liftreg_tpu's
trainer on the CPU: ``RegNet2D3D`` (the learned-basis workflow's stage 1:
the projection-loss dataset without the HU clip, ``RegNet2D3DLoss``, Adam
at lr 5e-4, 7 inverse steps) and ``LiftRegSubspace``, each for one epoch
of 3 steps (validation first) on tests/torch_train_data.py's dataset at
16^3 (B = 2, 2 views). The JAX trainer writes its initial parameters to a
checkpoint; the port starts from it (``init_params_from``).

Compared: the per-step losses, the validation score, and the parameters
and Adam moments after the 3 steps. Tolerances as tests/test_torch_trainer.py:
losses and the score atol 1e-6 (f32 convolutions summed in another
order); parameters atol 1e-6; moments rtol 1e-4, atol 1e-5 of the largest
value.
"""
import os

import numpy as np
import pytest
import torch

from liftreg_tpu_torch.train import RegistrationTrainer
from liftreg_tpu_torch.utils.checkpoint import load_checkpoint

from torch_train_data import read_metrics, setting, write_dataset

STEPS = 3
LOSS_TOL = 1e-6


def _setting(model, root, exp, **train):
    cfg = setting(root, exp, epochs=0, **train)
    if model == "regnet2d3d":
        cfg["dataset"].update(dataset_class="registration2d3d_projloss",
                              apply_hu_clip=False)
        cfg["train"].update(loss_class="regnet2d3d", model_class="regnet2d3d")
        cfg["train"]["model"] = {"drr_feature_num": 2, "inverse_iters": 7}
        cfg["train"]["optim"]["lr"] = 5e-4
    else:
        cfg["train"]["model_class"] = "subspace"
    return cfg


@pytest.fixture(scope="module", params=["regnet2d3d", "subspace"])
def runs(request, tmp_path_factory):
    os.environ["LIFTREG_NO_TB"] = "1"
    model = request.param
    root = write_dataset(str(tmp_path_factory.mktemp(f"data_{model}")))
    exp_j = str(tmp_path_factory.mktemp(f"exp_jax_{model}"))
    exp_t = str(tmp_path_factory.mktemp(f"exp_torch_{model}"))
    from liftreg_tpu.train import RegistrationTrainer as JaxTrainer
    jt = JaxTrainer(_setting(model, root, exp_j), n_devices=1)
    jt.save_model("init", is_best=False)
    init = os.path.join(exp_j, "checkpoints", "init_checkpoint.ckpt")
    jt.run()
    tt = RegistrationTrainer(_setting(model, root, exp_t,
                                      init_params_from=init), device="cpu")
    assert type(tt.model).__name__ == type(jt.model).__name__
    tt.run()
    return {"model": model, "jax": exp_j, "torch": exp_t, "init": init}


def test_losses_and_score_match_jax(runs):
    mj, mt = read_metrics(runs["jax"]), read_metrics(runs["torch"])
    tol = LOSS_TOL
    for key in ("total_loss", "sim_loss", "reg_loss"):
        want, got = mj[f"Train/{key}"], mt[f"Train/{key}"]
        assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
        np.testing.assert_allclose([got[s] for s in sorted(got)],
                                   [want[s] for s in sorted(want)],
                                   atol=tol, rtol=0, err_msg=key)
    assert all(v == 1.0 for v in mt["Train/finite"].values())
    assert abs(mt["Val_metrics/score"][0] - mj["Val_metrics/score"][0]) \
        <= tol


def test_params_and_moments_match_jax(runs):
    cj = load_checkpoint(os.path.join(runs["jax"], "checkpoints",
                                      "latest_checkpoint.ckpt"))
    ct = load_checkpoint(os.path.join(runs["torch"], "checkpoints",
                                      "latest_checkpoint.ckpt"))
    assert int(ct["opt_state"]["count"]) == int(cj["opt_state"]["count"]) \
        == STEPS
    init = load_checkpoint(runs["init"])["params"]
    assert sorted(ct["params"]) == sorted(cj["params"])
    for k, want in cj["params"].items():
        torch.testing.assert_close(ct["params"][k], want, atol=1e-6, rtol=0)
        assert not torch.equal(want, init[k]), k
        for m in ("mu", "nu"):
            w = cj["opt_state"][m][k]
            torch.testing.assert_close(
                ct["opt_state"][m][k], w, rtol=1e-4,
                atol=1e-5 * float(w.abs().max()))
