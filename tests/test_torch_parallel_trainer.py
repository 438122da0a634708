"""The port's trainer on a data mesh of 2 gloo ranks against the JAX
trainer's ``RegistrationTrainer(n_devices=2)`` on the conftest's 8 CPU
devices, on tests/torch_train_data.py's dataset (16^3, 2 views, latent 4)
at B = 3: every batch padded to 4 rows (the training batches' pad row
weighted 0, the validation batch of 3 cases one pad row). The JAX trainer
writes its initial parameters to a checkpoint and trains 2 epochs
(validation first, 2 steps an epoch), then a new trainer resumes its last
checkpoint for a third; the port's ranks start from that checkpoint
(``init_params_from``) and do the same. ``debug_on`` is set, as in the
reference config, so that each validation also logs its losses
(``Val_loss/*``, the global mean over the real rows).

Compared: each step's total, similarity and regularisation losses, each
epoch's ``Val_metrics/score`` and validation losses in ``metrics.jsonl``
(atol 1e-6, as
tests/test_torch_trainer.py holds one process to JAX's one device), the
resumed epoch and steps, the parameters after the resumed epoch (atol
1e-6), which are the same on both ranks, and rank 0 alone writing the
logs and checkpoints.
"""
import os

import numpy as np
import pytest
import torch

from liftreg_tpu_torch.parallel import launch
from liftreg_tpu_torch.utils.checkpoint import load_checkpoint

import torch_parallel_ranks as ranks
from torch_train_data import read_metrics, setting, write_dataset

B, STEPS_PER_EPOCH, EPOCHS = 3, 2, 3
LOSS_KEYS = ("total_loss", "sim_loss", "reg_loss")


def _setting(root, exp, **train):
    return setting(root, exp, batch_size=B, debug_on=True, **train)


def _resume(root, exp, **train):
    return _setting(root, exp, epochs=EPOCHS - 1, continue_train=True,
                    continue_from=os.path.join(
                        exp, "checkpoints",
                        f"epoch_{EPOCHS - 2}_checkpoint.ckpt"), **train)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    os.environ["LIFTREG_NO_TB"] = "1"
    root = write_dataset(str(tmp_path_factory.mktemp("mesh_trainer_data")))
    exp_j = str(tmp_path_factory.mktemp("exp_jax"))
    exp_t = str(tmp_path_factory.mktemp("exp_torch"))
    from liftreg_tpu.train import RegistrationTrainer as JaxTrainer
    jt = JaxTrainer(_setting(root, exp_j, epochs=EPOCHS - 2), n_devices=2)
    jt.save_model("init", is_best=False)
    init = os.path.join(exp_j, "checkpoints", "init_checkpoint.ckpt")
    jt.run()
    JaxTrainer(_resume(root, exp_j), n_devices=2).run()
    res = launch(ranks.train_and_resume, 2, device="cpu", args=(
        _setting(root, exp_t, epochs=EPOCHS - 2, init_params_from=init),
        _resume(root, exp_t, init_params_from=init)))
    return {"jax": exp_j, "torch": exp_t, "ranks": res}


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_step_losses_match_jax_mesh(runs, key):
    want = read_metrics(runs["jax"])[f"Train/{key}"]
    got = read_metrics(runs["torch"])[f"Train/{key}"]
    steps = list(range(1, EPOCHS * STEPS_PER_EPOCH + 1))
    assert sorted(got) == sorted(want) == steps
    np.testing.assert_allclose([got[s] for s in steps],
                               [want[s] for s in steps], rtol=0, atol=1e-6)


@pytest.mark.parametrize("tag", ["Val_metrics/score"] + [
    f"Val_loss/{k}" for k in LOSS_KEYS])
def test_val_score_and_losses_match_jax_mesh(runs, tag):
    want = read_metrics(runs["jax"])[tag]
    got = read_metrics(runs["torch"])[tag]
    assert sorted(got) == sorted(want) == list(range(EPOCHS))
    for epoch in want:
        assert abs(got[epoch] - want[epoch]) <= 1e-6, epoch


def test_resume_and_params_match_jax_mesh(runs):
    saved = load_checkpoint(os.path.join(
        runs["jax"], "checkpoints", f"epoch_{EPOCHS - 1}_checkpoint.ckpt"))
    for r in runs["ranks"]:
        assert r["resumed"]["start_epoch"] == EPOCHS - 1
        assert r["resumed"]["global_step"]["train"] == \
            (EPOCHS - 1) * STEPS_PER_EPOCH
        assert r["global_step"]["train"] == EPOCHS * STEPS_PER_EPOCH
        for k, want in saved["params"].items():
            torch.testing.assert_close(torch.from_numpy(r["params"][k]),
                                       want, atol=1e-6, rtol=0)
            assert np.array_equal(r["params"][k],
                                  runs["ranks"][0]["params"][k]), k


def test_rank_zero_writes_alone(runs):
    exp = runs["torch"]
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        f"epoch_{e}_checkpoint.ckpt" for e in range(EPOCHS)] + [
        "model_best.ckpt"]
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        lines = f.readlines()
    steps = [line for line in lines if '"Train/total_loss"' in line]
    assert len(steps) == EPOCHS * STEPS_PER_EPOCH
