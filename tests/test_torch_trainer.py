"""The port's trainer against liftreg_tpu's on the CPU, on one on-disk
dataset at 16^3 (tests/torch_train_data.py: B = 2, latent 4, 2 views,
6 training and 3 validation cases, so that the last validation batch is
padded). The JAX trainer writes its initial parameters to a checkpoint
and trains 2 epochs (validation first, 3 steps an epoch); the port starts
from that checkpoint (``init_params_from``) and trains the same 2 epochs
with the same shuffled order.

Compared: the per-step total, similarity and regularisation losses, the
validation metrics of each epoch (score, overlap, folding), the best
epoch, and the parameters and Adam moments after the 6 steps. Measured on
this sandbox's CPU: losses within 1.2e-7, parameters within 3e-8, moments
within 2e-9 of their largest values. Tolerances: losses and the score
atol 1e-6; overlap and folding metrics exactly; parameters atol 1e-6;
moments rtol 1e-4, atol 1e-5 of the largest value (f32 convolutions
summed in another order).

Also: a non-finite batch rolls back parameters and moments and ends in
``SystemExit(42)`` with a checkpoint; a partial evaluation batch is
padded, from the card-resident loader and from the host loader; resume
restores epoch, steps and parameters; the CLI trains 2 epochs end to end,
in one process and with ``--n_devices 2 --device cpu`` on two gloo ranks
(per-step losses within 1e-5 relative of the one-process run's, the same
batches split across the ranks); the config audit; and the default device
needs a card, and more ranks than visible cards raise.
"""
import json
import os

import numpy as np
import pytest
import torch

from liftreg_tpu_torch.train import RegistrationTrainer, get_network
from liftreg_tpu_torch.utils.checkpoint import load_checkpoint

from torch_train_data import read_metrics, setting, write_dataset

STEPS = 6
LOSS_KEYS = ("total_loss", "sim_loss", "reg_loss")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    os.environ["LIFTREG_NO_TB"] = "1"
    root = write_dataset(str(tmp_path_factory.mktemp("torch_trainer_data")))
    exp_j = str(tmp_path_factory.mktemp("exp_jax"))
    exp_t = str(tmp_path_factory.mktemp("exp_torch"))
    from liftreg_tpu.train import RegistrationTrainer as JaxTrainer
    jt = JaxTrainer(setting(root, exp_j), n_devices=1)
    jt.save_model("init", is_best=False)
    init = os.path.join(exp_j, "checkpoints", "init_checkpoint.ckpt")
    jt.run()
    tt = RegistrationTrainer(setting(root, exp_t, init_params_from=init),
                             device="cpu")
    tt.run()
    return {"root": root, "jax": exp_j, "torch": exp_t, "init": init,
            "trainer": tt}


def _ckpt(exp, name):
    return load_checkpoint(os.path.join(exp, "checkpoints", name))


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_step_losses_match_jax(runs, key):
    mj, mt = read_metrics(runs["jax"]), read_metrics(runs["torch"])
    want, got = mj[f"Train/{key}"], mt[f"Train/{key}"]
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], atol=1e-6,
                               rtol=0)
    assert all(mt["Train/finite"][s] == 1.0 for s in got)


@pytest.mark.parametrize("metric", ["score", "dice", "iou", "recall",
                                    "precision", "folding_sum",
                                    "folding_count"])
def test_val_metrics_match_jax(runs, metric):
    want = read_metrics(runs["jax"])[f"Val_metrics/{metric}"]
    got = read_metrics(runs["torch"])[f"Val_metrics/{metric}"]
    assert sorted(got) == sorted(want) == [0, 1]
    for epoch in want:
        if metric == "score":
            assert abs(got[epoch] - want[epoch]) <= 1e-6
        else:
            assert got[epoch] == want[epoch], (metric, epoch)


def test_best_checkpoint_matches_jax(runs):
    mj, mt = read_metrics(runs["jax"]), read_metrics(runs["torch"])
    assert set(mt) == set(mj)
    bj, bt = _ckpt(runs["jax"], "model_best.ckpt"), \
        _ckpt(runs["torch"], "model_best.ckpt")
    assert int(bt["epoch"]) == int(bj["epoch"])


def test_params_and_moments_match_jax(runs):
    cj, ct = _ckpt(runs["jax"], "latest_checkpoint.ckpt"), \
        _ckpt(runs["torch"], "latest_checkpoint.ckpt")
    assert int(ct["epoch"]) == int(cj["epoch"]) == 1
    assert ct["global_step"] == {k: int(v) for k, v in
                                 cj["global_step"].items()}
    assert int(ct["opt_state"]["count"]) == int(cj["opt_state"]["count"]) \
        == STEPS
    init = load_checkpoint(runs["init"])["params"]
    for k, want in cj["params"].items():
        torch.testing.assert_close(ct["params"][k], want, atol=1e-6, rtol=0)
        assert not torch.equal(want, init[k])
        for m in ("mu", "nu"):
            w = cj["opt_state"][m][k]
            torch.testing.assert_close(
                ct["opt_state"][m][k], w, rtol=1e-4,
                atol=1e-5 * float(w.abs().max()))


def _small_trainer(runs, tmp_path, **train):
    return RegistrationTrainer(
        setting(runs["root"], str(tmp_path), init_params_from=runs["init"],
                **train), device="cpu")


def test_non_finite_step_rolls_back_and_halts(runs, tmp_path):
    tr = _small_trainer(runs, tmp_path, log_flush_steps=100)
    batch, names = next(iter(tr._iter_device("train", 0)))
    tr.global_step["train"] = 1
    tr.step(batch, names)                       # one finite step
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    mu = {k: v.clone() for k, v in tr.opt_state["mu"].items()}
    count = int(tr.opt_state["count"])
    bad = dict(batch, source=torch.full_like(batch["source"], float("nan")))
    tr.global_step["train"] = 2
    losses = tr.step(bad, names)
    assert not bool(losses["finite"])
    for k, p in tr.params.items():
        assert torch.equal(p.detach(), before[k]), k
        assert torch.equal(tr.opt_state["mu"][k], mu[k]), k
    assert int(tr.opt_state["count"]) == count == 1
    with pytest.raises(SystemExit) as exc:
        tr._flush_losses()
    assert exc.value.code == 42
    halt = load_checkpoint(os.path.join(str(tmp_path), "checkpoints",
                                        "nan_halt_checkpoint.ckpt"))
    for k in before:
        assert torch.equal(halt["params"][k], before[k])


@pytest.mark.parametrize("cache", [True, False])
def test_partial_eval_batch_is_padded(runs, tmp_path, cache):
    """3 validation cases at B = 2: the second batch holds one case,
    padded to 2 rows; its metrics cover the real row only and equal those
    of the case in a batch of its own."""
    tr = _small_trainer(runs, tmp_path, cache_on_device=cache)
    batches = [tr.set_input(d, 0) for d in tr.loaders["val"]]
    assert [len(n) for _, n in batches] == [2, 1]
    batch, names = batches[1]
    assert all(v.shape[0] == 2 for v in batch.values() if v.dim() > 0)
    assert torch.equal(batch["source"][0], batch["source"][1])
    _, metrics = tr.val_step(batch, names, "val")
    ds = tr.datasets["val"]
    idx = ds.name_list.index(names[0])
    sample, _ = ds[idx]
    one = {k: torch.from_numpy(np.asarray(v)[None]) for k, v in
           sample.items()}
    eval_out, _ = tr._eval_step(one)
    alone = tr._compute_metrics(eval_out, one)
    assert set(metrics) == set(alone)
    for k in alone:
        assert abs(metrics[k] - alone[k]) <= 1e-6, k


def test_resume_restores_state(runs, tmp_path):
    path = os.path.join(runs["torch"], "checkpoints",
                        "latest_checkpoint.ckpt")
    saved = load_checkpoint(path)
    tr = _small_trainer(runs, tmp_path, continue_train=True,
                        continue_from=path)
    assert tr.start_epoch == int(saved["epoch"]) + 1
    assert tr.global_step == saved["global_step"]
    for k, p in tr.params.items():
        assert torch.equal(p.detach(), saved["params"][k])
        assert torch.equal(tr.opt_state["nu"][k], saved["opt_state"]["nu"][k])
    assert int(tr.opt_state["count"]) == STEPS


def test_cli_trains_two_epochs(runs, tmp_path):
    from liftreg_tpu_torch.main import main
    cfg = setting(runs["root"], "[SET_BY_MAIN]", epochs=1,
                  profile_dir=str(tmp_path / "profile"), profile_steps=1)
    sdir = tmp_path / "setting"
    sdir.mkdir()
    (sdir / "cur_task_setting.json").write_text(json.dumps(cfg))
    out = tmp_path / "out"
    trainer = main(["-o", str(out), "-d", runs["root"], "-e", "cli",
                    "-s", str(sdir), "--device", "cpu"])
    exp = trainer.check_point_path.rsplit(os.sep, 1)[0]
    ckpts = sorted(os.listdir(trainer.check_point_path))
    assert ckpts == ["latest_checkpoint.ckpt", "model_best.ckpt"]
    m = read_metrics(exp)
    assert sorted(m["Train/total_loss"]) == list(range(1, STEPS + 1))
    assert sorted(m["Val_metrics/score"]) == [0, 1]
    assert os.path.isfile(os.path.join(exp, "cur_task_setting.json"))
    assert os.path.isfile(tmp_path / "profile" / "trace.json")
    # the same run on a data mesh of two gloo ranks, one row each
    two = main(["-o", str(tmp_path / "out2"), "-d", runs["root"], "-e",
                "cli", "-s", str(sdir), "--device", "cpu", "--n_devices",
                "2"])
    assert two["global_step"]["train"] == STEPS
    assert sorted(os.listdir(two["check_point_path"])) == ckpts
    m2 = read_metrics(os.path.dirname(two["check_point_path"]))
    for key in LOSS_KEYS:
        want = m[f"Train/{key}"]
        assert sorted(m2[f"Train/{key}"]) == sorted(want)
        for step, v in want.items():
            assert m2[f"Train/{key}"][step] == pytest.approx(v, rel=1e-5)


def test_config_audit_and_registry(runs, tmp_path):
    cfg = setting(runs["root"], str(tmp_path), check_best_model_frequency=1,
                  typo_key=3)
    tr = RegistrationTrainer(cfg, device="cpu")
    text = "\n".join(tr.config_warnings)
    assert "train.check_best_model_frequency' accepted but unused" in text
    assert "train.typo_key' is not recognized" in text
    assert get_network(None) is RegistrationTrainer
    assert get_network("liftreg.networks.RegistrationNet.RegistrationNet") \
        is RegistrationTrainer
    with pytest.raises(KeyError):
        get_network("nope")


def test_more_ranks_than_cards_raise(runs, tmp_path, monkeypatch):
    """Two ranks with one visible card raise before any experiment folder
    is made, from the trainer and from the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = setting(runs["root"], str(tmp_path / "exp"))
    with pytest.raises(RuntimeError, match="2-device mesh but only 1"):
        RegistrationTrainer(cfg, n_devices=2)
    from liftreg_tpu_torch.main import main
    sdir = tmp_path / "setting"
    sdir.mkdir()
    (sdir / "cur_task_setting.json").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="2-device mesh but only 1"):
        main(["-o", str(tmp_path / "out"), "-d", runs["root"], "-e", "cli",
              "-s", str(sdir), "--n_devices", "2"])
    assert not os.path.exists(tmp_path / "out")


def test_default_device_needs_cuda(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegistrationTrainer(setting(runs["root"], str(tmp_path)))
