"""The callers of the space-to-depth encoder stages (``s2d_encoder``) in the
port against liftreg_tpu on the CPU: ``RegistrationPipeline``, the
trainer, ``tools/torch_export_serving.py`` and
``tools/torch_paper_workflow.py``.

Tolerances: the pipelines' phi and warped as in
tests/test_torch_pipeline.py (f32 phi atol 1e-5, warped atol 1e-4; bf16
phi atol 5e-5, warped atol 5e-3); the trainers' per-step losses atol 1e-6
and parameters atol 1e-6, as in tests/test_torch_trainer.py (f32
convolutions summed in another order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline
from liftreg_tpu_torch import RegistrationPipeline, params_from_jax
from liftreg_tpu_torch.models import s2d
from liftreg_tpu_torch.train import RegistrationTrainer
from liftreg_tpu_torch.utils.checkpoint import load_checkpoint

from torch_train_data import read_metrics, setting, write_dataset

SZ = (16, 16, 16)
L, B = 4, 2
CONFIGS = {"f32": (None, None, "float32", 1e-5, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, "bfloat16", 5e-5, 5e-3)}


def _spy(monkeypatch):
    calls = []
    fn = s2d.conv_pair_s2d

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(s2d, "conv_pair_s2d", spy)
    return calls


@pytest.mark.parametrize("dtype", sorted(CONFIGS))
def test_pipeline_register_matches_jax(monkeypatch, dtype):
    """``RegistrationPipeline(s2d_encoder=True)`` against the JAX pipeline
    with the option, from the same flax weights: ``register``'s warped
    CT and phi, through the s2d stages, and the flag in ``settings``."""
    jdt, tdt, basis, tol_phi, tol_warped = CONFIGS[dtype]
    rng = np.random.default_rng(0)
    n = 3 * int(np.prod(SZ))
    V = (rng.standard_normal((L, n)) * 0.01).astype(np.float32)
    mean = (rng.standard_normal(n) * 0.01).astype(np.float32)
    src, tgt = (rng.uniform(-1000, 0, (B, 1) + SZ).astype(np.float32)
                for _ in range(2))
    seg = (rng.uniform(size=(B, 1) + SZ) > 0.4).astype(np.float32)
    jp = JPipeline(SZ, latent_dim=L, compute_dtype=jdt, s2d_encoder=True)
    jpca = {"vectors": jnp.asarray(V, getattr(jnp, basis)),
            "mean": jnp.asarray(mean)}
    params = jp.init_params(jax.random.PRNGKey(1), jpca)
    jw, jphi = jp.register(params, jpca, src, tgt, seg, seg)
    tp = RegistrationPipeline(SZ, latent_dim=L, compute_dtype=tdt,
                              s2d_encoder=True, device="cpu")
    assert tp.settings["s2d_encoder"] is True
    assert RegistrationPipeline(SZ, latent_dim=L, device="cpu").settings[
        "s2d_encoder"] is False
    tp.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tpca = {"vectors": torch.from_numpy(V).to(getattr(torch, basis)),
            "mean": torch.from_numpy(mean)}
    calls = _spy(monkeypatch)
    tw, tphi = tp.register(tpca, *map(torch.from_numpy, (src, tgt, seg,
                                                         seg)))
    assert calls == [(B, 5) + SZ]
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=0,
                               atol=tol_phi)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=tol_warped)


def test_export_tool_reads_s2d_from_the_config(monkeypatch, tmp_path):
    """``tools/torch_export_serving.py`` builds the pipeline of an
    experiment whose model config sets ``s2d_encoder``, as the JAX tool
    does (``tools/export_serving.py``), and the exported program runs
    the s2d stages; without the key the pipeline is plain."""
    from tools.torch_export_serving import pipeline_from_setting
    os.environ["LIFTREG_NO_TB"] = "1"
    root = write_dataset(str(tmp_path / "data"))
    exp = str(tmp_path / "exp")
    paths = {}
    for name, flag in (("s2d", True), ("plain", None)):
        cfg = setting(root, exp)
        if flag is not None:
            cfg["train"]["model"]["s2d_encoder"] = flag
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    RegistrationTrainer(cfg, device="cpu").save_model("init", is_best=True)
    pipe, pca = pipeline_from_setting(paths["s2d"], {}, "cpu")
    plain, _ = pipeline_from_setting(paths["plain"], {}, "cpu")
    assert pipe.settings["s2d_encoder"] is True
    assert plain.settings["s2d_encoder"] is False
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(3)
    vols = [torch.from_numpy(rng.uniform(-1000, 0, (1, 1, 16, 16, 16))
                             .astype(np.float32)) for _ in range(2)]
    want = plain.register(pca, *vols)
    assert not calls
    got = pipe.register(pca, *vols)
    assert len(calls) == 1
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("flag", [[], ["--s2d"]])
def test_paper_workflow_puts_s2d_in_both_stages(tmp_path, flag):
    """``tools/torch_paper_workflow.py --s2d`` writes ``s2d_encoder`` into
    the RegNet2D3D stage's config and the subspace stage's, as
    ``tools/paper_workflow_160.py`` does; without it both say False."""
    from tools.torch_paper_workflow import (base_setting, parse_args,
                                            regnet_setting)
    args = parse_args(["--data", str(tmp_path / "d"), "--out",
                       str(tmp_path / "o")] + flag)
    s1 = regnet_setting(args, str(tmp_path / "o" / "exp_regnet"))
    s3 = base_setting(args, str(tmp_path / "o" / "exp_subspace"), 1)
    assert s1["train"]["model_class"] == "regnet2d3d"
    assert s1["train"]["model"]["s2d_encoder"] is bool(flag)
    assert s3["train"]["model"]["s2d_encoder"] is bool(flag)


@pytest.fixture(scope="module")
def s2d_runs(tmp_path_factory):
    """One epoch (a validation, then 3 steps of B = 2) of the JAX trainer
    and the port's from its initial parameters, both with
    ``s2d_encoder: true`` in the model config."""
    os.environ["LIFTREG_NO_TB"] = "1"
    root = write_dataset(str(tmp_path_factory.mktemp("s2d_trainer_data")))
    exp_j = str(tmp_path_factory.mktemp("exp_jax_s2d"))
    exp_t = str(tmp_path_factory.mktemp("exp_torch_s2d"))
    from liftreg_tpu.train import RegistrationTrainer as JaxTrainer

    def cfg(exp, **train):
        s = setting(root, exp, epochs=0, **train)
        s["train"]["model"]["s2d_encoder"] = True
        return s

    jt = JaxTrainer(cfg(exp_j), n_devices=1)
    jt.save_model("init", is_best=False)
    init = os.path.join(exp_j, "checkpoints", "init_checkpoint.ckpt")
    jt.run()
    tt = RegistrationTrainer(cfg(exp_t, init_params_from=init),
                             device="cpu")
    assert tt.model.encoder.s2d_stage01
    tt.run()
    return exp_j, exp_t


def test_trainer_s2d_steps_match_jax(s2d_runs):
    exp_j, exp_t = s2d_runs
    mj, mt = read_metrics(exp_j), read_metrics(exp_t)
    for key in ("total_loss", "sim_loss", "reg_loss"):
        want, got = mj[f"Train/{key}"], mt[f"Train/{key}"]
        assert sorted(got) == sorted(want) == [1, 2, 3]
        np.testing.assert_allclose([got[s] for s in sorted(got)],
                                   [want[s] for s in sorted(want)],
                                   atol=1e-6, rtol=0, err_msg=key)
    cj = load_checkpoint(os.path.join(exp_j, "checkpoints",
                                      "latest_checkpoint.ckpt"))
    ct = load_checkpoint(os.path.join(exp_t, "checkpoints",
                                      "latest_checkpoint.ckpt"))
    for k, want in cj["params"].items():
        torch.testing.assert_close(ct["params"][k], want, atol=1e-6, rtol=0)
