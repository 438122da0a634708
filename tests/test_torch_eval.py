"""Evaluation of the port against liftreg_tpu on the CPU: the coordinate
helpers, every function of ``utils/tre.py``, ``evaluate_result.csv``
(written without pandas) against the JAX package's (pandas), and the two
eval CLIs from one JAX checkpoint, on a dataset from
``tools/make_synthetic_dataset.py`` (16^3, 2 views, 3 test cases).

Tolerances: the coordinate helpers and the TRE host math bit for bit (the
same numpy f64 operations in the same order); the Dice of the nearest-
warped segmentation exactly; the CSV text exactly. The two CLIs: their
saved maps within 1e-5 (the f32 encoder and warp on two frameworks), so
each case's TRE within 1e-3 mm (a map error e moves a landmark by at most
e * (16 - 1) * 2.2 mm per axis) and its Dice within 0.02 (a voxel whose
nearest source voxel flips).
"""
import csv
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from liftreg_tpu import coords as jcoords
from liftreg_tpu.utils import tre as jtre
from liftreg_tpu_torch import coords
from liftreg_tpu_torch.eval_cli import main as eval_main
from liftreg_tpu_torch.utils import tre

from torch_train_data import setting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SZ = 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from tools.make_synthetic_dataset import generate
    out = str(tmp_path_factory.mktemp("synth_eval"))
    generate(out, n_train=2, n_val=1, n_test=3, sz=SZ, n_proj=2, latent=2,
             seed=3)
    return out


def _test_ids(dataset):
    return [str(c) for c in np.sort(np.load(os.path.join(
        dataset, "test", "data_id.npy")))]


# -- the coordinate helpers ---------------------------------------------------

def test_coords_helpers_match_jax():
    rng = np.random.default_rng(0)
    phi = rng.uniform(-1.2, 1.2, (2, 3, 4, 5, 6)).astype(np.float32)
    vol = rng.normal(size=(4, 5, 6)).astype(np.float32)
    for fn in ("phi_to_01", "phi_from_01"):
        want = np.asarray(getattr(jcoords, fn)(jnp.asarray(phi)))
        assert np.array_equal(getattr(coords, fn)(phi), want)
        assert np.array_equal(
            getattr(coords, fn)(torch.from_numpy(phi)).numpy(), want)
    want = jcoords.flip_sar_to_spr(vol)
    assert np.array_equal(coords.flip_sar_to_spr(vol), want)
    assert np.array_equal(
        coords.flip_sar_to_spr(torch.from_numpy(vol)).numpy(), want)
    # phi_from_01 inverts phi_to_01 on the stored form's grid
    assert np.array_equal(coords.phi_from_01(coords.phi_to_01(
        np.float32(0.5))), np.float32(0.5))


# -- tre.py, bit for bit ------------------------------------------------------

def _tre_case(seed):
    rng = np.random.default_rng(seed)
    dim = np.array([20.0, 18.0, 22.0])
    spacing = np.array([0.64, 0.64, 2.5])
    phi_spacing = np.array([2.2, 2.1, 2.3])
    origin = np.array([-3.0, 2.0, 0.5])
    source = rng.uniform(2, 17, size=(50, 3)).astype(np.float32)
    target = (source + rng.normal(scale=1.0, size=(50, 3))).astype(
        np.float32)
    idm = jtre.create_identity(dim.astype(int))
    phi = (idm + rng.normal(scale=0.01, size=idm.shape))[None]
    return source, target, phi, dim, spacing, origin, phi_spacing


def test_tre_host_math_is_bit_equal_to_jax():
    source, target, phi, dim, spacing, origin, phi_spacing = _tre_case(0)
    pts = np.random.default_rng(1).uniform(-1.1, 1.1, (40, 3))
    assert np.array_equal(tre._sample_phi_at_points(phi[0], pts),
                          jtre._sample_phi_at_points(phi[0], pts))
    assert np.array_equal(
        tre.calc_warped_points(pts, phi[0], dim, phi_spacing),
        jtre.calc_warped_points(pts, phi[0], dim, phi_spacing))
    got = tre.eval_with_data(source, target, phi, dim, spacing, origin,
                             phi_spacing)
    want = jtre.eval_with_data(source, target, phi, dim, spacing, origin,
                               phi_spacing)
    assert got[0] == want[0] and got[1] == want[1]
    assert np.array_equal(got[2], want[2])
    assert tre.compute_tre_statistics(got[2]) == \
        jtre.compute_tre_statistics(want[2])
    for shape in ((16, 16, 16), (5, 7, 9)):
        assert np.array_equal(tre.create_identity(shape),
                              jtre.create_identity(shape))
    assert tre.COPD_SPACING == jtre.COPD_SPACING
    assert tre.FDCT_SPACING == jtre.FDCT_SPACING


def test_identity_phi_tre_equals_initial_distance():
    """With an identity map, origin 0 and the landmarks at the volume's
    spacing, the TRE is the landmarks' initial mean distance (the
    reference's own oracle, as tests/test_tre.py checks the JAX package)."""
    rng = np.random.default_rng(1)
    dim = np.array([16.0, 16.0, 16.0])
    spacing = phi_spacing = np.array([2.2, 2.2, 2.2])
    source = rng.uniform(3, 13, size=(40, 3)).astype(np.float32)
    target = (source + rng.normal(scale=0.8, size=(40, 3))).astype(
        np.float32)
    phi = tre.create_identity(dim.astype(int))[None]
    got, _, _ = tre.eval_with_data(source, target, phi, dim, spacing,
                                   np.zeros(3), phi_spacing)
    expect = np.mean(np.linalg.norm((target - source) * spacing, axis=1))
    assert got == pytest.approx(expect, rel=1e-5)


def test_read_points_and_eval_with_file_match_jax(tmp_path):
    source, target, phi, dim, spacing, origin, phi_spacing = _tre_case(2)
    files = {}
    for name, pts, end in (("src", source, "\r\n"), ("tgt", target, "\t\n")):
        path = tmp_path / f"{name}.txt"
        path.write_text("".join(f"{p[0]:.4f}\t{p[1]:.4f}  {p[2]:.4f}{end}"
                                for p in pts) + "\n\ntrailing junk\n")
        files[name] = str(path)
        assert np.array_equal(tre.read_points(str(path), expect_count=50),
                              jtre.read_points(str(path)))
    np.save(tmp_path / "phi.npy", phi[0])
    args = (files["src"], files["tgt"], str(tmp_path / "phi.npy"), dim,
            spacing, origin, phi_spacing)
    got, want = tre.eval_with_file(*args), jtre.eval_with_file(*args)
    assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
    with pytest.raises(ValueError, match="expected 7 landmarks"):
        tre.read_points(files["src"], expect_count=7)


def test_warped_seg_dice_matches_jax(dataset):
    case = _test_ids(dataset)[0]
    pre = os.path.join(dataset, "preprocessed")
    src = np.load(os.path.join(pre, f"{case}_source_seg.npy"))
    tgt = np.load(os.path.join(pre, f"{case}_target_seg.npy"))
    rng = np.random.default_rng(4)
    for phi01 in (np.load(os.path.join(dataset, "gt_phi", f"{case}_phi.npy")),
                  (tre.create_identity((SZ,) * 3)
                   + rng.normal(scale=0.03, size=(3,) + (SZ,) * 3)).astype(
                       np.float32)):
        got = tre.warped_seg_dice(src, tgt, phi01, device="cpu")
        assert got == jtre.warped_seg_dice(src, tgt, phi01)
        assert 0.0 <= got <= 1.0


# -- evaluate_result.csv ------------------------------------------------------

def test_results_csv_text_is_pandas(tmp_path):
    rows = [{"id": "copd1", "dist": 1.0, "dist_x": 0.1, "dist_y": 1e-05,
             "dist_z": 123456789.125, "dice": float("nan")},
            {"id": "a,b", "dist": 2.5e-17, "dist_x": 3.0, "dist_y": 1e16,
             "dist_z": np.float64(0.30000000000000004), "dice": 0.875}]
    for results in (rows, rows[:1], []):
        path = tmp_path / "got.csv"
        tre.write_results_csv(str(path), results)
        pd.DataFrame(results, columns=list(tre.CSV_COLUMNS)).to_csv(
            tmp_path / "want.csv")
        assert path.read_text() == (tmp_path / "want.csv").read_text()


def test_eval_copd_highres_csv_equals_jax(dataset, tmp_path):
    rng = np.random.default_rng(5)
    exps = {}
    for side in ("jax", "torch"):
        exps[side] = tmp_path / side
        os.makedirs(exps[side] / "tests")
    for i, case in enumerate(_test_ids(dataset)):
        phi01 = np.load(os.path.join(dataset, "gt_phi", f"{case}_phi.npy"))
        if i:
            phi01 = phi01 + rng.normal(scale=0.01, size=phi01.shape).astype(
                np.float32)
        for exp in exps.values():
            np.save(exp / "tests" / f"{case}_phi.npy", phi01)
    want = jtre.eval_copd_highres(dataset, str(exps["jax"]), dim=(SZ,) * 3)
    got = tre.eval_copd_highres(dataset, str(exps["torch"]), dim=(SZ,) * 3,
                                device="cpu")
    assert got == want and len(got) == 3
    text = (exps["torch"] / "evaluate_result.csv").read_text()
    assert text == (exps["jax"] / "evaluate_result.csv").read_text()
    assert len(text.splitlines()) == 4


# -- the two CLIs from one JAX checkpoint -------------------------------------

@pytest.fixture(scope="module")
def cli_runs(dataset, tmp_path_factory):
    """The JAX eval_cli.py (a subprocess) and the port's, from the same
    JAX msgpack model_best.ckpt, each on its own copy of the experiment;
    the port's twice, with matplotlib and with it blocked."""
    os.environ["LIFTREG_NO_TB"] = "1"
    root = tmp_path_factory.mktemp("eval_cli")
    exps = {}
    for side in ("jax", "torch", "torch_no_mpl"):
        exp = str(root / side)
        cfg = setting(dataset, exp, sz=SZ, views=2, latent=2, batch_size=2)
        os.makedirs(exp)
        with open(os.path.join(exp, "cur_task_setting.json"), "w") as f:
            json.dump(cfg, f)
        exps[side] = exp
    from liftreg_tpu.train import RegistrationTrainer as JaxTrainer
    jt = JaxTrainer(setting(dataset, exps["jax"], sz=SZ, views=2, latent=2,
                            batch_size=2), n_devices=1)
    # a trained-looking checkpoint: the FC head's output scaled up, so
    # that the maps move
    params = jax.tree_util.tree_map(lambda a: a, jt.params)
    head = params["params"]["encoder"]["FullyConnectBlock_2"]["Dense_0"]
    head["kernel"] = head["kernel"] * 50.0
    jt.params = params
    jt.save_model("", is_best=True)
    del jt
    best = os.path.join(exps["jax"], "checkpoints", "model_best.ckpt")
    for side in ("torch", "torch_no_mpl"):
        os.makedirs(os.path.join(exps[side], "checkpoints"))
        shutil.copy(best, os.path.join(exps[side], "checkpoints"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "eval_cli.py", "-s",
                    os.path.join(exps["jax"], "cur_task_setting.json")],
                   cwd=REPO, env=env, check=True, capture_output=True)
    logs = {}
    for side in ("torch", "torch_no_mpl"):
        out = io.StringIO()
        saved = sys.modules.get("matplotlib")
        if side == "torch_no_mpl":
            sys.modules["matplotlib"] = None
        stdout, sys.stdout = sys.stdout, out
        try:
            eval_main(["-s", os.path.join(exps[side],
                                          "cur_task_setting.json"),
                       "--device", "cpu"])
        finally:
            sys.stdout = stdout
            if side == "torch_no_mpl":
                if saved is None:
                    del sys.modules["matplotlib"]
                else:
                    sys.modules["matplotlib"] = saved
        logs[side] = out.getvalue()
    return exps, logs


def _csv_rows(exp):
    with open(os.path.join(exp, "evaluate_result.csv")) as f:
        return {r["id"]: r for r in csv.DictReader(f)}


def test_eval_clis_agree_from_one_jax_checkpoint(dataset, cli_runs):
    exps, _ = cli_runs
    ids = _test_ids(dataset)
    moved = 0.0
    for case in ids:
        want = np.load(os.path.join(exps["jax"], "tests", f"{case}_phi.npy"))
        for side in ("torch", "torch_no_mpl"):
            got = np.load(os.path.join(exps[side], "tests",
                                       f"{case}_phi.npy"))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        moved = max(moved, float(np.abs(
            want - tre.create_identity((SZ,) * 3)).max()))
    assert moved > 1e-3
    want = _csv_rows(exps["jax"])
    for side in ("torch", "torch_no_mpl"):
        got = _csv_rows(exps[side])
        assert sorted(got) == sorted(want) == ids
        for case in ids:
            for key in ("dist", "dist_x", "dist_y", "dist_z"):
                assert abs(float(got[case][key]) - float(want[case][key])) \
                    <= 1e-3, (side, case, key)
            assert abs(float(got[case]["dice"])
                       - float(want[case]["dice"])) <= 0.02


def test_test_mode_without_matplotlib(dataset, cli_runs):
    """Blocked matplotlib: one line naming it, no PNG, every other output
    (maps, 3D volumes, CSV) written; with matplotlib, the figures too."""
    exps, logs = cli_runs
    line = [ln for ln in logs["torch_no_mpl"].splitlines()
            if "matplotlib" in ln]
    assert len(line) == 1 and "no 2D figures" in line[0]
    assert "matplotlib" not in logs["torch"]

    def files(exp, suffix):
        return [f for _, _, fs in os.walk(exp) for f in fs
                if f.endswith(suffix)]

    assert not files(exps["torch_no_mpl"], ".png")
    assert files(exps["torch"], ".png")
    for side in ("torch", "torch_no_mpl"):
        for case in _test_ids(dataset):
            for name in (f"{case}_phi.npy", f"{case}_phi.nii.gz",
                         os.path.join("3D", f"{case}_test_warped.nii.gz"),
                         os.path.join("3D", f"{case}_test_target.npy")):
                assert os.path.isfile(os.path.join(exps[side], "tests",
                                                   name)), (side, name)
        assert len(_csv_rows(exps[side])) == 3
