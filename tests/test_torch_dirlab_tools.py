"""The port's DirLab tools against the JAX package's on the CPU:
``tools/torch_dirlab_parity.py`` (the checks of
``tests/test_dirlab_parity.py`` on the port's tool, and the same report
text as ``tools/dirlab_parity.py`` in ``--identity`` and ``--exp`` mode)
and ``tools/torch_dirlab_e2e.py`` (raw int16 bytes -> CSV at 32^3, its
pieces against the JAX functions on the same inputs).

Tolerances: the parity reports' text equal; the preprocessed arrays and
``_prop.npy`` equal (the same host code); the DRRs within 1e-5 of the
largest line integral and the placeholder basis within 5e-6 of its
largest value, each component up to its sign (the projector and the noise
fields' upsampling round their last bits otherwise:
``tests/test_torch_learned_basis.py``); ``build_setting`` equal; the
CSV's TREs within 1e-3 mm of the JAX ``eval_copd_highres`` on the port's
saved phis. The JAX chain as a whole is not run here (``slow``, and it
trains from another initialisation).
"""
import contextlib
import csv
import importlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from liftreg_tpu_torch.utils.tre import read_points  # noqa: E402
from tests.test_dirlab_parity import _fixture, _write_expectations  # noqa: E402
from tests.test_preprocessing_cli import make_raw_case  # noqa: E402

RAW_SHAPE = (40, 64, 64)
RAW_SPACING = (2.5, 2.0, 2.0)
E2E_SIZE = 32


# -- the parity harness: the checks of tests/test_dirlab_parity.py ---------

def test_identity_oracle_green(tmp_path, capsys):
    from tools.torch_dirlab_parity import main
    data, truth = _fixture(tmp_path)
    expect = _write_expectations(tmp_path, truth)
    rc = main(["--data", data, "--identity", "--size", "32",
               "--expected", expect])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PARITY OK" in out
    for cid in truth:
        assert cid in out


def test_perturbed_expectation_fails_informatively(tmp_path, capsys):
    from tools.torch_dirlab_parity import main
    data, truth = _fixture(tmp_path)
    truth["syn2"] += 5.0  # deliberately wrong expectation
    expect = _write_expectations(tmp_path, truth)
    rc = main(["--data", data, "--identity", "--size", "32",
               "--expected", expect])
    out = capsys.readouterr().out
    assert rc == 1
    assert "PARITY FAIL" in out
    fail_lines = [ln for ln in out.splitlines()
                  if "FAIL" in ln and "syn" in ln]
    assert len(fail_lines) == 1 and "syn2" in fail_lines[0]
    assert "-5.0" in fail_lines[0] or "-4.9" in fail_lines[0]


def _perturbed_experiment(tmp_path):
    """A one-case experiment whose phi is the identity shifted by 0.05
    (~3.4 mm at 2.2 mm spacing), with its test id list; returns (data,
    exp, expectations) with the published TRE = the identity's."""
    from liftreg_tpu_torch.utils import tre
    data, truth = _fixture(tmp_path, n_cases=1)
    exp_dir = tmp_path / "exp"
    (exp_dir / "tests").mkdir(parents=True)
    phi = tre.create_identity((32, 32, 32)).astype(np.float32) + 0.05
    np.save(exp_dir / "tests" / "syn1_phi.npy", phi)
    (tmp_path / "data" / "test").mkdir(parents=True)
    np.save(tmp_path / "data" / "test" / "data_id.npy", np.array(["syn1"]))
    (tmp_path / "data" / "preprocessed").mkdir()
    expect = tmp_path / "expect.json"
    expect.write_text(json.dumps({
        "initial_tre_mm": {}, "published": {
            "per_case_tre_mm": dict(truth), "mean_tre_mm": None,
            "tol_mm": 0.05}}))
    return data, str(exp_dir), str(expect)


def test_perturbed_phi_fails(tmp_path, capsys):
    from tools.torch_dirlab_parity import main
    data, exp, expect = _perturbed_experiment(tmp_path)
    rc = main(["--data", data, "--exp", exp, "--size", "32", "--expected",
               expect, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and "PARITY FAIL" in out and "syn1" in out


def test_read_points_hardened(tmp_path):
    p = tmp_path / "lm.txt"
    # CRLF line endings + trailing tab + trailing blank lines
    p.write_bytes(b"1.0\t2.0\t3.0\t\r\n4.5\t5.5\t6.5\r\n\r\n\r\n")
    pts = read_points(str(p))
    assert pts.shape == (2, 3)
    np.testing.assert_allclose(pts, [[1.0, 2.0, 3.0], [4.5, 5.5, 6.5]])
    with pytest.raises(ValueError, match="expected 300 landmarks, parsed 2"):
        read_points(str(p), expect_count=300)
    p.write_text("1.0\t2.0\n")
    with pytest.raises(ValueError, match="lm.txt:1"):
        read_points(str(p))
    p.write_text("1 2 3\n4 5 6\n")
    assert read_points(str(p)).shape == (2, 3)


def test_default_expectations_file_valid():
    from tools.torch_dirlab_parity import (DEFAULT_EXPECTATIONS,
                                           load_expectations)
    assert os.path.samefile(DEFAULT_EXPECTATIONS,
                            ROOT / "tools" / "dirlab_expectations.json")
    exp = load_expectations(DEFAULT_EXPECTATIONS)
    init = exp["initial_tre_mm"]
    cases = [f"copd{i}" for i in range(1, 11)]
    assert all(c in init for c in cases)
    assert abs(np.mean([init[c] for c in cases]) - init["mean"]) < 0.01
    assert exp["landmarks_per_case"] == 300
    assert all(v is None for v in exp["published"]["per_case_tre_mm"].values())


# -- the same report text as the JAX tool ----------------------------------

@pytest.mark.parametrize("mode", ["identity", "identity_fail", "exp"])
def test_report_text_equals_jax(tmp_path, capsys, mode):
    from tools.dirlab_parity import main as jmain
    from tools.torch_dirlab_parity import main
    if mode == "exp":
        data, exp, expect = _perturbed_experiment(tmp_path)
        args = ["--data", data, "--exp", exp, "--size", "32", "--expected",
                expect]
    else:
        data, truth = _fixture(tmp_path, n_cases=3)
        if mode == "identity_fail":
            truth["syn3"] -= 1.0
        args = ["--data", data, "--identity", "--size", "32", "--expected",
                _write_expectations(tmp_path, truth)]
    want_rc = jmain(args)
    want = capsys.readouterr().out
    got_rc = main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got_rc == want_rc == (0 if mode == "identity" else 1)
    assert got == want
    assert "PARITY" in got


def test_raw_mode_runs_the_chain_then_diffs(tmp_path, capsys, monkeypatch):
    """``--raw`` hands the chain its arguments (and ``--device``), then
    diffs the dataset and experiment it wrote under ``--out``."""
    import tools.torch_dirlab_e2e as e2e
    from tools.torch_dirlab_parity import main
    fixture = tmp_path / "fixture"
    data, exp, expect = _perturbed_experiment(fixture)
    calls = []

    def fake_chain(argv):
        calls.append(argv)
        shutil.copytree(data, tmp_path / "out" / "dataset")
        shutil.copytree(exp, tmp_path / "out" / "exp")

    monkeypatch.setattr(e2e, "main", fake_chain)
    rc = main(["--raw", "RAW", "--out", str(tmp_path / "out"), "--landmarks",
               "LM", "--identity", "--epochs", "2", "--size", "32",
               "--expected", expect, "--device", "cpu"])
    out = capsys.readouterr().out
    assert calls == [["--raw_path", "RAW", "--out", str(tmp_path / "out"),
                      "--epochs", "2", "--size", "32", "--landmarks", "LM",
                      "--device", "cpu"]]
    # identity (the fixture's landmarks, no expectation: SKIP) and the
    # perturbed phi against the published identity TRE
    assert rc == 1 and "SKIP" in out and "PARITY FAIL (1 checks" in out


# -- the raw-to-CSV chain --------------------------------------------------

def _write_landmarks(lm_dir, case, shape, n=12, seed=0):
    """DirLab-style tab-separated 1-indexed (x, y, z) landmarks; eBH is
    iBH moved by a seeded offset of up to 2 voxels."""
    rng = np.random.default_rng(seed)
    d, w, h = shape
    ibh = np.stack([rng.uniform(h * 0.3, h * 0.7, n),
                    rng.uniform(w * 0.3, w * 0.7, n),
                    rng.uniform(d * 0.3, d * 0.7, n)], axis=1)
    ebh = ibh + rng.uniform(-2.0, 2.0, ibh.shape)
    os.makedirs(lm_dir, exist_ok=True)
    for tag, pts in (("iBH", ibh), ("eBH", ebh)):
        with open(os.path.join(lm_dir, f"{case}_300_{tag}_xyz_r1.txt"),
                  "w") as f:
            for p in pts:
                f.write(f"{p[0]:.2f}\t{p[1]:.2f}\t{p[2]:.2f}\n")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's chain on two raw cases at 32^3 (latent 4, 2 views, 2
    epochs of B = 2), its split drawn after ``np.random.seed(0)``; returns
    (tmp root, raw folder, the CSV rows, its summary line)."""
    from tools.torch_dirlab_e2e import main
    root = tmp_path_factory.mktemp("dirlab_e2e")
    raw = root / "raw"
    raw.mkdir()
    for i, case in enumerate(("copd1", "copd2")):
        make_raw_case(raw, case=case, shape=RAW_SHAPE)
        _write_landmarks(str(root / "lm"), case, RAW_SHAPE, seed=i)
    np.random.seed(0)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        out = main(["--raw_path", str(raw), "--landmarks", str(root / "lm"),
                    "--out", str(root / "out"), "--epochs", "1", "--latent",
                    "4", "--scan_num", "2", "--size", str(E2E_SIZE),
                    "--batch_size", "2", "--shape", *map(str, RAW_SHAPE),
                    "--spacing", *map(str, RAW_SPACING), "--device", "cpu"])
    with open(out) as f:
        rows = list(csv.DictReader(f))
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    return root, raw, rows, summary["dirlab_e2e"]


def test_e2e_writes_the_csv(chain):
    root, _, rows, _ = chain
    out = root / "out"
    assert sorted(r["id"] for r in rows) == ["copd1", "copd2"]
    assert all(np.isfinite(float(r["dist"])) and float(r["dist"]) > 0
               for r in rows)
    assert all(0.0 <= float(r["dice"]) <= 1.0 for r in rows)
    for path in ("dataset/preprocessed/copd1_source.npy",
                 "dataset/drr/drr/drr/poses.npy",
                 "dataset/pca/pca_vectors.npy",
                 "exp/checkpoints/model_best.ckpt",
                 "exp/tests/copd1_phi.npy",
                 "dataset/landmarks/copd2_300_eBH_xyz_r1.txt"):
        assert (out / path).is_file(), path


def test_e2e_summary_line(chain):
    """The chain's last line on the CPU: stage seconds, the split's steps
    (1 train case and 1 val case at B = 2: one step and one validation
    batch an epoch; both cases in one test batch) and no kernel launch."""
    root, _, _, s = chain
    assert s["device"] == "cpu" and s["cases"] == ["copd1", "copd2"]
    assert (s["size"], s["latent"], s["views"], s["batch"]) \
        == (E2E_SIZE, 4, 2, 2)
    assert set(s["seconds"]) == {"preprocess", "drr", "basis", "train",
                                 "test", "tre"}
    assert set(s["preprocess_seconds"]) == {"copd1", "copd2"}
    assert (s["train_steps"], s["val_batches"], s["test_batches"]) \
        == (2, 2, 1)
    assert len(s["train_step_ms"]) == 2
    assert all(v == 0 for stage in s["launches"].values()
               for v in stage.values())
    assert s["peak_rss_bytes"]["tre"] >= s["peak_rss_bytes"]["preprocess"] > 0
    assert 0 < s["bytes_written"] == sum(
        f.stat().st_size for f in (root / "out").rglob("*") if f.is_file())


def test_peak_rss_without_vmhwm(tmp_path, monkeypatch):
    """Where ``/proc/self/status`` has no ``VmHWM`` (some sandboxes), the
    peak is ``ru_maxrss`` once it exceeds its value at the run's start
    (before that it may be a forking parent's peak): else None."""
    import tools.torch_dirlab_e2e as e2e
    status = tmp_path / "status"
    status.write_text("Name:\tpython\nVmRSS:\t 100 kB\n")
    monkeypatch.setattr(e2e, "_STATUS", str(status))
    now = e2e._maxrss_bytes()
    assert e2e._peak_rss_bytes(now - 1) == now
    assert e2e._peak_rss_bytes(now) is None
    status.write_text("VmHWM:\t 2048 kB\n")
    assert e2e._peak_rss_bytes(now) == 2048 * 1024


def test_e2e_preprocessing_equals_jax(chain, tmp_path):
    import tools.preprocessing as jtool
    root, raw, _, _ = chain
    jtool.preprocess(str(raw), str(tmp_path), jtool.FILE_TYPE.copd,
                     target_size=(E2E_SIZE,) * 3, shape_override=RAW_SHAPE,
                     spacing_override=RAW_SPACING)
    pre = root / "out" / "dataset" / "preprocessed"
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(os.listdir(pre)) and len(files) == 10
    for f in files:
        want = np.load(tmp_path / f, allow_pickle=True)
        got = np.load(pre / f, allow_pickle=True)
        if want.dtype == object:                 # the _prop.npy dicts
            assert got.item().keys() == want.item().keys()
            for k, v in want.item().items():
                np.testing.assert_array_equal(got.item()[k], v, err_msg=f)
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)


def test_e2e_drrs_match_jax(chain, tmp_path):
    import tools.preprocessing_drr as jtool
    root, _, _, _ = chain
    ds = root / "out" / "dataset"
    for sub in ("preprocessed", "train", "debug", "val", "test"):
        shutil.copytree(ds / sub, tmp_path / sub)
    jtool.generate_drrs(str(tmp_path), "drr", scan_range=30.0, scan_num=2)
    want_dir = tmp_path / "drr" / "drr" / "drr"
    got_dir = ds / "drr" / "drr" / "drr"
    files = sorted(os.listdir(want_dir))
    assert files == sorted(os.listdir(got_dir)) and "poses.npy" in files
    for f in files:
        want, got = np.load(want_dir / f), np.load(got_dir / f)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f)


def test_e2e_placeholder_basis_matches_jax(chain, tmp_path):
    from tools.dirlab_e2e import placeholder_pca as jplaceholder
    root, _, _, _ = chain
    jplaceholder(str(tmp_path), E2E_SIZE, 4)
    got_dir = root / "out" / "dataset" / "pca"
    mean_want = np.load(tmp_path / "pca_mean.npy")
    np.testing.assert_allclose(np.load(got_dir / "pca_mean.npy"), mean_want,
                               rtol=0, atol=5e-6 * np.abs(mean_want).max())
    want = np.load(tmp_path / "pca_vectors.npy")
    got = np.load(got_dir / "pca_vectors.npy")
    assert got.shape == want.shape == (4, 3 * E2E_SIZE ** 3)
    signs = np.sign(np.sum(got * want, axis=1))[:, None]
    np.testing.assert_allclose(got * signs, want, rtol=0,
                               atol=5e-6 * np.abs(want).max())


def test_build_setting_equals_jax():
    from tools.dirlab_e2e import build_setting as jbuild
    from tools.torch_dirlab_e2e import build_setting
    args = ("data", "exp", 160, 56, 4, 300, 2, "pca")
    assert build_setting(*args) == jbuild(*args)
    assert build_setting(*args, val_frequency=3) \
        == jbuild(*args, val_frequency=3)


def test_e2e_tre_matches_jax(chain, tmp_path):
    from liftreg_tpu.utils.tre import eval_copd_highres as jeval
    root, _, rows, _ = chain
    shutil.copytree(root / "out" / "exp" / "tests", tmp_path / "tests")
    table = {cid: np.flipud(np.asarray(RAW_SPACING, np.float64))
             for cid in ("copd1", "copd2")}
    want = {r["id"]: r for r in jeval(str(root / "out" / "dataset"),
                                      str(tmp_path), spacing_table=table,
                                      dim=(E2E_SIZE,) * 3)}
    assert sorted(want) == sorted(r["id"] for r in rows)
    for r in rows:
        for k in ("dist", "dist_x", "dist_y", "dist_z"):
            assert abs(float(r[k]) - want[r["id"]][k]) <= 1e-3, (r, k)
        assert float(r["dice"]) == pytest.approx(want[r["id"]]["dice"],
                                                 abs=1e-12)


@pytest.mark.parametrize("tool", ["torch_dirlab_e2e", "torch_dirlab_parity"])
def test_tool_needs_a_card(tmp_path, monkeypatch, tool):
    """Without ``--device`` and without a card the chain and ``--exp``
    raise before they read or write anything."""
    from tools import torch_preprocessing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch_preprocessing, "process_case",
                        lambda *a, **k: pytest.fail("preprocessing ran"))
    if tool == "torch_dirlab_parity":
        data, exp, expect = _perturbed_experiment(tmp_path)
        args = ["--data", data, "--exp", exp, "--expected", expect]
    else:
        raw = tmp_path / "raw"
        make_raw_case(raw, shape=RAW_SHAPE)
        args = ["--raw_path", str(raw), "--out", str(tmp_path / "out")]
    main = importlib.import_module(f"tools.{tool}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
    assert not (tmp_path / "out").exists()
