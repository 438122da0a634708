"""The port's evaluation tools against the JAX package's on a 16^3
synthetic split (``tools/make_synthetic_dataset.py``: 2 views, 3 test
cases): ``tools/torch_evaluate_dir_lab.py`` and
``tools/torch_demo_report.py`` print the JAX tools' numbers (the TRE host
math is bit-equal, so every printed number agrees to well within 1e-6 mm),
and ``tools/torch_refine_eval.py`` from the JAX tool's checkpoint writes
amortized maps within 1e-5 and image-domain refined maps within 1e-4 of
the JAX tool's (tests/test_torch_eval.py's and test_torch_refine.py's
tolerances), so each case's TRE agrees within 1e-2 mm (a map error e moves
a landmark by at most e * 15 * 2.2 mm per axis); its projection domain
runs and lowers the similarity."""
import contextlib
import csv
import io
import json
import os
import re
import runpy
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from torch_train_data import setting

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_demo_report  # noqa: E402
import torch_evaluate_dir_lab  # noqa: E402
import torch_refine_eval  # noqa: E402

SZ = 16
NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?|nan")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from tools.make_synthetic_dataset import generate
    out = str(tmp_path_factory.mktemp("synth_eval_tools"))
    generate(out, n_train=2, n_val=1, n_test=3, sz=SZ, n_proj=2, latent=2,
             seed=4)
    return out


def _ids(dataset):
    return [str(c) for c in np.sort(np.load(os.path.join(
        dataset, "test", "data_id.npy")))]


def _run_jax_tool(name, argv):
    """A JAX package tool run as its ``__main__`` in this process; its
    standard output."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "tools" / name), run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def _run_port_tool(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _numbers(text):
    return [float(x) for x in NUMBER.findall(text)]


def _assert_same_numbers(got, want):
    a, b = _numbers(got), _numbers(want)
    assert len(a) == len(b) and a
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def exp_maps(dataset, tmp_path_factory):
    """Two experiment folders holding the same saved maps: the ground truth
    for the first test case, perturbed ones for the others."""
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("maps")
    exps = {side: root / side for side in ("jax", "torch")}
    for exp in exps.values():
        os.makedirs(exp / "tests")
    for i, case in enumerate(_ids(dataset)):
        phi01 = np.load(os.path.join(dataset, "gt_phi", f"{case}_phi.npy"))
        if i:
            phi01 = phi01 + rng.normal(scale=0.01, size=phi01.shape).astype(
                np.float32)
        for exp in exps.values():
            np.save(exp / "tests" / f"{case}_phi.npy", phi01)
    return {k: str(v) for k, v in exps.items()}


def test_evaluate_dir_lab_prints_jax_numbers(dataset, exp_maps):
    want = _run_jax_tool("evaluate_dir_lab.py",
                         ["-d", dataset, "--exp_path", exp_maps["jax"],
                          "--dim", str(SZ)])
    got = _run_port_tool(torch_evaluate_dir_lab.main,
                         ["-d", dataset, "--exp_path", exp_maps["torch"],
                          "--dim", str(SZ), "--device", "cpu"])
    _assert_same_numbers(got, want)
    assert "TRE" in got and "GFR" in got
    for side in ("jax", "torch"):
        assert os.path.isfile(os.path.join(exp_maps[side],
                                           "evaluate_result.csv"))


def test_demo_report_prints_jax_numbers(dataset, exp_maps):
    want = _run_jax_tool("demo_report.py", ["-d", dataset, "-e",
                                            exp_maps["jax"], "--dim",
                                            str(SZ)])
    got = _run_port_tool(torch_demo_report.main,
                         ["-d", dataset, "-e", exp_maps["torch"], "--dim",
                          str(SZ)])
    _assert_same_numbers(got, want)
    assert got.splitlines()[0] == want.splitlines()[0]
    assert "mean TRE trained" in got and "mean TRE ground_truth" in got


@pytest.fixture(scope="module")
def refine_runs(dataset, tmp_path_factory):
    """tools/refine_eval.py (image domain) and the port's tool (both
    domains) from one JAX checkpoint, each on its own copy of the
    experiment."""
    os.environ["LIFTREG_NO_TB"] = "1"
    root = tmp_path_factory.mktemp("refine_eval")
    exps = {}
    for side in ("jax", "torch"):
        exp = str(root / side)
        os.makedirs(os.path.join(exp, "checkpoints"))
        with open(os.path.join(exp, "cur_task_setting.json"), "w") as f:
            json.dump(setting(dataset, exp, sz=SZ, views=2, latent=2,
                              batch_size=2), f)
        exps[side] = exp
    from liftreg_tpu.train import RegistrationTrainer as JaxTrainer
    jt = JaxTrainer(setting(dataset, exps["jax"], sz=SZ, views=2, latent=2,
                            batch_size=2), n_devices=1)
    # a trained-looking checkpoint: the FC head scaled up, so the maps move
    params = jax.tree_util.tree_map(lambda a: a, jt.params)
    head = params["params"]["encoder"]["FullyConnectBlock_2"]["Dense_0"]
    head["kernel"] = head["kernel"] * 50.0
    jt.params = params
    jt.save_model("", is_best=True)
    del jt
    shutil.copy(os.path.join(exps["jax"], "checkpoints", "model_best.ckpt"),
                os.path.join(exps["torch"], "checkpoints"))
    args = ["--steps", "3", "--lr", "0.05", "--iso_spacing", "2.2"]
    logs = {"jax": _run_jax_tool(
        "refine_eval.py",
        ["-s", os.path.join(exps["jax"], "cur_task_setting.json"), *args])}
    for domain in ("image", "projection"):
        logs[domain] = _run_port_tool(
            torch_refine_eval.main,
            ["-s", os.path.join(exps["torch"], "cur_task_setting.json"),
             *args, "--domain", domain, "--device", "cpu"])
    return exps, logs


def _csv(path):
    with open(os.path.join(path, "evaluate_result.csv")) as f:
        return {r["id"]: r for r in csv.DictReader(f)}


def test_refine_eval_matches_jax(dataset, refine_runs):
    exps, logs = refine_runs
    ids = _ids(dataset)
    for sub, tol in (("tests", 1e-5), ("refined/tests", 1e-4)):
        for case in ids:
            want = np.load(os.path.join(exps["jax"], sub, f"{case}_phi.npy"))
            got = np.load(os.path.join(exps["torch"], sub,
                                       f"{case}_phi.npy"))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for sub in ("", "refined"):
        want = _csv(os.path.join(exps["jax"], sub))
        got = _csv(os.path.join(exps["torch"], sub))
        assert sorted(got) == sorted(want) == ids
        for case in ids:
            for key in ("dist", "dist_x", "dist_y", "dist_z"):
                assert abs(float(got[case][key])
                           - float(want[case][key])) <= 1e-2
    # the refinement moved the maps and lowered the similarity loss
    assert "mean TRE" in logs["image"]
    for domain in ("image", "projection"):
        first, last = re.search(
            r"mean sim loss over test batches: (\S+) -> (\S+)",
            logs[domain]).groups()
        assert float(last) < float(first), domain
    assert len(_csv(os.path.join(exps["torch"], "refined_proj"))) == 3
