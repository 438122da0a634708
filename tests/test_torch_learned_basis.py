"""The learned-basis workflow's host modules and tools in the port against
the JAX package's on the CPU: ``pca`` (fit, save, EVR), ``utils/settings``,
``data/preprocessing``, ``native`` (the codec) and the tools
``tools/torch_build_pca.py``, ``tools/torch_basis_oracle.py``,
``tools/torch_make_synthetic_dataset.py``,
``tools/torch_preprocessing.py``, ``tools/torch_preprocessing_drr.py`` and
``tools/torch_paper_workflow.py`` (the port's optreg chain up to its gate).

Tolerances: the PCA, the settings, preprocessing, the gate's residuals and
the codec's bytes are equal (the same host code); the synthetic dataset's
masks, ids and poses are equal and its volumes, fields, DRRs and basis
within 5e-6 of each array's largest value (the noise fields' upsampling,
the warps and the projector round their last bits otherwise, and the
target's warp carries its field's ulps by the phantom's gradient), its
landmarks within 1e-3 voxel (4 decimals printed); the DRR tool's
projections within 1e-5 of the largest line integral; the workflow's
train-split fields (per-pair registration, bf16 taps, two levels of 2
steps; three pairs, so that the two components are well defined) within
5e-4 (a grid node whose gradient is near 0 takes Adam's first step of a
level by the sign of last-bit differences: ``tests/test_torch_optreg.py``)
and the EVR within 1e-5.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from liftreg_tpu import native as jnative  # noqa: E402
from liftreg_tpu import pca as jpca  # noqa: E402
from liftreg_tpu.data import dataset as jdata  # noqa: E402
from liftreg_tpu.data import preprocessing as jpre  # noqa: E402
from liftreg_tpu.utils import settings as jsettings  # noqa: E402
from liftreg_tpu_torch import native, pca  # noqa: E402
from liftreg_tpu_torch.data import dataset as tdata  # noqa: E402
from liftreg_tpu_torch.data import preprocessing as tpre  # noqa: E402
from liftreg_tpu_torch.utils import settings  # noqa: E402

SZ = 24


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same seeded 24^3 dataset from the JAX tool and the port's."""
    from tools import make_synthetic_dataset as jgen
    from tools import torch_make_synthetic_dataset as tgen
    root = tmp_path_factory.mktemp("learned_basis")
    kw = dict(n_train=3, n_val=1, n_test=1, sz=SZ, n_proj=3, latent=2,
              seed=3, deformation_rank=2, texture="anatomical",
              deformation_smooth=6, deformation_magnitude=0.1)
    jgen.generate(str(root / "jax"), **kw)
    tgen.generate(str(root / "torch"), device="cpu", **kw)
    return root / "jax", root / "torch"


@pytest.mark.parametrize("scale_by_stddev", [False, True])
def test_fit_save_and_evr_bit_equal(tmp_path, scale_by_stddev):
    X = np.random.default_rng(1).normal(size=(7, 300)).astype(np.float32)
    want = jpca.fit_pca(X, 4, chunk=3, scale_by_stddev=scale_by_stddev)
    got = pca.fit_pca(list(X), 4, chunk=3, scale_by_stddev=scale_by_stddev)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert pca.explained_variance_ratio(X, *got) \
        == jpca.explained_variance_ratio(X, *want)
    jpca.save_pca(str(tmp_path / "j"), *want)
    pca.save_pca(str(tmp_path / "t"), *got)
    for name in ("pca_vectors.npy", "pca_mean.npy"):
        assert (tmp_path / "j" / name).read_bytes() \
            == (tmp_path / "t" / name).read_bytes()
    # fit_pca writes its vectors in Fortran order, as JAX's does; the
    # loaded basis is contiguous, as the PCA kernel needs it
    assert np.load(tmp_path / "t" / "pca_vectors.npy").flags.f_contiguous
    loaded = pca.load_pca(str(tmp_path / "t"), device="cpu")
    assert loaded["vectors"].is_contiguous()
    np.testing.assert_array_equal(loaded["vectors"].numpy(), got[0])
    with pytest.raises(ValueError):
        pca.fit_pca(X, 8)


def test_default_task_setting():
    over = {"dataset": {"max_num_for_loading": [40, 4, 4, 4]},
            "train": {"epoch": 3, "model": {"latent_dim": 24},
                      "new_key": {"a": 1}}}
    assert settings.default_task_setting("d", "o", 96, overrides=over) \
        == jsettings.default_task_setting("d", "o", 96, overrides=over)
    assert settings.deep_update({"a": {"b": 1}}, {"a": {"c": 2}}) \
        == jsettings.deep_update({"a": {"b": 1}}, {"a": {"c": 2}})


def test_load_disp_fields(tmp_path):
    from tools.build_pca import load_disp_fields as jload
    from tools.torch_build_pca import load_disp_fields
    rng = np.random.default_rng(2)
    idm = np.stack(np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32)
                                 for n in (5, 6, 7)], indexing="ij"))
    np.save(tmp_path / "a_phi.npy",
            ((idm + rng.normal(0, 0.02, idm.shape)).clip(-1, 1) + 1) / 2)
    np.save(tmp_path / "b_disp.npy",
            rng.normal(0, 0.3, idm.shape).astype(np.float32))
    np.testing.assert_array_equal(load_disp_fields(str(tmp_path)),
                                  jload(str(tmp_path)))


@pytest.mark.parametrize("mask", ["none", "lung"])
def test_basis_oracle_residual(datasets, mask):
    from tools.basis_oracle import main as jmain
    from tools.torch_basis_oracle import main
    jroot, _ = datasets
    args = ["--pca", str(jroot / "pca"), "--data", str(jroot), "--phase",
            "train", "--mask", mask]
    got = main(args)
    assert got == jmain(args)
    # the dataset's own basis spans its training fields
    assert mask == "lung" or got < 1e-3


def test_synthetic_dataset_matches_jax_tool(datasets):
    jroot, troot = datasets
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(troot) for p in troot.rglob("*")
                           if p.is_file())
    for rel in files:
        a, b = jroot / rel, troot / rel
        if rel.suffix == ".txt":
            np.testing.assert_allclose(np.loadtxt(b), np.loadtxt(a), rtol=0,
                                       atol=1e-3, err_msg=str(rel))
            continue
        want = np.load(a, allow_pickle=True)
        got = np.load(b, allow_pickle=True)
        if want.dtype == object:                 # the _prop.npy dicts
            for k, v in want.item().items():
                np.testing.assert_array_equal(got.item()[k], v)
        elif "seg" in rel.name or "data_id" in rel.name \
                or rel.name == "poses.npy":
            np.testing.assert_array_equal(got, want, err_msg=str(rel))
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=5e-6 * np.abs(want).max(),
                                       err_msg=str(rel))


def _raw_case(raw, shape=(30, 48, 48)):
    sys.path.insert(0, str(ROOT / "tests"))
    from test_preprocessing_cli import make_raw_case
    make_raw_case(raw, shape=shape)
    case_dir = raw / "copd1" / "copd1"
    return (str(case_dir / "copd1_iBHCT.img"),
            str(case_dir / "copd1_eBHCT.img"), shape)


def test_process_case_and_preprocessing_tool(tmp_path):
    import tools.preprocessing as jtool
    import tools.torch_preprocessing as ttool
    raw = tmp_path / "raw"
    src, tgt, shape = _raw_case(raw)
    kw = dict(target_size=(40, 40, 40), target_spacing=(2.2, 2.2, 2.2))
    want = jpre.process_case(src, tgt, shape, (2.5, 2.0, 2.0), **kw)
    got = tpre.process_case(src, tgt, shape, (2.5, 2.0, 2.0), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert tpre._kmeans2_threshold(np.arange(10.0)) \
        == jpre._kmeans2_threshold(np.arange(10.0))
    # the CLI's per-case loop, with the raw shape and spacing given
    for tool, name in ((jtool, "j"), (ttool, "t")):
        os.makedirs(tmp_path / name)
        tool.preprocess(str(raw), str(tmp_path / name),
                        tool.FILE_TYPE.copd, target_size=(40, 40, 40),
                        shape_override=shape,
                        spacing_override=(2.5, 2.0, 2.0))
    for f in sorted(os.listdir(tmp_path / "j")):
        a = np.load(tmp_path / "j" / f, allow_pickle=True)
        b = np.load(tmp_path / "t" / f, allow_pickle=True)
        if a.dtype == object:
            a, b = a.item()["origin"], b.item()["origin"]
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_drr_tool_matches_jax(datasets, tmp_path):
    import tools.preprocessing_drr as jtool
    import tools.torch_preprocessing_drr as ttool
    jroot, _ = datasets
    want_poses = jtool.generate_drrs(str(jroot), "jdrr", scan_range=40.0,
                                     scan_num=2, phases=["train"])
    csv = tmp_path / "geo.csv"
    np.savetxt(csv, want_poses * 2.2, delimiter=",", header="x,y,z",
               comments="")
    got_poses = ttool.main(["--data_path", str(jroot), "--drr_folder_name",
                            "tdrr", "--geo_path", str(csv), "--phase",
                            "train", "--device", "cpu"])
    np.testing.assert_allclose(got_poses, want_poses, rtol=1e-6)
    for f in sorted(os.listdir(jroot / "drr" / "jdrr" / "drr")):
        want = np.load(jroot / "drr" / "jdrr" / "drr" / f)
        got = np.load(jroot / "drr" / "tdrr" / "drr" / f)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f)


def test_preprocessing_attenuation_matches_jax():
    import jax.numpy as jnp

    from liftreg_tpu.ops import drr as jdrr
    from liftreg_tpu_torch.ops import drr
    hu = np.random.default_rng(5).uniform(-1500, 500, (4, 5, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(
        drr.calc_relative_atten_coef_preprocessing(
            torch.from_numpy(hu)).numpy(),
        np.asarray(jdrr.calc_relative_atten_coef_preprocessing(
            jnp.asarray(hu))))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_codec_bytes_equal_jax(monkeypatch, path):
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(20, 33, 7)).astype(np.float32),
              np.linspace(-1, 1, 4096).astype(np.float32),
              (rng.normal(size=(10, 11)) * 100).astype(np.int32),
              rng.integers(0, 2, (9, 9, 9)).astype(np.int8)]
    if path == "native":
        assert native.native_available() and jnative.native_available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    for arr in arrays:
        meta, payload = native.pack_array(arr)
        assert (meta, payload) == jnative.pack_array(arr)
        np.testing.assert_array_equal(native.unpack_array(meta, payload),
                                      arr)
        np.testing.assert_array_equal(jnative.unpack_array(meta, payload),
                                      arr)


def test_dataset_compress_in_memory(datasets):
    jroot, _ = datasets
    opt = {"drr_folder_name": "drr", "use_segmentation_map": True,
           "spacing_to_refer": [2.2] * 3, "load_projection_interval": 1,
           "apply_hu_clip": True, "max_num_for_loading": (-1,) * 4,
           "compress_in_memory": True}
    got = tdata.Registration2D3DDataset(str(jroot), "train", option=opt)
    want = jdata.Registration2D3DDataset(str(jroot), "train", option=opt)
    for case_t, case_j in zip(got.cases, want.cases):
        assert case_t.keys() == case_j.keys()
        for k in case_t:
            assert case_t[k] == case_j[k][1:], k
    (gs, gn), (ws, wn) = got[1], want[1]
    assert gn == wn
    for k in ws:
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)


def test_workflow_optreg_basis_and_gate_match_jax(datasets, tmp_path,
                                                  capsys):
    """The port's workflow through stage 2 and the gate (a residual limit
    below any basis's, so that it stops before stage 3), against the JAX
    tool's ``disp_from_optreg`` and ``fit_pca`` on the same dataset."""
    import json

    from tools.build_pca import disp_from_optreg as jdisp
    from tools.torch_paper_workflow import main
    jroot, _ = datasets
    levels = "4:2:0.04,8:2:0.02"
    rc = main(["--data", str(jroot), "--out", str(tmp_path), "--size",
               str(SZ), "--stage1_mode", "optreg", "--optreg_levels", levels,
               "--latent", "2", "--gate_mask", "lung", "--gate_residual",
               "1e-9", "--device", "cpu"])
    assert rc == 3
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # 3 pairs in 2 calls, the second padded
    assert summary["fields"] == 3 and "stage3_s" not in summary
    assert summary["optreg_calls"] == 2
    for first, last in summary["optreg_sim_first_last"]:
        assert last <= first
    X = jdisp(str(jroot), levels=((4, 2, 0.04), (8, 2, 0.02)), batch=2,
              verbose=False)
    vectors, mean = jpca.fit_pca(X, 2)
    got = pca.load_pca(str(tmp_path / "pca_from_optreg"), device="cpu")
    np.testing.assert_allclose(got["mean"].numpy(), mean, rtol=0, atol=5e-4)
    # the basis up to each component's sign
    got_v = got["vectors"].numpy()
    signs = np.sign(np.sum(got_v * vectors, axis=1))[:, None]
    np.testing.assert_allclose(got_v * signs, vectors, rtol=0, atol=5e-4)
    assert summary["evr"]["2"] == pytest.approx(
        jpca.explained_variance_ratio(X, vectors, mean), abs=1e-5)
    assert torch.isfinite(got["vectors"]).all()
