"""The port's timing tools (``tools/torch_kernel_ab.py``,
``tools/torch_drr_sweep.py``, ``tools/torch_grad_sweep.py``,
``tools/torch_warp_sweep.py``, ``tools/torch_image_grad_sweep.py``) on the
CPU:
what they can check without a card. They share the serving inputs with
``chip_smoke.py``."""
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_drr_sweep  # noqa: E402
import torch_kernel_ab  # noqa: E402

from liftreg_tpu_torch.ops import drr, drr_kernel  # noqa: E402


def test_serving_drr_inputs_shapes():
    cs = torch_kernel_ab.chip_smoke_module()
    g = torch.Generator().manual_seed(0)
    poses, res, fwd, bwd, att, proj = cs.serving_drr_inputs(
        torch, drr, g, torch.device("cpu"))
    sz, b = cs.SZ, cs.B
    assert poses.shape == (4, 3) and res == drr.default_resolution((sz,) * 3)
    assert [tuple(t.shape) for t in fwd] == [(4, sz, res[0]), (4, sz, res[1]),
                                            (4, res[0], res[1])]
    assert [tuple(t.shape) for t in bwd] == [(4, sz, sz), (4, sz, sz)]
    assert att.shape == (b, sz, sz, sz) and proj.shape == (b, 4) + res
    assert float(att.min()) >= 0.0 and float(proj.abs().max()) <= 1.0


@pytest.mark.parametrize("table", ["PROJECTORS", "LIFTS"])
def test_sweep_variants_exist_and_start_from_the_port(table):
    rows = getattr(torch_drr_sweep, table)
    assert rows[0][0] == "csrc"
    kernel = "drr_project" if table == "PROJECTORS" else "drr_backproject"
    assert rows[0][1] == ROOT / f"liftreg_tpu_torch/csrc/{kernel}.cu"
    assert rows[0][2] == ()
    for _, src, _ in rows:
        assert src.is_file(), src
    names = [r[0] for r in rows]
    assert len(names) == len(set(names))


def test_adjoint_sweep_variants_exist_and_start_from_the_port():
    """The adjoint's sweep starts from the port's source as built, and
    every knob a variant sets is one its source reads."""
    rows = torch_drr_sweep.ADJOINTS
    assert rows[0] == ("csrc", ROOT / "liftreg_tpu_torch/csrc/"
                       "drr_project_adjoint.cu", ())
    for name, path, defines in rows:
        src = path.read_text()
        for d in defines:
            assert f"#ifndef {d.split('=')[0]}" in src, (name, d)
    names = [r[0] for r in rows]
    assert len(names) == len(set(names))
    assert "gather" in names


@pytest.mark.parametrize("name", sorted(torch_drr_sweep.ABLATIONS))
def test_sweep_ablations_patch_the_sources(name):
    """Each ablation's patterns still match the source they patch."""
    src, subs = torch_drr_sweep.ABLATIONS[name]
    text = src.read_text()
    for pattern, repl in subs:
        text, count = re.subn(pattern, repl, text)
        assert count > 0, pattern


def test_projector_knob_defaults_match_the_wrapper():
    """The wrapper sizes its plane chunks from the kernel's tile."""
    src = (ROOT / "liftreg_tpu_torch/csrc/drr_project.cu").read_text()
    ti = int(re.search(r"#define LIFTREG_PROJ_TI (\d+)", src).group(1))
    tj = int(re.search(r"constexpr int kTJ = (\d+);", src).group(1))
    planes = int(re.search(r"constexpr int kMaxPlanes = (\d+);",
                           src).group(1))
    assert drr_kernel._PROJ_TILE == (ti, tj)
    assert drr_kernel._PROJ_MAX_PLANES == planes


def test_sweep_reads_ptxas_registers():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "drr_backproject_rowsI13__nv_bfloat16EEvPKfS4_S4_PT_iiii' for "
        "'sm_90a'",
        "ptxas info    : Used 80 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "drr_backproject_rowsIfEEvPKfS2_S2_PT_iiii' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__e0f1b2c3"
        "_22_drr_project_cu_7c1f0d2a17drr_project_tilesEPKfS1_S1_S1_S1_"
        "Pfiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117",
        "ptxas info    : Used 56 registers, used 1 barriers, 29440 bytes smem",
    ])
    assert torch_drr_sweep._registers(log) == {
        "drr_backproject_rows_bf16": 80, "drr_backproject_rows": 40,
        "drr_project_tiles": 56}


def test_sweep_reads_the_adjoint_kernels_registers():
    """The adjoint's kernels are named after the word adjoint_, after the
    file's name in the anonymous namespace."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__807f513e"
        "_22_drr_project_adjoint_cu_3e3c4df013adjoint_tilesEPKfS1_S1_S1_PK4"
        "int2PfPiiiiiiiii' for 'sm_90a'",
        "ptxas info    : Used 122 registers, used 1 barriers, 5216 bytes smem",
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__807f513e"
        "_22_drr_project_adjoint_cu_3e3c4df017adjoint_plan_rowsEPKfS1_P4int2"
        "iiiii' for 'sm_90a'",
        "ptxas info    : Used 23 registers, used 1 barriers",
    ])
    assert torch_drr_sweep._registers(log) == {"adjoint_tiles": 122,
                                               "adjoint_plan_rows": 23}


import torch_grad_sweep  # noqa: E402

from liftreg_tpu_torch.ops import pca_kernel  # noqa: E402


@pytest.mark.parametrize("table,src", [("PCAS", "pca_expand.cu"),
                                       ("WARPS", "warp_trilinear.cu")])
def test_grad_sweep_variants_exist_and_start_from_the_port(table, src):
    rows = getattr(torch_grad_sweep, table)
    assert rows[0] == ("csrc", ROOT / "liftreg_tpu_torch/csrc" / src, ())
    for _, path, _ in rows:
        assert path.is_file(), path
    names = [r[0] for r in rows]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", sorted(torch_grad_sweep.ABLATIONS))
def test_grad_sweep_ablations_patch_the_sources(name):
    """Each ablation's patterns still match the source they patch."""
    src, subs = torch_grad_sweep.ABLATIONS[name]
    text = src.read_text()
    for pattern, repl in subs:
        text, count = re.subn(pattern, repl, text)
        assert count > 0, pattern


def test_pca_grad_tile_matches_the_wrapper():
    """The wrapper counts the backward's tiles to size its grid."""
    src = (ROOT / "liftreg_tpu_torch/csrc/pca_expand.cu").read_text()
    cols = int(re.search(r"constexpr int kCols = (\d+);", src).group(1))
    assert re.search(r"constexpr int kGradTile = 32 \* kCols;", src)
    assert pca_kernel._GRAD_TILE == 32 * cols


def test_grad_sweep_reads_ptxas_registers():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123"
        "pca_grad_partial_kernelILi4EEEvPKfPK13__nv_bfloat16Pflli' for "
        "'sm_90a'",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122"
        "pca_grad_finish_kernelEPKfPflll' for 'sm_90a'",
        "ptxas info    : Used 16 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122"
        "warp_coord_grad_kernelI13__nv_bfloat16Li0EEEvPKT_PKfS5_Pfiiiiiiii' "
        "for 'sm_90a'",
        "ptxas info    : Used 64 registers",
    ])
    assert torch_grad_sweep._registers(log) == {
        "pca_grad_partial_kernel<Li4E>": 128,
        "warp_coord_grad_kernel<13__nv_bfloat16Li0E>": 64}


def test_refine_inputs_shapes():
    """The refine phase's inputs (shared by chip_smoke.py and the A/B
    tool's refined register), at a small size."""
    import torch.nn.functional as F
    cs = torch_kernel_ab.chip_smoke_module()
    cs.SZ, cs.B, cs.LATENT = 12, 2, 3
    g = torch.Generator().manual_seed(0)
    src, tgt, seg, pca = cs.refine_inputs(torch, F, g, torch.device("cpu"))
    shape = (2, 1, 12, 12, 12)
    assert src.shape == tgt.shape == seg.shape == shape
    assert pca["vectors"].shape == (3, 3 * 12 ** 3)
    assert pca["vectors"].dtype == torch.bfloat16
    assert pca["mean"].shape == (3 * 12 ** 3,)
    assert set(seg.unique().tolist()) <= {0.0, 1.0}
    assert float(src.min()) >= -900.0 and float(src.max()) <= -100.0


import torch_warp_sweep  # noqa: E402


def test_warp_sweep_variants_exist_and_start_from_the_port():
    rows = torch_warp_sweep.WARPS
    assert rows[0] == ("csrc", ROOT / "liftreg_tpu_torch/csrc/"
                       "warp_trilinear.cu", ())
    for name, path, defines in rows:
        src = path.read_text()
        for d in defines:
            # every knob is one its source reads
            assert f"#ifndef {d.split('=')[0]}" in src, (name, d)
    names = [r[0] for r in rows]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", sorted(torch_warp_sweep.ABLATIONS))
def test_warp_sweep_ablations_patch_the_sources(name):
    """Each ablation's patterns still match the source they patch."""
    src, subs = torch_warp_sweep.ABLATIONS[name]
    text = src.read_text()
    for pattern, repl in subs:
        text, count = re.subn(pattern, repl, text)
        assert count > 0, pattern


def test_warp_sweep_reads_ptxas_registers():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "warp_trilinear_kernelI13__nv_bfloat16Li0ELi1EEEvPKT_PKfPfiiiiiiiii"
        "i' for 'sm_90a'",
        "ptxas info    : Used 72 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "warp_trilinear_kernelIfLin1ELi0EEEvPKT_PKfPfiiiiiiiiii' for "
        "'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    assert torch_warp_sweep._registers(log) == {
        "warp_trilinear_kernel<13__nv_bfloat16Li0ELi1E>": 72,
        "warp_trilinear_kernel<fLin1ELi0E>": 40}


def test_warp_phi_cases_shapes():
    """chip_smoke.py's phi-layout cases at a small size: the batch sizes,
    the ragged point count, the unaligned copies, the unit dims."""
    import torch.nn.functional as F
    cs = torch_kernel_ab.chip_smoke_module()
    cs.SZ, cs.B = 10, 2
    g = torch.Generator().manual_seed(0)
    cases = cs.warp_phi_cases(torch, F, g, torch.device("cpu"))
    assert set(cases) == {"serving_b1", "serving_b2", "serving_b9",
                          "unaligned", "ragged_m", "unit_d", "unit_w",
                          "unit_h"}
    for name, (vol, phi, cot) in cases.items():
        assert phi.shape[:2] == (vol.shape[0], 3)
        assert cot.shape == vol.shape[:2] + phi.shape[2:], name
        assert phi.is_contiguous() and cot.is_contiguous()
    assert cases["ragged_m"][1].shape[2:] == (6001,)
    assert cases["unaligned"][1].data_ptr() % 16 != 0
    assert cases["unaligned"][2].data_ptr() % 16 != 0
    assert torch.equal(cases["unaligned"][1], cases["serving_b2"][1])
    assert cases["unit_w"][0].shape[2:] == (10, 1, 10)
    # phi's pixel coordinates are the smooth field's
    coords = cs._smooth_coords(torch, F, torch.Generator().manual_seed(1),
                               2, 10, 4.0, torch.device("cpu"))
    back = (cs._phi_of(coords, 10).movedim(1, -1) + 1.0) * 4.5
    torch.testing.assert_close(back.reshape(2, -1, 3), coords)


def test_glue_counter_sees_the_plain_glue():
    """chip_smoke.py's glue_check counter on the CPU, where warp_image runs
    the plain glue: it sees the coordinate buffer, one rescale per warp
    and one tap cast per call (two with refinement: the encoder's
    prediction and the refinement's steps). On the card the first two
    must be 0."""
    from liftreg_tpu_torch import RegistrationPipeline
    cs = torch_kernel_ab.chip_smoke_module()
    sz, g = (12, 12, 12), torch.Generator().manual_seed(0)
    pca = {"vectors": (torch.randn((3, 3 * 12 ** 3), generator=g)
                       * 0.01).bfloat16(), "mean": torch.zeros(3 * 12 ** 3)}
    hu = [torch.rand((2, 1) + sz, generator=g) * -1000.0 for _ in range(2)]
    seg = (torch.rand((2, 1) + sz, generator=g) > 0.3).float()
    for steps, warps, casts in ((0, 1, 1), (2, 5, 2)):
        pipe = RegistrationPipeline(sz, latent_dim=3, refine_steps=steps,
                                    compute_dtype=torch.bfloat16,
                                    device="cpu")
        counts = cs.glue_ops(torch, lambda: pipe.register(pca, *hu, seg,
                                                          seg), 2, 12)
        assert counts["coordinate_buffers"] >= warps
        assert counts["rescales"] == warps
        assert counts["tap_casts"] == casts


import torch_image_grad_sweep  # noqa: E402


def test_image_grad_sweep_variants_read_the_knobs():
    """The image gradient's sweep starts from the port's source as built;
    every constant it sets is one the source defines, once; the names are
    distinct."""
    sweep = torch_image_grad_sweep
    assert list(sweep.VARIANTS)[0] == "csrc" and sweep.VARIANTS["csrc"] == []
    src = sweep.SRC.read_text()
    for name, subs in sweep.VARIANTS.items():
        for pattern, _ in subs:
            assert len(re.findall(pattern, src)) == 1, (name, pattern)
        # each variant other than the port's source changes it
        assert (sweep.patched_source(name, subs) == src) == (name == "csrc")
    names = list(sweep.VARIANTS) + list(sweep.ABLATIONS) \
        + list(sweep.DESIGNS)
    assert len(names) == len(set(names))
    text = sweep.patched_source("t2x8x32_n256_mb4_ch1_s12288",
                                sweep.VARIANTS["t2x8x32_n256_mb4_ch1_s12288"])
    assert "constexpr int kImgTZ = 2;" in text
    assert "constexpr int kImgChan = 1;" in text


@pytest.mark.parametrize("name", sorted(torch_image_grad_sweep.ABLATIONS)
                         + sorted(torch_image_grad_sweep.DESIGNS))
def test_image_grad_sweep_ablations_patch_the_source(name):
    """Each ablation's and design's patterns still match the port's source
    once."""
    subs = {**torch_image_grad_sweep.ABLATIONS,
            **torch_image_grad_sweep.DESIGNS}[name]
    text = torch_image_grad_sweep.SRC.read_text()
    for pattern, repl in subs:
        text, count = re.subn(pattern, repl, text)
        assert count == 1, pattern


def test_image_grad_sweep_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__cbb06ca2"
        "_17_warp_trilinear_cu_7a471e3c22warp_image_grad_kernelILi1ELi1EEEvP"
        "KfS2_PfPyiiiiiiiiiiii' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 20 bytes spill stores, 20 bytes spill "
        "loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 32 bytes smem",
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__cbb06ca2"
        "_17_warp_trilinear_cu_7a471e3c22warp_image_grad_kernelILin1ELi0EEEv"
        "PKfS2_PfPyiiiiiiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 32 bytes smem",
    ])
    assert torch_image_grad_sweep._registers(log) == {
        "warp_image_grad_kernel<Li1ELi1E>": "64 (spills 20 bytes)",
        "warp_image_grad_kernel<Lin1ELi0E>": 40}


def test_image_grad_cases_shapes():
    """chip_smoke.py's image-gradient cases at a small size: both layouts
    of each field at C = 1 and 3, the rough field off its own voxels, the
    slab's y outside the volume, the clamped field on the faces."""
    import torch.nn.functional as F
    cs = torch_kernel_ab.chip_smoke_module()
    cs.SZ, cs.ROUGH_SZ = 10, 12
    g = torch.Generator().manual_seed(0)
    cases = cs.image_grad_cases(torch, F, g, torch.device("cpu"))
    for field in ("rough", "slab", "faces"):
        for C in (1, 3):
            vol, phi, cot, is_phi = cases[f"phi/{field}_c{C}"]
            assert is_phi and phi.shape == (2, 3) + (12,) * 3
            assert vol.shape == cot.shape == (2, C) + (12,) * 3
            _, pix, pcot, is_phi = cases[f"pixel/{field}_c{C}"]
            assert not is_phi and pix.shape == (2, 12 ** 3, 3)
            assert pcot.shape == (2, C, 12 ** 3)
            back = (phi.movedim(1, -1) + 1.0) * 5.5
            torch.testing.assert_close(back.reshape(2, -1, 3), pix)
    _, pix, _, _ = cases["pixel/faces_c3"]
    assert float(pix.min()) == 0.0 and float(pix.max()) == 11.0
    _, pix, _, _ = cases["pixel/slab_c1"]
    assert bool((pix.view(2, 12, 12, 12, 3)[:, :, 5:8, :, 1] == 48.0).all())
    ident = torch.arange(12.0)
    rough = cases["pixel/rough_c1"][1].view(2, 12, 12, 12, 3)[..., 2]
    assert float((rough - ident).abs().max()) > 6.0


def test_regnet_step_times_a_step_on_the_cpu(monkeypatch):
    """torch_kernel_ab.py's RegNet2D3D step at 16^3 with the CPU's plain
    versions: finite medians of 5 steps, the model's gradients filled."""
    from liftreg_tpu_torch.models.unet2d3d import RegNet2D3D
    cs = torch_kernel_ab.chip_smoke_module()
    cs.SZ = 16
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    out = torch_kernel_ab._regnet_step(torch, cs, drr, RegNet2D3D,
                                       torch.device("cpu"))
    assert len(out["regnet_step_calls"]) == 5
    assert out["regnet_step"] == sorted(out["regnet_step_calls"])[2] > 0
    # no card, so no image-gradient kernel in the profile
    assert out["regnet_image_grad_launches"] == 0
    assert out["regnet_image_grad_smooth_launches"] == 0


@pytest.mark.parametrize("name", ["subspace_backproj", "subspace"])
def test_subspace_step_times_a_step_on_the_cpu(monkeypatch, name):
    """torch_kernel_ab.py's LiftReg and LiftRegSubspace steps at 32^3,
    B = 2, latent 4 with the CPU's plain versions: finite medians of 3
    steps."""
    from liftreg_tpu_torch.models import get_model
    cs = torch_kernel_ab.chip_smoke_module()
    cs.SZ, cs.TRAIN_B, cs.LATENT = 32, 2, 4
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    out = torch_kernel_ab._subspace_step(torch, cs, drr, get_model(name),
                                         "step", torch.device("cpu"))
    assert len(out["step_calls"]) == 3
    assert out["step"] == sorted(out["step_calls"])[1] > 0


def test_refine_conditioning_needs_a_card(monkeypatch, capsys):
    """tools/torch_refine_conditioning.py refuses to run without a card
    (it draws refine_reference's data on the card) and covers
    refine_reference's four configurations."""
    import torch_refine_conditioning
    cs = torch_kernel_ab.chip_smoke_module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_refine_conditioning.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert set(torch_refine_conditioning.CONFIGS) == {
        "image_ncc", "image_lncc", "projection_ncc", "projection_ngf"}
    assert cs.REFINE_HISTORY_TOL > 0
