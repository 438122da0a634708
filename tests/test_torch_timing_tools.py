"""The port's six timing tools (tools/torch_bench_train_step.py,
torch_bench_refine.py, torch_profile_refine.py,
torch_bench_pallas_frontier.py, torch_bench_stage0.py, torch_bench_ab.py)
on the CPU at small sizes: each runs with ``--device cpu`` and prints the
JSON line its docstring names, each refuses to run without a card unless
``--device cpu`` is given, and where a tool exposes the function it times,
that function on the same inputs as the JAX function that the JAX tool
times:

* bench_refine's pipelines (bf16 encoder, basis and taps, the JAX tool's
  config), refined for 2 steps in each domain, from the JAX pipeline's
  initial parameters (``params_from_jax``): phi atol 5e-4, warped atol
  1e-2. The two frameworks' bf16 encoders round their coefficients ~1e-3
  apart (tests/test_torch_pipeline.py), and Adam's second step divides
  gradients taken at those two points; measured here 1.35e-4 and 2.1e-3
  in the image domain, 9.6e-6 and 2.0e-4 in the projection domain, on
  noise volumes whose gradient reaches 2 a voxel;
* profile_refine's parts with the JAX tool's default bf16 basis and taps
  and with f32 ones: the PCA expansion atol/rtol 1e-5
  (tests/test_torch_pca.py); its coefficients' gradient rtol 2^-8 and
  atol 1e-4 of the largest with a bf16 basis, rtol 1e-5 with an f32 one
  (tests/test_torch_grads.py); the warp atol 2e-6 with bf16 taps and 2e-5
  with f32 (``warp_image``'s in tests/test_torch_warp.py), its phi
  gradient atol 2e-5 of the
  largest; NCC's and the regulariser's gradients rtol 1e-5, atol 1e-6; the
  identity-map add atol 1e-6; one refinement step's coefficients atol 1e-3
  and phi 1e-4 (tests/test_torch_refine.py's bf16-tap trajectories);
* bench_pallas_frontier's plain versions (the PCA expansion against the
  XLA dot the JAX tool times, the projector and the lift against the
  JAX matrix chains) atol/rtol 1e-5 (tests/test_torch_coords_drr.py).
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_bench_ab  # noqa: E402
import torch_bench_pallas_frontier as frontier  # noqa: E402
import torch_bench_refine  # noqa: E402
import torch_bench_stage0  # noqa: E402
import torch_bench_train_step  # noqa: E402
import torch_profile_refine  # noqa: E402
from liftreg_tpu.losses.registration import displacement_reg  # noqa: E402
from liftreg_tpu.losses.similarity import ncc_loss  # noqa: E402
from liftreg_tpu.models.subspace_backproj import expand_pca  # noqa: E402
from liftreg_tpu.ops import drr as jdrr  # noqa: E402
from liftreg_tpu.ops import resample as jresample  # noqa: E402
from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline  # noqa
from liftreg_tpu.refine import make_refiner as jmake_refiner  # noqa: E402
from liftreg_tpu_torch import params_from_jax  # noqa: E402
from liftreg_tpu_torch.ops import drr as tdrr  # noqa: E402
from liftreg_tpu_torch.ops.drr_kernel import (  # noqa: E402
    backproject_taps_plain, project_taps_plain)
from liftreg_tpu_torch.ops.pca_kernel import pca_expand_plain  # noqa: E402

SZ, LATENT = 16, 4
TOOLS = {"train_step": torch_bench_train_step, "refine": torch_bench_refine,
         "profile_refine": torch_profile_refine, "frontier": frontier,
         "stage0": torch_bench_stage0, "ab": torch_bench_ab}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 16^3 synthetic set with 4 views and a latent-4 basis."""
    from tools.torch_make_synthetic_dataset import generate
    out = tmp_path_factory.mktemp("timing_tools") / "data"
    generate(str(out), n_train=4, n_val=2, n_test=1, sz=SZ, n_proj=4,
             latent=LATENT, seed=0, device="cpu")
    return str(out)


def _args(name, dataset):
    """Each tool's small CPU arguments."""
    return {
        "train_step": ["--data", dataset, "--model", "subspace_backproj",
                       "--size", str(SZ), "--latent", str(LATENT),
                       "--batch", "2", "--epochs", "1"],
        "refine": ["--size", str(SZ), "--latent", str(LATENT), "--steps",
                   "2", "--batch", "2"],
        "profile_refine": ["--size", str(SZ), "--latent", str(LATENT),
                           "--reps", "1", "--batch", "2"],
        "frontier": ["--size", str(SZ), "--sizes", str(SZ), "--reps", "1"],
        "stage0": ["--size", "8", "--iters", "1", "--batch", "2"],
        "ab": ["--size", str(SZ), "--iters", "1", "--train_iters", "1"],
    }[name]


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _finite(*values):
    return all(v is not None and np.isfinite(v) for v in values)


def test_train_step_tool(dataset, capsys):
    rec = torch_bench_train_step.main(_args("train_step", dataset)
                                      + ["--device", "cpu"])
    assert _last_json(capsys) == json.loads(json.dumps(rec))
    assert list(rec)[:3] == ["card", "tool", "device"]
    assert rec["card"] == "cpu" and rec["metric"] == "train_step_time_ms"
    # epochs 0 and 1 of 2 steps (4 cases, B = 2), each logged
    assert rec["steps"] == 4 and len(rec["all_flushes_ms"]) == 4
    assert rec["val_batches"] == 2
    assert _finite(rec["value"]) and rec["launches"] == {}


def test_train_step_tool_regnet(dataset, capsys):
    rec = torch_bench_train_step.main(
        ["--data", dataset, "--model", "regnet2d3d", "--size", str(SZ),
         "--epochs", "0", "--inverse_iters", "1", "--device", "cpu"])
    assert rec["model"] == "regnet2d3d" and rec["steps"] == 4
    assert _finite(rec["value"])


@pytest.mark.parametrize("domain", ["image", "projection"])
def test_refine_tool(domain, capsys):
    rec = torch_bench_refine.main(_args("refine", None)
                                  + ["--domain", domain, "--device", "cpu"])
    assert _last_json(capsys)["tool"] == "torch_bench_refine"
    assert set(rec["calls"]) == {"0", "2"}
    for line in rec["calls"].values():
        assert _finite(line["first_call_ms"], line["ms_per_call"],
                       line["reg_per_s"])
    assert _finite(rec["refine_tail_ms"], rec["refine_ms_per_step"])


def test_refine_tool_artifact(tmp_path, capsys):
    from tools.torch_export_serving import main as export
    path = export(["--demo", str(SZ), "-o", str(tmp_path / "d.liftreg"),
                   "-b", "2", "--refine_steps", "2", "--device", "cpu"])
    rec = torch_bench_refine.main(["--artifact", path, "--device", "cpu"])
    assert _last_json(capsys)["artifact"] == path
    assert rec["entry"] == "register" and rec["refine_steps"] == 2
    assert rec["batch"] == 2
    assert _finite(rec["load_ms"], rec["first_call_ms"], rec["ms_per_call"])


def test_profile_refine_tool(capsys):
    rec = torch_profile_refine.main(_args("profile_refine", None)
                                    + ["--device", "cpu"])
    assert _last_json(capsys)["tool"] == "torch_profile_refine"
    names = [r["name"] for r in rec["rows"]]
    assert names == [
        "expand_pca fwd", "expand_pca fwd+vjp", "warp fwd",
        "warp fwd+grad(phi)", "ncc fwd+grad", "disp_reg fwd+grad",
        "phi = disp + idm", "refine total n=1", "refine total n=3"]
    assert _finite(*(r["ms"] for r in rec["rows"]),
                   rec["refine_per_step_ms"], rec["sum_of_parts_ms"])


def test_frontier_tool(capsys):
    rec = frontier.main(_args("frontier", None) + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "winner" in out and json.loads(out.strip().splitlines()[-1])
    kinds = [(r["kind"], r.get("latent"), r["size"]) for r in rec["rows"]]
    assert kinds == [("pca_expand", 56, SZ), ("pca_expand", 128, SZ),
                     ("pca_expand", 256, SZ), ("drr_project", None, SZ),
                     ("drr_backproject", None, SZ)]
    for r in rec["rows"]:
        assert r["max_abs_err"] == 0.0      # the plain version on the CPU
        assert _finite(r["kernel_ms"], r["library_ms"], r["plain_ms"],
                       r["bound_ms"], r["share_of_bound"])
        assert r["bound_by"] in ("bytes", "operations")


def test_frontier_refused_shape_is_reported(monkeypatch):
    """A kernel that refuses a shape leaves its row without a time and
    with the reason; the tool goes on."""
    def refuse(*a, **k):
        raise ValueError("pca_expand: too many coefficients")
    monkeypatch.setattr("liftreg_tpu_torch.ops.pca_kernel.pca_expand",
                        refuse)
    rows = frontier.bench_pca(torch.device("cpu"), 1, sz=8, latents=(4,))
    assert rows[0]["kernel_ms"] is None
    assert "too many" in rows[0]["refused"]
    assert _finite(rows[0]["library_ms"], rows[0]["plain_ms"])
    assert "refused" in frontier.decision_table(rows)


def test_stage0_tool(capsys):
    rec = torch_bench_stage0.main(_args("stage0", None) + ["--device", "cpu"])
    assert _last_json(capsys)["tool"] == "torch_bench_stage0"
    assert set(rec["ms"]) == {
        "cf_f32", "cf_bf16", "cl_f32", "cl_bf16", "cl_bf16_cpad8",
        "cl_bf16_cpad16", "kgrad_bf16", "stage1_cf_bf16_s2",
        "pair01_convblock_bf16", "pair01_convblock_bf16 grad",
        "pair01_s2d_bf16", "pair01_s2d_bf16 grad"}
    assert _finite(*rec["ms"].values(), *rec["bound_ms"].values())
    assert rec["kernels"] == {}          # no profiler rows on the CPU


def test_stage0_variants_agree():
    """The layout and padding variants compute the same stage."""
    fns = torch_bench_stage0.variants(2, 8, 5, 16, torch.device("cpu"))
    want = fns["cf_f32"]()
    torch.testing.assert_close(fns["cl_f32"](), want, rtol=1e-5, atol=1e-5)
    for name in ("cl_bf16", "cl_bf16_cpad8", "cl_bf16_cpad16"):
        torch.testing.assert_close(fns[name](), fns["cf_bf16"](), rtol=0.02,
                                   atol=0.02)


def test_ab_tool_serving(capsys):
    rec = torch_bench_ab.main(_args("ab", None) + ["--skip-train",
                                                   "--device", "cpu"])
    assert _last_json(capsys)["tool"] == "torch_bench_ab"
    assert set(rec["serving"]) == {"4", "8"} and "training" not in rec
    for per_b in rec["serving"].values():
        assert set(per_b) == {"s2d_off", "s2d_on"}
        for line in per_b.values():
            assert len(line["chunks_ms"]) == 2
            assert _finite(line["first_call_ms"], line["ms_per_call"],
                           line["reg_per_s"])


def test_ab_tool_training(capsys):
    """At 64^3, where the encoder's last stage is 2^3: torch's CPU bf16
    conv3d weight gradient of a 1^3 input with padding reads memory it
    never wrote (a 16^3 step's last stage gives NaN now and then; the
    card's cuDNN is not concerned)."""
    rec = torch_bench_ab.main(["--size", "64", "--train_iters", "1",
                               "--skip-serve", "--device", "cpu"])
    assert _last_json(capsys)["tool"] == "torch_bench_ab"
    assert set(rec["training"]) == {"s2d_off", "s2d_on"}
    for line in rec["training"].values():
        assert line["loss_finite"]
        assert _finite(line["first_step_ms"], line["ms_per_step"],
                       line["pairs_per_s"])


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_refuses_without_card(name, dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main(_args(name, dataset))


# -- the timed functions against the JAX tools' -----------------------------

def _rng_case(seed, B, latent=LATENT, sz=SZ):
    rng = np.random.default_rng(seed)
    K = 3 * sz ** 3
    return {"coefs": rng.standard_normal((B, latent)).astype(np.float32),
            "vectors": (rng.standard_normal((latent, K)) * 0.01).astype(
                np.float32),
            "mean": (rng.standard_normal(K) * 0.001).astype(np.float32),
            "moving": rng.uniform(-1, 1, (B, 1) + (sz,) * 3).astype(
                np.float32),
            "target": rng.uniform(-1, 1, (B, 1) + (sz,) * 3).astype(
                np.float32)}


@pytest.mark.parametrize("domain", ["image", "projection"])
def test_refine_tool_pipeline_matches_jax(domain):
    rng = np.random.default_rng(1)
    n = 3 * SZ ** 3
    V = (rng.standard_normal((LATENT, n)) * 0.01).astype(np.float32)
    mean = (rng.standard_normal(n) * 0.01).astype(np.float32)
    shape = (2, 1) + (SZ,) * 3
    src = rng.uniform(-1000, 0, shape).astype(np.float32)
    tgt = rng.uniform(-1000, 0, shape).astype(np.float32)
    seg = (rng.uniform(size=shape) > 0.4).astype(np.float32)
    jp = JPipeline((SZ,) * 3, latent_dim=LATENT, compute_dtype=jnp.bfloat16,
                   refine_steps=2, refine_domain=domain)
    jpca = {"vectors": jnp.asarray(V, jnp.bfloat16),
            "mean": jnp.asarray(mean)}
    params = jp.init_params(jax.random.PRNGKey(0), jpca)
    tp = torch_bench_refine.make_pipeline(2, domain, SZ, LATENT,
                                          torch.device("cpu"))
    tp.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tpca = {"vectors": torch.from_numpy(V).bfloat16(),
            "mean": torch.from_numpy(mean)}
    if domain == "projection":
        proj = rng.uniform(-1, 1, (2, 4) + tp.resolution).astype(np.float32)
        jw, jphi = jp.register_projections(params, jpca, src, proj, seg)
        tw, tphi = tp.register_projections(
            tpca, *map(torch.from_numpy, (src, proj, seg)))
    else:
        jw, jphi = jp.register(params, jpca, src, tgt, seg, seg)
        tw, tphi = tp.register(tpca, *map(torch.from_numpy,
                                          (src, tgt, seg, seg)))
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-2)


def _close_rel(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_profile_refine_parts_match_jax(dtype):
    c = _rng_case(2, 2)
    bf16 = dtype == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    img = (SZ,) * 3
    jpca = {"vectors": jnp.asarray(c["vectors"], jdt),
            "mean": jnp.asarray(c["mean"])}
    tpca = {"vectors": torch.from_numpy(c["vectors"]).to(tdt),
            "mean": torch.from_numpy(c["mean"])}
    taps_j = jnp.bfloat16 if bf16 else None
    taps_t = torch.bfloat16 if bf16 else None
    t = {k: torch.from_numpy(c[k]) for k in ("coefs", "moving", "target")}
    fns = torch_profile_refine.parts(t["coefs"], tpca, t["moving"],
                                     t["target"], img, taps_t)
    got = {k: fn() for k, fn in fns.items()}

    z, V, m = jnp.asarray(c["coefs"]), jpca["vectors"], jpca["mean"]
    mov, tgt = jnp.asarray(c["moving"]), jnp.asarray(c["target"])
    from liftreg_tpu.coords import identity_map
    idm = identity_map(img)
    disp = expand_pca(z, V, m, img)
    phi = disp + idm[None]

    def warp(p):
        return jresample.warp_image(mov, p, zero_boundary=True,
                                    scale_intensity=True, taps_dtype=taps_j)
    warped = warp(phi)
    want = {
        "expand_pca fwd": disp,
        "expand_pca fwd+vjp": jax.grad(
            lambda z: jnp.sum(expand_pca(z, V, m, img) ** 2))(z),
        "warp fwd": warped,
        "warp fwd+grad(phi)": jax.grad(lambda p: jnp.sum(warp(p)))(phi),
        "ncc fwd+grad": jax.grad(lambda w: jnp.mean(
            ncc_loss(w, tgt, reduction="none")))(warped),
        "disp_reg fwd+grad": jax.grad(lambda d: jnp.mean(
            displacement_reg(d, reduction="none")))(disp),
        "phi = disp + idm": phi,
    }
    assert set(got) == set(want)
    w = {k: np.asarray(v) for k, v in want.items()}
    g = {k: v.detach().numpy() for k, v in got.items()}
    np.testing.assert_allclose(g["expand_pca fwd"], w["expand_pca fwd"],
                               atol=1e-5, rtol=1e-5)
    if bf16:
        np.testing.assert_allclose(
            g["expand_pca fwd+vjp"], w["expand_pca fwd+vjp"], rtol=2 ** -8,
            atol=1e-4 * np.abs(w["expand_pca fwd+vjp"]).max())
    else:
        np.testing.assert_allclose(g["expand_pca fwd+vjp"],
                                   w["expand_pca fwd+vjp"], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(g["warp fwd"], w["warp fwd"], rtol=0,
                               atol=2e-6 if bf16 else 2e-5)
    _close_rel(g["warp fwd+grad(phi)"], w["warp fwd+grad(phi)"], 2e-5)
    for key in ("ncc fwd+grad", "disp_reg fwd+grad"):
        np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(g["phi = disp + idm"], w["phi = disp + idm"],
                               rtol=0, atol=1e-6)

    # one refinement step, as the tool's refiner of n_steps=1 takes it
    ref = torch_profile_refine.refiners(img, taps_t)[1](
        t["coefs"], tpca, t["moving"], t["target"])
    jref = jmake_refiner(img, sim="ncc", n_steps=1, lr=0.05, reg_factor=1e-3,
                         warp_taps_dtype=taps_j)(z, jpca, mov, tgt)
    np.testing.assert_allclose(ref["coefs"].numpy(),
                               np.asarray(jref["coefs"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ref["phi"].numpy(), np.asarray(jref["phi"]),
                               rtol=0, atol=1e-4)


def test_frontier_plain_versions_match_jax():
    c = _rng_case(3, 4, latent=8)
    z = jnp.asarray(c["coefs"])
    V16 = jnp.asarray(c["vectors"], jnp.bfloat16)
    m = jnp.asarray(c["mean"])
    want = jnp.dot(z.astype(jnp.bfloat16), V16,
                   preferred_element_type=jnp.float32) + m
    got = pca_expand_plain(torch.from_numpy(c["coefs"]),
                           torch.from_numpy(c["vectors"]).bfloat16(),
                           torch.from_numpy(c["mean"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)

    rng = np.random.default_rng(4)
    for sz in (SZ, 20):
        shape = (sz, sz, sz)
        res = tdrr.default_resolution(shape)
        poses = tdrr.synthesize_poses(30.0, 4, sz)
        vol = (rng.uniform(size=(1,) + shape) * 0.2).astype(np.float32)
        proj = (rng.uniform(size=(1, 4) + res) * 6).astype(np.float32)
        Rx, Rz, dx = jdrr.forward_matrices(jnp.asarray(poses), shape, res,
                                           (2.2, 2.2, 2.2))
        want = jdrr.project_with_mats(jnp.asarray(vol), Rx, Rz, dx)
        tposes = torch.from_numpy(poses)
        got = project_taps_plain(torch.from_numpy(vol), *tdrr.forward_geometry(
            tposes, shape, res, (2.2, 2.2, 2.2)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        Bu, Bv = jdrr.backward_matrices(jnp.asarray(poses), shape, res)
        want = jdrr.backproject_with_mats(jnp.asarray(proj), Bu, Bv)
        got = backproject_taps_plain(torch.from_numpy(proj),
                                     *tdrr.backward_geometry(tposes, shape,
                                                             res))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
