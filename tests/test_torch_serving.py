"""The port's serving artifacts (``liftreg_tpu_torch/serving.py`` and its
tools) on the CPU, at tests/test_serving_export.py's size (16^3, latent 8,
B = 2), in f32 and in the bf16 config.

* A port artifact (v1 and v2, both entries) served through
  ``ServingModel`` is bit-equal to the live port pipeline, and a batch of
  one, padded, equals the full batch's first row.
* The exported graph calls the kernels as ``liftreg::`` operators: a
  ``ctypes`` launch inside traced code would export here, where only the
  plain versions run, and break on the card.
* Against the JAX package's ``ServingModel`` on a JAX artifact exported for
  ("cpu",), the port artifact that ``tools/torch_convert_artifact.py`` makes
  of it serves within tests/test_torch_pipeline.py's tolerances (f32: phi
  1e-5, warped 1e-4; bf16: phi 5e-5, warped 5e-3), and with 5 refinement
  steps within tests/test_torch_refine.py's (phi 1e-4, warped 1e-3).
* Each package reads the other's files, v1 and v2, bf16 included, and the
  port reads bf16 without ``ml_dtypes``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from liftreg_tpu import serving as jserving
from liftreg_tpu.pipeline import RegistrationPipeline as JPipeline
from liftreg_tpu_torch import RegistrationPipeline
from liftreg_tpu_torch import serving
from liftreg_tpu_torch.ops._library import op_names
from liftreg_tpu_torch.ops.drr_kernel import project
from liftreg_tpu_torch.ops import drr
from liftreg_tpu_torch.utils.msgpack_codec import pack, read_msgpack

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_convert_artifact  # noqa: E402
import torch_export_serving  # noqa: E402
import torch_serve_batch  # noqa: E402

SZ, L, B = 16, 8, 2
IMG = (SZ,) * 3
TOL = {"f32": {"phi": 1e-5, "warped": 1e-4},
       "bf16": {"phi": 5e-5, "warped": 5e-3}}
REFINE_TOL = {"phi": 1e-4, "warped": 1e-3}
KERNEL_OPS = {"liftreg::project", "liftreg::encoder_input",
              "liftreg::pca_expand", "liftreg::warp_trilinear"}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    vols = [rng.uniform(-1000, 0, (B, 1) + IMG).astype(np.float32)
            for _ in range(2)]
    seg = (rng.uniform(size=(B, 1) + IMG) > 0.4).astype(np.float32)
    return vols[0], vols[1], seg


def _basis(seed=0):
    rng = np.random.default_rng(seed)
    n = 3 * SZ ** 3
    return ((rng.standard_normal((L, n)) * 0.01).astype(np.float32),
            (rng.standard_normal(n) * 0.01).astype(np.float32))


def _port_pipe(dtype, **kw):
    torch.manual_seed(0)
    pipe = RegistrationPipeline(IMG, latent_dim=L, device="cpu",
                                compute_dtype=torch.bfloat16
                                if dtype == "bf16" else None, **kw)
    V, mean = _basis()
    pca = {"vectors": torch.from_numpy(V).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32),
        "mean": torch.from_numpy(mean)}
    return pipe, pca


def _entry_args(pipe, entry, src, tgt, seg):
    if entry == "register":
        return src, tgt, seg, seg
    proj = drr.normalize_drr(project(
        drr.calc_relative_atten_coef(tgt[:, 0]), pipe.poses,
        pipe.resolution, pipe.spacing))
    return src, proj, seg


@pytest.fixture(scope="module")
def port_artifacts(tmp_path_factory):
    """{(dtype, format, entry): (pipe, pca, path)}, made on first use."""
    root = tmp_path_factory.mktemp("port_serving")
    cache = {}

    def get(dtype, fmt, entry):
        key = (dtype, fmt, entry)
        if key not in cache:
            pipe, pca = _port_pipe(dtype)
            path = str(root / f"{dtype}_v{fmt}_{entry}.liftreg")
            serving.export_serving(pipe, pca, B, path, entry=entry,
                                   artifact_format=fmt)
            cache[key] = (pipe, pca, path)
        return cache[key]
    return get


@pytest.mark.parametrize("entry", serving.ENTRIES)
@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_artifact_bit_equal_to_live_pipeline(port_artifacts, dtype, fmt,
                                             entry):
    pipe, pca, path = port_artifacts(dtype, fmt, entry)
    args = _entry_args(pipe, entry, *map(torch.from_numpy, _inputs()))
    srv = serving.ServingModel.load(path, device="cpu")
    live = getattr(pipe, entry)(pca, *args)
    got = getattr(srv, entry)(*args)
    for a, b in zip(got, live):
        assert torch.equal(a, b)
    # a partial batch is padded with its last row and sliced back
    one = getattr(srv, entry)(*(a[:1] for a in args))
    for a, b in zip(one, got):
        assert a.shape[0] == 1 and torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="outside"):
        getattr(srv, entry)(*(torch.cat([a, a]) for a in args))


@pytest.mark.parametrize("entry", serving.ENTRIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exported_graph_calls_the_kernel_ops(port_artifacts, dtype, entry):
    """The program calls the projector (register only), the lift into the
    encoder's input, the PCA expansion (bf16 basis; an f32 basis is an f32
    matmul) and the warp as ``liftreg::`` operators, read back from the
    saved program."""
    _, _, path = port_artifacts(dtype, 2, entry)
    import io
    program = torch.export.load(io.BytesIO(
        serving.read_artifact(path)["exported"]))
    want = set(KERNEL_OPS)
    if entry == "register_projections":
        want.discard("liftreg::project")
    if dtype == "f32":
        want.discard("liftreg::pca_expand")
    assert op_names(program.graph_module) == want
    sig = program.graph_signature
    assert all(s.kind.name == "USER_INPUT" for s in sig.input_specs)
    assert not program.state_dict and not program.constants


def test_bf16_read_without_ml_dtypes(tmp_path):
    """With ``ml_dtypes`` blocked, so that ``np.dtype("bfloat16")`` fails,
    the port reads a flax msgpack file and a JAX v2 artifact holding bf16
    arrays: the bits equal what JAX wrote."""
    leaf = (np.random.default_rng(0).standard_normal((3, 5)) * 7
            ).astype(jnp.bfloat16)
    ckpt = tmp_path / "state.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(
        {"a": {"w": leaf}, "s": np.float32(2.5)}))
    jp = JPipeline(IMG, latent_dim=L)
    V, mean = _basis()
    jpca = {"vectors": jnp.asarray(V, jnp.bfloat16),
            "mean": jnp.asarray(mean)}
    art = str(tmp_path / "jax.liftreg")
    jserving.export_serving(jp, jp.init_params(jax.random.PRNGKey(0), jpca),
                            jpca, B, art, platforms=("cpu",))
    script = f"""
import sys
sys.modules["ml_dtypes"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np
try:
    np.dtype("bfloat16")
    raise SystemExit("numpy knows bfloat16")
except TypeError:
    pass
import torch
from liftreg_tpu_torch.utils.checkpoint import read_msgpack
from liftreg_tpu_torch.serving import read_artifact
state = read_msgpack(open({str(ckpt)!r}, "rb").read())
w = state["a"]["w"]
assert w.dtype == torch.bfloat16 and float(state["s"]) == 2.5
vec = read_artifact({art!r})["pca"]["vectors"]
assert vec.dtype == torch.bfloat16
np.save({str(tmp_path / "w.npy")!r}, w.view(torch.int16).numpy())
np.save({str(tmp_path / "v.npy")!r}, vec.view(torch.int16).numpy())
assert "ml_dtypes" not in [m for m, v in sys.modules.items() if v]
"""
    subprocess.run([sys.executable, "-c", script], check=True, timeout=120,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    np.testing.assert_array_equal(np.load(tmp_path / "w.npy"),
                                  leaf.view(np.int16))
    np.testing.assert_array_equal(
        np.load(tmp_path / "v.npy"),
        np.asarray(jpca["vectors"]).view(np.int16))


def _bits(x):
    """Array bits for comparing bf16 (ml_dtypes or torch) and others."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(a, b):
    fa = serving.flat(a)
    fb = serving.flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]))


@pytest.mark.parametrize("fmt", [1, 2])
def test_jax_reader_reads_port_artifacts(port_artifacts, fmt):
    _, _, path = port_artifacts("bf16", fmt, "register")
    theirs = jserving.read_artifact(path)
    ours = serving.read_artifact(path)
    assert theirs["version"] == ours["version"] == fmt
    assert set(theirs["meta"]) == set(ours["meta"])
    assert theirs["meta"]["batch_size"] == B
    for group in serving.GROUPS:
        _assert_trees_equal(theirs[group], ours[group])
    assert ours["pca"]["vectors"].dtype == torch.bfloat16
    assert bytes(theirs["exported"]) == ours["exported"]


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """JAX pipelines and artifacts of both entries and configs, made on
    first use: {(dtype, entry, fmt): (path, params, pca)}."""
    root = tmp_path_factory.mktemp("jax_serving")
    cache = {}

    def get(dtype, entry, fmt=2):
        key = (dtype, entry, fmt)
        if key not in cache:
            jp = JPipeline(IMG, latent_dim=L,
                           compute_dtype=jnp.bfloat16 if dtype == "bf16"
                           else None)
            V, mean = _basis()
            jpca = {"vectors": jnp.asarray(
                V, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
                "mean": jnp.asarray(mean)}
            params = jp.init_params(jax.random.PRNGKey(1), jpca)
            path = str(root / f"{dtype}_{entry}_v{fmt}.liftreg")
            jserving.export_serving(jp, params, jpca, B, path,
                                    platforms=("cpu",), entry=entry,
                                    artifact_format=fmt)
            cache[key] = (path, jp)
        return cache[key]
    return get


@pytest.mark.parametrize("fmt", [1, 2])
def test_port_reader_reads_jax_artifacts(jax_case, fmt):
    path, _ = jax_case("bf16", "register", fmt)
    theirs = jserving.read_artifact(path)
    ours = serving.read_artifact(path)
    assert ours["version"] == fmt
    assert ours["meta"] == theirs["meta"]
    for group in ("params", "pca"):
        _assert_trees_equal(theirs[group], ours[group])
    assert ours["pca"]["vectors"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="torch_convert_artifact"):
        serving.ServingModel.load(path, device="cpu")


def _convert(src, dst, *extra):
    return torch_convert_artifact.main([src, dst, "--device", "cpu",
                                        *extra])


def _check(got, want, tol):
    (tw, tphi), (jw, jphi) = got, want
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi),
                               atol=tol["phi"], rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               atol=tol["warped"], rtol=0)


@pytest.mark.parametrize("entry", serving.ENTRIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_converted_jax_artifact_serves_as_jax(jax_case, tmp_path, dtype,
                                              entry):
    path, jp = jax_case(dtype, entry)
    port_path = _convert(path, str(tmp_path / "port.liftreg"))
    ours = serving.ServingModel.load(port_path, device="cpu")
    theirs = jserving.ServingModel.load(path)
    src, tgt, seg = _inputs(1)
    if entry == "register":
        args = (src, tgt, seg, seg)
    else:
        args = (src, np.array(jax.numpy.asarray(
            np.random.default_rng(5).uniform(-1, 1, (B, 4) + jp.resolution),
            jnp.float32)), seg)
    want = getattr(theirs, entry)(*args)
    _check(getattr(ours, entry)(*map(torch.from_numpy, args)), want,
           TOL[dtype])
    # and a batch of one, padded on each side
    want1 = getattr(theirs, entry)(*(a[:1] for a in args))
    _check(getattr(ours, entry)(*(torch.from_numpy(a[:1]) for a in args)),
           want1, TOL[dtype])


@pytest.mark.parametrize("domain,entry", [
    pytest.param("image", "register", id="image"),
    pytest.param("projection", "register_projections", id="projection"),
    pytest.param("projection", "register", id="projection-register")])
def test_refined_serving_matches_jax_and_live(tmp_path, domain, entry):
    """refine_steps=5: the JAX artifact (its refinement inside the
    program) against the converted port artifact (the port's refiner
    rebuilt from meta), and the port artifact against the live refined
    port pipeline, bit for bit. The image domain through ``register``, the
    projection domain through both entries. The converter refuses without
    the refinement's settings, and for ``register``, whose artifact does
    not say which domain it refines in, without ``--refine_domain``."""
    from test_torch_projection_refine import _pipeline_case
    jp, params, jpca, tp, tpca, (src, tgt, seg, _) = _pipeline_case(
        5, refine_lr=0.005, refine_domain=domain)
    path = str(tmp_path / "jax.liftreg")
    jserving.export_serving(jp, params, jpca, B, path, platforms=("cpu",),
                            entry=entry)
    settings = ("--refine_lr", "0.005", "--refine_sim", "ncc",
                "--refine_reg_factor", "1e-3")
    with pytest.raises(SystemExit, match="refine_lr"):
        _convert(path, str(tmp_path / "refused.liftreg"))
    if entry == "register":
        with pytest.raises(SystemExit, match="refine_domain"):
            _convert(path, str(tmp_path / "refused.liftreg"), *settings)
        settings += ("--refine_domain", domain)
    port_path = _convert(path, str(tmp_path / "port.liftreg"), *settings)
    meta = serving.read_artifact(port_path)["meta"]
    assert meta["refine_steps"] == 5 and meta["refine_domain"] == domain
    ours = serving.ServingModel.load(port_path, device="cpu")
    if entry == "register":
        args = (src, tgt, seg, seg)
    else:
        args = (src, _jax_target_proj(jp, tgt), seg)
    want = getattr(jserving.ServingModel.load(path), entry)(*args)
    targs = tuple(map(torch.from_numpy, args))
    got = getattr(ours, entry)(*targs)
    _check(got, want, REFINE_TOL)
    hist = ours.last_refine["total_history"]
    assert hist.shape == (6,) and bool(hist[-1] <= hist[0])
    # the live port pipeline with the converted weights: the same bits
    tp.model.load_state_dict(
        serving.flat(serving.read_artifact(port_path)["params"]))
    live = getattr(tp, entry)(tpca, *targs)
    for a, b in zip(got, live):
        assert torch.equal(a, b)


def _jax_target_proj(jp, tgt):
    from liftreg_tpu.ops import drr as jdrr
    return np.array(jdrr.normalize_drr(jdrr.project(
        jdrr.calc_relative_atten_coef(jnp.asarray(tgt))[:, 0], jp.poses,
        jp.resolution, jp.spacing)))


def test_convert_round_trip(port_artifacts, tmp_path):
    """v2 -> v1 -> v2 carries the program's bytes and every array
    verbatim, and the result serves as the original."""
    pipe, pca, path = port_artifacts("bf16", 2, "register")
    v1 = _convert(path, str(tmp_path / "v1.liftreg"), "--to", "1")
    v2 = _convert(v1, str(tmp_path / "v2.liftreg"), "--to", "2")
    a, b, c = (serving.read_artifact(p) for p in (path, v1, v2))
    assert (a["version"], b["version"], c["version"]) == (2, 1, 2)
    assert a["exported"] == b["exported"] == c["exported"]
    assert a["meta"] == b["meta"] == c["meta"]
    for group in serving.GROUPS:
        _assert_trees_equal(a[group], b[group])
        _assert_trees_equal(a[group], c[group])
    assert Path(path).read_bytes() == Path(v2).read_bytes()
    args = tuple(map(torch.from_numpy, _inputs()))
    args = args + args[2:]
    for x, y in zip(serving.ServingModel.load(v1, device="cpu").register(
            *args), pipe.register(pca, *args)):
        assert torch.equal(x, y)


def _write_cases(root, ids, entry, pipe):
    src, tgt, seg = _inputs(2)
    rng = np.random.default_rng(7)
    vols = {"source": rng.uniform(-1000, 0, (len(ids),) + IMG),
            "target": rng.uniform(-1000, 0, (len(ids),) + IMG)}
    os.makedirs(root, exist_ok=True)
    for k, cid in enumerate(ids):
        np.save(os.path.join(root, f"{cid}_source.npy"),
                vols["source"][k].astype(np.float32))
        if entry == "register":
            np.save(os.path.join(root, f"{cid}_target.npy"),
                    vols["target"][k].astype(np.float32))
        else:
            proj = _entry_args(pipe, entry, None, torch.from_numpy(
                vols["target"][k:k + 1, None].astype(np.float32)), None)[1]
            np.save(os.path.join(root, f"{cid}_target_proj.npy"),
                    proj[0].numpy())
        if k != 1:      # one case without masks: all ones
            np.save(os.path.join(root, f"{cid}_source_seg.npy"),
                    (rng.uniform(size=IMG) > 0.3).astype(np.float32))
    return vols


@pytest.mark.parametrize("entry", serving.ENTRIES)
def test_serve_batch_tool(port_artifacts, tmp_path, entry):
    """3 cases with a B = 2 artifact (one full batch, one partial): the
    tool's outputs equal ServingModel's, phi rescaled to [0, 1]."""
    pipe, _, path = port_artifacts("f32", 2, entry)
    ids = ["c0", "c1", "c2"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    _write_cases(inp, ids, entry, pipe)
    assert torch_serve_batch.main(["-a", path, "-i", inp, "-o", out,
                                   "--device", "cpu"]) == 0
    srv = serving.ServingModel.load(path, device="cpu")
    for cid in ids:
        src = np.load(os.path.join(inp, f"{cid}_source.npy"))[None, None]
        seg_path = os.path.join(inp, f"{cid}_source_seg.npy")
        seg = np.load(seg_path)[None, None] if os.path.exists(seg_path) \
            else np.ones_like(src)
        if entry == "register":
            tgt = np.load(os.path.join(inp, f"{cid}_target.npy"))[None, None]
            warped, phi = srv.register(src, tgt, seg, np.ones_like(src))
        else:
            proj = np.load(os.path.join(inp, f"{cid}_target_proj.npy"))[None]
            warped, phi = srv.register_projections(src, proj, seg)
        got_phi = np.load(os.path.join(out, f"{cid}_phi.npy"))
        np.testing.assert_array_equal(
            np.load(os.path.join(out, f"{cid}_warped.npy")),
            warped[0].numpy())
        np.testing.assert_array_equal(got_phi,
                                      ((phi + 1.0) / 2.0)[0].numpy())
        # [-1, 1] (the volume; random weights reach a little past it at
        # the faces) onto [0, 1]
        inside = ((phi >= -1.0) & (phi <= 1.0))[0].numpy()
        np.testing.assert_array_equal((got_phi >= 0.0) & (got_phi <= 1.0),
                                      inside)
        assert inside.mean() > 0.9


def test_export_tool_demo_and_meta(tmp_path):
    path = torch_export_serving.main(
        ["--demo", "16", "-o", str(tmp_path / "demo.liftreg"), "-b", "2",
         "--device", "cpu", "--refine_steps", "2", "--entry",
         "projections", "--format", "1"])
    payload = serving.read_artifact(path)
    meta = payload["meta"]
    assert payload["version"] == 1
    assert meta["entry"] == "register_projections"
    assert meta["refine_domain"] == "projection"
    assert meta["device"] == "cpu" and meta["program"] == serving.PROGRAM
    for key in ("scan_range_deg", "spacing", "mask_ct", "warp_taps_dtype",
                "refine_lr", "refine_sim", "refine_sim_opts",
                "refine_reg_factor", "refine_early_stop_patience",
                "refine_early_stop_tol", "img_sz", "batch_size",
                "latent_dim", "n_proj", "resolution", "platforms",
                "compute_dtype", "refine_steps"):
        assert key in meta, key
    # the program's bytes hold no weights
    weights = sum(t.numel() * t.element_size()
                  for t in serving.flat(payload["params"]).values())
    assert len(payload["exported"]) < weights
    srv = serving.ServingModel.load(path, device="cpu")
    src, tgt, seg = map(torch.from_numpy, _inputs())
    proj = _entry_args(RegistrationPipeline(IMG, latent_dim=8, device="cpu"),
                       "register_projections", src, tgt, seg)[1]
    warped, phi = srv.register_projections(src, proj, seg)
    assert warped.shape == (B, 1) + IMG and torch.isfinite(phi).all()
    with pytest.raises(ValueError, match="register_projections"):
        srv.register(src, tgt)


def test_export_guards(port_artifacts, tmp_path):
    pipe, pca = _port_pipe("f32")
    out = str(tmp_path / "x.liftreg")
    with pytest.raises(ValueError, match="entry"):
        serving.export_serving(pipe, pca, B, out, entry="nope")
    with pytest.raises(ValueError, match="artifact_format"):
        serving.export_serving(pipe, pca, B, out, artifact_format=3)
    refining, _ = _port_pipe("f32", refine_steps=2)
    with pytest.raises(ValueError, match="refine_domain='projection'"):
        serving.export_serving(refining, pca, B, out,
                               entry="register_projections")
    assert not os.path.exists(out)
    _, _, path = port_artifacts("f32", 2, "register")
    srv = serving.ServingModel.load(path, device="cpu")
    src, tgt, seg = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="register"):
        srv.register_projections(src, tgt[:, :1, :, 0], seg)
    with pytest.raises(ValueError, match="shape"):
        srv.register(src, tgt[..., :8])
    # no masks: all ones
    for a, b in zip(srv.register(src, tgt),
                    srv.register(src, tgt, torch.ones_like(src),
                                 torch.ones_like(src))):
        assert torch.equal(a, b)
    # a v2 header whose version field is not 2 (the same length: every
    # section offset stays valid)
    raw = bytearray(Path(path).read_bytes())
    start = len(b"LIFTREGv2\0")
    hlen = int.from_bytes(raw[start:start + 8], "little")
    header = read_msgpack(bytes(raw[start + 8:start + 8 + hlen]))
    header["version"] = 99
    new = pack(header)
    assert len(new) == hlen
    raw[start + 8:start + 8 + hlen] = new
    bad = tmp_path / "bad.liftreg"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="version"):
        serving.read_artifact(str(bad))
    assert json.loads(json.dumps(srv.meta))["batch_size"] == B


def test_program_of_another_device_type_is_moved(port_artifacts, tmp_path):
    """A program recorded as exported on another device type goes through
    ``move_to_device_pass`` at load (on the CPU the move is to the CPU, so
    the served outputs stay bit-equal); on the card ``chip_smoke.py``
    serves a CPU-exported program there."""
    pipe, pca, path = port_artifacts("f32", 2, "register")
    payload = serving.read_artifact(path)
    payload["meta"] = dict(payload["meta"], device="cuda")
    moved_path = serving.write_artifact(payload, str(tmp_path / "m.liftreg"))
    srv = serving.ServingModel.load(moved_path, device="cpu")
    args = tuple(map(torch.from_numpy, _inputs()))
    args = args + args[2:]
    for a, b in zip(srv.register(*args), pipe.register(pca, *args)):
        assert torch.equal(a, b)
