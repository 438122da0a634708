"""The port's data mesh (``liftreg_tpu_torch/parallel``) against the JAX
package's on the CPU: ``shard_batch``'s rows against JAX's
``addressable_shards``, and one train step of LiftRegSubspaceBackproj at
16^3 on 2 and 3 gloo ranks (``parallel.launch``), with global batches of
3 and 5 rows padded to a multiple of the ranks, against liftreg_tpu's
loss and gradients on a ``make_mesh(n)`` of the same size (the conftest's
8 CPU devices), and against the port's own step in one process on the
same padded batch. Also: batch norm's statistics (ResBlock2D, the JAX
legacy block with batch norm; RegNet2D3D has none) at B = 3 on 2 ranks
against JAX on a 2-mesh; ``Mesh.extremes`` with ties across the ranks
against ``jnp.min``/``max``; RegNet2D3D's step on 2 ranks (its min-max
normalisation over the global batch, pad row included) against
liftreg_tpu's RegNet2D3D on a make_mesh(2) from the same flax parameters
and against the port in one process;
the collective bytes of a step; and the negative controls (gradients
averaged over the ranks instead of summed, pad rows weighted 1).

Tolerances. Against the port in one process on the same padded batch
(the same sums split across the ranks): losses rel 1e-5, gradients rtol
2e-4 and atol 1e-6, as tests/test_parallel.py holds the JAX mesh to one
device. Against JAX: losses rel 1e-5; gradients rtol 2e-4 and atol 1e-6,
and also within 1e-3 of each leaf's largest value, as
tests/test_torch_subspace_model.py holds the port's gradients to JAX's
in one process (an atol of 1e-6 exceeds the whole of some leaves here;
measured at 2 ranks, B = 3: every leaf within 3e-6 of its largest
value). Batch norm as tests/test_torch_blocks.py: 1e-5 of the
largest value plus 1e-5 relative; the gradients 1e-4 relative plus 1e-5
of the block's largest gradient (a convolution's bias before batch norm
has a gradient of 0 up to rounding). RegNet2D3D's re-projections atol
1e-5, as tests/test_torch_regnet.py's forward: its loss's NCC is
invariant to a positive affine map of each row, so the losses and
gradients cannot see the min-max's extremes, and the re-projections are
what shows them (each rank's own extremes move them by 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liftreg_tpu.losses import registration as jreg
from liftreg_tpu.models import LiftRegSubspaceBackproj as JModel
from liftreg_tpu.models import RegNet2D3D as JRegNet
from liftreg_tpu.models import legacy_blocks as jlegacy
from liftreg_tpu.parallel import mesh as jmesh
from liftreg_tpu_torch import params_from_jax
from liftreg_tpu_torch.parallel import Mesh, launch, make_mesh, pad_batch
from liftreg_tpu_torch.parallel import shard_batch
from liftreg_tpu_torch.models.legacy_blocks import ResBlock2D

import torch_parallel_ranks as ranks
from test_torch_blocks import _last, _variables
from test_torch_regnet import _jax_params

SZ, P, L = (16, 16, 16), 2, 4
CASES = [(2, 3), (2, 5), (3, 3), (3, 5)]     # (ranks, global batch)
LOSS_REL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
JAX_GRAD_SHARE = 1e-3
REGNET_PROJ_ATOL = 1e-5


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    seg = (rng.uniform(size=(b, 1) + SZ) > 0.3).astype(np.float32)
    poses = np.array([[-8.0, 56.0, -3.0], [8.0, 56.0, 3.0]], np.float32)
    return {
        "source": rng.uniform(-1, 1, (b, 1) + SZ).astype(np.float32),
        "target": rng.uniform(-1, 1, (b, 1) + SZ).astype(np.float32),
        "target_proj": rng.uniform(-1, 1, (b, P, 24, 24)).astype(np.float32),
        "target_poses": np.repeat(poses[None], b, 0),
        "spacing": np.full((b, 3), 2.2, np.float32),
        "source_label": seg, "target_label": seg[::-1].copy(),
    }


def _pca():
    rng = np.random.default_rng(1)
    n = 3 * int(np.prod(SZ))
    return {"vectors": (rng.standard_normal((L, n)) * 0.02).astype(
        np.float32), "mean": (rng.standard_normal(n) * 0.01).astype(
        np.float32)}


@pytest.fixture(scope="module")
def flax_params():
    batch = {k: jnp.asarray(v[:1]) for k, v in _batch(1, 0).items()}
    pca = {k: jnp.asarray(v) for k, v in _pca().items()}
    params = jax.jit(JModel(SZ, latent_dim=L, drr_feature_num=P).init)(
        jax.random.PRNGKey(0), batch, pca)
    return jax.tree_util.tree_map(np.asarray, params)


def _case(n, b, flax_params):
    target_b = -(-b // n) * n
    batch, n_valid = pad_batch(_batch(b, 10 + b), target_b)
    return {"sz": SZ, "latent": L, "views": P, "batch": batch,
            "n_valid": n_valid, "pca": _pca(),
            "state": {k: v.numpy() for k, v in
                      params_from_jax(flax_params).items()}}


def _bn_case():
    """ResBlock2D's input at B = 3 padded to 4 rows, its flax variables
    (batch-norm parameters and statistics drawn at random) and a
    cotangent that is 0 on the pad row."""
    x = np.random.default_rng(21).normal(size=(3, 3, 8, 8)).astype(
        np.float32)
    x, _ = pad_batch({"x": x}, 4)
    x = x["x"]
    cot = np.random.default_rng(22).normal(size=(4, 4, 4, 4)).astype(
        np.float32)
    cot[3:] = 0.0
    variables = _variables(jlegacy.ResBlock2D(4), _last(x), 7)
    state = {k: v.numpy() for k, v in params_from_jax(
        variables, ResBlock2D(3, 4)).items()}
    return {"bn_x": x, "bn_cot": cot, "bn_features": 4,
            "bn_state": state, "variables": variables}


def _extremes_input():
    """(4, 5) values with the minimum tied on both ranks' rows and the
    maximum tied within rank 1's."""
    x = np.random.default_rng(23).uniform(-1, 1, (4, 5)).astype(np.float32)
    x[0, 1] = x[3, 2] = x[3, 4] = -2.0
    x[2, 0] = x[3, 3] = 3.0
    return x


def _regnet_case():
    """RegNet2D3D's padded B = 3 batch and its flax parameters (the flow
    head scaled as tests/test_torch_regnet.py scales it, so that the warps
    move voxels), carried to the port."""
    rng = np.random.default_rng(24)
    batch, n_valid = pad_batch(_batch(3, 25), 4)
    batch["original_source"] = rng.uniform(0, 0.2, batch["source"].shape
                                           ).astype(np.float32)
    flax = jax.tree_util.tree_map(np.asarray, _jax_params(
        JRegNet(img_sz=SZ, drr_feature_num=P, **ranks.REGNET_WIDTHS),
        {k: jnp.asarray(v[:1]) for k, v in batch.items()}, 3))
    return {"sz": SZ, "views": P, "batch": batch, "n_valid": n_valid,
            "flax": flax, "state": {k: v.numpy() for k, v in
                                    params_from_jax(flax).items()}}


@pytest.fixture(scope="module")
def runs(flax_params):
    """The rank results of each case, from one launch per mesh size."""
    bn = _bn_case()
    controls = {"step": _case(2, 3, flax_params), "extremes":
                _extremes_input(), "regnet": _regnet_case(),
                **{k: v for k, v in bn.items() if k != "variables"}}
    out = {}
    for n in (2, 3):
        cases = [_case(n, b, flax_params) for m, b in CASES if m == n]
        res = launch(ranks.step_suite, n, device="cpu",
                     args=(cases, controls if n == 2 else None))
        for (m, b), k in zip([c for c in CASES if c[0] == n],
                             range(len(cases))):
            out[(m, b)] = {"case": cases[k],
                           "ranks": [r["steps"][k] for r in res]}
        if n == 2:
            out["controls"] = [{k: v for k, v in r.items() if k != "steps"}
                               for r in res]
    out["bn"] = bn
    out["controls_input"] = controls
    return out


def _jax_step(case, n, regnet=False):
    """liftreg_tpu's weighted loss and gradients of the padded batch, sharded
    over a make_mesh(n), as its trainer's step computes them: of
    LiftRegSubspaceBackproj, or with ``regnet`` of RegNet2D3D."""
    mesh = jmesh.make_mesh(n)
    if regnet:
        model = JRegNet(img_sz=SZ, drr_feature_num=P, mesh=mesh,
                        **ranks.REGNET_WIDTHS)
        loss = jreg.RegNet2D3DLoss(ranks.LOSS_OPT)
    else:
        model = JModel(SZ, latent_dim=L, drr_feature_num=P, mesh=mesh)
        loss = jreg.SubspaceLoss(ranks.LOSS_OPT)
    target_b = case["batch"]["source"].shape[0]
    rep = jmesh.replicated(mesh)

    def fn(p, batch, pca, w):
        losses = loss(model.apply(p, batch, pca), ranks.REG_FACTOR,
                      weights=w)
        return losses["total_loss"], losses

    params = jax.device_put(jax.tree_util.tree_map(
        jnp.asarray, case["flax"]), rep)
    pca = None if regnet else jax.device_put(
        {k: jnp.asarray(v) for k, v in case["pca"].items()}, rep)
    w = (jnp.arange(target_b) < case["n_valid"]).astype(jnp.float32)
    batch = jmesh.shard_batch(case["batch"], mesh)
    (_, losses), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, batch, pca, w)
    if regnet:
        out = jax.jit(model.apply)(params, batch, pca)
        case["jax_projections"] = {k: np.asarray(out[k])
                                   for k in ranks.REGNET_PROJECTIONS}
    return ({k: float(v) for k, v in losses.items()},
            {k: v.numpy() for k, v in params_from_jax(
                jax.tree_util.tree_map(np.asarray, g)).items()})


@pytest.fixture(scope="module")
def jax_steps(runs, flax_params):
    out = {}
    for n, b in CASES:
        out[(n, b)] = _jax_step(dict(runs[(n, b)]["case"], flax=flax_params),
                                n)
    return out


def _grads_close(got, want, share=None):
    for k, w in want.items():
        if share is None:
            np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=share * np.abs(w).max(),
                                       err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
def test_shard_batch_rows_match_jax(n):
    """Each rank's rows of the padded batch are the JAX mesh's device
    shards; poses and spacing (and arrays whose rows do not divide the
    mesh) are whole on every rank."""
    batch, n_valid = pad_batch(_batch(5, 1), -(-5 // n) * n)
    assert n_valid == 5
    batch["shared"] = np.arange(7, dtype=np.float32)
    sharded = jmesh.shard_batch(batch, jmesh.make_mesh(n))
    for rank in range(n):
        got = shard_batch(batch, Mesh(rank=rank, size=n, device="cpu"))
        assert set(got) == set(batch)
        for k, v in sharded.items():
            shard = next(s for s in v.addressable_shards
                         if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)
    assert np.array_equal(batch["source"][5:], batch["source"][4:5].repeat(
        batch["source"].shape[0] - 5, 0))


def test_mesh_without_group_is_the_identity():
    mesh = make_mesh(1, "cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.device.type) == \
        (0, 1, None, "cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_reduce(x) is x and mesh.gather_rows(x) is x
    assert mesh.sum(x) is x and mesh.broadcast_object({"a": 1}) == {"a": 1}
    lo, hi = mesh.extremes(x)
    assert (float(lo), float(hi)) == (0.0, 5.0)
    assert mesh.collective_bytes == 0 and mesh.rows(3) == slice(0, 3)
    with pytest.raises(ValueError):
        Mesh(size=2, device="cpu").rows(3)


def test_mesh_device_is_the_card_unless_asked(monkeypatch):
    """A mesh built without a device takes the card, as every entry point
    of the port does, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        Mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert Mesh(size=2).device == torch.device("cuda")
    assert Mesh(device="cpu").device == torch.device("cpu")


def test_make_mesh_refuses_missing_cards(monkeypatch):
    """More ranks than visible cards raise, as the JAX package refuses a
    mesh larger than its devices; so do several ranks in one process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2-device mesh but only 1"):
        make_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="2-device mesh but only 1"):
        launch(ranks.step_suite, 2, device="cuda", args=([],))
    with pytest.raises(RuntimeError, match="one process a rank"):
        make_mesh(2, "cpu")


@pytest.mark.parametrize("n,b", CASES)
def test_step_matches_jax_mesh(runs, jax_steps, n, b):
    want_losses, want_grads = jax_steps[(n, b)]
    got = runs[(n, b)]["ranks"][0]
    for k, v in want_losses.items():
        assert got["losses"][k] == pytest.approx(v, rel=LOSS_REL), k
    _grads_close(got["grads"], want_grads)
    _grads_close(got["grads"], want_grads, JAX_GRAD_SHARE)


@pytest.mark.parametrize("n,b", CASES)
def test_step_matches_one_process(runs, n, b):
    """The ranks' summed shares against the same padded batch in one
    process; every rank holds the same global losses and gradients."""
    run = runs[(n, b)]
    want = ranks.subspace_step(Mesh(device="cpu"), run["case"])
    assert want["bytes"] == 0
    for got in run["ranks"]:
        for k, v in want["losses"].items():
            assert got["losses"][k] == pytest.approx(v, rel=LOSS_REL), k
        _grads_close(got["grads"], want["grads"])
        assert got["losses"] == run["ranks"][0]["losses"]
        for k, v in got["grads"].items():
            assert np.array_equal(v, run["ranks"][0]["grads"][k]), k


@pytest.mark.parametrize("n,b", CASES)
def test_step_collective_bytes(runs, n, b):
    """One all_reduce of the flat f32 gradients and one of the loss
    scalars: between the parameters' f32 bytes and 1.1 times them plus
    4096 bytes, and no collective carries a volume."""
    run = runs[(n, b)]
    param_bytes = 4 * sum(v.size for v in run["case"]["state"].values())
    for got in run["ranks"]:
        assert got["calls"] == 2
        assert param_bytes <= got["bytes"] <= 1.1 * param_bytes + 4096


def test_averaged_gradients_fail_against_jax(runs, jax_steps):
    """Negative control: the ranks' gradients averaged instead of summed
    miss JAX's by far more than the tolerance."""
    for n, b in CASES:
        got = runs[(n, b)]["ranks"][0]["grads"]
        want = jax_steps[(n, b)][1]
        with pytest.raises(AssertionError):
            _grads_close({k: v / n for k, v in got.items()}, want,
                         JAX_GRAD_SHARE)


def test_pad_row_weighted_one_fails_against_jax(runs, jax_steps):
    """Negative control: the pad row of B = 3 on 2 ranks weighted 1 moves
    the loss and the gradients past their tolerances."""
    got = runs["controls"][0]["pad_weighted_one"]
    want_losses, want_grads = jax_steps[(2, 3)]
    assert got["losses"]["total_loss"] != pytest.approx(
        want_losses["total_loss"], rel=LOSS_REL)
    with pytest.raises(AssertionError):
        _grads_close(got["grads"], want_grads, JAX_GRAD_SHARE)


def test_batch_norm_matches_jax_mesh(runs):
    """ResBlock2D in training at B = 3 padded to 4 on 2 ranks: the output,
    the running averages (equal on both ranks) and the parameters'
    gradients against flax on the padded batch sharded over a 2-mesh,
    whose statistics count the pad row."""
    bn = runs["bn"]
    variables = bn["variables"]
    mesh = jmesh.make_mesh(2)
    xs = jmesh.shard_batch({"x": _last(bn["bn_x"])}, mesh)["x"]
    cot = jnp.asarray(_last(bn["bn_cot"]))
    block = jlegacy.ResBlock2D(4)

    def fn(params):
        out, new = block.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               xs, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new)

    (_, (out, new)), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        variables["params"])
    want_state = params_from_jax(
        {"params": variables["params"],
         **jax.tree_util.tree_map(np.asarray, new)}, ResBlock2D(3, 4))
    want_grads = {k: v for k, v in params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, g),
         "batch_stats": variables["batch_stats"]}, ResBlock2D(3, 4)).items()
        if "running" not in k}
    want_out = np.moveaxis(np.asarray(out), -1, 1)
    for r in runs["controls"]:
        got = r["batch_norm"]
        np.testing.assert_allclose(got["out"], want_out, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_out).max())
        for k, v in want_state.items():
            v = v.numpy()
            if "running" in k:
                np.testing.assert_allclose(got["state"][k], v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max(),
                                           err_msg=k)
                assert np.array_equal(
                    got["state"][k],
                    runs["controls"][0]["batch_norm"]["state"][k])
        scale = max(float(v.abs().max()) for v in want_grads.values())
        for k, v in want_grads.items():
            np.testing.assert_allclose(got["grads"][k], v.numpy(), rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=k)


def test_extremes_match_jax(runs):
    x = runs["controls_input"]["extremes"]
    g = jax.grad(lambda v: 2 * jnp.min(v) + 3 * jnp.max(v))(jnp.asarray(x))
    for r in runs["controls"]:
        got = r["extremes"]
        assert (got["lo"], got["hi"]) == (float(x.min()), float(x.max()))
        np.testing.assert_array_equal(got["grad"], np.asarray(g))


def test_regnet_step_matches_one_process(runs):
    """RegNet2D3D on 2 ranks, B = 3 padded to 4: its re-projections'
    min-max over the global batch, pad row included, as in one process."""
    case = runs["controls_input"]["regnet"]
    want = ranks.regnet_step(Mesh(device="cpu"), case)
    for r in runs["controls"]:
        got = r["regnet"]
        for k, v in want["losses"].items():
            assert got["losses"][k] == pytest.approx(v, rel=LOSS_REL), k
        _grads_close(got["grads"], want["grads"])
        for k, v in want["projections"].items():
            np.testing.assert_allclose(got["projections"][k], v, rtol=0,
                                       atol=REGNET_PROJ_ATOL, err_msg=k)


def test_regnet_step_matches_jax_mesh(runs):
    """RegNet2D3D on 2 ranks, B = 3 padded to 4, against liftreg_tpu's
    RegNet2D3D on a make_mesh(2) from the same flax parameters: the
    re-projections' ``jnp.min``/``max`` over the sharded batch, pad row
    and the ties at 0 of the detector's pixels outside the volume's
    shadow included."""
    case = dict(runs["controls_input"]["regnet"])
    want_losses, want_grads = _jax_step(case, 2, regnet=True)
    for r in runs["controls"]:
        got = r["regnet"]
        for k, v in want_losses.items():
            assert got["losses"][k] == pytest.approx(v, rel=LOSS_REL), k
        assert sorted(got["grads"]) == sorted(want_grads)
        _grads_close(got["grads"], want_grads)
        for k, v in case["jax_projections"].items():
            np.testing.assert_allclose(got["projections"][k], v, rtol=0,
                                       atol=REGNET_PROJ_ATOL, err_msg=k)
