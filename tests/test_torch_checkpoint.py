"""Checkpoints and the model registry of the port against liftreg_tpu on
the CPU: a JAX trainer checkpoint (flax msgpack: params, optax Adam and
AdamW state, epoch, global_step, schedule state) read into the port, the
port's own format round-tripped, and ``get_model`` with ``s2d_encoder`` on
against the JAX model with it on.

Tolerances: checkpoint contents exactly (the reader decodes the same
bytes); the model's outputs phi atol 1e-5 and warped atol 1e-4 (f32
convolutions summed in another order, and the JAX encoder's space-to-depth
form of its first two stages against the port's plain convolutions).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from liftreg_tpu.models import LiftRegSubspaceBackproj as JModel
from liftreg_tpu.utils import checkpoint as jckpt
from liftreg_tpu_torch import params_from_jax
from liftreg_tpu_torch.models import get_model
from liftreg_tpu_torch.utils import checkpoint as tckpt

SZ, P, L, B = (16, 16, 16), 2, 4, 2


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    det = (24, 24)
    seg = (rng.uniform(size=(B, 1) + SZ) > 0.3).astype(np.float32)
    return {
        "source": rng.uniform(-1, 1, (B, 1) + SZ).astype(np.float32),
        "target": rng.uniform(-1, 1, (B, 1) + SZ).astype(np.float32),
        "target_proj": rng.uniform(-1, 1, (B, P) + det).astype(np.float32),
        "target_poses": np.array([[-8.0, 56.0, -3.0], [8.0, 56.0, 3.0]],
                                 np.float32),
        "source_label": seg, "target_label": seg[::-1].copy(),
    }


def _pca(seed=1):
    rng = np.random.default_rng(seed)
    n = 3 * int(np.prod(SZ))
    return {"vectors": (rng.standard_normal((L, n)) * 0.01).astype(
        np.float32), "mean": (rng.standard_normal(n) * 0.01).astype(
        np.float32)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    model = JModel(SZ, latent_dim=L, drr_feature_num=P)
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    pca = {k: jnp.asarray(v) for k, v in _pca().items()}
    return _np_tree(model.init(jax.random.PRNGKey(3), inp, pca))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_read_jax_checkpoint(tmp_path, jax_params, weight_decay):
    """A checkpoint as the JAX trainer writes it: its params through
    params_from_jax, its Adam moments through the same mapping, the step
    count, the injected hyperparameters and the loop's state."""
    from liftreg_tpu.train.optim import build_optimizer
    tx, lr, sched = build_optimizer({"lr": 1e-3, "adam": {
        "beta": [0.9, 0.999], "weight_decay": weight_decay}})
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p * 7.0) + 0.1, params)
    for _ in range(2):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    sched.step(0.3)
    path = jckpt.save_checkpoint(
        {"epoch": 4, "params": params, "opt_state": state,
         "global_step": {"train": 12, "val": 5, "debug": 0, "test": 0},
         "lr_state": sched.state_dict()}, False, str(tmp_path), "latest")
    got = tckpt.resume_train(path)
    assert got is not None
    epoch, gstep, st = got
    assert epoch == 5
    assert gstep == {"train": 12, "val": 5, "debug": 0, "test": 0}
    assert st["lr_state"] == sched.state_dict()
    want = params_from_jax(_np_tree(params))
    assert set(st["params"]) == set(want)
    for k in want:
        assert torch.equal(st["params"][k], want[k]), k
    inner = state.inner_state[0]
    for key, tree in (("mu", inner.mu), ("nu", inner.nu)):
        want = params_from_jax(_np_tree(tree))
        for k in want:
            assert torch.equal(st["opt_state"][key][k], want[k]), (key, k)
    assert int(st["opt_state"]["count"]) == 2
    hyper = st["opt_state"]["hyperparams"]
    for k, v in state.hyperparams.items():
        if k != "eps_root":
            assert float(hyper[k]) == float(v), k
    assert ("weight_decay" in hyper) == (weight_decay > 0)


def test_read_missing_checkpoint(tmp_path, capsys):
    assert tckpt.resume_train(str(tmp_path / "absent.ckpt")) is None
    assert "no checkpoint found" in capsys.readouterr().out


def test_own_format_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn((3, 4), generator=g),
              "a.bias": torch.randn((4,), generator=g)}
    state = {"epoch": 2, "params": params,
             "opt_state": {"count": torch.tensor(7, dtype=torch.int32),
                           "mu": {k: v * 0.1 for k, v in params.items()},
                           "nu": {k: v * v for k, v in params.items()},
                           "hyperparams": {"learning_rate": torch.tensor(
                               1e-3)}},
             "global_step": {"train": 9, "val": 3, "debug": 0, "test": 0},
             "lr_state": {"current_lr": 0.1, "best": float("-inf"),
                          "num_bad": 1, "cooldown_counter": 0}}
    best = tckpt.save_checkpoint(state, True, str(tmp_path), "")
    latest = tckpt.save_checkpoint(state, False, str(tmp_path), "latest")
    assert os.path.basename(best) == "model_best.ckpt"
    assert os.path.basename(latest) == "latest_checkpoint.ckpt"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    epoch, gstep, st = tckpt.resume_train(latest)
    assert epoch == 3 and gstep == state["global_step"]
    assert st["lr_state"] == state["lr_state"]
    for k in params:
        assert torch.equal(st["params"][k], params[k])
        for key in ("mu", "nu"):
            assert torch.equal(st["opt_state"][key][k],
                               state["opt_state"][key][k])
    assert int(st["opt_state"]["count"]) == 7
    # a torch file that is not this trainer's checkpoint is refused
    other = tmp_path / "other.ckpt"
    torch.save({"weights": params}, other)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(str(other))


@pytest.mark.parametrize("s2d", [False, True])
def test_get_model_s2d_against_jax(jax_params, s2d):
    """The JAX model with ``s2d_encoder`` (and ``fast_vjp``) on or off from
    one parameter tree; the port's get_model accepts both options and
    gives the same outputs."""
    inp = _inputs(5)
    pca = _pca()
    jm = JModel(SZ, latent_dim=L, drr_feature_num=P, s2d_encoder=s2d,
                fast_vjp=s2d)
    want = jm.apply(jax_params, {k: jnp.asarray(v) for k, v in inp.items()},
                    {k: jnp.asarray(v) for k, v in pca.items()})
    tm = get_model("liftreg.models.LiftRegDeformSubspaceBackproj.model")(
        img_sz=SZ, latent_dim=L, drr_feature_num=P, s2d_encoder=s2d,
        fast_vjp=s2d)
    tm.load_state_dict(params_from_jax(jax_params))
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in inp.items()},
                 {k: torch.from_numpy(v) for k, v in pca.items()})
    np.testing.assert_allclose(got["phi"].numpy(), np.asarray(want["phi"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["warped"].numpy(),
                               np.asarray(want["warped"]), atol=1e-4, rtol=0)


def test_get_model_registry():
    """Every name of the JAX registry resolves to the port's class of the
    same name (A4 ported the subspace model and RegNet2D3D)."""
    from liftreg_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    assert get_model("subspace_backproj").__name__ == \
        "LiftRegSubspaceBackproj"
    for name, cls in JAX_REGISTRY.items():
        assert get_model(name).__name__ == cls.__name__, name
    for name in ("subspace", "regnet2d3d",
                 "liftreg.models.previous.RegNet2D3D.model"):
        assert get_model(name).__module__.startswith("liftreg_tpu_torch.")
    with pytest.raises(KeyError):
        get_model("nope")
