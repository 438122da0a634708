"""The port's optimizers and schedules against liftreg_tpu's (optax) on the
CPU: Adam, AdamW and SGD from ``build_optimizer`` over five steps, with the
learning rate changed through the injected hyperparameter after the third;
the optimizer state; StepLR and PlateauLR over a run of epochs and scores,
and their state dicts.

Tolerances: parameters and moments rtol 1e-6, atol 1e-7 (the f32 power
of the bias correction may differ by an ulp between XLA and torch); the
schedules exactly (both are plain Python).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from liftreg_tpu.train import optim as joptim
from liftreg_tpu_torch.train import optim as toptim

TOL = dict(rtol=1e-6, atol=1e-7)

CONFIGS = {
    "adam": {"optim_type": "adam", "lr": 1e-3,
             "adam": {"beta": [0.9, 0.999], "weight_decay": 0}},
    "adamw": {"optim_type": "adam", "lr": 2e-3,
              "adam": {"beta": [0.8, 0.99], "weight_decay": 0.05}},
    "sgd": {"optim_type": "sgd", "lr": 0.1},
}


def _grads(rng, shapes, step):
    out = {}
    for k, s in shapes.items():
        g = rng.standard_normal(s).astype(np.float32) * (0.1 + step)
        g.flat[0] = 1e-9          # a gradient far below eps
        out[k] = g
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 5), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jtx, jlr, _ = joptim.build_optimizer(CONFIGS[name])
    ttx, tlr, _ = toptim.build_optimizer(CONFIGS[name])
    assert jlr == tlr
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    jstate.hyperparams["learning_rate"] = jnp.asarray(jlr, jnp.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for step in range(5):
        if step == 3:
            jstate.hyperparams["learning_rate"] = jnp.asarray(jlr * 0.5,
                                                              jnp.float32)
            tstate["hyperparams"]["learning_rate"] = torch.tensor(tlr * 0.5)
        g = _grads(rng, shapes, step)
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tupd, tstate = ttx.update({k: torch.from_numpy(v) for k, v in
                                   g.items()}, tstate, tp)
        tp = toptim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=f"step {step} {k}")
    if name != "sgd":
        inner = jstate.inner_state[0]
        assert int(tstate["count"]) == int(inner.count) == 5
        for k in shapes:
            np.testing.assert_allclose(tstate["mu"][k].numpy(),
                                       np.asarray(inner.mu[k]), **TOL)
            np.testing.assert_allclose(tstate["nu"][k].numpy(),
                                       np.asarray(inner.nu[k]), **TOL)
        assert set(tstate["hyperparams"]) <= set(jstate.hyperparams)


def test_adamw_is_not_torch_adamw():
    """The decay joins the Adam direction before the learning rate scales
    it (optax), which torch.optim.AdamW does not: the two differ."""
    tx, _, _ = toptim.build_optimizer(CONFIGS["adamw"])
    p = {"w": torch.ones(3)}
    g = {"w": torch.tensor([0.5, -0.2, 0.1])}
    upd, _ = tx.update(g, tx.init(p), p)
    ours = toptim.apply_updates(p, upd)["w"]
    tw = torch.ones(3, requires_grad=True)
    opt = torch.optim.AdamW([tw], lr=2e-3, betas=(0.8, 0.99), eps=1e-5,
                            weight_decay=0.05)
    tw.grad = g["w"].clone()
    opt.step()
    assert not torch.equal(ours, tw.detach())


@pytest.mark.parametrize("sched", [
    {"type": "custom", "custom": {"step_size": 3, "gamma": 0.5}},
    {"type": "plateau", "plateau": {"patience": 1, "factor": 0.5,
                                    "threshold": 1e-3, "min_lr": 1e-5,
                                    "cooldown": 1}},
    {"type": "none"},
])
def test_schedules_over_epochs(sched):
    cfg = dict(CONFIGS["adam"], lr_scheduler=sched)
    _, _, js = joptim.build_optimizer(cfg)
    _, _, ts = toptim.build_optimizer(cfg)
    assert type(ts).__name__ == type(js).__name__
    scores = [0.1, 0.2, 0.2, 0.19, 0.2, 0.5, 0.5, 0.49, 0.48, 0.47, 0.6,
              -0.1, -0.2, -0.2, 0.0, 0.0]
    for s in scores:
        assert ts.lr == js.lr
        js.step(s)
        ts.step(s)
    assert ts.lr == js.lr
    assert ts.state_dict() == js.state_dict()
    fresh = toptim.build_optimizer(cfg)[2]
    fresh.load_state_dict(js.state_dict())
    assert fresh.lr == js.lr


def test_warming_up():
    for name, cfg in CONFIGS.items():
        assert toptim.build_optimizer(cfg, warming_up=True)[1] == \
            joptim.build_optimizer(cfg, warming_up=True)[1]
