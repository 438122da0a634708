"""Optimizers and learning-rate schedules, PyTorch port of
``liftreg_tpu/train/optim.py``: Adam (eps 1e-5), AdamW when
``adam.weight_decay > 0``, or SGD; StepLR ('custom') or ReduceLROnPlateau
on the validation score ('plateau').

The optimizers are written out as ``optax.inject_hyperparams`` of
``optax.adam``/``adamw``/``sgd`` computes them, on a dict of tensors, so
that the updates follow the JAX trainer's: the hyperparameters are f32
tensors (``1 - b1`` is taken in f32, the bias corrections ``1 - b^count``
as f32 powers of the f32 ``b``), the weight decay is added to the Adam
direction before the learning rate scales it (``torch.optim.AdamW`` decays
the parameters before the step instead), and ``lr`` is injected: set
``state["hyperparams"]["learning_rate"]`` (an f32 tensor on the
parameters' device) to change it between steps. ``init``/``update`` are
functional, so a caller can keep or drop a step's new state (the
trainer's rollback of a non-finite step).
"""
from __future__ import annotations

import dataclasses

import torch


class Adam:
    """``optax.inject_hyperparams(optax.adam)`` (``weight_decay == 0``) or
    ``optax.adamw`` over a dict of tensors. The state holds the step
    ``count`` (int32), the moments ``mu`` and ``nu`` (dicts like the
    parameters) and ``hyperparams`` (f32 tensors)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-5,
                 weight_decay=0.0):
        self.hyperparams = {"learning_rate": learning_rate, "b1": b1,
                            "b2": b2, "eps": eps}
        if weight_decay > 0.0:
            self.hyperparams["weight_decay"] = weight_decay

    def init(self, params):
        device = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "hyperparams": {k: torch.tensor(float(v), dtype=torch.float32,
                                            device=device)
                            for k, v in self.hyperparams.items()},
        }

    def update(self, grads, state, params):
        """-> (updates, new state); ``params + updates`` is the step."""
        h = state["hyperparams"]
        b1, b2, eps = h["b1"], h["b2"], h["eps"]
        count = state["count"] + 1
        bias1 = 1 - b1 ** count.float()
        bias2 = 1 - b2 ** count.float()
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
            u = (mu[k] / bias1) / (torch.sqrt(nu[k] / bias2) + eps)
            if "weight_decay" in h:
                u = u + h["weight_decay"] * params[k]
            updates[k] = -h["learning_rate"] * u
        return updates, {"count": count, "mu": mu, "nu": nu,
                         "hyperparams": h}


class SGD:
    """``optax.inject_hyperparams(optax.sgd)`` without momentum: the
    update is ``-lr * g``; the state holds only the hyperparameters."""

    def __init__(self, learning_rate):
        self.hyperparams = {"learning_rate": learning_rate}

    def init(self, params):
        device = next(iter(params.values())).device
        return {"hyperparams": {"learning_rate": torch.tensor(
            float(self.hyperparams["learning_rate"]), dtype=torch.float32,
            device=device)}}

    def update(self, grads, state, params):
        lr = state["hyperparams"]["learning_rate"]
        return {k: -lr * g for k, g in grads.items()}, state


def apply_updates(params, updates):
    """``optax.apply_updates``: ``p + u`` per tensor, in ``p``'s dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def build_optimizer(opt_setting: dict, warming_up: bool = False):
    """Returns (optimizer with an injectable lr, base_lr, scheduler).
    ``warming_up`` starts at lr/10."""
    optim_type = opt_setting.get("optim_type", "adam")
    lr = float(opt_setting.get("lr", 1e-3))
    if warming_up:
        lr = lr / 10.0
    if optim_type == "adam":
        adam = opt_setting.get("adam", {})
        beta = adam.get("beta", [0.9, 0.999])
        # the reference schema's optim.adam.weight_decay: AdamW when > 0
        weight_decay = float(adam.get("weight_decay", 0.0))
        tx = Adam(lr, b1=float(beta[0]), b2=float(beta[1]), eps=1e-5,
                  weight_decay=weight_decay)
    else:
        tx = SGD(lr)

    sched_setting = opt_setting.get("lr_scheduler", {})
    sched_type = sched_setting.get("type", "custom")
    if sched_type == "custom":
        custom = sched_setting.get("custom", {})
        scheduler = StepLR(lr, int(custom.get("step_size", 50)),
                           float(custom.get("gamma", 0.5)))
    elif sched_type == "plateau":
        p = sched_setting.get("plateau", {})
        scheduler = PlateauLR(lr, patience=int(p.get("patience", 2)),
                              factor=float(p.get("factor", 0.7)),
                              threshold=float(p.get("threshold", 1e-4)),
                              min_lr=float(p.get("min_lr", 1e-8)),
                              cooldown=int(p.get("cooldown", 2)))
    else:
        scheduler = StepLR(lr, 10 ** 9, 1.0)
    return tx, lr, scheduler


@dataclasses.dataclass
class StepLR:
    """lr = base * gamma^(epoch // step_size) (torch StepLR semantics when
    stepped once per epoch)."""
    base_lr: float
    step_size: int
    gamma: float
    epochs_stepped: int = 0

    def step(self, metric=None):
        self.epochs_stepped += 1

    @property
    def lr(self):
        return self.base_lr * self.gamma ** (self.epochs_stepped // self.step_size)

    def state_dict(self):
        return {"epochs_stepped": self.epochs_stepped,
                "base_lr": self.base_lr}

    def load_state_dict(self, d):
        self.epochs_stepped = int(d.get("epochs_stepped", 0))
        self.base_lr = float(d.get("base_lr", self.base_lr))


@dataclasses.dataclass
class PlateauLR:
    """ReduceLROnPlateau (mode='max') on the validation score."""
    base_lr: float
    patience: int = 2
    factor: float = 0.7
    threshold: float = 1e-4
    min_lr: float = 1e-8
    cooldown: int = 2
    current_lr: float = None
    best: float = float("-inf")
    num_bad: int = 0
    cooldown_counter: int = 0

    def __post_init__(self):
        if self.current_lr is None:
            self.current_lr = self.base_lr

    def step(self, metric=None):
        if metric is None:
            return
        if metric > self.best * (1 + self.threshold) if self.best > 0 \
                else metric > self.best + self.threshold:
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor,
                                      self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0

    @property
    def lr(self):
        return self.current_lr

    def state_dict(self):
        return {"current_lr": self.current_lr, "best": self.best,
                "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)
