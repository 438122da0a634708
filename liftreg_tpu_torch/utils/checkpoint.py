"""Checkpoints of the port: {params, optimizer state, epoch, global_step,
schedule state}, and a reader of the JAX package's checkpoints.

The port's own format is one ``torch.save`` file (tensors on the CPU,
plain Python values otherwise), written to a temporary file and then
``os.replace``d, so that a reader never sees half a checkpoint. The file
names follow the JAX package's (``model_best.ckpt``,
``<prefix>_checkpoint.ckpt``).

The JAX package writes flax ``msgpack_serialize`` files
(``liftreg_tpu/utils/checkpoint.py``). :func:`.msgpack_codec.read_msgpack`
decodes the subset of msgpack that flax emits (maps, arrays, str, bin,
ints, floats, nil, bools and flax's ndarray and numpy-scalar ext types) by
hand, bf16 arrays without ``ml_dtypes``: the card's machine need not have
either package. :func:`from_jax_state` maps such
a state into the port's layout: the params through
:func:`..params.params_from_jax`, and the Adam moments through the same
mapping.
"""
from __future__ import annotations

import os

import torch

from ..params import params_from_jax
from .msgpack_codec import read_msgpack

FORMAT = "liftreg_tpu_torch"
PHASES = ("train", "val", "debug", "test")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(state: dict, is_best: bool, save_path: str, prefix: str,
                    filename: str = "checkpoint"):
    """state: {'epoch', 'params', 'opt_state', 'global_step', 'lr_state'};
    tensors are copied to the CPU. Returns the path written."""
    os.makedirs(save_path, exist_ok=True)
    if is_best:
        out = os.path.join(save_path, "model_best.ckpt")
    else:
        out = os.path.join(save_path, "_".join([prefix, filename]) + ".ckpt")
    payload = dict(_cpu(state), format=FORMAT)
    tmp = out + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    return out


def _is_msgpack(head: bytes):
    # a flax checkpoint is one map; torch.save writes a zip archive ("PK")
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


def from_jax_state(state: dict):
    """A JAX trainer's checkpoint state (nested dicts of numpy arrays) ->
    the port's: ``params`` a ``state_dict`` of the model, ``opt_state``
    ``{count, mu, nu, hyperparams}`` of :class:`..train.optim.Adam` (from
    optax's ``inject_hyperparams`` state; the moments mapped as the params
    are) or ``{hyperparams}`` for SGD."""
    out = {k: v for k, v in state.items() if k not in ("params", "opt_state")}
    out["params"] = params_from_jax(state["params"])
    opt = state.get("opt_state")
    if opt:
        hyper = {k: torch.tensor(float(v), dtype=torch.float32)
                 for k, v in opt.get("hyperparams", {}).items()
                 if k != "eps_root"}
        inner = opt.get("inner_state", {}).get("0", {})
        if "mu" in inner:
            out["opt_state"] = {
                "count": torch.tensor(int(inner["count"]), dtype=torch.int32),
                "mu": params_from_jax(inner["mu"]),
                "nu": params_from_jax(inner["nu"]),
                "hyperparams": hyper}
        else:
            out["opt_state"] = {"hyperparams": hyper}
    return out


def load_checkpoint(path: str):
    """Either format -> the state in the port's layout (tensors on the
    CPU)."""
    with open(path, "rb") as f:
        head = f.read(1)
    if _is_msgpack(head):
        with open(path, "rb") as f:
            return from_jax_state(read_msgpack(f.read()))
    state = torch.load(path, map_location="cpu", weights_only=True)
    if state.get("format") != FORMAT:
        raise ValueError(f"'{path}' is not a checkpoint of this trainer")
    return state


def resume_train(model_path: str):
    """Load a checkpoint for resuming; returns (start_epoch, global_step,
    state), or None with a printed warning when the file is absent (the
    training then starts fresh, as in the JAX package)."""
    if not os.path.isfile(model_path):
        print(f"=> no checkpoint found at '{model_path}'")
        return None
    print(f"=> loading checkpoint '{model_path}'")
    state = load_checkpoint(model_path)
    start_epoch = int(state.get("epoch", -1)) + 1
    global_step = state.get("global_step", {p: 0 for p in PHASES})
    global_step = {k: int(v) for k, v in global_step.items()}
    return start_epoch, global_step, state
