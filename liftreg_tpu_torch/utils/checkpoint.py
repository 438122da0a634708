"""Checkpoints of the port: {params, optimizer state, epoch, global_step,
schedule state}, and a reader of the JAX package's checkpoints.

The port's own format is one ``torch.save`` file (tensors on the CPU,
plain Python values otherwise), written to a temporary file and then
``os.replace``d, so that a reader never sees half a checkpoint. The file
names follow the JAX package's (``model_best.ckpt``,
``<prefix>_checkpoint.ckpt``).

The JAX package writes flax ``msgpack_serialize`` files
(``liftreg_tpu/utils/checkpoint.py``). :func:`read_msgpack` decodes the
subset of msgpack that flax emits (maps, arrays, str, bin, ints, floats,
nil, bools and flax's ndarray and numpy-scalar ext types) by hand: the
card's machine has no ``msgpack`` package. :func:`from_jax_state` maps such
a state into the port's layout: the params through
:func:`..params.params_from_jax`, and the Adam moments through the same
mapping.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..params import params_from_jax

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


# -- msgpack, the subset flax emits -----------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
                 0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map"),
                 0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixed = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xd4 <= b <= 0xd8:               # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xd4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, dtype, buf = _Reader(data).obj()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_msgpack(data: bytes):
    """Decode one msgpack object (flax ``msgpack_serialize`` output) into
    dicts, lists, numpy arrays and Python scalars."""
    reader = _Reader(memoryview(data))
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
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
