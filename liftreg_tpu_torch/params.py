"""Import the JAX package's flax parameters into the port's modules."""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(p):
    """A flax Conv's {kernel, bias}: (kd, kh, kw, Cin, Cout) ->
    (Cout, Cin, kd, kh, kw)."""
    return (_tensor(np.transpose(np.asarray(p["kernel"]), (4, 3, 0, 1, 2))),
            _tensor(p["bias"]))


def params_from_jax(tree):
    """flax parameter tree of one of the JAX package's models -> the
    ``state_dict`` of the port's model of the same name.

    ``tree`` is nested dicts of arrays, with or without the top-level
    ``"params"`` collection.

    * ``LiftRegSubspaceBackproj`` and ``LiftRegSubspace`` (the same
      encoder): ``encoder/CheckpointConvBlock_{i}/Conv_0`` and
      ``encoder/FullyConnectBlock_{i}/Dense_0``, each ``{kernel, bias}``.
      Dense kernels go from (in, out) to (out, in); the port's encoder
      flattens channels-last as the JAX one does, so the first FC layer's
      rows keep their order.
    * ``RegNet2D3D``: ``CheckpointConvBlock_{n}/Conv_0`` becomes
      ``convs.{n}`` and the top-level ``Conv_0`` (the flow head) ``flow``.

    Conv kernels go from (kd, kh, kw, Cin, Cout) to (Cout, Cin, kd, kh, kw).
    """
    tree = tree.get("params", tree)
    state = {}
    if "encoder" not in tree:
        i = 0
        while f"CheckpointConvBlock_{i}" in tree:
            w, b = _conv(tree[f"CheckpointConvBlock_{i}"]["Conv_0"])
            state[f"convs.{i}.conv.weight"], state[f"convs.{i}.conv.bias"] = \
                w, b
            i += 1
        state["flow.weight"], state["flow.bias"] = _conv(tree["Conv_0"])
        return state
    enc = tree["encoder"]
    i = 0
    while f"CheckpointConvBlock_{i}" in enc:
        w, b = _conv(enc[f"CheckpointConvBlock_{i}"]["Conv_0"])
        state[f"encoder.convs.{i}.conv.weight"] = w
        state[f"encoder.convs.{i}.conv.bias"] = b
        i += 1
    i = 0
    while f"FullyConnectBlock_{i}" in enc:
        p = enc[f"FullyConnectBlock_{i}"]["Dense_0"]
        state[f"encoder.fcs.{i}.linear.weight"] = _tensor(
            np.asarray(p["kernel"]).T)
        state[f"encoder.fcs.{i}.linear.bias"] = _tensor(p["bias"])
        i += 1
    return state
