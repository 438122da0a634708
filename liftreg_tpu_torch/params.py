"""Import the JAX package's flax parameters into the port's modules."""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(tree):
    """flax parameter tree of ``LiftRegSubspaceBackproj`` -> ``state_dict``
    of :class:`liftreg_tpu_torch.models.LiftRegSubspaceBackproj`.

    ``tree`` is nested dicts of arrays, with or without the top-level
    ``"params"`` collection: ``encoder/CheckpointConvBlock_{i}/Conv_0`` and
    ``encoder/FullyConnectBlock_{i}/Dense_0``, each ``{kernel, bias}``.
    Conv kernels go from (kd, kh, kw, Cin, Cout) to (Cout, Cin, kd, kh, kw),
    Dense kernels from (in, out) to (out, in). The port's encoder flattens
    channels-last as the JAX one does, so the first FC layer's rows keep
    their order.
    """
    enc = tree.get("params", tree)["encoder"]
    state = {}
    i = 0
    while f"CheckpointConvBlock_{i}" in enc:
        p = enc[f"CheckpointConvBlock_{i}"]["Conv_0"]
        state[f"encoder.convs.{i}.conv.weight"] = _tensor(
            np.transpose(np.asarray(p["kernel"]), (4, 3, 0, 1, 2)))
        state[f"encoder.convs.{i}.conv.bias"] = _tensor(p["bias"])
        i += 1
    i = 0
    while f"FullyConnectBlock_{i}" in enc:
        p = enc[f"FullyConnectBlock_{i}"]["Dense_0"]
        state[f"encoder.fcs.{i}.linear.weight"] = _tensor(
            np.asarray(p["kernel"]).T)
        state[f"encoder.fcs.{i}.linear.bias"] = _tensor(p["bias"])
        i += 1
    return state
