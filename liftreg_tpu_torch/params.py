"""Import the JAX package's flax parameters into the port's modules."""
from __future__ import annotations

import numpy as np
import torch


def _np(a):
    """A leaf as numpy: a bf16 tensor (a JAX file's bf16 array, read
    without ``ml_dtypes``) widened to f32, which holds its values exactly."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _tensor(a):
    return torch.from_numpy(np.array(_np(a), dtype=np.float32, copy=True))


def _conv(p):
    """A flax Conv's {kernel, bias}: (kd, kh, kw, Cin, Cout) ->
    (Cout, Cin, kd, kh, kw)."""
    return (_tensor(np.transpose(_np(p["kernel"]), (4, 3, 0, 1, 2))),
            _tensor(p["bias"]))


def _kernel(k):
    """A flax Conv's or ConvTranspose's kernel (*k, Cin, Cout) ->
    (Cout, Cin, *k); the port runs ConvTranspose as flax computes it, so
    its kernel is not flipped."""
    k = _np(k)
    n = k.ndim - 2
    return _tensor(np.transpose(k, (n + 1, n) + tuple(range(n))))


def _block_state(params, stats, module, prefix, state):
    """Walk a flax block's parameter (and ``batch_stats``) tree beside the
    port's module: each submodule's name goes through the module's
    ``FLAX_NAMES``; a leaf with a ``kernel`` is a Conv, ConvTranspose or
    Dense, one with a ``scale`` a BatchNorm."""
    names = getattr(module, "FLAX_NAMES", {})
    for name, sub in params.items():
        attr = names.get(name, name)
        child = getattr(module, attr)
        key = f"{prefix}{attr}."
        if "kernel" in sub:
            k = _np(sub["kernel"])
            state[key + "weight"] = (_tensor(k.T) if k.ndim == 2
                                     else _kernel(k))
            if "bias" in sub:
                state[key + "bias"] = _tensor(sub["bias"])
        elif "scale" in sub:
            state[key + "weight"] = _tensor(sub["scale"])
            state[key + "bias"] = _tensor(sub["bias"])
            state[key + "running_mean"] = _tensor(stats[name]["mean"])
            state[key + "running_var"] = _tensor(stats[name]["var"])
        else:
            _block_state(sub, (stats or {}).get(name, {}), child, key,
                         state)


def params_from_jax(tree, module=None):
    """flax parameter tree of one of the JAX package's models -> the
    ``state_dict`` of the port's model of the same name; or, with
    ``module``, of one of its blocks (``models/blocks.py``,
    ``models/legacy_blocks.py``) -> the ``state_dict`` of ``module``, the
    port's block built with the same options.

    ``tree`` is nested dicts of arrays, with or without the top-level
    ``"params"`` collection; for a block with batch norm, flax's variables
    ``{"params": ..., "batch_stats": ...}``, whose ``mean`` and ``var``
    become ``running_mean`` and ``running_var`` (flax's ``scale`` the
    weight).

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
    if module is not None:
        state = {}
        _block_state(tree.get("params", tree), tree.get("batch_stats", {}),
                     module, "", state)
        return state
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
            _np(p["kernel"]).T)
        state[f"encoder.fcs.{i}.linear.bias"] = _tensor(p["bias"])
        i += 1
    return state
