"""The floating-point operations of the declared model, counted from the
configuration's shapes whatever kernels implement it: the encoder's
convolutions and fully connected layers and the PCA expansion (a
multiply and an add each), and for a train step their backward (the
weight gradients of every layer, the input gradients of every layer but
the first, the coefficients' gradient through the basis)."""
from __future__ import annotations

import math

from portbench.lib.inputs import encoder_shapes


def model_flops(cfg, batch, train=False):
    sz = [int(n) for n in cfg["img_sz"]]
    convs, fcs = encoder_shapes(cfg)
    fwd, first = 0, None
    spatial = sz
    for i, (co, ci) in enumerate(convs):
        if i > 0:
            spatial = [(n - 1) // 2 + 1 for n in spatial]
        f = 2 * co * ci * 27 * math.prod(spatial) * batch
        first = f if first is None else first
        fwd += f
    fc = sum(2 * co * ci * batch for co, ci in fcs)
    pca = 2 * batch * int(cfg["latent_dim"]) * 3 * math.prod(sz)
    if not train:
        return fwd + fc + pca
    return (3 * fwd - first) + 3 * fc + 2 * pca
