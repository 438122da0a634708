"""The ``liftreg`` operator namespace: the serving path's kernels as
``torch.library`` operators.

A kernel launched through ``ctypes`` on raw data pointers is opaque to
``torch.export``: a tracer that hands it a FakeTensor has no pointer to
give. Each forward kernel of the serving path is therefore an operator
with three implementations, registered here by the module that owns the
kernel: ``CUDA`` (the wrapper's checks, then the hand-written kernel),
``CPU`` (the same checks, then the plain version) and a fake one that
gives the output's shape and dtype from the inputs' (and checks their
shapes). The dispatcher picks by the tensors' device, so a CUDA tensor
only ever reaches the kernel. Everything that the host decides per call
(argument checks, the projector's plane chunks from the card's SM count,
the PCA expansion's chunks of 8 rows) happens inside the CUDA
implementation, so an exported program decides it again on the card
that runs it.

The operators are registered with the low-level ``Library.define`` /
``Library.impl``, which adds no Python layer of its own to a call (as
``torch.library.custom_op`` does). None has an autograd kernel: the
wrappers call them without gradient or from the forward of their
``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

NAMESPACE = "liftreg"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema, impl, fake):
    """Define ``liftreg::<schema>`` with ``impl`` for the CPU and CUDA keys
    (it tells the two apart itself) and ``fake`` for FakeTensors and the
    meta device; returns the operator's overload packet."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, impl, "CPU")
    LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name)


def op_names(graph_module):
    """Qualified names (``liftreg::project``) of the ``liftreg`` operators
    called anywhere in an FX graph module, its submodules included."""
    graphs = (m.graph for m in graph_module.modules() if hasattr(m, "graph"))
    return {f"{NAMESPACE}::{node.target._opname}"
            for graph in graphs for node in graph.nodes
            if isinstance(node.target, torch._ops.OpOverload)
            and node.target.namespace == NAMESPACE}
