"""Model registry of the port, with the JAX package's names and the
reference class-path aliases. The subspace model without the lift and
RegNet2D3D are not ported yet: their names raise ``NotImplementedError``
naming ROADMAP A4."""
from .subspace_backproj import LiftRegSubspaceBackproj, SubspaceEncoder  # noqa: F401

MODEL_REGISTRY = {
    "subspace_backproj": LiftRegSubspaceBackproj,
    "liftreg.models.LiftRegDeformSubspaceBackproj.model":
        LiftRegSubspaceBackproj,
}

#: the JAX registry's other names (``liftreg_tpu/models/__init__.py``)
NOT_PORTED = {
    "subspace": "LiftRegSubspace",
    "regnet2d3d": "RegNet2D3D",
    "liftreg.models.LiftRegDeformSubspace.model": "LiftRegSubspace",
    "liftreg.models.previous.RegNet2D3D.model": "RegNet2D3D",
}


def get_model(name):
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' ({NOT_PORTED[name]}) is not ported to "
            "liftreg_tpu_torch yet (ROADMAP A4)")
    raise KeyError(f"unknown model '{name}'; known: "
                   f"{sorted(MODEL_REGISTRY) + sorted(NOT_PORTED)}")
