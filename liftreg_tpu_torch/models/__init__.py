"""Model registry of the port: the JAX package's names and the reference
class-path aliases (``liftreg_tpu/models/__init__.py``)."""
from .subspace import LiftRegSubspace  # noqa: F401
from .subspace_backproj import LiftRegSubspaceBackproj, SubspaceEncoder  # noqa: F401
from .unet2d3d import RegNet2D3D  # noqa: F401

MODEL_REGISTRY = {
    "subspace_backproj": LiftRegSubspaceBackproj,
    "subspace": LiftRegSubspace,
    "regnet2d3d": RegNet2D3D,
    # reference class-path aliases
    "liftreg.models.LiftRegDeformSubspaceBackproj.model":
        LiftRegSubspaceBackproj,
    "liftreg.models.LiftRegDeformSubspace.model": LiftRegSubspace,
    "liftreg.models.previous.RegNet2D3D.model": RegNet2D3D,
}


def get_model(name):
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    raise KeyError(f"unknown model '{name}'; known: {sorted(MODEL_REGISTRY)}")
