from .subspace_backproj import LiftRegSubspaceBackproj, SubspaceEncoder  # noqa: F401
