"""liftreg_tpu_torch: the PyTorch/CUDA port of liftreg_tpu.

Registers a 3D CT to limited-angle 2D projections on an NVIDIA Hopper card,
optionally refining each case in the PCA subspace against the target CT or
against the projections. The DRR projector and its adjoint, the
backprojection lift, the PCA expansion and its backward, and the trilinear
warp and its coordinate gradient are CUDA kernels written for ``sm_90a``
(``csrc/``), built at first use; every other stage is plain PyTorch.
Imports no JAX.
"""
from .params import params_from_jax
from .pipeline import RegistrationPipeline

__all__ = ["RegistrationPipeline", "params_from_jax"]
