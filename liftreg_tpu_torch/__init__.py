"""liftreg_tpu_torch: the PyTorch/CUDA port of liftreg_tpu.

Registers a 3D CT to limited-angle 2D projections on an NVIDIA Hopper card.
The PCA expansion and the trilinear warp are CUDA kernels written for
``sm_90a`` (``csrc/``), built with one ``nvcc`` call at first use; every
other stage is plain PyTorch. Imports no JAX.
"""
from .params import params_from_jax
from .pipeline import RegistrationPipeline

__all__ = ["RegistrationPipeline", "params_from_jax"]
