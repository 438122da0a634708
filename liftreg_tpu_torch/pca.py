"""Load the PCA deformation basis in the JAX package's on-disk layout."""
from __future__ import annotations

import os

import numpy as np
import torch

from .device import resolve_device


def load_pca(pca_path, dtype=None, device=None):
    """Load ``{vectors (L, 3*D*W*H), mean (3*D*W*H,)}`` from
    ``pca_vectors.npy``/``pca_mean.npy`` under ``pca_path``, unchanged.

    ``dtype=torch.bfloat16`` stores the vectors in bf16 (the serving
    basis, which the PCA kernel reads); the mean stays f32. ``device``
    None means the CUDA card."""
    device = resolve_device(device)
    vectors = np.load(os.path.join(pca_path, "pca_vectors.npy"))
    mean = np.load(os.path.join(pca_path, "pca_mean.npy"))
    return {
        "vectors": torch.from_numpy(vectors).to(device,
                                                dtype or torch.float32),
        "mean": torch.from_numpy(mean).to(device, torch.float32),
    }
