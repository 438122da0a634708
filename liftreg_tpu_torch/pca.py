"""The PCA deformation basis: load it in the JAX package's on-disk layout,
and fit one over displacement fields (the port's copy of
``liftreg_tpu/pca.py``: host numpy in f64, the same bits on the same
input).

The basis is the layout the models load: vectors ``(latent, 3*D*W*H)``
and mean ``(3*D*W*H,)``. Fields are many (3*160^3 ~ 12.3M values) and
few (~100 training pairs), so :func:`fit_pca` eigendecomposes the
(M, M) Gram matrix of the centred snapshots instead of the covariance.
"""
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
    None means the CUDA card. The tensors are contiguous whatever the
    files' order (:func:`fit_pca`, as the JAX package's, writes its vectors
    in Fortran order)."""
    device = resolve_device(device)
    vectors = np.ascontiguousarray(
        np.load(os.path.join(pca_path, "pca_vectors.npy")))
    mean = np.ascontiguousarray(
        np.load(os.path.join(pca_path, "pca_mean.npy")))
    return {
        "vectors": torch.from_numpy(vectors).to(device,
                                                dtype or torch.float32),
        "mean": torch.from_numpy(mean).to(device, torch.float32),
    }


def fit_pca(disp_fields, n_components, chunk=8, scale_by_stddev=False):
    """Fit a PCA over displacement snapshots.

    ``disp_fields``: an ``(M, K)`` array, or an iterable of ``(K,)`` /
    ``(3, D, W, H)`` arrays (flattened). ``n_components`` L <= M;
    ``chunk`` rows of the Gram matrix at a time; ``scale_by_stddev``
    scales each component by ``sqrt(lambda_i / (M-1))``, so that the
    coefficients a network regresses are ~N(0, 1).

    Returns (vectors ``(L, K)`` f32, unit-norm rows unless
    ``scale_by_stddev``; mean ``(K,)`` f32)."""
    if not isinstance(disp_fields, np.ndarray):
        disp_fields = np.stack([np.asarray(d).reshape(-1)
                                for d in disp_fields])
    X = disp_fields.reshape(disp_fields.shape[0], -1).astype(np.float64)
    M, K = X.shape
    if n_components > M:
        raise ValueError(f"n_components={n_components} > samples={M}")
    mean = X.mean(axis=0)
    # centred in place: X is this function's own f64 copy, and a second
    # (M, K) f64 array is ~11 GB for 112 fields at 160^3
    X -= mean
    Xc = X
    gram = np.zeros((M, M), dtype=np.float64)
    for i in range(0, M, chunk):
        gram[i:i + chunk] = Xc[i:i + chunk] @ Xc.T
    evals, evecs = np.linalg.eigh(gram)
    order = np.argsort(evals)[::-1][:n_components]
    evals = np.maximum(evals[order], 1e-12)
    evecs = evecs[:, order]
    # principal directions: V = Xc^T U / sqrt(lambda), unit-norm rows
    vectors = (Xc.T @ (evecs / np.sqrt(evals))).T
    if scale_by_stddev:
        vectors = vectors * np.sqrt(evals / max(M - 1, 1))[:, None]
    return vectors.astype(np.float32), mean.astype(np.float32)


def save_pca(out_dir, vectors, mean):
    """Write ``pca_vectors.npy`` and ``pca_mean.npy`` under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "pca_vectors.npy"), vectors)
    np.save(os.path.join(out_dir, "pca_mean.npy"), mean)


def explained_variance_ratio(disp_fields, vectors, mean):
    """The share of the snapshots' variance that the basis captures."""
    X = np.stack([np.asarray(d).reshape(-1)
                  for d in disp_fields]).astype(np.float64)
    Xc = X - mean
    coefs = Xc @ vectors.T.astype(np.float64)
    recon = coefs @ vectors.astype(np.float64)
    total = float(np.sum(Xc ** 2))
    return float(np.sum(recon ** 2) / max(total, 1e-12))
