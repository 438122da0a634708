"""Artifact IO: the port's copy of ``liftreg_tpu/utils/io_utils.py``
(numpy only; the port imports nothing of the JAX package).

Replaces the reference's nibabel/SimpleITK usage (``utils/utils.py:57-91``)
with a dependency-free NIfTI-1 writer (neither library is available here).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np


def _nifti1_header(shape, pixdim, dtype_code=16, bitpix=32):
    """Minimal NIfTI-1 header. dtype 16 = float32."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                    # sizeof_hdr
    ndim = len(shape)
    dims = [ndim] + list(shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)                # dim
    struct.pack_into("<h", hdr, 70, dtype_code)            # datatype
    struct.pack_into("<h", hdr, 72, bitpix)                # bitpix
    pd = [1.0] + list(pixdim) + [1.0] * (7 - len(pixdim))
    struct.pack_into("<8f", hdr, 76, *pd)                  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                  # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                    # qform_code
    struct.pack_into("<h", hdr, 254, 1)                    # sform_code
    # identity srow (the reference writes nib.Nifti1Image(x, np.eye(4)))
    sx = pixdim[0] if len(pixdim) > 0 else 1.0
    sy = pixdim[1] if len(pixdim) > 1 else 1.0
    sz = pixdim[2] if len(pixdim) > 2 else 1.0
    struct.pack_into("<4f", hdr, 280, sx, 0, 0, 0)
    struct.pack_into("<4f", hdr, 296, 0, sy, 0, 0)
    struct.pack_into("<4f", hdr, 312, 0, 0, sz, 0)
    hdr[344:348] = b"n+1\x00"                              # magic
    return bytes(hdr)


def save_nifti(path, array, spacing=(1.0, 1.0, 1.0)):
    """Write ``array`` as a .nii or .nii.gz (float32, Fortran voxel order —
    axis 0 fastest, matching nibabel's to-disk convention)."""
    arr = np.asarray(array, dtype=np.float32)
    hdr = _nifti1_header(arr.shape, list(spacing)[:3])
    payload = hdr + b"\x00" * 4 + arr.tobytes(order="F")
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def save_deformations(phis, names, path):
    """Save batched maps rescaled to [0,1] as ``{name}_phi.npy`` and
    ``.nii.gz`` (``utils/utils.py:57-68``). phis: (B, 3, D, W, H) in [-1,1]."""
    phis = (np.asarray(phis) + 1.0) / 2.0
    for i in range(phis.shape[0]):
        np.save(os.path.join(path, str(names[i]) + "_phi.npy"), phis[i])
        save_nifti(os.path.join(path, str(names[i]) + "_phi.nii.gz"), phis[i])


def save_fig_3d(imgs, path, names, suffix, spacing=(1.0, 1.0, 1.0),
                save_as_np=True):
    """Save 3D volumes per batch item (``utils/utils.py:71-91``).
    imgs: (B, D, W, H)."""
    imgs = np.asarray(imgs)
    for i in range(imgs.shape[0]):
        base = os.path.join(path, str(names[i]) + suffix)
        if save_as_np:
            np.save(base + ".npy", imgs[i])
        save_nifti(base + ".nii.gz", imgs[i], spacing=np.flipud(spacing))


def make_dir(directory):
    os.makedirs(directory, exist_ok=True)
