"""Device and dtype selection for the port's entry points, and the f32
precision scope of its own f32 products and convolutions."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the
    entry points never drop to the CPU on their own. Pass ``"cpu"`` to run
    the plain versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("liftreg_tpu_torch runs on a CUDA device by "
                               "default and none is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype, what="dtype"):
    """``None``, a ``torch.dtype`` or a dtype's name as the JAX package and
    its JSON configs give it (``"bfloat16"``, ``"float32"``) -> ``None`` or
    the ``torch.dtype``. Anything else raises ``ValueError`` naming
    ``what``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, dtype, None) if isinstance(dtype, str) else None
    if not isinstance(found, torch.dtype):
        raise ValueError(f"{what} {dtype!r} is not a torch dtype or the name "
                         "of one")
    return found


def _new_flags():
    """The ``fp32_precision`` flag objects of torch's newer TF32 API (cuBLAS
    products, cuDNN convolutions and RNNs), or () on a torch without it."""
    cudnn = torch.backends.cudnn
    flags = (torch.backends.cuda.matmul, getattr(cudnn, "conv", None),
             getattr(cudnn, "rnn", None))
    return flags if all(hasattr(f, "fp32_precision") for f in flags) else ()


def _read(getter):
    """A flag of torch's older API, or None where torch refuses to read it
    because the caller set the newer API."""
    try:
        return getter()
    except RuntimeError:
        return None


@contextlib.contextmanager
def f32_precision():
    """Within the block, f32 matrix products and convolutions on the card
    keep f32 precision (no TF32), as the JAX package asks XLA for HIGHEST;
    the caller's settings come back on exit, whatever they were. The port
    wraps its own f32 work in this (the model's forward, the refinement,
    the plain DRR products, the trainer's steps) and sets no process-wide
    flag. A backward runs with the flags of the moment it runs, so a caller
    that differentiates the model itself wraps its backward too.

    Torch has two TF32 APIs, ``allow_tf32`` and the matmul precision, and
    (newer) ``fp32_precision``, and refuses to read a state in which they
    disagree. The block sets both to f32 through the older API's setters,
    which keep them in step, and on exit restores each flag of each API as
    the caller left it."""
    new = _new_flags()
    saved_new = [f.fp32_precision for f in new]
    saved_matmul = _read(torch.get_float32_matmul_precision)
    saved_cudnn = _read(lambda: torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if saved_matmul is not None:
            torch.set_float32_matmul_precision(saved_matmul)
        if saved_cudnn is not None:
            torch.backends.cudnn.allow_tf32 = saved_cudnn
        for f, value in zip(new, saved_new):
            f.fp32_precision = value
