"""Device and dtype selection for the port's entry points."""
from __future__ import annotations

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
