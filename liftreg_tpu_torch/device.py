"""Device selection for the port's entry points."""
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
