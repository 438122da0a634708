"""The data mesh of the port (``liftreg_tpu/parallel``): one process a
rank over ``torch.distributed``."""
from .mesh import (Mesh, attach, launch, make_mesh, pad_batch,  # noqa: F401
                   shard_batch)
