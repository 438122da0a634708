"""General helpers: the port's copy of ``parse_bool`` and ``make_dir`` from
``liftreg_tpu/utils/general.py``."""
from __future__ import annotations

import os


def make_dir(directory):
    os.makedirs(directory, exist_ok=True)


def parse_bool(raw, default=False):
    """Config-bool parser: real bools pass through; strings
    "false"/"0"/"no" (any case) mean False, anything else truthy-spelled
    means True. ``bool("false")`` is True, so naive casting silently
    inverts a user's intent."""
    if raw is None:
        return default
    if isinstance(raw, bool):
        return raw
    return str(raw).lower() not in ("false", "0", "no")
