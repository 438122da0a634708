"""What the metric readers under ``portbench/metrics/`` share: each reads
a :class:`Run` and returns a number, or None where the run holds nothing
for it to read (an untraced run has no trace; a cell whose path launches
none of the port's counted kernels has no roofline).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from portbench.lib import catalog, flops

_LIB = Path(__file__).resolve().parent
PEAKS = json.loads((_LIB / "peaks.json").read_text())
CLASSES = json.loads((_LIB / "kernel_classes.json").read_text())


@dataclasses.dataclass
class Run:
    """One run of a cell: its configuration and traffic, the loop's
    record (``calls``, ``t0``, ``t_end``, ``latencies``), the set-up
    seconds, and for a traced run the trace, the traced window's (start,
    end) on the trace's clock, the port's launch counts over it, and the
    device seconds and calls of each marked phase after it."""
    cfg: dict
    traffic: dict
    window: dict
    setup_s: float
    trace: object = None
    traced: tuple = None
    launches: dict = None
    phases: dict = dataclasses.field(default_factory=dict)

    @property
    def batch(self):
        return int(self.traffic["batch"])

    def per_call_s(self):
        w = self.window
        return (w["t_end"] - w["t0"]) / w["calls"]


def registrations_per_s(run):
    """Registrations completed a second over the whole window, from the
    first dispatch to the last completion."""
    w = run.window
    return run.batch * w["calls"] / (w["t_end"] - w["t0"])


def kernel_class(name):
    low = name.lower()
    for cls in ("port", "conv"):
        if any(k in low for k in CLASSES[cls]):
            return cls
    return "glue"


def _device_ops(run):
    if run.trace is None:
        return None
    return run.trace.ops(*run.traced)


def idle_share(run):
    """% of the traced window in which no operation ran on the card."""
    if run.trace is None:
        return None
    start, end = run.traced
    return 100.0 * (1.0 - run.trace.busy_s(start, end) / (end - start))


def class_ms(run, cls):
    """Device ms a call in the kernels of class ``cls``."""
    ops = _device_ops(run)
    if not ops:
        return None
    total = sum(e - s for s, e, name in ops if kernel_class(name) == cls)
    return total / run.window["calls"] * 1e3


def pattern_ms(run, patterns):
    """Device ms a call in the operations whose name holds one of
    ``patterns`` (lower case)."""
    ops = _device_ops(run)
    if not ops:
        return None
    total = sum(e - s for s, e, name in ops
                if any(p in name.lower() for p in patterns))
    return total / run.window["calls"] * 1e3


def launches_per_call(run):
    if run.launches is None:
        return None
    return sum(run.launches.values()) / run.window["calls"]


def shapes(run):
    """The sizes a roofline count reads: batch B, volume D, W, H, latent
    L, views P, detector rd x rh, and the bytes of the taps, the basis and
    the encoder's input buffer."""
    cfg = run.cfg
    D, W, H = (int(n) for n in cfg["img_sz"])
    rd, rh = (int(n) for n in cfg["resolution"])
    size = {"bfloat16": 2, "float32": 4}
    return {"B": run.batch, "D": D, "W": W, "H": H,
            "L": int(cfg["latent_dim"]), "P": int(cfg["n_proj"]),
            "rd": rd, "rh": rh,
            "taps_bytes": size[cfg["warp_taps_dtype"] or "float32"],
            "basis_bytes": size[cfg["pca_dtype"]],
            "basis_dtype": cfg["pca_dtype"],
            "lift_bytes": size[cfg["compute_dtype"] or "float32"]}


def bound_s(nbytes, ops, dtype):
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["ops_per_s"][dtype])


def roofline_share(run):
    """% of Σ bound time over Σ device time of the operations under
    ``rooflines/`` that the traced window launched: each operation's
    bound at the call's shapes times its launches, over the device time
    of the operations its patterns name. None where none ran."""
    ops = _device_ops(run)
    if not ops or run.launches is None:
        return None
    s = shapes(run)
    bound = device = 0.0
    for mod in catalog.rooflines().values():
        n = run.launches.get(mod.COUNTER, 0)
        t = sum(e - st for st, e, name in ops
                if any(p in name for p in mod.PATTERNS))
        if n and t > 0:
            bound += n * bound_s(*mod.cost(s))
            device += t
    return 100.0 * bound / device if device > 0 else None


def mfu(run, train=False):
    """% of the dtype's peak that the declared model's operations a call
    over the traced window's time a call make."""
    if run.trace is None:
        return None
    start, end = run.traced
    per_call = (end - start) / run.window["calls"]
    dtype = run.cfg["compute_dtype"] or "float32"
    return 100.0 * flops.model_flops(run.cfg, run.batch, train) \
        / per_call / PEAKS["ops_per_s"][dtype]


def percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def finite(x):
    return x is not None and math.isfinite(x)
