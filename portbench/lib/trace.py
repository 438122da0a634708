"""The device trace of a traced run: ``torch.profiler`` over the traced
window, read back from its Chrome trace. Gives the device operations in
the window (kernels, copies and fills, with their start and length), the
seconds in which any ran (``busy_s``), the window's length, the device
time of each host phase the benchmark marked, the idle gaps labelled by
what the host was doing (inside a call, waiting for a result, or between
the two), and the breakdown that the result line carries.
"""
from __future__ import annotations

import bisect
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host spans the loops mark, by the idle-gap label they give
HOST_LABELS = (("portbench.wait", "sync"), ("portbench.call", "call"))


def profiler():
    """A profiler of the host and, where there is one, the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of an exported Chrome trace, times in seconds."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device, self.spans = [], {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
            if ev.get("cat") in DEVICE_CATS:
                self.device.append((ts, ts + dur, ev["name"]))
            elif ev.get("cat") == "user_annotation":
                self.spans.setdefault(ev["name"], []).append((ts, ts + dur))
        self.device.sort()
        for v in self.spans.values():
            v.sort()

    def phase(self, name):
        """(start, end) of the host span ``name`` (the first), or None."""
        spans = self.spans.get(name)
        return spans[0] if spans else None

    def ops(self, start, end):
        """Device operations that start within [start, end]."""
        return [d for d in self.device if start <= d[0] <= end]

    def busy_s(self, start, end):
        return sum(min(e, end) - max(s, start) for s, e in _merged(
            [(s, e) for s, e, _ in self.ops(start, end)]))

    def gaps(self, start, end):
        """[(label, seconds)] of each interval of [start, end] in which no
        device operation ran."""
        busy = _merged([(max(s, start), min(e, end))
                        for s, e, _ in self.ops(start, end)])
        holes, at = [], start
        for s, e in busy:
            if s > at:
                holes.append((at, s))
            at = max(at, e)
        if end > at:
            holes.append((at, end))
        return [(self._label((s + e) / 2), e - s) for s, e in holes]

    def _label(self, t):
        for name, label in HOST_LABELS:
            spans = self.spans.get(name, [])
            k = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if k >= 0 and spans[k][0] <= t <= spans[k][1]:
                return label
        return "host"


def short_name(name, n=64):
    return re.sub(r"[^A-Za-z0-9_.:]+", "_", name)[:n]


def breakdown(trace, start, end, top=10):
    """The device operations that took most time, and the idle gaps by
    what the host was doing, each with its seconds."""
    by_op = {}
    for s, e, name in trace.ops(start, end):
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    groups = {}
    for label, sec in trace.gaps(start, end):
        n, total, longest = groups.get(label, (0, 0.0, 0.0))
        groups[label] = (n + 1, total + sec, max(longest, sec))
    idle = sorted(((f"{label}: {n} gaps, longest {longest * 1e3:.4f} ms",
                    total) for label, (n, total, longest) in groups.items()),
                  key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def export(prof, directory):
    """Write ``prof``'s Chrome trace under ``directory``, read it back,
    remove the file and return the :class:`Trace`."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        return Trace(path)
    finally:
        os.remove(path)
