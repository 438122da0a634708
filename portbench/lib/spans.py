"""The port's own spans in a traced run: the ``liftreg.`` spans that
``liftreg_tpu_torch/tracing.py`` records through the benchmark's
``torch.profiler``, on the device trace's clock.

Two readers:

* From the benchmark's :class:`.trace.Trace`, which a metric reader gets:
  the spans' host intervals. They give a span's host ms and the idle gaps
  (``Trace.gaps``' intervals) whose midpoint a span holds. That trace
  keeps no runtime calls, so a gap in which the host was blocked inside a
  span counts there as one that the host's dispatch caused.
* From the whole Chrome trace, :class:`Spans` (``portbench/span_table.py``
  runs a cell for it): each device operation found, through its
  ``correlation``, with the runtime or driver call that launched it, and
  attributed to the innermost span that holds the launch, by time on any
  thread (the autograd engine launches a backward from its own thread
  while the caller waits inside ``liftreg.refine.backward``); the
  operations launched under a backward node (``autograd::engine::
  evaluate_function: ...``) also to the span that recorded the forward op
  of the same ``Sequence number``; the blocking runtime calls; and each
  idle gap labelled at its midpoint ``blocked`` (a blocking call in
  flight on any thread), else ``dispatch`` (a span holds it), else
  ``outside``.

A reader returns None where the run holds nothing to read: no trace, no
``liftreg.`` span (a program without them), no device operation (the
CPU) for a device time.
"""
from __future__ import annotations

import bisect
import json

from portbench.lib import trace as trace_lib

PREFIX = "liftreg."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: runtime calls that hold the calling thread until the card or the
#: allocator lets it go
BLOCKING = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMalloc", "cudaFree", "cudaHostAlloc",
    "cudaMallocHost"))
BACKWARD = "autograd::engine::evaluate_function: "
LABELS = ("blocked", "dispatch", "outside")


class Nest:
    """Nested intervals ``[(start, end, name)]`` cut into the segments in
    which one of them is the innermost: ``at(t)`` gives its index (or
    None), ``parent[i]`` the interval that holds interval i."""

    def __init__(self, intervals):
        # at one start the outer interval first
        self.intervals = sorted(intervals, key=lambda v: (v[0], -v[1]))
        self.parent = [None] * len(self.intervals)
        bounds = []
        for i, (s, e, _) in enumerate(self.intervals):
            bounds.append((s, 1, i))
            # at one time an interval ends before the next starts, unless
            # it is empty
            bounds.append((e, 0 if e > s else 2, i))
        bounds.sort()
        self.starts, self.inner = [], []
        active = []
        for t, kind, i in bounds:
            if kind == 1:
                self.parent[i] = active[-1] if active else None
                active.append(i)
            else:
                active.remove(i)
            self.starts.append(t)
            self.inner.append(active[-1] if active else None)

    def at(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        return self.inner[k] if k >= 0 else None

    def name(self, i):
        return self.intervals[i][2]

    def names_around(self, i):
        """The names of interval i and of those that hold it, each once."""
        names = []
        while i is not None:
            if self.name(i) not in names:
                names.append(self.name(i))
            i = self.parent[i]
        return names


def program_spans(spans, start, end):
    """The ``liftreg.`` spans of ``{name: [(start, end)]}`` that lie in
    [start, end], as ``[(start, end, name)]``."""
    return [(s, e, name) for name, v in spans.items()
            if name.startswith(PREFIX) for s, e in v
            if start <= s and e <= end]


def holes(trace, start, end):
    """The intervals of [start, end] in which no device operation ran,
    as :meth:`.trace.Trace.gaps` finds them."""
    busy = trace_lib._merged([(max(s, start), min(e, end))
                              for s, e, _ in trace.ops(start, end)])
    out, at = [], start
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if end > at:
        out.append((at, end))
    return out


def label_gaps(gaps, nest, blocking=()):
    """[(label, seconds, innermost span index)] of each gap, labelled at
    its midpoint; ``blocking``: the blocking calls' (start, end)."""
    blocked = trace_lib._merged(blocking)
    starts = [s for s, _ in blocked]
    out = []
    for s, e in gaps:
        t = (s + e) / 2
        k = bisect.bisect_right(starts, t) - 1
        i = nest.at(t)
        if k >= 0 and blocked[k][1] >= t:
            label = "blocked"
        else:
            label = "dispatch" if i is not None else "outside"
        out.append((label, e - s, i))
    return out


def _window(run):
    """(trace, start, end, spans) of a traced run with ``liftreg.``
    spans, else None."""
    if run.trace is None:
        return None
    start, end = run.traced
    spans = program_spans(run.trace.spans, start, end)
    return (run.trace, start, end, spans) if spans else None


def host_ms(run, name):
    """Host ms of one ``name`` span in the traced window, their mean."""
    got = _window(run)
    if got is None:
        return None
    ds = [e - s for s, e, n in got[3] if n == name]
    return 1e3 * sum(ds) / len(ds) if ds else None


def dispatch_idle_share(run):
    """% of the traced window idle while a ``liftreg.`` span was open on
    the host (the gap's midpoint)."""
    got = _window(run)
    if got is None:
        return None
    tr, start, end, spans = got
    gaps = label_gaps(holes(tr, start, end), Nest(spans))
    return 100.0 * sum(sec for label, sec, _ in gaps
                       if label == "dispatch") / (end - start)


def _row():
    return {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
            "blocked_s": 0.0, "device_s": 0.0, "self_device_s": 0.0,
            "backward_device_s": 0.0, "blocks": 0,
            "idle_s": dict.fromkeys(LABELS, 0.0)}


class Spans:
    """A whole Chrome trace of ``torch.profiler`` at ``path`` beside the
    benchmark's :class:`.trace.Trace` of it (``trace``, read here when
    not given): each device operation with the time of its launch, the
    blocking calls, and for each operation launched under a backward node
    the time of the forward op that recorded that node. Times in
    seconds."""

    def __init__(self, path, trace=None):
        self.trace = trace or trace_lib.Trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device = []        # (start, end, name, correlation)
        launches = {}           # correlation -> (launch start, thread)
        self.blocking = []      # (start, end, name)
        backward = {}           # thread -> [(start, end, sequence number)]
        forward = {}            # sequence number -> its forward op's start
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat"), ev.get("name", "")
            ts = float(ev["ts"]) * 1e-6
            te = ts + float(ev.get("dur", 0)) * 1e-6
            args = ev.get("args") or {}
            if cat in trace_lib.DEVICE_CATS:
                self.device.append((ts, te, name, args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launches[args["correlation"]] = (ts, ev.get("tid"))
                if name in BLOCKING:
                    self.blocking.append((ts, te, name))
            elif cat == "cpu_op" and "Sequence number" in args:
                seq = args["Sequence number"]
                if name.startswith(BACKWARD):
                    backward.setdefault(ev.get("tid"), []).append(
                        (ts, te, seq))
                elif seq not in forward or ts < forward[seq]:
                    # the earliest op of a number is the forward one
                    forward[seq] = ts
        self.device.sort()
        self.blocking.sort()
        nodes = {tid: Nest(v) for tid, v in backward.items()}
        #: correlation -> the launch's start, and the forward op's start
        #: of the backward node it ran under
        self.launch, self.forward = {}, {}
        for _, _, _, corr in self.device:
            if corr not in launches:
                continue
            t, tid = launches[corr]
            self.launch[corr] = t
            nest = nodes.get(tid)
            i = nest.at(t) if nest is not None else None
            if i is not None and nest.name(i) in forward:
                self.forward[corr] = forward[nest.name(i)]

    def match(self, start, end):
        """(share of the window's device time whose launch was found, the
        longest lead in s of an operation's start over its launch's), or
        (None, None) where no device operation ran."""
        ops = [d for d in self.device if start <= d[0] <= end]
        total = sum(e - s for s, e, _, _ in ops)
        if not total:
            return None, None
        found = [(s, e, self.launch[c]) for s, e, _, c in ops
                 if c in self.launch]
        lead = max((t - s for s, _, t in found), default=None)
        return sum(e - s for s, e, _ in found) / total, lead

    def attribute(self, start, end):
        """Sums over the window [start, end]: ``rows``, by span name, of
        ``count``; host seconds inclusive (``host_s``), less the inner
        spans (``self_host_s``) and blocked in the blocking calls that
        start inside (``blocked_s``); device seconds of the operations
        launched inside (``device_s``), of those with no inner span
        around the launch (``self_device_s``) and of those launched under
        a backward node whose forward op it holds
        (``backward_device_s``); ``blocks``, the blocking calls that
        start inside with no inner span around them; ``idle_s`` by label,
        of the gaps whose midpoint it is the innermost span of. The row
        ``None`` holds what no span holds. Also ``gaps``, the idle
        seconds by label, ``blocks``, the blocking calls that start
        inside any span, and ``blocks_by_name``, them by call."""
        nest = Nest(program_spans(self.trace.spans, start, end))
        rows = {None: _row()}

        def row(i):
            key = None if i is None else nest.name(i)
            return rows.setdefault(key, _row())

        for i, (s, e, _) in enumerate(nest.intervals):
            r = row(i)
            r["count"] += 1
            r["host_s"] += e - s
            r["self_host_s"] += e - s
            if nest.parent[i] is not None:
                row(nest.parent[i])["self_host_s"] -= e - s
        for s, e, _, corr in self.device:
            if not start <= s <= end or corr not in self.launch:
                continue
            i = nest.at(self.launch[corr])
            row(i)["self_device_s"] += e - s
            for name in nest.names_around(i):
                rows[name]["device_s"] += e - s
            if corr in self.forward:
                for name in nest.names_around(nest.at(self.forward[corr])):
                    rows[name]["backward_device_s"] += e - s
        by_name = {}
        for s, e, call in self.blocking:
            if start <= s <= end:
                i = nest.at(s)
                row(i)["blocks"] += 1
                if i is not None:
                    by_name[call] = by_name.get(call, 0) + 1
                for name in nest.names_around(i):
                    rows[name]["blocked_s"] += e - s
        gaps = dict.fromkeys(LABELS, 0.0)
        for label, sec, i in label_gaps(holes(self.trace, start, end), nest,
                                        [b[:2] for b in self.blocking]):
            row(i)["idle_s"][label] += sec
            gaps[label] += sec
        return {"rows": rows, "gaps": gaps,
                "blocks": sum(by_name.values()), "blocks_by_name": by_name}

