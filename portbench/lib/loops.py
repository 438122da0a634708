"""The measured loops: a closed loop of calls with ``depth`` of them in
flight (1: each call's result is waited for before the next is sent),
over a pool of inputs taken in turn. A call is timed from its dispatch on
the host clock to the moment its completion event is seen; the window
runs from the first dispatch to the last completion. The cyclic garbage
collector is off inside the window.
"""
from __future__ import annotations

import collections
import gc
import time

import torch
from torch.profiler import record_function


class _Done:
    """A completion mark where no card is: the CPU's calls return done."""

    def synchronize(self):
        pass


def mark(device):
    """An event recorded on ``device``'s stream after the work enqueued
    so far."""
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call, pool, device, depth, seconds, min_calls, keep=(),
                span="portbench.window"):
    """Dispatch ``call(pool[i % len(pool)])`` for i = 0, 1, ... while
    ``seconds`` have not passed since the first dispatch or fewer than
    ``min_calls`` were sent, waiting for call i - depth + 1 before call
    i + 1 is sent; then wait for the rest. Returns the number of calls,
    the window's start and end, each call's latency (s) in order, and the
    results of the calls whose index is in ``keep``. The window is the
    host span ``span`` of a trace."""
    sync(device)
    inflight = collections.deque()
    latencies, kept, failed = [], {}, 0
    i = t0 = t_end = 0

    def wait_oldest():
        nonlocal t_end
        t_disp, ev = inflight.popleft()
        with record_function("portbench.wait"):
            ev.synchronize()
        t_end = time.perf_counter()
        latencies.append(t_end - t_disp)

    # the cyclic garbage collector runs before the window, not in it
    gc.collect()
    gc.disable()
    try:
        with record_function(span):
            t0 = t_end = time.perf_counter()
            while i < min_calls or time.perf_counter() - t0 < seconds:
                t_disp = time.perf_counter()
                with record_function("portbench.call"):
                    try:
                        out = call(pool[i % len(pool)])
                    except (RuntimeError, ValueError) as exc:
                        failed += 1
                        print(f"call {i} failed: {exc!r}", flush=True)
                        out = None
                    ev = mark(device)
                if i in keep:
                    kept[i] = out
                inflight.append((t_disp, ev))
                i += 1
                if len(inflight) >= depth:
                    wait_oldest()
            while inflight:
                wait_oldest()
    finally:
        gc.enable()
    return {"calls": i, "failed": failed, "t0": t0, "t_end": t_end,
            "latencies": latencies, "kept": kept}
