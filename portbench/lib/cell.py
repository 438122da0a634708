"""One run of one cell: set up, warm up, measure (or trace) for the
window, check the window's results against the reference, print the
result line.

The result line (the last line of standard output) holds ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
untraced, its per-layer metrics traced), ``device``, with a trace
``breakdown``, and last ``checks``: each number compared with its value
and limit. The same numbers end standard error.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np

#: top-level module names that may not be loaded: JAX, its libraries and
#: the JAX package that the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "liftreg_tpu")


class Refused(Exception):
    """The run cannot be made here; nothing is printed on standard
    output."""


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_indices(seed, span, n):
    """The ``n`` calls of the first ``span`` whose results are checked,
    drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 63, 3]))
    return set(int(k) for k in rng.choice(span, size=min(n, span),
                                          replace=False))


def _device(chips, device):
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA device(s); "
                      f"torch.cuda.is_available()="
                      f"{torch.cuda.is_available()}, "
                      f"device_count()={torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def run(argv=None, t_start=None, device=None, overrides=None, hooks=None):
    """Run a cell as ``portbench/run.py`` does; returns the result dict.

    For tests: ``device`` skips the look for a card (``"cpu"`` runs the
    kernels' plain versions); ``overrides`` ({"config": {...}, "traffic":
    {...}}) updates the configuration and traffic; ``hooks`` (a callable)
    gets the built program before the first call, to break it."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    # the trainer's TensorBoard mirror imports TensorFlow where it is
    # installed, which loads JAX: its JSON metrics log is kept
    os.environ["LIFTREG_NO_TB"] = "1"
    import torch
    from torch.profiler import record_function

    from portbench.lib import catalog, check, inputs, loops, program, trace
    from portbench.lib.readers import Run, finite
    from portbench.reference.liftreg import LiftReg

    bench = catalog.benchmark()
    wl = catalog.workload(bench, args.workload)
    cfg = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    for key, part in (overrides or {}).items():
        {"config": cfg, "traffic": traffic}[key].update(part)
    metrics = catalog.metrics_of(bench, args.workload, bool(args.trace))
    readers = {m["name"]: catalog.reader(m["name"]) for m in metrics}
    limits = catalog.limits(args.workload)
    dev = _device(int(wl["chips"]), device)
    seed = args.seed
    kind = traffic["kind"]
    batch = int(traffic["batch"])
    depth = int(traffic.get("in_flight", 1))

    marks = [("imports", time.perf_counter())]
    maker = LiftReg(cfg, dev)
    w = inputs.weights(seed, cfg, dev)
    pca = inputs.basis(seed, cfg, dev)
    marks.append(("weights", time.perf_counter()))
    workdir = tempfile.TemporaryDirectory(prefix="portbench_")
    if kind == "serve":
        pool = inputs.serve_pool(seed, cfg, batch, int(traffic["pool"]),
                                 maker, dev)
        system = program.Server(cfg, traffic, w, pca, dev)
        marks.append(("pool and program", time.perf_counter()))
        if hooks:
            hooks(system)
        for j in range(int(traffic["warm_calls"])):
            system(pool[j % len(pool)])
        if traffic.get("unrefined_calls") and args.trace:
            system.unrefined(pool[0])
        keep = check_indices(seed, int(traffic["check_span"]),
                             int(traffic["check_calls"]))
        min_calls = int(traffic["check_span"])
    elif kind == "train":
        if int(cfg["setting"]["train"]["dataloader"]["batch_size"]) != batch:
            raise ValueError("the traffic's batch is not the setting's")
        pool = inputs.train_pool(seed, cfg, batch, int(traffic["pool"]),
                                 maker, dev)
        system = program.Trainer(cfg, w, pca, dev, workdir.name)
        marks.append(("pool and program", time.perf_counter()))
        if hooks:
            hooks(system)
        # the checked steps: the window's own call on its own batches
        steps = [pool[j % len(pool)]
                 for j in range(int(traffic["warm_calls"]))]
        prog = system.checked_steps(steps, w)
        keep, min_calls = set(), 1
    else:
        raise ValueError(f"traffic kind {kind!r} not in ('serve', 'train')")
    loops.sync(dev)

    tr = traced = launches = None
    phases = {}
    if args.trace:
        min_calls = max(min_calls, int(traffic.get("trace_calls", 1)))
        program.zero_counters()
        prof = trace.profiler()
        with prof:
            window = loops.closed_loop(system, pool, dev, depth,
                                       float(traffic["trace_seconds"]),
                                       min_calls, keep)
            launches = program.read_counters()
            n_unref = int(traffic.get("unrefined_calls", 0))
            if n_unref:
                with record_function("portbench.unrefined"):
                    for j in range(n_unref):
                        system.unrefined(pool[j % len(pool)])
                    loops.sync(dev)
        tr = trace.export(prof, os.path.join(workdir.name, "trace"))
        traced = tr.phase("portbench.window")
        if n_unref:
            span = tr.phase("portbench.unrefined")
            phases["unrefined"] = (tr.busy_s(*span), n_unref)
    else:
        window = loops.closed_loop(system, pool, dev, depth, args.seconds,
                                   min_calls, keep)
    setup_s = window["t0"] - t_start
    marks.append(("warm-up", window["t0"]))
    print("setup " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks])), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    setting = cfg.get("setting")
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    low, tf32 = check.precision_of(cfg)
    reference = LiftReg(cfg, dev, low=low, tf32=tf32,
                        geometry=maker.geometry)
    if kind == "serve":
        numbers = check.serve_numbers(traffic, window["kept"], pool, w, pca,
                                      reference)
    else:
        numbers = check.train_numbers(prog, reference, w, pca, steps,
                                      setting)
    window["kept"] = None
    checks, within = check.verdict(numbers, limits)
    correct = window["failed"] == 0 and within

    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that the benchmark forbids: {found}")

    data = Run(cfg=cfg, traffic=traffic, window=window, setup_s=setup_s,
               trace=tr, traced=traced, launches=launches, phases=phases)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(data)
        if finite(v):
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": window["calls"] * (batch if kind == "serve"
                                              else 1),
              "failed": window["failed"] * (batch if kind == "serve"
                                            else 1),
              "metrics": values, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s(*traced)
        device_info["window_s"] = traced[1] - traced[0]
        result["breakdown"] = trace.breakdown(tr, *traced)
    result["checks"] = checks
    workdir.cleanup()
    return result


def main(argv=None, t_start=None, **test_options):
    """Print the result line of a run (``test_options``: :func:`run`'s);
    returns the exit code."""
    try:
        result = run(argv, t_start, **test_options)
    except Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 3
    line = json.dumps(result)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
