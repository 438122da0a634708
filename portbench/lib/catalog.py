"""Where the benchmark's parts are found by name: ``BENCHMARK.json`` at the
root of the checkout, and under ``portbench/`` a file for each
configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), metric reader (``metrics/<name>.py``),
operation's roofline count (``rooflines/<name>.py``) and cell's limits
(``limits/<workload>.json``). Adding a cell, a metric or a roofline count
adds files; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(CHECKOUT / "BENCHMARK.json")


def workload(bench, name):
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name):
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name):
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(workload_name):
    return _json(BENCH_DIR / "limits" / f"{workload_name}.json")


def _module(path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name):
    """The module of ``metrics/<metric_name>.py``; its ``read(run)`` gives
    the metric's value, or None where the run has nothing to read."""
    return _module(BENCH_DIR / "metrics" / f"{metric_name}.py")


def rooflines():
    """{operation: module} of every file under ``rooflines/``."""
    return {p.stem: _module(p)
            for p in sorted((BENCH_DIR / "rooflines").glob("*.py"))}


def metrics_of(bench, workload_name, traced):
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced; a metric with a
    ``workloads`` key only in the cells it lists."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload_name in m["workloads"]]
