"""Run one cell traced, as ``portbench/run.py --trace 1`` does, and read
the port's ``liftreg.`` spans from the whole Chrome trace
(:class:`lib.spans.Spans`), from the root of a checkout:

    python3 portbench/span_table.py --workload <name> --seed <n> \
        --seconds <s>

Prints on standard error the table a call of each span (count, host ms
inclusive and self, device ms inclusive, self and of its backward, idle
ms by label, blocking calls), and last one JSON line: the run's
``correct`` and per-layer metrics, the share of the window's device time
matched to a launch call and the longest lead of an operation over its
launch (``match``), the idle seconds by label, the per-layer quantities
read from the spans (``by_span``), the device ms a call launched under no
span, the refined cells' device ms a call of ``liftreg.refine`` against
a refined call's less an unrefined one's, and the host µs of one
``span()`` with no profiler running.
"""
import json
import os
import sys
import timeit

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", os.path.join(
    CHECKOUT, "build", "portbench", "torch_kernels"))
sys.path.insert(0, CHECKOUT)

from portbench.lib import cell, spans, trace  # noqa: E402


def traced_run(argv, **options):
    """:func:`cell.run` of ``argv`` with ``--trace 1``, keeping the
    exported Chrome trace; returns (result, :class:`spans.Spans`)."""
    kept = []

    class Keep(trace.Trace):
        def __init__(self, path):
            super().__init__(path)
            kept.append(spans.Spans(path, self))

    original, trace.Trace = trace.Trace, Keep
    try:
        result = cell.run(list(argv) + ["--trace", "1"], **options)
    finally:
        trace.Trace = original
    return result, kept[-1]


def _count(tr, name, start, end):
    return sum(1 for s, e in tr.spans.get(name, ()) if start <= s and
               e <= end)


def by_span(att, calls, window_s, has_device):
    """The per-layer quantities that the spans give, by the names of the
    metrics that would read them (device ms None without device
    operations; counts 0 where none was counted)."""
    rows = att["rows"]

    def get(name, key):
        r = rows.get(name)
        return r[key] if r else 0.0

    def device_ms(total_s, n):
        return 1e3 * total_s / n if has_device and n else None

    step = rows.get("liftreg.refine.step")
    out = {
        "refine_step_device_ms": device_ms(
            get("liftreg.refine.step", "device_s"), step and step["count"]),
        "refine_step_host_ms": (1e3 * (step["host_s"] - step["blocked_s"])
                                / step["count"] if step else None),
        "regulariser_device_ms": device_ms(
            get("liftreg.loss.regulariser", "device_s")
            + get("liftreg.loss.regulariser", "backward_device_s"), calls),
        "dispatch_idle_share": 100.0 * att["gaps"]["dispatch"] / window_s,
        "host_blocks": att["blocks"] / calls,
        "encoder_device_ms": device_ms(
            get("liftreg.model.encoder", "device_s"), calls),
        "entry_device_ms": device_ms(sum(
            r["self_device_s"] for name, r in rows.items()
            if name and name.startswith("liftreg.entry.")), calls),
        "update_device_ms": device_ms(
            get("liftreg.train.update", "device_s"), calls),
    }
    return out


def read(result, sp):
    """The summary line of a traced run's result and its Chrome trace."""
    tr = sp.trace
    start, end = tr.phase("portbench.window")
    calls = _count(tr, "portbench.call", start, end)
    att = sp.attribute(start, end)
    share, lead = sp.match(start, end)
    has_device = share is not None
    busy = tr.busy_s(start, end)
    summary = {
        "correct": result["correct"], "metrics": result["metrics"],
        "calls": calls, "window_s": end - start, "busy_s": busy,
        "match": {"device_share": share, "longest_lead_s": lead},
        "idle_s": att["gaps"], "blocks_in_spans": att["blocks_by_name"],
        "by_span": by_span(att, calls, end - start, has_device),
        "unspanned_device_ms": (1e3 * att["rows"][None]["self_device_s"]
                                / calls if has_device else None),
    }
    unrefined = tr.phase("portbench.unrefined")
    refine = att["rows"].get("liftreg.refine")
    n = unrefined and _count(tr, "liftreg.model.encoder", *unrefined)
    if refine and n and has_device:
        summary["refine_check_ms"] = {
            "liftreg.refine": 1e3 * refine["device_s"] / calls,
            "refined_less_unrefined": 1e3 * (busy / calls
                                             - tr.busy_s(*unrefined) / n)}
    return summary, table(att, calls)


def table(attribution, calls):
    """Lines of a table a call: each span name's count, host ms (inclusive
    and self), device ms (inclusive, self, of its backward), idle ms by
    label and blocking calls."""
    head = ("span", "n", "host", "self", "dev", "self_dev", "bwd_dev",
            "idle_blocked", "idle_dispatch", "idle_outside", "blocks")
    lines = ["  ".join(head)]
    rows = attribution["rows"]
    for name in sorted(rows, key=lambda k: (k is None, k or "")):
        r = rows[name]
        ms = [1e3 * r[k] / calls for k in ("host_s", "self_host_s",
                                           "device_s", "self_device_s",
                                           "backward_device_s")]
        idle = [1e3 * r["idle_s"][k] / calls for k in spans.LABELS]
        lines.append("  ".join(
            [name or "(no span)", f"{r['count'] / calls:.6g}"]
            + [f"{v:.6g}" for v in ms + idle]
            + [f"{r['blocks'] / calls:.6g}"]))
    return lines


def span_off_us(n=200000):
    """Host µs of one ``with span(...)`` with no profiler running."""
    from liftreg_tpu_torch.tracing import span

    def one():
        with span("refine.step"):
            pass
    return timeit.timeit(one, number=n) / n * 1e6


def main(argv=None, **options):
    argv = sys.argv[1:] if argv is None else argv
    result, sp = traced_run(argv, **options)
    summary, lines = read(result, sp)
    summary["span_off_us"] = span_off_us()
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
