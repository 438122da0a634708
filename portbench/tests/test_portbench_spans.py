"""The span reader (``portbench/lib/spans.py``) on a hand-built Chrome
trace of one call: a kernel launched from the autograd engine's thread
inside ``liftreg.refine.backward``, a backward node whose ``Sequence
number`` is that of a forward op inside ``liftreg.loss.regulariser``, a
``cudaStreamSynchronize`` across an idle gap, a gap outside every span
and a device operation with no launch; then traced runs of the refined
and the synchronous cells at a CPU test's size."""
import json
import math

import pytest

import tiny
from portbench import span_table
from portbench.lib import spans, trace
from portbench.lib.readers import Run, finite

US = 1e-6
# (name, start, end) in µs, all on the calling thread
ANNOTATIONS = [
    ("portbench.window", 0, 600), ("portbench.call", 0, 400),
    ("liftreg.entry.register_projections", 10, 390),
    ("liftreg.refine", 50, 380), ("liftreg.refine.step", 60, 200),
    ("liftreg.refine.forward", 60, 100),
    ("liftreg.loss.regulariser", 70, 90),
    ("liftreg.refine.backward", 100, 180),
    ("liftreg.refine.update", 180, 200)]
# (correlation, launch at, thread, kernel name, start, end)
KERNELS = [(1, 80, 1, "index_select", 85, 95),
           (2, 120, 2, "index_add", 125, 140),
           (3, 190, 1, "adam", 195, 210),
           (4, 215, 1, "rewarp", 300, 350),
           (5, 385, 1, "encode", 550, 600)]


def _x(name, cat, ts, end, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": tid, "args": args}


def _events():
    evs = [_x(n, "user_annotation", s, e) for n, s, e in ANNOTATIONS]
    evs.append(_x("aten::index_select", "cpu_op", 75, 78,
                  **{"Sequence number": 7, "Fwd thread id": 0}))
    evs.append(_x("autograd::engine::evaluate_function: "
                  "IndexSelectBackward0", "cpu_op", 115, 130, tid=2,
                  **{"Sequence number": 7, "Fwd thread id": 1}))
    for corr, at, tid, name, s, e in KERNELS:
        evs.append(_x("cudaLaunchKernel", "cuda_runtime", at, at + 4,
                      tid=tid, correlation=corr))
        evs.append(_x(name, "kernel", s, e, tid=7, correlation=corr))
    evs.append(_x("cudaStreamSynchronize", "cuda_runtime", 220, 300,
                  correlation=9))
    # a fill with no launch call in the trace
    evs.append(_x("fill", "gpu_memset", 560, 570, tid=7, correlation=99))
    return evs


@pytest.fixture
def path(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    return str(p)


def _run(tr):
    return Run(cfg={}, traffic={"batch": 1}, window={"calls": 1},
               setup_s=0.0, trace=tr, traced=tr.phase("portbench.window"))


def test_attribution_by_launch_and_sequence_number(path):
    sp = spans.Spans(path)
    att = sp.attribute(0, 600 * US)
    rows = att["rows"]
    ms = lambda r, k: round(r[k] / US, 6)  # noqa: E731

    reg = rows["liftreg.loss.regulariser"]
    assert ms(reg, "self_device_s") == ms(reg, "device_s") == 10
    assert ms(reg, "backward_device_s") == 15
    # launched from the engine's thread while the caller waits inside
    # the backward span: by time, not by thread
    assert ms(rows["liftreg.refine.backward"], "self_device_s") == 15
    assert ms(rows["liftreg.refine.update"], "self_device_s") == 15
    assert ms(rows["liftreg.refine.step"], "device_s") == 40
    assert ms(rows["liftreg.refine"], "self_device_s") == 50
    assert ms(rows["liftreg.refine"], "device_s") == 90
    entry = rows["liftreg.entry.register_projections"]
    assert ms(entry, "self_device_s") == 50
    assert ms(entry, "device_s") == 140
    assert rows[None]["self_device_s"] == 0
    assert ms(rows["liftreg.refine.step"], "host_s") == 140
    assert ms(rows["liftreg.refine.step"], "self_host_s") == 0
    assert ms(rows["liftreg.refine"], "self_host_s") == 330 - 140
    assert rows["liftreg.refine.step"]["count"] == 1


def test_gap_labels_and_blocking_calls(path):
    sp = spans.Spans(path)
    att = sp.attribute(0, 600 * US)
    gaps = {k: round(v / US, 6) for k, v in att["gaps"].items()}
    # [0, 85], [95, 125], [140, 195] inside spans; [210, 300] across the
    # synchronize; [350, 550] after the call's spans closed
    assert gaps == {"dispatch": 85 + 30 + 55, "blocked": 90,
                    "outside": 200}
    assert att["blocks"] == 1
    assert att["blocks_by_name"] == {"cudaStreamSynchronize": 1}
    assert att["rows"]["liftreg.refine"]["blocks"] == 1
    assert round(att["rows"]["liftreg.refine"]["blocked_s"] / US, 6) == 80
    share, lead = sp.match(0, 600 * US)
    assert share == pytest.approx(140 / 150)
    assert lead == pytest.approx(-5 * US)
    by = span_table.by_span(att, 1, 600 * US, True)
    assert by["dispatch_idle_share"] == pytest.approx(100 * 170 / 600)
    assert by["host_blocks"] == 1
    assert by["regulariser_device_ms"] == pytest.approx(0.025)
    assert by["refine_step_device_ms"] == pytest.approx(0.040)
    assert by["entry_device_ms"] == pytest.approx(0.050)
    assert by["update_device_ms"] == 0


def test_holes_are_the_benchmark_gaps(path):
    tr = trace.Trace(path)
    window = tr.phase("portbench.window")
    assert [e - s for s, e in spans.holes(tr, *window)] == \
        [sec for _, sec in tr.gaps(*window)]


def test_readers_of_the_benchmark_trace(path):
    """From the benchmark's Trace, without runtime calls: the gap across
    the synchronize counts as dispatch."""
    run = _run(trace.Trace(path))
    assert spans.host_ms(run, "liftreg.refine.step") == pytest.approx(0.140)
    assert spans.dispatch_idle_share(run) == pytest.approx(
        100 * (170 + 90) / 600)


def test_readers_read_nothing_without_program_spans(tmp_path):
    """A program without spans (the parent of this reader) and an
    untraced run give None."""
    evs = [e for e in _events() if not e["name"].startswith("liftreg.")]
    p = tmp_path / "bare.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    run = _run(trace.Trace(str(p)))
    assert spans.host_ms(run, "liftreg.refine.step") is None
    assert spans.dispatch_idle_share(run) is None
    run.trace = None
    assert spans.dispatch_idle_share(run) is None


@pytest.mark.parametrize("workload,metrics", [
    ("serve_b4_projrefine30", ("refine_step_host_ms.projrefine",
                               "dispatch_idle_share.projrefine")),
    ("serve_b4_sync", ("dispatch_idle_share.sync",))])
def test_traced_cpu_run_reads_the_spans(workload, metrics):
    result, sp = span_table.traced_run(tiny.argv(workload), device="cpu",
                                       overrides=tiny.overrides(workload))
    assert result["correct"], result["checks"]
    for name in metrics:
        assert finite(result["metrics"][name]["value"]), name
    summary, lines = span_table.read(result, sp)
    by = summary["by_span"]
    assert by["host_blocks"] == 0
    assert by["refine_step_device_ms"] is None      # no device on the CPU
    if workload == "serve_b4_projrefine30":
        assert math.isfinite(by["refine_step_host_ms"])
        step = [ln for ln in lines if ln.startswith("liftreg.refine.step ")]
        assert float(step[0].split()[1]) == 3 + 1    # refine_steps + 1
