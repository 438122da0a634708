"""The port's spans (``liftreg_tpu_torch/tracing.py``) on the CPU, at
tests/test_torch_serving.py's size (16^3, latent 8, B = 2): read back from
the profiler's Chrome trace, as the benchmark's span reader reads the
card's.

* A projection-refined ``register_projections`` records
  ``liftreg.refine.step`` ``refine_steps + 1`` times a call, each holding
  one ``.forward`` (with the losses' spans), one ``.backward`` and one
  ``.update``, all inside ``liftreg.refine`` inside
  ``liftreg.entry.register_projections``.
* ``register`` records the model's four spans, in order.
* A train step records ``liftreg.train.step`` with its forward, backward,
  update and the losses' flush.
* With no profiler running ``span`` is one shared no-op; the outputs are
  bit-equal with and without a profiler; the exported serving program
  holds no profiler op, exported with or without one running.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liftreg_tpu_torch import RegistrationPipeline, serving, tracing
from liftreg_tpu_torch.ops import drr
from liftreg_tpu_torch.ops.drr_kernel import project

from torch_train_data import setting, write_dataset

SZ, L, B, STEPS = 16, 8, 2, 3
IMG = (SZ,) * 3
MODEL = ("liftreg.model.lift", "liftreg.model.encoder", "liftreg.model.pca",
         "liftreg.model.warp")


def _basis():
    rng = np.random.default_rng(0)
    n = 3 * SZ ** 3
    return {"vectors": torch.from_numpy(
        (rng.standard_normal((L, n)) * 0.01).astype(np.float32)),
        "mean": torch.from_numpy(
            (rng.standard_normal(n) * 0.01).astype(np.float32))}


def _pipe(**kw):
    torch.manual_seed(0)
    return RegistrationPipeline(IMG, latent_dim=L, device="cpu", **kw)


def _cases(pipe, seed=0):
    rng = np.random.default_rng(seed)
    src, tgt = (torch.from_numpy(
        rng.uniform(-1000, 0, (B, 1) + IMG).astype(np.float32))
        for _ in range(2))
    seg = torch.from_numpy(
        (rng.uniform(size=(B, 1) + IMG) > 0.4).astype(np.float32))
    proj = drr.normalize_drr(project(drr.calc_relative_atten_coef(
        tgt[:, 0]), pipe.poses, pipe.resolution, pipe.spacing))
    return src, tgt, seg, proj


def _spans(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; returns its result and the
    ``liftreg.`` spans of the trace as (name, start, end), in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                   for ev in events
                   if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                   and ev["name"].startswith(tracing.PREFIX))
    return out, [(name, s, e) for s, e, name in spans]


def _inside(spans, outer):
    _, s0, e0 = outer
    return [sp for sp in spans if sp is not outer and s0 <= sp[1]
            and sp[2] <= e0]


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def test_refined_call_records_each_step(tmp_path):
    pipe = _pipe(refine_steps=STEPS, refine_domain="projection")
    pca = _basis()
    src, _, seg, proj = _cases(pipe)
    _, spans = _spans(lambda: pipe.register_projections(pca, src, proj, seg),
                      tmp_path)
    (entry,) = _named(spans, "liftreg.entry.register_projections")
    (refine,) = _named(spans, "liftreg.refine")
    assert refine in _inside(spans, entry)
    in_refine = _inside(spans, refine)
    steps = _named(spans, "liftreg.refine.step")
    assert len(steps) == STEPS + 1
    for name in ("liftreg.refine.taps", "liftreg.refine.select"):
        assert len(_named(in_refine, name)) == 1, name
    for step in steps:
        assert step in in_refine
        inner = _inside(spans, step)
        for part in ("forward", "backward", "update"):
            assert len(_named(inner, "liftreg.refine." + part)) == 1, part
        (fwd,) = _named(inner, "liftreg.refine.forward")
        losses = {sp[0] for sp in _inside(spans, fwd)}
        assert losses == {"liftreg.loss.similarity",
                          "liftreg.loss.regulariser"}
    # the model's spans run once, before the refinement
    for name in MODEL:
        (sp,) = _named(spans, name)
        assert sp in _inside(spans, entry) and sp[2] <= refine[1]


def test_register_records_the_model_spans(tmp_path):
    pipe = _pipe()
    pca = _basis()
    src, tgt, seg, _ = _cases(pipe)
    _, spans = _spans(lambda: pipe.register(pca, src, tgt, seg, seg),
                      tmp_path)
    (entry,) = _named(spans, "liftreg.entry.register")
    model = [sp for sp in spans if sp[0].startswith("liftreg.model.")]
    assert [sp[0] for sp in model] == list(MODEL)
    assert all(sp in _inside(spans, entry) for sp in model)
    assert all(a[2] <= b[1] for a, b in zip(model, model[1:]))
    assert not _named(spans, "liftreg.refine")


def test_train_step_records_the_train_spans(tmp_path):
    os.environ["LIFTREG_NO_TB"] = "1"
    from liftreg_tpu_torch.train import RegistrationTrainer
    root = write_dataset(str(tmp_path / "data"))
    tr = RegistrationTrainer(setting(root, str(tmp_path / "exp"),
                                     log_flush_steps=1), device="cpu")
    batch, names = next(iter(tr._iter_device("train", 0)))
    _, spans = _spans(lambda: tr.step(batch, names), tmp_path)
    (step,) = _named(spans, "liftreg.train.step")
    inner = _inside(spans, step)
    for part in ("forward", "backward", "update", "flush"):
        assert len(_named(inner, "liftreg.train." + part)) == 1, part
    (fwd,) = _named(inner, "liftreg.train.forward")
    in_fwd = {sp[0] for sp in _inside(spans, fwd)}
    assert in_fwd >= set(MODEL) | {"liftreg.loss.similarity",
                                   "liftreg.loss.regulariser"}
    order = [_named(inner, "liftreg.train." + p)[0]
             for p in ("forward", "backward", "update", "flush")]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = tracing.span("refine.step")
    assert off is tracing.span("model.encoder")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.span("refine.step")
        assert on is not off
        assert isinstance(on, torch.autograd.profiler.record_function)
    assert tracing.span("refine.step") is off


@pytest.mark.parametrize("entry", serving.ENTRIES)
def test_outputs_bit_equal_under_the_profiler(entry):
    def call():
        pipe = _pipe(refine_steps=STEPS, refine_domain="projection")
        src, tgt, seg, proj = _cases(pipe)
        if entry == "register":
            warped, phi = pipe.register(_basis(), src, tgt, seg, seg)
        else:
            warped, phi = pipe.register_projections(_basis(), src, proj, seg)
        return warped, phi, pipe.last_refine["total_history"]

    plain = call()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = call()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("profiled", [False, True])
def test_exported_program_holds_no_profiler_op(profiled):
    pipe = _pipe()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            program = serving._export_program(pipe, _basis(), B)
    else:
        program = serving._export_program(pipe, _basis(), B)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets
    assert not [t for t in targets if "profiler" in t]
