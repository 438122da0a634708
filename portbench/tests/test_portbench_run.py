"""Runs of each cell at a CPU test's size (``tiny.py``): the result line's
keys, the check against the reference passing, and the faults that a
cell can have making ``correct`` false."""
import contextlib
import io
import json

import pytest
import torch

import tiny
from portbench.lib import catalog, cell

WORKLOADS = [w["name"] for w in catalog.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(workload, hooks=None, trace=0):
    return cell.run(tiny.argv(workload, trace=trace), device="cpu",
                    overrides=tiny.overrides(workload), hooks=hooks)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cell.main(tiny.argv("serve_b4_stream", trace=trace),
                       device="cpu",
                       overrides=tiny.overrides("serve_b4_stream"))
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"reg_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_at_test_size(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def _alter_answer(system):
    """An answer altered where it is produced: phi of one case moved by a
    voxel along one axis."""
    register = system.pipe.register_projections \
        if system.entry != "register" else system.pipe.register
    n = system.pipe.img_sz[0]

    def altered(*args, **kw):
        warped, phi = register(*args, **kw)
        phi = phi.clone()
        phi[0, 0] += 2.0 / (n - 1)
        return warped, phi
    setattr(system.pipe, system.entry, altered)


def _half_batch_serve(system):
    """Half of the batch left out: the first half's answers stand for the
    rest."""
    register = getattr(system.pipe, system.entry)

    def half(pca, *tensors):
        h = tensors[0].shape[0] // 2
        warped, phi = register(pca, *(t[:h] for t in tensors))
        if system.pipe.last_refine is not None:
            coefs = system.pipe.last_refine["coefs"]
            system.pipe.last_refine["coefs"] = torch.cat([coefs, coefs])
        return torch.cat([warped, warped]), torch.cat([phi, phi])
    setattr(system.pipe, system.entry, half)


def _unchanged_state(system):
    """A step that returns its state unchanged."""
    tx = system.trainer.tx

    class Frozen:
        def update(self, grads, state, params):
            return {k: torch.zeros_like(p) for k, p in params.items()}, state
    system.trainer.tx = Frozen()
    system.trainer.tx.init = tx.init


def _half_batch_train(system):
    """Half of the batch left out, the mean taken over the rest: the
    second half's rows replaced by the first half's."""
    step = system.trainer.step

    def half(batch, names):
        h = batch["source"].shape[0] // 2
        batch = {k: torch.cat([v[:h], v[:h]]) for k, v in batch.items()}
        return step(batch, names)
    system.trainer.step = half


SERVE_FAULTS = [_alter_answer, _half_batch_serve]


def test_refinement_step_unchanged_is_not_correct(monkeypatch):
    """A refinement step that returns its state unchanged: the unrefined
    coefficients come back."""
    from liftreg_tpu_torch import refine
    monkeypatch.setattr(refine.Adam, "step", lambda self, z, g: z)
    res = _run("serve_b4_projrefine30")
    assert not res["correct"], res["checks"]



def _doubled_rate(monkeypatch):
    """Adam at twice the configured rate."""
    from liftreg_tpu_torch import refine
    init = refine.Adam.__init__
    monkeypatch.setattr(refine.Adam, "__init__",
                        lambda self, z, lr: init(self, z, 2 * lr))


def _no_bias_correction(monkeypatch):
    """Adam without its bias corrections."""
    from liftreg_tpu_torch import refine

    def step(self, z, g):
        self.mu = (1 - refine.ADAM_B1) * g + refine.ADAM_B1 * self.mu
        self.nu = (1 - refine.ADAM_B2) * g ** 2 + refine.ADAM_B2 * self.nu
        return z - self.lr * self.mu / (self.nu.sqrt() + refine.ADAM_EPS)
    monkeypatch.setattr(refine.Adam, "step", step)


@pytest.mark.parametrize("fault", [_doubled_rate, _no_bias_correction],
                         ids=lambda f: f.__name__)
def test_wrong_refinement_update_is_not_correct(monkeypatch, fault):
    """A refinement update that is wrong but still descends: its
    objective history leaves the reference's."""
    fault(monkeypatch)
    res = _run("serve_b4_projrefine30")
    assert not res["correct"], res["checks"]
    history = res["checks"]["history_gap"]
    assert history["value"] > history["limit"], res["checks"]


TRAIN_FAULTS = [_unchanged_state, _half_batch_train]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in WORKLOADS
    for f in (TRAIN_FAULTS if w.startswith("train") else SERVE_FAULTS)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(workload, fault):
    res = _run(workload, hooks=fault)
    assert not res["correct"], res["checks"]
