"""The reference against the port at a test's size on the CPU, and the
control (the reference one step below the stated precision, in the
program's place) failing the cell's limits. The float32 cell's control is
TF32, which only a card computes: its test needs one."""
import pytest
import torch

import tiny
from portbench import control
from portbench.lib import catalog

SERVE = [w["name"] for w in catalog.benchmark()["workloads"]
         if catalog.traffic(w["traffic"])["kind"] == "serve"]


def _readings(workload, device="cpu"):
    ov = tiny.overrides(workload) if device == "cpu" else None
    return list(control.readings(workload, [11, 12, 13], 3, device=device,
                                 overrides=ov))


def _judge(workload, rows):
    verdicts = control.judge(workload, rows)
    assert {v[1] for v in verdicts} >= {"program", "control"}
    assert all(v[3] for v in verdicts), (verdicts, rows)


@pytest.mark.parametrize("workload", SERVE)
def test_control_fails_and_program_passes(workload):
    _judge(workload, _readings(workload))


@pytest.mark.cuda
def test_control_fails_on_the_card_train():
    if not torch.cuda.is_available():
        pytest.skip("TF32, the f32 cell's control, needs a CUDA card")
    _judge("train_ref_b30_f32", _readings("train_ref_b30_f32", "cuda"))
