#!/usr/bin/env python3
"""How far the reference train step's gradients lie from their exact
values in the encoder's two forms of stages 0+1: the plain ``ConvBlock``
pair and the space-to-depth pair (``liftreg_tpu_torch/models/s2d.py``).

    python3 tools/torch_s2d_step_precision.py [--runs 5] [--steps 10]
        [--points 1] [--out FILE]

It writes ``chip_smoke.py``'s training dataset (the reference config:
160^3, B = 30, 4 views on 240^2, latent 56, f32) under
``build/s2d_step_precision/``, takes ``--steps`` steps of the plain
trainer on its batch (the train phase's count: 3 epochs, the resumed one
and 6 steps alone), and at that one point:

* ``runs``: with ``torch.use_deterministic_algorithms`` off and then on,
  ``--runs`` times the step's gradients of each form
  (``train.trainer.loss_and_grads``, the s2d step first, as the s2d phase
  of ``chip_smoke.py`` takes them), and per leaf the pair's largest
  difference relative to the plain leaf's largest value (the quantity
  that phase holds to ``S2D_STEP_GRAD_RTOL``) and each form's spread over
  the runs (the largest difference from its first run, relative likewise);
* ``f64``, at that point and after each of ``--points`` - 1 more steps:
  the stage input and the cotangent at stage 1's output of each form's
  step, captured with hooks, and the exact weight and bias gradients of
  stages 0 and 1 for each cotangent, from f64 convolutions on the card
  (two rows at a time, summed in f64); per leaf each form's error against
  the f64 gradient of its own cotangent, relative to the f64 leaf's
  largest value; the pair's difference on every leaf; and how far the two
  cotangents differ (their largest difference relative to the plain one's
  largest value, and how many elements differ by more than 1e-6, 1e-4
  and 1e-2 of it).

One JSON line each, the card's name and power limit first; the dataset is
removed at the end. Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STAGE_LEAVES = ("encoder.convs.0.conv.weight", "encoder.convs.0.conv.bias",
                "encoder.convs.1.conv.weight", "encoder.convs.1.conv.bias")
F64_ROWS = 2


def _emit(out, **line):
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


def _rel(a, b):
    """Largest |a - b| relative to b's largest value."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


class StageTap:
    """Hooks on a SubspaceEncoder: its input, and the cotangent of the
    output of its stage 1 (the input of stage 2), of the last forward and
    backward."""

    def __init__(self, encoder):
        self.x0 = self.dy1 = None

        def take_input(module, args):
            self.x0 = args[0].detach()

        def take_cotangent(module, args):
            x = args[0]
            if x.requires_grad:
                x.register_hook(self._keep)

        self.handles = [encoder.register_forward_pre_hook(take_input),
                        encoder.convs[2].register_forward_pre_hook(
                            take_cotangent)]

    def _keep(self, g):
        self.dy1 = g.detach().clone()

    def remove(self):
        for h in self.handles:
            h.remove()


def exact_stage_grads(torch, F, encoder, x0, dy1, slope):
    """dw0, db0, dw1, db1 of stages 0+1 in f64 for input ``x0`` and stage
    1's output cotangent ``dy1``, F64_ROWS rows at a time."""
    c0, c1 = encoder.convs[0].conv, encoder.convs[1].conv
    leaves = [p.detach().double().requires_grad_(True)
              for p in (c0.weight, c0.bias, c1.weight, c1.bias)]
    w0, b0, w1, b1 = leaves
    sums = [torch.zeros_like(p) for p in leaves]
    for i in range(0, x0.shape[0], F64_ROWS):
        y = F.leaky_relu(F.conv3d(x0[i:i + F64_ROWS].double(), w0, b0,
                                  padding=1), slope)
        y = F.leaky_relu(F.conv3d(y, w1, b1, stride=2, padding=1), slope)
        for s, g in zip(sums, torch.autograd.grad(
                y, leaves, dy1[i:i + F64_ROWS].double())):
            s += g
        del y
    return dict(zip(STAGE_LEAVES, sums))


def f64_line(torch, F, tr, tr_s, grads, step):
    """Each form's stage gradients against the f64 ones of its own stage
    input and cotangent, the pair's difference on every leaf, and how far
    the two cotangents at stage 1's output differ."""
    t0 = time.perf_counter()
    line = {"phase": "f64", "step": step, "rows_at_a_time": F64_ROWS}
    taps, found = {}, {}
    for form, trainer in (("s2d", tr_s), ("plain", tr)):
        tap = StageTap(trainer.model.encoder)
        try:
            found[form] = grads(trainer)[1]
        finally:
            tap.remove()
        taps[form] = tap
    dy = (taps["s2d"].dy1 - taps["plain"].dy1).abs()
    top = float(taps["plain"].dy1.abs().max())
    line["cotangent_rel_diff"] = float(dy.max()) / top
    # how many of its elements differ by more than each share of its
    # largest value: a few large differences are a kink of a LeakyReLU
    # downstream taken on the other side, many small ones rounding
    line["cotangent_elements_over"] = {
        str(r): int((dy > r * top).sum()) for r in (1e-6, 1e-4, 1e-2)}
    line["cotangent_elements"] = dy.numel()
    line["input_equal"] = bool(torch.equal(taps["s2d"].x0, taps["plain"].x0))
    slope = tr.model.encoder.convs[0].negative_slope
    exact = {}
    for form in ("s2d", "plain"):
        exact[form] = exact_stage_grads(torch, F, tr.model.encoder,
                                        taps[form].x0, taps[form].dy1, slope)
        line[f"{form}_vs_f64"] = {k: _rel(found[form][k], exact[form][k])
                                  for k in STAGE_LEAVES}
        line[f"{form}_vs_f64_l2"] = {
            k: float((found[form][k].double() - exact[form][k]).norm()
                     / exact[form][k].norm()) for k in STAGE_LEAVES}
    line["f64_cotangents_rel_diff"] = {
        k: _rel(exact["s2d"][k], exact["plain"][k]) for k in STAGE_LEAVES}
    pair = {k: _rel(found["s2d"][k], g) for k, g in found["plain"].items()}
    line["pair_stage_leaves"] = {k: pair[k] for k in STAGE_LEAVES}
    line["pair_max"] = max(pair.values())
    line["pair_argmax"] = max(pair, key=pair.get)
    line["pair_max_other_leaves"] = max(v for k, v in pair.items()
                                        if k not in STAGE_LEAVES)
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--points", type=int, default=1,
                    help="f64 lines at this many points, a step apart")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)

    # cuBLAS needs a fixed workspace for deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("torch_s2d_step_precision: needs a CUDA card")

    import chip_smoke as cs
    from liftreg_tpu_torch.ops import _build, drr
    from liftreg_tpu_torch.ops.drr_kernel import project_taps
    from liftreg_tpu_torch.train import RegistrationTrainer
    from liftreg_tpu_torch.train.trainer import loss_and_grads

    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _emit(args.out, device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    os.environ["LIFTREG_NO_TB"] = "1"
    dev = torch.device("cuda")
    root = REPO / "build" / "s2d_step_precision"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        data = str(root / "data")
        cs.write_train_dataset(torch, F, drr, project_taps, data, cs.SZ,
                               cs.TRAIN_B, cs.TRAIN_VAL, cs.TRAIN_DISTINCT,
                               cs.LATENT, 4,
                               torch.Generator(device=dev).manual_seed(3),
                               dev)
        tr = RegistrationTrainer(cs.train_setting(
            cs.TRAIN_CONFIG, data, str(root / "out"), epoch=0,
            debug_on=False))
        cfg = cs.train_setting(cs.TRAIN_CONFIG, data, str(root / "out_s2d"),
                               epoch=0, debug_on=False)
        cfg["train"]["model"]["s2d_encoder"] = True
        tr_s = RegistrationTrainer(cfg)
        batch, names = next(iter(tr._iter_device("train", 0)))
        for _ in range(args.steps):
            tr.step(batch, names)
        tr._pending_losses.clear()
        tr_s.model.load_state_dict(tr.model.state_dict())
        reg = tr.loss.factor(tr.cur_epoch)
        weights = tr._weights(len(names))
        _emit(args.out, phase="point", steps=args.steps, batch=len(names),
              seconds=round(time.perf_counter() - t0, 3))

        def grads(trainer):
            return loss_and_grads(trainer.model, trainer.loss,
                                  trainer.params, batch, trainer.pca, reg,
                                  weights, trainer.mesh)

        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            torch.backends.cudnn.deterministic = det
            t0 = time.perf_counter()
            pair, first, spread = [], {}, {"plain": {}, "s2d": {}}
            for _ in range(args.runs):
                got = grads(tr_s)[1]
                want = grads(tr)[1]
                pair.append({k: _rel(got[k], g) for k, g in want.items()})
                for form, gr in (("s2d", got), ("plain", want)):
                    if form not in first:
                        first[form] = gr
                        continue
                    for k, g in gr.items():
                        spread[form][k] = max(spread[form].get(k, 0.0),
                                              _rel(g, first[form][k]))
            worst = {k: max(p[k] for p in pair) for k in pair[0]}
            top = sorted(worst, key=worst.get, reverse=True)[:6]
            _emit(args.out, phase="runs", deterministic=det, runs=args.runs,
                  pair_max_per_run=[max(p.values()) for p in pair],
                  pair_argmax_per_run=[max(p, key=p.get) for p in pair],
                  pair_worst_leaves={k: worst[k] for k in top},
                  pair_stage_leaves_per_run=[
                      {k: p[k] for k in STAGE_LEAVES} for p in pair],
                  spread_max={f: max(s.values(), default=0.0)
                              for f, s in spread.items()},
                  spread_stage_leaves={f: {k: s.get(k, 0.0)
                                           for k in STAGE_LEAVES}
                                       for f, s in spread.items()},
                  seconds=round(time.perf_counter() - t0, 3))
            del first, got, want
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False

        # the exact stage gradients at this point and after each of
        # --points - 1 more steps, for each form's own stage input and
        # cotangent
        for point in range(args.points):
            if point:
                tr.step(batch, names)
                tr._pending_losses.clear()
                tr_s.model.load_state_dict(tr.model.state_dict())
            _emit(args.out, **f64_line(torch, F, tr, tr_s, grads,
                                       args.steps + point))
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
