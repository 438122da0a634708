"""Train-step time on the card: ms a step for any model and config on a
dataset; the port of ``tools/bench_train_step.py``.

Builds the production ``RegistrationTrainer`` on ``--data`` with the
chosen model family and knobs, trains ``--epochs`` (the trainer's
``epoch``, its last epoch: 0 is one epoch) into a throwaway experiment
folder, and reads ``Train/step_time_ms`` from the trainer's own metrics
log (``train/trainer.py``: host time from one loss flush to the next,
which reads the losses back and so waits for the card, divided by the
steps flushed). The steady state is the mean over the last half of the
logged steps, so the first flush, which holds the first step's kernel
build and cuDNN's first calls, is left out, as the JAX tool does.

For ``subspace_backproj`` and ``subspace`` the basis is ``--data``'s
``pca/`` (its latent must be ``--latent``); the JAX tool names none, so
there they train without one. ``--fast_vjp`` is not taken: it picks
between two JAX warp VJPs of the same gradient, and the port has one warp
backward (ROADMAP A.9).

Prints one JSON line: the card's name and power limit, then
``metric: train_step_time_ms``, ``value`` (ms a step, steady state),
``all_flushes_ms`` (one per logged step), the model and knobs, the steps
and validation batches run, and ``launches`` (the counted kernels'
launches over the whole run). Runs on the CUDA card; ``--device cpu``
runs the plain versions on the host clock.

Usage:
  python tools/torch_bench_train_step.py --data DATA --model regnet2d3d \
      --inverse_iters 2 --s2d [--epochs 1] [--batch 1] [--keep]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_timing  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402


def setting(args, exp):
    """The JAX tool's task setting, with the basis of ``--data``."""
    from liftreg_tpu_torch.utils.settings import default_task_setting
    s = default_task_setting(args.data, exp, args.size, overrides={
        "train": {
            "epoch": args.epochs,
            "model": {"latent_dim": args.latent, "s2d_encoder": args.s2d},
            "save_fig": False,
            "save_fig_frequency": 1000,
            "save_model_frequency": 1000,
            "log_flush_steps": 2,
        },
    })
    s["train"]["dataloader"]["batch_size"] = args.batch
    if args.model == "regnet2d3d":
        s["dataset"]["dataset_class"] = "registration2d3d_projloss"
        s["dataset"]["apply_hu_clip"] = False
        s["train"]["model_class"] = "regnet2d3d"
        s["train"]["loss_class"] = "regnet2d3d"
        s["train"]["model"] = {"drr_feature_num": 4,
                               "s2d_encoder": args.s2d,
                               "inverse_iters": args.inverse_iters}
        s["train"]["optim"]["lr"] = 5e-4
    else:
        s["train"]["model_class"] = args.model
        s["train"]["model"]["pca_path"] = os.path.join(args.data, "pca")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--model", default="regnet2d3d",
                    choices=("regnet2d3d", "subspace_backproj", "subspace"))
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--inverse_iters", type=int, default=2)
    ap.add_argument("--s2d", action="store_true")
    ap.add_argument("--keep", action="store_true",
                    help="keep the throwaway experiment folder")
    torch_timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from liftreg_tpu_torch.train import RegistrationTrainer

    os.environ.setdefault("LIFTREG_NO_TB", "1")
    exp = tempfile.mkdtemp(prefix="bench_train_")
    try:
        print(f"model={args.model} s2d={args.s2d} batch={args.batch} "
              f"inverse_iters={args.inverse_iters}", flush=True)
        trainer = RegistrationTrainer(setting(args, exp), device=device)
        torch_timing.zero_launches()
        trainer.run()
        torch_timing.sync(device)
        launches = torch_timing.launches()
        times = []
        with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("tag") == "Train/step_time_ms":
                    times.append(float(rec["value"]))
    finally:
        if not args.keep:
            shutil.rmtree(exp, ignore_errors=True)
    steady = times[len(times) // 2:]
    return torch_timing.emit(
        device, "torch_bench_train_step", metric="train_step_time_ms",
        value=sum(steady) / max(1, len(steady)),
        unit="ms/step (steady-state)", all_flushes_ms=times,
        model=args.model, s2d=args.s2d, batch=args.batch, size=args.size,
        latent=args.latent, inverse_iters=args.inverse_iters,
        steps=trainer.global_step["train"],
        val_batches=trainer.global_step["val"], launches=launches,
        experiment=exp if args.keep else None)


if __name__ == "__main__":
    main()
