"""One-command DirLab run with the PyTorch port: raw ``.img`` ->
``evaluate_result.csv``.

Chains the production pipeline (the reference's four manual steps:
preprocessing, DRR generation, training, evaluation) into one CLI:

1. preprocess raw DirLab-format volumes (resample to iso spacing, body
   strip, lung masks, centre pad/crop) and write train/val + test id
   lists (``tools/torch_preprocessing.py``);
2. copy the DirLab landmark files into the dataset layout;
3. generate limited-angle DRRs + shared poses with the port's projector
   (``tools/torch_preprocessing_drr.py``);
4. obtain a PCA deformation basis (``--pca_path`` for a real basis, e.g.
   built by ``tools/torch_build_pca.py --from_experiment`` from a trained
   dense model; else a smooth random placeholder basis so that the chain
   still runs);
5. train the subspace model for ``--epochs``;
6. test the best checkpoint, save deformations, and run the landmark TRE
   evaluation -> ``<out>/exp/evaluate_result.csv``.

The last line of standard output is one JSON object, ``{"dirlab_e2e":
...}``: each stage's seconds (preprocessing per case, on the host), the
logged train step times, the train steps and validation batches, the
port's kernel launches by stage (counted by the kernels' wrappers; 0 on
the CPU), the process's peak RSS after each stage and the bytes the run
wrote under ``--out``.

Real-data usage (10 COPD cases + landmark txts), on the CUDA card:

    python tools/torch_dirlab_e2e.py --raw_path /data/copd_raw \\
        --landmarks /data/copd_landmarks --out /data/liftreg_run \\
        --pca_path /data/pca --epochs 300

``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch import pca as pca_lib  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.ops import (drr_kernel, gather_probe,  # noqa: E402
                                   pca_kernel, warp_kernel)
from liftreg_tpu_torch.train import RegistrationTrainer  # noqa: E402
from liftreg_tpu_torch.utils.settings import default_task_setting  # noqa: E402
from liftreg_tpu_torch.utils.tre import eval_copd_highres  # noqa: E402
from tools.torch_make_synthetic_dataset import random_disp  # noqa: E402
from tools.torch_preprocessing import (FILE_TYPE, preprocess,  # noqa: E402
                                       save_id_list)
from tools.torch_preprocessing_drr import generate_drrs  # noqa: E402


def build_setting(data_path, exp_path, size, latent, n_proj, epochs,
                  batch_size, pca_path, val_frequency=1):
    """A ``cur_task_setting.json``-schema dict wired for the run
    (canonical base: ``liftreg_tpu_torch.utils.settings``)."""
    return default_task_setting(data_path, exp_path, size, overrides={
        "train": {
            "dataloader": {"batch_size": batch_size},
            "epoch": epochs,
            "model": {"drr_feature_num": n_proj, "latent_dim": latent,
                      "pca_path": pca_path},
            "save_3d_img": True,
            "save_model_frequency": 5,
            "val_frequency": val_frequency,
        },
    })


def placeholder_pca(out_dir, size, latent, seed=0, magnitude=0.03,
                    device=None):
    """Smooth random low-rank basis: lets the chain run without a trained
    dense model; NOT a statistical deformation model of real motion. The
    2 * ``latent`` fields are drawn straight into one f32 array (stacking
    a list of them would hold both copies, 5.5 GB more at 160^3 and latent
    56); their upsampling runs on ``device``."""
    rng = np.random.default_rng(seed)
    fields = np.empty((2 * latent, 3 * size ** 3), np.float32)
    for i in range(2 * latent):
        fields[i] = random_disp(rng, size, magnitude,
                                device=device).reshape(-1)
    vectors, mean = pca_lib.fit_pca(fields, latent)
    pca_lib.save_pca(out_dir, vectors, mean)
    return out_dir


def launch_counts():
    """The port's kernel launches so far in this process, by kernel (the
    names ``chip_smoke.py`` uses)."""
    wrappers = {"pca_expand": pca_kernel.pca_expand,
                "pca_grad": pca_kernel.pca_grad,
                "warp_trilinear": warp_kernel.warp_trilinear,
                "warp_coord_grad": warp_kernel.warp_coord_grad,
                "warp_image_grad": warp_kernel.warp_image_grad,
                "drr_project": drr_kernel.project_taps,
                "drr_project_adjoint": drr_kernel.project_adjoint_taps,
                "drr_adjoint_plan": drr_kernel.project_adjoint_plan,
                "drr_backproject": drr_kernel.backproject_taps,
                "gather_probe_rows": gather_probe.gather_rows,
                "gather_probe_lanes": gather_probe.gather_lanes,
                "gather_probe_roll": gather_probe.roll_sum,
                "gather_probe_warp_step": gather_probe.warp_step}
    return {name: fn.launches for name, fn in wrappers.items()}


class _Stages:
    """Seconds, kernel launches and peak RSS of each stage of the run."""

    def __init__(self, device):
        self.device = device
        self.seconds, self.launches, self.peak_rss = {}, {}, {}
        self.maxrss_at_start = _maxrss_bytes()

    def run(self, name, fn, *args, **kwargs):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = {k: v - before[k]
                               for k, v in launch_counts().items()}
        self.peak_rss[name] = _peak_rss_bytes(self.maxrss_at_start)
        return out


_STATUS = "/proc/self/status"


def _maxrss_bytes():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _peak_rss_bytes(maxrss_at_start):
    """The process's peak resident set so far: Linux's ``VmHWM``, which
    starts anew at ``exec``. Where ``/proc`` has no such line,
    ``ru_maxrss``, which keeps a forking parent's peak across ``exec``,
    once it exceeds its value at the run's start; else None."""
    try:
        with open(_STATUS) as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    maxrss = _maxrss_bytes()
    return maxrss if maxrss > maxrss_at_start else None


def _bytes_under(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _step_times_ms(exp_path):
    """The train step times the trainer logged, in step order."""
    times = {}
    with open(os.path.join(exp_path, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "Train/step_time_ms":
                times[rec["step"]] = rec["value"]
    return [times[k] for k in sorted(times)]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Raw DirLab .img -> evaluate_result.csv, one command")
    p.add_argument("--raw_path", required=True,
                   help="folder of raw cases (DirLab layout)")
    p.add_argument("--landmarks", default="",
                   help="folder of {case}_300_{iBH,eBH}_xyz_r1.txt files")
    p.add_argument("--out", required=True, help="output root")
    p.add_argument("--file_type", default="copd", choices=["copd", "dct"])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--latent", type=int, default=56)
    p.add_argument("--scan_num", type=int, default=4)
    p.add_argument("--scan_range", type=float, default=30.0)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--pca_path", default="",
                   help="existing pca_vectors/pca_mean folder; omitted -> "
                        "smooth random placeholder basis")
    p.add_argument("--shape", type=int, nargs=3, default=None,
                   help="override raw (z,y,x) shape for every case")
    p.add_argument("--spacing", type=float, nargs=3, default=None,
                   help="override raw (z,y,x) spacing in mm")
    p.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions; default "
                        "the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    stages = _Stages(device)

    out_root = os.path.abspath(args.out)
    task_root = os.path.join(out_root, "dataset")
    pre = os.path.join(task_root, "preprocessed")
    os.makedirs(pre, exist_ok=True)

    # 1. preprocessing (raw -> npy sets + id lists). The same cases serve
    # as the train corpus and the test/eval set unless you train on a
    # separate corpus first (reference splits, tools/preprocessing.py)
    per_case = {}
    ids = stages.run("preprocess", preprocess, args.raw_path, pre,
                     FILE_TYPE[args.file_type],
                     target_size=(args.size,) * 3, shape_override=args.shape,
                     spacing_override=args.spacing, seconds=per_case)
    if not ids:
        raise SystemExit(f"no cases found under {args.raw_path}")
    save_id_list(task_root, "data_id", ids, mode="train")
    save_id_list(task_root, "data_id", ids, mode="test")

    # 2. landmarks into the layout the TRE evaluator expects
    if args.landmarks:
        lm_dir = os.path.join(task_root, "landmarks")
        os.makedirs(lm_dir, exist_ok=True)
        for f in os.listdir(args.landmarks):
            if f.endswith(".txt"):
                shutil.copy(os.path.join(args.landmarks, f),
                            os.path.join(lm_dir, f))

    # 3. DRRs
    stages.run("drr", generate_drrs, task_root, "drr",
               scan_range=args.scan_range, scan_num=args.scan_num,
               device=device)

    # 4. PCA basis
    pca_path = args.pca_path or stages.run(
        "basis", placeholder_pca, os.path.join(task_root, "pca"), args.size,
        args.latent, device=device)
    if not args.pca_path:
        print("note: using a smooth random placeholder PCA basis — pass "
              "--pca_path (e.g. from tools/torch_build_pca.py "
              "--from_experiment) for a real statistical deformation "
              "subspace")

    # 5. train
    exp_path = os.path.join(out_root, "exp")
    os.makedirs(exp_path, exist_ok=True)
    setting = build_setting(task_root, exp_path, args.size, args.latent,
                            args.scan_num, args.epochs, args.batch_size,
                            pca_path)

    def train():
        trainer = RegistrationTrainer(setting, device=device)
        trainer.run()
        return dict(trainer.global_step)

    steps = stages.run("train", train)

    # 6. test + TRE eval -> evaluate_result.csv
    setting["train"]["mode"] = "test"
    setting["train"]["test_from"] = os.path.join(
        exp_path, "checkpoints", "model_best.ckpt")

    def test():
        tester = RegistrationTrainer(setting, device=device)
        tester.run()
        return len(tester.loaders["test"])

    test_batches = stages.run("test", test)
    spacing_table = None
    if args.spacing is not None:
        spacing_table = {cid: np.flipud(np.asarray(args.spacing, np.float64))
                         for cid in ids}
    results = stages.run("tre", eval_copd_highres, task_root, exp_path,
                         spacing_table=spacing_table, dim=(args.size,) * 3,
                         device=device)
    csv = os.path.join(exp_path, "evaluate_result.csv")
    print(f"wrote {csv} ({len(results)} cases)")
    print(json.dumps({"dirlab_e2e": {
        "device": str(device), "cases": list(ids), "size": args.size,
        "latent": args.latent, "views": args.scan_num,
        "batch": args.batch_size, "epochs": args.epochs,
        "seconds": stages.seconds, "preprocess_seconds": per_case,
        "train_steps": steps["train"], "val_batches": steps["val"],
        "test_batches": test_batches,
        "train_step_ms": _step_times_ms(exp_path),
        "launches": stages.launches, "peak_rss_bytes": stages.peak_rss,
        "bytes_written": _bytes_under(out_root)}}), flush=True)
    return csv


if __name__ == "__main__":
    main()
