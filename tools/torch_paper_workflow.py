"""The LiftReg learned-basis workflow with the PyTorch port
(``liftreg_tpu_torch``), on the CUDA card: the port's counterpart of
``tools/paper_workflow_160.py``.

  stage 1  either train the dense RegNet2D3D model on the DRR dataset
           (``--stage1_mode regnet``), or register every training pair by
           per-pair optimization (``--stage1_mode optreg``,
           ``liftreg_tpu_torch.optreg.DenseRegisterer``);
  stage 2  fit the PCA deformation basis to the train split's fields
           (EVR at each K), then the basis-span gate on the test split's
           ground truth (``tools/torch_basis_oracle.py``; ``--gate_residual``
           stops before stage 3 when the residual exceeds it);
  stage 3  train LiftRegSubspaceBackproj on that basis (bf16 basis and
           warp taps), run it in test mode and score the test split's
           landmark TRE, beside the identity map's TRE.

The last line of standard output is one JSON object with each stage's
seconds, the EVR at each K, the gate residual and both mean TREs.

    python tools/torch_paper_workflow.py --data DATA --out OUT \\
        --size 96 --stage1_mode optreg --gate_mask lung \\
        --gate_residual 0.6 --latent 24

``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch import pca as pca_lib  # noqa: E402
from liftreg_tpu_torch.coords import identity_map_np, phi_to_01  # noqa: E402
from liftreg_tpu_torch.train import RegistrationTrainer  # noqa: E402
from liftreg_tpu_torch.utils.settings import default_task_setting  # noqa: E402
from liftreg_tpu_torch.utils.tre import eval_copd_highres  # noqa: E402
from tools.torch_basis_oracle import main as basis_oracle_main  # noqa: E402
from tools.torch_build_pca import (disp_from_experiment,  # noqa: E402
                                   disp_from_optreg, parse_levels)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True, help="the dataset's root")
    ap.add_argument("--out", required=True,
                    help="folder for the experiments and the basis")
    ap.add_argument("--stage1_epochs", type=int, default=1)
    ap.add_argument("--stage3_epochs", type=int, default=40)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--latent", type=int, default=24)
    ap.add_argument("--s2d", action="store_true",
                    help="space-to-depth encoder stages "
                         "(liftreg_tpu_torch/models/s2d.py) in both the "
                         "RegNet2D3D stage and the subspace stage")
    ap.add_argument("--stage1_cache", default="auto",
                    help="cache_on_device for stage 1: auto|true|false")
    ap.add_argument("--stage1_batch", type=int, default=1)
    ap.add_argument("--stage1_inverse_iters", type=int, default=7)
    ap.add_argument("--stage1_loss", choices=("regnet2d3d", "image"),
                    default="regnet2d3d")
    ap.add_argument("--stage1_mode", choices=("regnet", "optreg"),
                    default="regnet")
    ap.add_argument("--optreg_batch", type=int, default=2)
    ap.add_argument("--optreg_sim", default="ncc")
    ap.add_argument("--optreg_levels", default="",
                    help="grid:steps:lr,... e.g. 10:80:0.04,20:60:0.02")
    ap.add_argument("--stage1_reg", type=float, default=None,
                    help="constant reg_factor for stage 1 (no decay)")
    ap.add_argument("--stage1_resume", action="store_true",
                    help="resume stage 1 from exp_regnet's latest "
                         "checkpoint if one exists")
    ap.add_argument("--gate_residual", type=float, default=0.0,
                    help="stop before stage 3 when the test split's "
                         "gt-span residual exceeds this (0: no gate)")
    ap.add_argument("--gate_mask", choices=("none", "lung"), default="none")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions; default "
                         "the CUDA card")
    return ap.parse_args(argv)


def base_setting(args, exp, epochs):
    """The canonical task setting with this tool's knobs."""
    return default_task_setting(args.data, exp, args.size, overrides={
        "dataset": {"max_num_for_loading": [40, 4, 4, 4]},
        "train": {
            "epoch": epochs,
            "model": {"latent_dim": args.latent, "s2d_encoder": args.s2d},
            "save_fig_frequency": 1000,
            "log_flush_steps": 4,
        },
    })


def regnet_setting(args, exp_rn):
    """The task setting of stage 1 in ``regnet`` mode: RegNet2D3D on the
    projection loss, its experiment in ``exp_rn``."""
    s1 = base_setting(args, exp_rn, epochs=args.stage1_epochs)
    s1["dataset"]["dataset_class"] = "registration2d3d_projloss"
    s1["dataset"]["apply_hu_clip"] = False
    s1["train"]["model_class"] = "regnet2d3d"
    s1["train"]["loss_class"] = ("regnet_image" if args.stage1_loss == "image"
                                 else "regnet2d3d")
    s1["train"]["model"] = {"drr_feature_num": 4, "s2d_encoder": args.s2d,
                            "inverse_iters": args.stage1_inverse_iters}
    s1["train"]["optim"]["lr"] = 5e-4
    if args.stage1_reg is not None:
        s1["train"]["loss"]["initial_reg_factor"] = args.stage1_reg
        s1["train"]["loss"]["min_reg_factor"] = args.stage1_reg
    ckpt = os.path.join(exp_rn, "checkpoints", "latest_checkpoint.ckpt")
    if args.stage1_resume and os.path.exists(ckpt):
        s1["train"]["continue_train"] = True
        s1["train"]["continue_from"] = ckpt
        print(f"STAGE1 resuming from {ckpt}", flush=True)
    s1["train"]["cache_on_device"] = (
        "auto" if args.stage1_cache == "auto"
        else args.stage1_cache.lower() == "true")
    s1["train"]["dataloader"]["batch_size"] = args.stage1_batch
    return s1


def train_regnet(args):
    """Stage 1 in ``regnet`` mode; returns the path of the experiment's
    saved setting."""
    exp_rn = os.path.join(args.out, "exp_regnet")
    os.makedirs(exp_rn, exist_ok=True)
    s1 = regnet_setting(args, exp_rn)
    RegistrationTrainer(s1, device=args.device).run()
    path = os.path.join(exp_rn, "cur_task_setting.json")
    with open(path, "w") as f:
        json.dump(s1, f)
    return path


def identity_tre(data, out, size, device=None):
    """The test split's mean TRE of the identity map: the identity, stored
    as the trainer stores its maps under ``out/exp_identity``, scored by
    ``eval_copd_highres``."""
    exp_id = os.path.join(out, "exp_identity")
    os.makedirs(os.path.join(exp_id, "tests"), exist_ok=True)
    phi01 = phi_to_01(identity_map_np((size,) * 3))
    for case in np.load(os.path.join(data, "test", "data_id.npy")):
        np.save(os.path.join(exp_id, "tests", f"{case}_phi.npy"), phi01)
    results = eval_copd_highres(data, exp_id, dim=(size,) * 3,
                                device=device)
    return float(np.mean([r["dist"] for r in results]))


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = {"size": args.size, "stage1_mode": args.stage1_mode}

    # -- stage 1: the train split's deformation fields ---------------------
    t0 = time.time()
    if args.stage1_mode == "optreg":
        calls = []
        X = disp_from_optreg(args.data, phase="train",
                             levels=parse_levels(args.optreg_levels),
                             sim=args.optreg_sim, batch=args.optreg_batch,
                             device=args.device, record=calls)
        summary["optreg_calls"] = len(calls)
        summary["optreg_sim_first_last"] = [
            [float(c["sim_history"][0]), float(c["sim_history"][-1])]
            for c in calls]
    else:
        cfg = train_regnet(args)
        X = disp_from_experiment(args.data, cfg, phase="train",
                                 device=args.device)
    summary["stage1_s"] = time.time() - t0
    summary["fields"] = X.shape[0]
    print(f"STAGE1 {args.stage1_mode} done {summary['stage1_s']:.1f}s",
          flush=True)

    # -- stage 2: PCA, then the basis-span gate ----------------------------
    t1 = time.time()
    print("fields:", X.shape, flush=True)
    latent = min(args.latent, X.shape[0])
    vectors, mean = pca_lib.fit_pca(X, latent)
    pca_dir = os.path.join(args.out, f"pca_from_{args.stage1_mode}")
    pca_lib.save_pca(pca_dir, vectors, mean)
    # nested subsets of the basis give the EVR at every smaller K
    summary["evr"] = {}
    for k in sorted({2, 4, 8, 16, latent}):
        if k <= latent:
            r = pca_lib.explained_variance_ratio(X, vectors[:k], mean)
            summary["evr"][k] = r
            print(f"  EVR@K={k}: {r:.3f}", flush=True)
    del X
    summary["stage2_s"] = time.time() - t1
    print(f"STAGE2 pca done, explained variance {summary['evr'][latent]:.3f}"
          f", {summary['stage2_s']:.1f}s", flush=True)
    resid = basis_oracle_main(["--pca", pca_dir, "--data", args.data,
                               "--phase", "test", "--mask", args.gate_mask])
    summary["gate_residual"] = resid
    print(f"ORACLE gt-span residual (test) {resid:.4f}", flush=True)
    if args.gate_residual and resid > args.gate_residual:
        print(f"GATE: residual {resid:.4f} > {args.gate_residual}: the basis "
              "cannot express the test deformations; stage 3 skipped",
              flush=True)
        print(json.dumps(summary), flush=True)
        return 3

    # -- stage 3: the subspace model on the learned basis ------------------
    t2 = time.time()
    exp_ss = os.path.join(args.out, "exp_subspace")
    os.makedirs(exp_ss, exist_ok=True)
    s3 = base_setting(args, exp_ss, epochs=args.stage3_epochs)
    s3["train"]["model"]["latent_dim"] = latent
    s3["train"]["model"]["pca_path"] = pca_dir
    s3["train"]["model"]["pca_dtype"] = "bfloat16"
    s3["train"]["model"]["warp_taps_dtype"] = "bfloat16"
    s3["train"]["val_frequency"] = 5
    s3["train"]["save_model_frequency"] = 5
    with open(os.path.join(exp_ss, "cur_task_setting.json"), "w") as f:
        json.dump(s3, f)
    trainer = RegistrationTrainer(s3, device=args.device)
    # "epoch" is the last epoch's index: epochs 0 .. stage3_epochs
    steps = len(trainer.loaders["train"]) * (args.stage3_epochs + 1)
    trainer.run()
    del trainer
    summary["stage3_s"] = time.time() - t2
    summary["stage3_steps"] = steps
    print(f"STAGE3 subspace done {summary['stage3_s']:.1f}s", flush=True)

    # -- test mode, then the test split's TRE ------------------------------
    t3 = time.time()
    s3["train"]["mode"] = "test"
    s3["train"]["test_from"] = os.path.join(exp_ss, "checkpoints",
                                            "model_best.ckpt")
    s3["train"]["save_3d_img"] = True
    RegistrationTrainer(s3, device=args.device).run()
    results = eval_copd_highres(args.data, exp_ss, dim=(args.size,) * 3,
                                device=args.device)
    summary["tre_learned_mm"] = float(np.mean([r["dist"] for r in results]))
    summary["tre_learned_per_case"] = {r["id"]: r["dist"] for r in results}
    summary["tre_identity_mm"] = identity_tre(args.data, args.out,
                                              args.size, args.device)
    summary["eval_s"] = time.time() - t3
    summary["total_s"] = time.time() - t0
    print(f"PAPER WORKFLOW COMPLETE {summary['total_s']:.1f} s total",
          flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
