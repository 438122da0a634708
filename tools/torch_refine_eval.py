"""Evaluate per-case refinement on a trained experiment's test split, the
port's counterpart of ``tools/refine_eval.py``.

Runs the trained model over the test split twice: the amortized
prediction, and the prediction followed by N steps of per-case
refinement of the PCA coefficients (``liftreg_tpu_torch/refine.py``);
writes both sets of maps, scores both with the landmark TRE
(``utils/tre.eval_copd_highres``) and prints the comparison::

    python tools/torch_refine_eval.py -s EXP/cur_task_setting.json \
        --steps 30 --lr 0.05

The refined maps and their ``evaluate_result.csv`` land in
``EXP/refined/tests`` (``EXP/refined_proj/tests`` for ``--domain
projection``). ``--iso_spacing`` gives a uniform landmark spacing for
synthetic datasets (DIR-Lab cases use the built-in COPD table). Runs on
the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", "--setting_path", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--reg_factor", type=float, default=None,
                    help="smoothness weight (default: the config's "
                         "min_reg_factor)")
    ap.add_argument("--iso_spacing", type=float, default=0.0,
                    help="uniform landmark spacing (mm) for synthetic data")
    ap.add_argument("--domain", choices=("image", "projection"),
                    default="image",
                    help="refinement objective: 'image' = similarity with "
                         "the target CT (training's loss; needs the target "
                         "volume); 'projection' = similarity of the DRR of "
                         "the warped attenuation with the projections (no "
                         "target CT)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)

    import numpy as np

    from liftreg_tpu_torch.models.subspace_backproj import mask_lung
    from liftreg_tpu_torch.ops import drr
    from liftreg_tpu_torch.refine import (_VOLUME_ONLY_SIMS,
                                          make_projection_refiner,
                                          make_refiner)
    from liftreg_tpu_torch.train import get_network
    from liftreg_tpu_torch.utils.config import ParameterDict
    from liftreg_tpu_torch.utils.io_utils import save_deformations
    from liftreg_tpu_torch.utils.tre import eval_copd_highres

    setting = ParameterDict()
    setting.load_JSON(args.setting_path)
    setting["train"]["mode"] = "test"
    setting["train"]["test_from"] = os.path.join(
        setting["train"]["output_path"], "checkpoints", "model_best.ckpt")
    setting["train"]["save_fig"] = False
    setting["train"]["save_3d_img"] = True

    trainer = get_network(setting["train"][("network_class", "")])(
        setting, device=args.device)
    loss_cfg = dict(setting["train"]["loss"].as_dict())
    reg_factor = args.reg_factor if args.reg_factor is not None \
        else float(loss_cfg.get("min_reg_factor", 1e-3))
    sim_kw = dict(sim=loss_cfg.get("sim_class", "ncc"),
                  sim_opts=loss_cfg.get("sim_opts", None),
                  n_steps=args.steps, lr=args.lr, reg_factor=reg_factor)
    refiner = None      # the projection refiner needs the dataset's poses
    if args.domain == "image":
        refiner = make_refiner(trainer.img_sz,
                               warp_taps_dtype=trainer.model.warp_taps_dtype,
                               **sim_kw)
    ds_cfg = dict(setting["dataset"].as_dict())

    exp = setting["train"]["output_path"]
    base_tests = os.path.join(exp, "tests")
    refined_exp = os.path.join(
        exp, "refined" if args.domain == "image" else "refined_proj")
    refined_tests = os.path.join(refined_exp, "tests")
    os.makedirs(base_tests, exist_ok=True)
    os.makedirs(refined_tests, exist_ok=True)

    all_names, sim_drops = [], []
    for data in trainer.loaders["test"]:
        batch, names = trainer.set_input(data, 0)
        eval_out, out = trainer._eval_step(batch)
        nv = len(names)
        # the amortized maps (what the eval CLI scores)
        save_deformations(eval_out["phi"][:nv].cpu().numpy(), names,
                          base_tests)
        if args.domain == "projection":
            if refiner is None:
                proj_kw = dict(sim_kw)
                if proj_kw["sim"] in _VOLUME_ONLY_SIMS:
                    # a 3-D windowed similarity cannot score 2-D
                    # projections: NCC instead, loudly
                    print(f"note: sim_class {proj_kw['sim']!r} is 3D-only; "
                          "projection-domain refinement uses 'ncc' instead")
                    proj_kw.update(sim="ncc", sim_opts=None)
                poses = batch["target_poses"]
                poses = poses[0] if poses.dim() == 3 else poses
                # f32 taps, as the JAX tool builds this refiner
                refiner = make_projection_refiner(
                    trainer.img_sz, poses,
                    tuple(batch["target_proj"].shape[-2:]),
                    tuple(ds_cfg.get("spacing_to_refer", (2.2, 2.2, 2.2))),
                    **proj_kw)
            # the dataset's source is normalized HU in [-1, 1]: back to HU,
            # then to linear attenuation
            hu = (batch["source"] - 1.0) * 500.0
            res = refiner(out["pca_coefs"], trainer.pca,
                          drr.calc_relative_atten_coef(hu),
                          batch["target_proj"])
        else:
            if trainer.model.mask_ct and "source_label" in batch:
                moving_cp = mask_lung(batch["source"], batch["source_label"])
            else:
                moving_cp = batch["source"]
            res = refiner(out["pca_coefs"], trainer.pca, moving_cp,
                          out["target"])
        save_deformations(res["phi"][:nv].detach().cpu().numpy(), names,
                          refined_tests)
        hist = res["sim_history"].cpu().numpy()
        sim_drops.append((float(hist[0]), float(hist[-1])))
        all_names.extend(names)
        print(f"{names}: sim {hist[0]:.4f} -> {hist[-1]:.4f} "
              f"({args.steps} steps)")

    data_path = ds_cfg["data_path"]
    dim = tuple(ds_cfg.get("img_after_resize", (160, 160, 160)))
    table = {str(n): [args.iso_spacing] * 3 for n in all_names} \
        if args.iso_spacing else None
    if sim_drops:
        d0 = float(np.mean([a for a, _ in sim_drops]))
        d1 = float(np.mean([b for _, b in sim_drops]))
        print(f"\nmean sim loss over test batches: {d0:.4f} -> {d1:.4f}")
    print("\n== amortized prediction ==")
    base = eval_copd_highres(data_path, exp, spacing_table=table, dim=dim,
                             device=trainer.device)
    print(f"\n== refined ({args.steps} steps, lr {args.lr}, "
          f"reg {reg_factor}) ==")
    refined = eval_copd_highres(data_path, refined_exp, spacing_table=table,
                                dim=dim, device=trainer.device)
    if base and refined:
        b = float(np.mean([r["dist"] for r in base]))
        r = float(np.mean([r["dist"] for r in refined]))
        print(f"\nmean TRE: {b:.4f} mm amortized -> {r:.4f} mm refined "
              f"({100.0 * (b - r) / max(b, 1e-12):+.1f}%)")
    return base, refined


if __name__ == "__main__":
    main()
