"""Export a trained experiment of the port as a one-file serving artifact
(``liftreg_tpu_torch/serving.py``): the ``torch.export`` program of the
amortized registration with the weights, the PCA basis and the
pipeline's constants, which ``tools/torch_serve_batch.py`` or
``ServingModel.load`` serve.

From a trained experiment (its settings, ``model_best.ckpt`` and basis)::

    python tools/torch_export_serving.py -s EXP/cur_task_setting.json \
        -o flagship.liftreg -b 4

``--checkpoint PATH`` exports another checkpoint of the experiment (the
last one, an earlier epoch's), as the JAX tool's option does.

Synthetic smoke test (random seeded weights and basis, no experiment)::

    python tools/torch_export_serving.py --demo 32 -o demo.liftreg

The program is traced on the CUDA card unless ``--device cpu``; it runs on
the device type it was traced on (``ServingModel.load`` moves it to
another explicitly). ``--refine_steps N`` records N steps of per-case
refinement, which the serving side runs with the port's refiner (it is
not part of the program); from an experiment the refinement takes the
training loss's similarity and its converged regulariser weight, as the
JAX tool does.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pipeline_from_setting(setting_path, refine_kw, device, checkpoint=None):
    """The pipeline of a trained experiment, its weights from
    ``checkpoint`` (default the experiment's ``model_best.ckpt``), and its
    basis: ``(pipe, pca)``. The encoder's compute type,
    its space-to-depth stages and the basis type come from the model
    config; the warp's taps are bf16 only where ``warp_taps_dtype`` says
    so, as the trainer builds its model (the pipeline's own default would
    follow the compute type)."""
    import torch

    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.pca import load_pca
    from liftreg_tpu_torch.utils.checkpoint import load_checkpoint
    from liftreg_tpu_torch.utils.config import ParameterDict
    from liftreg_tpu_torch.utils.general import parse_bool

    setting = ParameterDict()
    setting.load_JSON(setting_path)
    train = setting["train"]
    model_cfg = dict(train["model"].as_dict())
    ds_cfg = dict(setting["dataset"].as_dict())
    img_sz = tuple(ds_cfg.get("img_after_resize", (160, 160, 160)))
    if refine_kw.get("refine_steps"):
        loss_cfg = dict(train["loss"].as_dict())
        refine_kw = dict(refine_kw,
                         refine_sim=loss_cfg.get("sim_class", "ncc"),
                         refine_sim_opts=loss_cfg.get("sim_opts", None),
                         refine_reg_factor=float(loss_cfg.get(
                             "min_reg_factor", 1e-3)))
    bf16 = torch.bfloat16
    pipe = RegistrationPipeline(
        img_sz, latent_dim=int(model_cfg.get("latent_dim", 56)),
        n_proj=int(model_cfg.get("drr_feature_num", 4)),
        compute_dtype=bf16 if model_cfg.get("compute_dtype") == "bfloat16"
        else None,
        warp_taps_dtype=bf16 if model_cfg.get("warp_taps_dtype")
        == "bfloat16" else None,
        mask_ct=parse_bool(model_cfg.get("mask_ct"), default=True),
        s2d_encoder=parse_bool(model_cfg.get("s2d_encoder"), default=False),
        device=device, **refine_kw)
    pca = load_pca(model_cfg["pca_path"],
                   dtype=bf16 if model_cfg.get("pca_dtype") == "bfloat16"
                   else None, device=pipe.device)
    ckpt = checkpoint or os.path.join(train["output_path"], "checkpoints",
                                      "model_best.ckpt")
    state = load_checkpoint(ckpt)
    pipe.model.load_state_dict(state["params"])
    print(f"loaded checkpoint '{ckpt}' (epoch {int(state.get('epoch', -1))})")
    return pipe, pca


def demo_pipeline(sz, refine_kw, device, latent=8):
    """A randomly initialised SZ^3 pipeline (seed 0) and a random f32
    basis, as the JAX tool's ``--demo`` makes them."""
    import torch

    from liftreg_tpu_torch import RegistrationPipeline

    torch.manual_seed(0)
    pipe = RegistrationPipeline((sz,) * 3, latent_dim=latent, device=device,
                                **refine_kw)
    g = torch.Generator().manual_seed(0)
    n = 3 * sz ** 3
    pca = {"vectors": torch.randn((latent, n), generator=g) * 0.01,
           "mean": torch.randn((n,), generator=g) * 0.01}
    return pipe, {k: v.to(pipe.device) for k, v in pca.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", "--setting_path", type=str, default="",
                    help="experiment cur_task_setting.json")
    ap.add_argument("-o", "--out", type=str, required=True,
                    help="output artifact path (e.g. flagship.liftreg)")
    ap.add_argument("-b", "--batch_size", type=int, default=4,
                    help="serving batch the program is specialized to")
    ap.add_argument("--checkpoint", type=str, default="",
                    help="checkpoint to export (default: the experiment's "
                         "model_best.ckpt)")
    ap.add_argument("--demo", type=int, default=0, metavar="SZ",
                    help="export a randomly initialised SZ^3 model instead "
                         "of a trained experiment (smoke testing)")
    ap.add_argument("--refine_steps", type=int, default=0,
                    help="N steps of per-case refinement at serving time")
    ap.add_argument("--refine_lr", type=float, default=0.05)
    ap.add_argument("--format", type=int, choices=(1, 2), default=2,
                    help="artifact format: 2 = zero-copy sections "
                         "(default), 1 = one msgpack blob")
    ap.add_argument("--entry", choices=("register", "projections"),
                    default="register",
                    help="'projections' exports the CT-free entry (moving "
                         "CT and measured projections in); refinement then "
                         "runs in the projection domain")
    ap.add_argument("--device", default=None,
                    help="'cpu' traces on the CPU; default the CUDA card")
    args = ap.parse_args(argv)

    from liftreg_tpu_torch.serving import export_serving

    entry = "register" if args.entry == "register" \
        else "register_projections"
    refine_kw = dict(refine_steps=args.refine_steps,
                     refine_lr=args.refine_lr)
    if args.refine_steps and entry == "register_projections":
        # the CT-free entry can only refine against the projections
        refine_kw["refine_domain"] = "projection"
    if args.demo:
        pipe, pca = demo_pipeline(args.demo, refine_kw, args.device)
    elif args.setting_path:
        pipe, pca = pipeline_from_setting(args.setting_path, refine_kw,
                                          args.device, args.checkpoint)
    else:
        ap.error("either --setting_path or --demo is required")
    out = export_serving(pipe, pca, batch_size=args.batch_size,
                         out_path=args.out, entry=entry,
                         artifact_format=args.format)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, device "
          f"{pipe.device.type}, batch_size={args.batch_size}, "
          f"entry={entry}, refine_steps={args.refine_steps})")
    return out


if __name__ == "__main__":
    main()
