"""Convert a serving artifact for the port: between its formats (v1
msgpack <-> v2 zero-copy sections), or from the JAX package's artifact to
the port's.

    python tools/torch_convert_artifact.py old_v1.liftreg new_v2.liftreg
    python tools/torch_convert_artifact.py --to 1 v2.liftreg legacy.liftreg
    python tools/torch_convert_artifact.py jax.liftreg port.liftreg

Between the port's formats it is host IO only: the program's bytes and the
arrays are carried over verbatim. A JAX artifact holds a StableHLO program
that the port cannot run, so the tool rebuilds the pipeline from the JAX
meta (image size, latent size, views, detector, compute type, batch,
entry, refinement steps), carries the weights across with
``params_from_jax``, keeps the basis as it is (bf16 included), and exports
a port artifact on ``--device`` (default the CUDA card). The JAX meta does
not record the pose range, the voxel spacing, the lung mask or the warp's
tap type: the tool takes the pipeline's defaults (30 degrees, 2.2 mm,
masked, taps of the compute type), which ``tools/export_serving.py``'s
``--demo`` always used, and says so; ``--warp_taps_dtype`` overrides the
last (the JAX tool gave a trained experiment f32 taps unless its config
said bf16). Nor does it record the refinement's settings: for an artifact
with ``refine_steps > 0`` the tool refuses unless ``--refine_lr``,
``--refine_sim`` and ``--refine_reg_factor`` are given, and for the
``register`` entry, which may refine in either domain, ``--refine_domain``
too (the CT-free entry refines in the projection domain); it never
guesses them.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the pipeline's defaults that a JAX artifact's meta does not record
JAX_META_DEFAULTS = {"scan_range_deg": 30.0, "spacing": (2.2, 2.2, 2.2),
                     "mask_ct": True}


def from_jax(payload, dst, args):
    """Rebuild the pipeline of a JAX artifact and export it for the port;
    returns the port artifact's path."""
    from liftreg_tpu_torch import RegistrationPipeline, params_from_jax
    from liftreg_tpu_torch.serving import export_serving

    meta = payload["meta"]
    entry = meta.get("entry", "register")
    steps = int(meta.get("refine_steps", 0))
    refine_kw = {}
    if steps:
        needed = ("refine_lr", "refine_sim", "refine_reg_factor") + (
            ("refine_domain",) if entry == "register" else ())
        missing = [f"--{k}" for k in needed if getattr(args, k) is None]
        if missing:
            raise SystemExit(
                f"the JAX artifact refines {steps} steps, and its meta "
                f"does not record how: pass {', '.join(missing)} (the "
                "settings it was exported with)")
        refine_kw = dict(refine_steps=steps, refine_lr=args.refine_lr,
                         refine_sim=args.refine_sim,
                         refine_sim_opts=json.loads(args.refine_sim_opts)
                         if args.refine_sim_opts else None,
                         refine_reg_factor=args.refine_reg_factor,
                         refine_domain=args.refine_domain or "projection")
    print("the JAX meta does not record these; the pipeline's defaults: "
          + ", ".join(f"{k}={v}" for k, v in JAX_META_DEFAULTS.items())
          + f", warp_taps_dtype={args.warp_taps_dtype}")
    pipe = RegistrationPipeline(
        tuple(meta["img_sz"]), latent_dim=int(meta["latent_dim"]),
        n_proj=int(meta["n_proj"]),
        resolution=meta.get("resolution") or None,
        compute_dtype=meta.get("compute_dtype") or None,
        warp_taps_dtype=args.warp_taps_dtype, device=args.device,
        **JAX_META_DEFAULTS, **refine_kw)
    pipe.model.load_state_dict(params_from_jax(payload["params"]))
    pca = {k: v.to(pipe.device) for k, v in payload["pca"].items()}
    return export_serving(pipe, pca, int(meta["batch_size"]), dst,
                          entry=entry, artifact_format=args.to)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--to", type=int, choices=(1, 2), default=2)
    ap.add_argument("--device", default=None,
                    help="JAX artifacts: where the port's program is "
                         "traced ('cpu'; default the CUDA card)")
    ap.add_argument("--warp_taps_dtype", default="auto",
                    help="JAX artifacts: the warp's tap type ('bfloat16', "
                         "'float32'; default that of the compute type)")
    ap.add_argument("--refine_lr", type=float, default=None)
    ap.add_argument("--refine_sim", default=None)
    ap.add_argument("--refine_sim_opts", default=None,
                    help="JSON of the similarity's options")
    ap.add_argument("--refine_reg_factor", type=float, default=None)
    ap.add_argument("--refine_domain", choices=("image", "projection"),
                    default=None,
                    help="required to refine through 'register'; the "
                         "CT-free entry refines in 'projection'")
    args = ap.parse_args(argv)

    from liftreg_tpu_torch.serving import (is_port_artifact, read_artifact,
                                           write_artifact)

    t0 = time.perf_counter()
    payload = read_artifact(args.src)
    port = is_port_artifact(payload["meta"])
    print(f"read {args.src} (v{payload['version']}, "
          f"{'port' if port else 'JAX package'}) in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    if port:
        out = write_artifact(payload, args.dst, args.to)
    else:
        out = from_jax(payload, args.dst, args)
    print(f"wrote {out} (v{args.to}, {os.path.getsize(out) / 1e6:.1f} MB) "
          f"in {time.perf_counter() - t0:.2f} s")
    return out


if __name__ == "__main__":
    main()
