#!/usr/bin/env python3
"""How far chip_smoke.py's refine_reference problem moves under a one-ulp
change of its inputs, on the CPU alone, and how far the card is from the
CPU there.

    python3 tools/torch_refine_conditioning.py [SEED ...]

For each seed (default: 2, refine_reference's own, to 9) it builds
refine_reference's data on the card with that seed (the smooth bf16 basis
and the smooth volumes at 32^3, drawn from a generator on the card as
chip_smoke.py draws them), and runs ``RegistrationPipeline.register`` with
5 refinement steps (lr 0.02) in each of refine_reference's four
configurations: on the CPU with the identity map and DRR geometry rounded as
the JAX package rounds them inside ``jit`` (``coords.linspace_in_jit``, the
port's), on the CPU with every fourth element of each of their axes one
ulp higher (``torch.nextafter``; an eager ``jnp.linspace`` differs from
the rule inside ``jit`` by an ulp at about a quarter of the positions),
and on the card with the port's rounding. It prints one JSON line per
seed: for each
configuration the largest difference in phi and in the warped CT between the
two CPU runs (``cpu_one_ulp``) and between the card and the CPU
(``card_cpu``), and the card's name and power limit first. Needs a CUDA card
and nvcc; imports nothing of JAX.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONFIGS = {"image_ncc": {},
           "image_lncc": {"refine_sim": "lncc", "refine_sim_opts": {
               "smooth": 3, "scales": [1, 2]}},
           "projection_ncc": {"refine_domain": "projection"},
           "projection_ngf": {"refine_domain": "projection",
                              "refine_sim": "ngf"}}


def main(argv):
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_refine_conditioning: no CUDA device", file=sys.stderr)
        return 1
    from liftreg_tpu_torch import RegistrationPipeline, coords
    from liftreg_tpu_torch.ops import drr
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda")
    small, latent = (32, 32, 32), 8
    # refine_reference's model: the reference phase's seeded weights
    torch.manual_seed(1)
    state = RegistrationPipeline(small, latent_dim=latent,
                                 device="cpu").model.state_dict()
    port_rule = coords.linspace_in_jit

    def one_ulp(start, stop, n):
        """The port's axis with elements 1, 5, 9, ... one ulp higher."""
        axis = port_rule(start, stop, n)
        axis[1::4] = torch.nextafter(axis[1::4],
                                     torch.tensor(float("inf")))
        return axis

    def run(pca, args, opts, rule, where):
        coords.linspace_in_jit = drr.linspace_in_jit = rule
        coords._identity_map.cache_clear()
        p = RegistrationPipeline(small, latent_dim=latent,
                                 warp_taps_dtype=torch.float32,
                                 refine_steps=5, refine_lr=0.02,
                                 device=where, **opts)
        p.model.load_state_dict(state)
        pc = {k: v.to(where) for k, v in pca.items()}
        return [t.cpu() for t in p.register(pc, *(a.to(where)
                                                  for a in args))]

    def diff(a, b):
        return [float((a[1] - b[1]).abs().max()),
                float((a[0] - b[0]).abs().max())]

    for seed in [int(s) for s in argv] or list(range(2, 10)):
        gs = torch.Generator(device=dev).manual_seed(seed)
        pca = {"vectors": cs._smooth_basis(torch, F, gs, latent, 32, 0.05,
                                           dev).cpu(),
               "mean": torch.zeros((3 * 32 ** 3,))}
        field = cs._smooth_field(torch, F, gs, (2, 1) + small, 6, dev).cpu()
        args = [field * 400.0 - 500.0,
                torch.roll(field, shifts=(1, -2, 1), dims=(2, 3, 4))
                * 400.0 - 500.0] + [torch.ones((2, 1) + small)] * 2
        out = {}
        for cfg, opts in CONFIGS.items():
            port = run(pca, args, opts, port_rule, "cpu")
            moved = run(pca, args, opts, one_ulp, "cpu")
            card = run(pca, args, opts, port_rule, "cuda")
            out[cfg] = {"cpu_one_ulp": diff(port, moved),
                        "card_cpu": diff(card, port)}
        coords.linspace_in_jit = drr.linspace_in_jit = port_rule
        coords._identity_map.cache_clear()
        print(json.dumps({"seed": seed, "phi_warped": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
