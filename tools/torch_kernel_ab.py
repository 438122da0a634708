#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels of several source trees on one card.

    git archive <rev> | tar -x -C build/parent liftreg_tpu_torch
    python3 tools/torch_kernel_ab.py build/parent . . build/parent

Each argument is a directory holding a ``liftreg_tpu_torch`` package; each
runs in its own process, in the order given (parent, change, change,
parent compares two versions in turns), and prints one JSON line of CUDA
event times in ms (20 launches after 3 warm-ups) at the serving shapes of
this checkout's ``chip_smoke.py``, whose seeded input builders and timer
it uses: 160^3, B=4, 4 views on a 240^2 detector, latent 56 (the DRR
kernels also with one volume, ``_b1``; the warp kernels with pixel
coordinates and, where the tree has it, with phi in its (B, 3, D, W, H)
layout, ``_phi``; ``warp_image`` with its glue, forward and with the phi
gradient; the projector's adjoint where the tree has it, with its plan
built once where the tree has one, ``drr_adjoint_plan`` timing the plan),
and the steady-state
time of ``RegistrationPipeline.register`` there (bf16 encoder, basis and
taps, random seeded weights; host clock over 10 calls after 2 warm-ups,
ending in a synchronize). ``register_refine`` is the same pipeline with
``refine_steps=30`` on ``chip_smoke.py``'s refine inputs: each of 3 calls
after 1 warm-up on the host clock, their median, and the peak memory;
``register_refine_projection`` the same in the projection domain, where
the tree has it.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke_module():
    """chip_smoke.py of this checkout: the serving shapes, the seeded input
    builders and the CUDA-event timer that this tool shares with it."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_tree(root):
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.ops import drr, drr_kernel, resample
    from liftreg_tpu_torch.ops.drr_kernel import backproject_taps, project_taps
    from liftreg_tpu_torch.ops.pca_kernel import pca_expand, pca_grad
    from liftreg_tpu_torch.ops.warp_kernel import (warp_coord_grad,
                                                   warp_trilinear)
    if not drr.__file__.startswith(root):
        raise RuntimeError(f"imported {drr.__file__}, not from {root}")
    cs = chip_smoke_module()
    dev = torch.device("cuda")
    sz, batch = cs.SZ, cs.B

    def ms(fn):
        return cs._cuda_ms(fn, 20, warmup=3)

    g = torch.Generator(device=dev).manual_seed(0)
    _, _, fwd, bwd, att, proj = cs.serving_drr_inputs(torch, drr, g, dev)
    vol = torch.rand((batch, 1, sz, sz, sz), generator=g, device=dev)
    coords = cs._smooth_coords(torch, F, g, batch, sz, 4.0, dev)
    cot = torch.randn((batch, 1, sz ** 3), generator=g, device=dev)
    n = 3 * sz ** 3
    V = (torch.randn((cs.LATENT, n), generator=g, device=dev)
         * 0.01).bfloat16()
    mean = torch.zeros(n, device=dev)
    coefs = torch.randn((batch, cs.LATENT), generator=g, device=dev)
    g_pca = torch.randn((batch, n), generator=g, device=dev)
    out = {"root": root}
    # the same points as phi (B, 3, D, W, H), for a tree whose warp kernels
    # take that layout, and warp_image's cotangent
    phi = cs._phi_of(coords, sz)
    cot5 = cot.reshape(batch, 1, sz, sz, sz)
    phi_layout = "normalized" in inspect.signature(warp_trilinear).parameters
    for tdt in (torch.bfloat16, torch.float32):
        taps = vol.to(tdt)
        key = str(tdt).split(".")[-1]
        out[f"warp_{key}"] = ms(lambda: warp_trilinear(taps, coords, False))
        out[f"warp_grad_{key}"] = ms(
            lambda: warp_coord_grad(taps, coords, cot, False))
        if phi_layout:
            out[f"warp_phi_{key}"] = ms(lambda: warp_trilinear(
                taps, phi, False, normalized=True, scale_intensity=True))
            out[f"warp_grad_phi_{key}"] = ms(lambda: warp_coord_grad(
                taps, phi, cot5, False, normalized=True,
                scale_intensity=True))
    # warp_image as the main path calls it (bf16 taps), forward and forward
    # with the phi gradient: the kernels with whatever glue the tree has
    img = vol * 2.0 - 1.0
    phi_g = phi.clone().requires_grad_(True)
    out["warp_image_bf16"] = ms(lambda: resample.warp_image(
        img, phi, taps_dtype=torch.bfloat16))
    out["warp_image_grad_bf16"] = ms(lambda: torch.autograd.grad(
        resample.warp_image(img, phi_g, taps_dtype=torch.bfloat16), phi_g,
        cot5))
    out["drr_project"] = ms(lambda: project_taps(att, *fwd))
    out["drr_backproject"] = ms(lambda: backproject_taps(proj, *bwd))
    # one volume: how much of the time the batch's work takes
    att1, proj1 = att[:1].contiguous(), proj[:1].contiguous()
    out["drr_project_b1"] = ms(lambda: project_taps(att1, *fwd))
    out["drr_backproject_b1"] = ms(lambda: backproject_taps(proj1, *bwd))
    # the projector's adjoint, on a cotangent of its own generator so that
    # the other inputs stay those of trees without it
    if hasattr(drr_kernel, "project_adjoint_taps"):
        adjoint = drr_kernel.project_adjoint_taps
        cot_proj = torch.randn(
            proj.shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        kw = {}
        if hasattr(drr_kernel, "project_adjoint_plan"):
            kw["plan"] = drr_kernel.project_adjoint_plan(fwd[0], fwd[1],
                                                         (sz,) * 3)
            out["drr_adjoint_plan"] = ms(
                lambda: drr_kernel.project_adjoint_plan(fwd[0], fwd[1],
                                                        (sz,) * 3))
        cot1 = cot_proj[:1].contiguous()
        out["drr_project_adjoint"] = ms(
            lambda: adjoint(cot_proj, *fwd, (sz,) * 3, **kw))
        out["drr_project_adjoint_b1"] = ms(
            lambda: adjoint(cot1, *fwd, (sz,) * 3, **kw))
    out["pca_expand"] = ms(lambda: pca_expand(coefs, V, mean))
    out["pca_grad"] = ms(lambda: pca_grad(g_pca, V))

    torch.manual_seed(0)
    pipe = RegistrationPipeline((sz,) * 3, latent_dim=cs.LATENT,
                                compute_dtype=torch.bfloat16)
    shape = (batch, 1, sz, sz, sz)
    src = torch.rand(shape, generator=g, device=dev) * -1000.0
    tgt = torch.rand(shape, generator=g, device=dev) * -1000.0
    seg = (torch.rand(shape, generator=g, device=dev) > 0.4).float()
    pca = {"vectors": V, "mean": mean}
    for _ in range(2):
        pipe.register(pca, src, tgt, seg, seg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        pipe.register(pca, src, tgt, seg, seg)
    torch.cuda.synchronize()
    out["register"] = (time.perf_counter() - t0) * 1e3 / 10

    pipe_r = RegistrationPipeline((sz,) * 3, latent_dim=cs.LATENT,
                                  compute_dtype=torch.bfloat16,
                                  refine_steps=cs.REFINE_STEPS)
    pipe_r.model.load_state_dict(pipe.model.state_dict())
    r_src, r_tgt, r_seg, r_pca = cs.refine_inputs(torch, F, g, dev)
    pipe_r.register(r_pca, r_src, r_tgt, r_seg, r_seg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe_r.register(r_pca, r_src, r_tgt, r_seg, r_seg)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    out["register_refine_calls"] = calls
    out["register_refine"] = sorted(calls)[1]
    out["register_refine_peak_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    del pipe_r
    if "refine_domain" in inspect.signature(
            RegistrationPipeline).parameters:
        pipe_p = RegistrationPipeline((sz,) * 3, latent_dim=cs.LATENT,
                                      compute_dtype=torch.bfloat16,
                                      refine_steps=cs.REFINE_STEPS,
                                      refine_domain="projection")
        pipe_p.model.load_state_dict(pipe.model.state_dict())
        pipe_p.register(r_pca, r_src, r_tgt, r_seg, r_seg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe_p.register(r_pca, r_src, r_tgt, r_seg, r_seg)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
        out["register_refine_projection_calls"] = calls
        out["register_refine_projection"] = sorted(calls)[1]
        out["register_refine_projection_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 3 and argv[1] == "--one":
        _time_tree(os.path.abspath(argv[2]))
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for root in argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root],
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
