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
built once where the tree has one, ``drr_adjoint_plan`` timing the plan;
the warp's image gradient where the tree has it, at ``chip_smoke.py``'s
timed inputs of it: C = 3, 160^3, B = 1, phi layout, zeros padding, and
on a 0.9-voxel field and on the identity, ``_near_identity`` and
``_identity``),
and the steady-state
time of ``RegistrationPipeline.register`` there (bf16 encoder, basis and
taps, random seeded weights; host clock over 10 calls after 2 warm-ups,
ending in a synchronize). ``register_refine`` is the same pipeline with
``refine_steps=30`` on ``chip_smoke.py``'s refine inputs: each of 3 calls
after 1 warm-up on the host clock, their median, and the peak memory;
``register_refine_projection`` the same in the projection domain, where
the tree has it. ``regnet_step`` is RegNet2D3D's forward, its projection
loss (``RegNet2D3DLoss``, NCC) and the backward, in f32 as the trainer's
step runs them (no optimizer update), at the learned-basis
workflow's stage-1 shape (160^3, B = 1, 4 views on 240^2, f32, random
seeded weights and inputs), where the tree has the model: each of 5 steps
after 1 warm-up on the host clock, their median; then one more step under
``torch.profiler``, whose image-gradient launches give
``regnet_image_grad_ms`` (their device time) and
``regnet_image_grad_launches``, and the same on smooth inputs, as
``chip_smoke.py``'s dataset makes them (``regnet_image_grad_smooth_ms``). ``train_step`` and ``subspace_step`` are
the same for LiftReg (``subspace_backproj``) and ``LiftRegSubspace`` at the
reference config (``configs/cur_task_setting.json``: 160^3, B = 30, 4 views
on 240^2, latent 56, f32, NCC with the subspace loss), each of 3 steps
after 1 warm-up, their median. ``optreg_step_96`` is one level of
per-pair registration at 96^3 (B = 2, a 20^3 grid, 60 steps, bf16 taps,
smooth seeded volumes), where the tree has it: ms a step of each of 3
calls after 1 warm-up, their median (the step is host-bound there: it
shows a change in the host's cost per launch); ``host_us_a_call`` the host
microseconds a call of each forward wrapper (projector, lift, PCA
expansion, warp) at 8^3, 2000 calls after 100 warm-ups.

    python3 tools/torch_kernel_ab.py --optreg-op-turns [CALLS]

times the 96^3 optreg step of this checkout alone, its warp through the
``liftreg::`` operator and through the operator's implementation called
directly, in turns, CALLS calls each (default 40;
:func:`optreg_op_turns`).
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
    from liftreg_tpu_torch.ops import warp_kernel
    if hasattr(warp_kernel, "warp_image_grad"):
        # chip_smoke.py's times of the image gradient, on a generator of
        # their own so that the other inputs stay those of trees without it
        gi = torch.Generator(device=dev).manual_seed(2)
        ig_vol = torch.zeros((1, 3) + (sz,) * 3, device=dev)
        ig_phi = cs._phi_of(cs._smooth_coords(torch, F, gi, 1, sz, 4.0, dev),
                            sz)
        ig_cot = torch.randn((1, 3) + (sz,) * 3, generator=gi, device=dev)
        out["warp_image_grad"] = ms(lambda: warp_kernel.warp_image_grad(
            ig_vol, ig_phi, ig_cot, False, normalized=True))
        # the fields of RegNet2D3D's inverse iteration: up to 0.9 voxels,
        # and the identity
        for name, amp in (("near_identity", 0.9), ("identity", 0.0)):
            near = cs._near_identity_phi(torch, F, gi, 1, sz, amp, dev)
            out[f"warp_image_grad_{name}"] = ms(
                lambda: warp_kernel.warp_image_grad(
                    ig_vol, near, ig_cot, False, normalized=True))
        del ig_vol, ig_phi, ig_cot, near

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
        del pipe_p
    try:
        from liftreg_tpu_torch.models.unet2d3d import RegNet2D3D
    except ImportError:
        RegNet2D3D = None
    if RegNet2D3D is not None:
        out.update(_regnet_step(torch, cs, drr, RegNet2D3D, dev))
    try:
        from liftreg_tpu_torch import optreg  # noqa: F401
    except ImportError:
        optreg = None
    if optreg is not None:
        out.update(_optreg_step(torch, cs, dev))
    out.update(_host_us(torch, cs, dev))
    from liftreg_tpu_torch.models import get_model
    for key, name in (("train_step", "subspace_backproj"),
                      ("subspace_step", "subspace")):
        out.update(_subspace_step(torch, cs, drr, get_model(name), key, dev))
    print(json.dumps(out), flush=True)


def _median_step(torch, step, n):
    """The host-clock ms of ``n`` calls of ``step`` after 1 warm-up, their
    median, and the peak memory."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    return steps, sorted(steps)[n // 2], \
        torch.cuda.max_memory_allocated() / 2 ** 30


def regnet_step_inputs(torch, cs, drr, RegNet2D3D, dev, smooth=False):
    """RegNet2D3D at the stage-1 shape (160^3, B = 1, 4 views on 240^2,
    random seeded weights and inputs) and ``step()``: its forward, its
    projection loss (``RegNet2D3DLoss``, NCC) and the backward, in f32 as
    the trainer's step runs them (no optimizer update). With ``smooth`` the
    inputs are made as ``chip_smoke.write_train_dataset`` makes a case (a
    smooth volume, the target a shifted copy, its projections from the
    port's projector) instead of uniform noise."""
    from liftreg_tpu_torch.device import f32_precision
    from liftreg_tpu_torch.losses.registration import RegNet2D3DLoss
    sz = (cs.SZ,) * 3
    torch.manual_seed(0)
    model = RegNet2D3D(sz).to(dev)
    loss_fn = RegNet2D3DLoss({"sim_class": "ncc"})
    g = torch.Generator(device=dev).manual_seed(4)
    res = drr.default_resolution(sz)
    poses = torch.from_numpy(drr.synthesize_poses(30.0, 4, cs.SZ)).to(dev)
    if smooth:
        import torch.nn.functional as F
        from liftreg_tpu_torch.ops.drr_kernel import project_taps
        base = cs._smooth_field(torch, F, g, (1, 1) + sz, 8, dev)
        target = torch.roll(base, shifts=(2, -3, 1), dims=(2, 3, 4)) \
            + cs._smooth_field(torch, F, g, (1, 1) + sz, 6, dev) * 0.09
        hu = target * 450.0 - 500.0
        geom = drr.forward_geometry(poses, sz, res, (2.2, 2.2, 2.2))
        proj = project_taps(drr.calc_relative_atten_coef(hu[0, 0])[None]
                            .contiguous(), *geom)
        inputs = {"source": base, "target": target,
                  "original_source": (base * 450.0 + 500.0) / 1000.0 * 0.2,
                  "target_proj": drr.normalize_drr(proj)}
    else:
        vol = torch.rand((1, 1) + sz, generator=g, device=dev)
        inputs = {
            "source": vol * 2.0 - 1.0,
            "target": torch.rand((1, 1) + sz, generator=g, device=dev),
            "original_source": vol * 0.3,
            "target_proj": torch.rand((1, 4) + res, generator=g,
                                      device=dev) * 2.0 - 1.0}
    inputs.update(source_label=torch.ones((1, 1) + sz, device=dev),
                  target_poses=poses[None],
                  spacing=torch.full((1, 3), 2.2, device=dev))

    def step():
        # f32 convolutions forward and backward, as the trainer's step
        # keeps them
        with f32_precision():
            model.zero_grad(set_to_none=True)
            loss_fn(model(inputs), 1.0)["total_loss"].backward()

    return step


def _regnet_step(torch, cs, drr, RegNet2D3D, dev):
    """RegNet2D3D's step at the stage-1 shape: the median ms of 5 steps
    after 1 warm-up and the peak memory, then the device ms and launches
    of the image gradient in one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    def image_grad(step):
        """(device ms, launches) of the image gradient in one step."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "warp_image_grad" in e.key]
        return (sum(e.self_device_time_total for e in events) / 1e3,
                sum(e.count for e in events))

    step = regnet_step_inputs(torch, cs, drr, RegNet2D3D, dev)
    steps, median, peak = _median_step(torch, step, 5)
    ms, launches = image_grad(step)
    del step
    step = regnet_step_inputs(torch, cs, drr, RegNet2D3D, dev, smooth=True)
    step()
    smooth_ms, smooth_launches = image_grad(step)
    return {"regnet_step_calls": steps, "regnet_step": median,
            "regnet_step_peak_gib": peak, "regnet_image_grad_ms": ms,
            "regnet_image_grad_launches": launches,
            "regnet_image_grad_smooth_ms": smooth_ms,
            "regnet_image_grad_smooth_launches": smooth_launches}


def _subspace_step(torch, cs, drr, model_cls, key, dev):
    """``model_cls``'s forward, the subspace loss (NCC, reg factor 0.01) and
    the backward at the reference config, f32, random seeded weights,
    inputs and basis: the median ms of 3 steps after 1 warm-up, and the
    peak memory."""
    from liftreg_tpu_torch.device import f32_precision
    from liftreg_tpu_torch.losses.registration import SubspaceLoss
    sz, batch, n = (cs.SZ,) * 3, cs.TRAIN_B, 3 * cs.SZ ** 3
    torch.manual_seed(0)
    model = model_cls(sz, latent_dim=cs.LATENT, drr_feature_num=4).to(dev)
    loss_fn = SubspaceLoss({"sim_class": "ncc", "initial_reg_factor": 0.01,
                            "min_reg_factor": 0.01})
    g = torch.Generator(device=dev).manual_seed(5)
    res = drr.default_resolution(sz)
    label = (torch.rand((batch, 1) + sz, generator=g, device=dev)
             > 0.3).float()
    inputs = {"source": torch.rand((batch, 1) + sz, generator=g,
                                   device=dev) * 2.0 - 1.0,
              "target": torch.rand((batch, 1) + sz, generator=g,
                                   device=dev) * 2.0 - 1.0,
              "source_label": label, "target_label": label,
              "target_proj": torch.rand((batch, 4) + res, generator=g,
                                        device=dev) * 2.0 - 1.0,
              "target_poses": torch.from_numpy(
                  drr.synthesize_poses(30.0, 4, cs.SZ)).to(dev)}
    pca = {"vectors": torch.randn((cs.LATENT, n), generator=g, device=dev)
           * 0.01, "mean": torch.zeros(n, device=dev)}

    def step():
        with f32_precision():
            model.zero_grad(set_to_none=True)
            loss_fn(model(inputs, pca), 0.01)["total_loss"].backward()

    steps, median, peak = _median_step(torch, step, 3)
    del model, inputs, pca
    torch.cuda.empty_cache()
    return {f"{key}_calls": steps, key: median, f"{key}_peak_gib": peak}


def _optreg_level(torch, cs, dev, sz=96, level=(20, 60, 0.02), batch=2):
    """One pyramid level of per-pair registration (``optreg.make_level``,
    as ``tools/torch_profile_optreg.py`` profiles it) at ``sz``^3, B = 2,
    bf16 taps, on smooth seeded volumes: a function of no arguments that
    runs it, and its n + 1 gradient evaluations (steps)."""
    import torch.nn.functional as F
    from liftreg_tpu_torch import optreg
    grid, steps, lr = level
    g = torch.Generator(device=dev).manual_seed(9)
    moving = cs._smooth_field(torch, F, g, (batch, 1) + (sz,) * 3, 6, dev)
    target = torch.roll(moving, shifts=(1, -2, 1), dims=(2, 3, 4))
    fn = optreg.make_level((sz,) * 3, grid, n_steps=steps, lr=lr,
                           warp_taps_dtype=torch.bfloat16)
    z0 = torch.zeros((batch, 3) + (grid,) * 3, device=dev)
    return lambda: fn(z0, moving, target), steps + 1


def _optreg_step(torch, cs, dev, sz=96):
    """:func:`_optreg_level`'s ms a step of each of 10 calls after 1
    warm-up, their median."""
    run, steps = _optreg_level(torch, cs, dev, sz)
    calls, median, _ = _median_step(torch, run, 10)
    key = f"optreg_step_{sz}"
    return {f"{key}_calls": [c / steps for c in calls], key: median / steps}


def optreg_op_turns(calls=40):
    """The 96^3 optreg step (:func:`_optreg_level`) with the warp's forward
    called through the ``liftreg::warp_trilinear`` operator and through
    the operator's implementation directly, in one process, in turns (op,
    direct, direct, op, ...; 1 warm-up each): ms a step of each call, the
    medians and the means, and the means' difference with its standard
    error. The step is host-bound, so this is the operator's
    registration's cost to it."""
    sys.path.insert(0, str(ROOT))
    import torch
    from liftreg_tpu_torch.ops import warp_kernel
    cs = chip_smoke_module()
    run, steps = _optreg_level(torch, cs, torch.device("cuda"))
    op = warp_kernel.warp_trilinear

    def direct(taps, coords, border, normalized=False,
               scale_intensity=False):
        return warp_kernel._warp_impl(taps, coords, bool(border),
                                      bool(normalized), bool(scale_intensity))

    direct.launches = 0
    times = {"op": [], "direct": []}
    try:
        for i in range(-2, 2 * calls):
            name = "op" if i % 4 in (0, 3) else "direct"
            warp_kernel.warp_trilinear = op if name == "op" else direct
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i >= 0:
                times[name].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        warp_kernel.warp_trilinear = op
    if direct.launches == 0 or op.launches == 0:
        raise RuntimeError("optreg_op_turns: a path launched no warp")
    med = {k: sorted(v)[calls // 2] for k, v in times.items()}
    mean = {k: sum(v) / calls for k, v in times.items()}
    var = {k: sum((t - mean[k]) ** 2 for t in v) / (calls - 1)
           for k, v in times.items()}
    print(json.dumps({"optreg_step_96_turns": times, "calls": calls,
                      "median_op": med["op"], "median_direct": med["direct"],
                      "mean_op": mean["op"], "mean_direct": mean["direct"],
                      "op_minus_direct_ms": mean["op"] - mean["direct"],
                      "se_ms": ((var["op"] + var["direct"]) / calls) ** 0.5,
                      "op_over_direct": mean["op"] / mean["direct"] - 1.0}),
          flush=True)


def _host_us(torch, cs, dev, calls=2000):
    """Host microseconds a call of each forward wrapper on a tiny input
    (8^3, B = 1: the launch is all there is), ``calls`` calls after 100
    warm-ups and one synchronize at the end: the cost of the call path
    (the wrapper, and where the tree registers them, the dispatcher's hop
    into the operator's Python implementation)."""
    from liftreg_tpu_torch.ops import drr
    from liftreg_tpu_torch.ops.drr_kernel import backproject_taps, project_taps
    from liftreg_tpu_torch.ops.pca_kernel import pca_expand
    from liftreg_tpu_torch.ops.warp_kernel import warp_trilinear
    g = torch.Generator(device=dev).manual_seed(3)
    sz = (8, 8, 8)
    poses = torch.from_numpy(drr.synthesize_poses(30.0, 2, 8)).to(dev)
    fwd = drr.forward_geometry(poses, sz, (12, 12), (2.2, 2.2, 2.2))
    bwd = drr.backward_geometry(poses, sz, (12, 12))
    vol = torch.rand((1,) + sz, generator=g, device=dev)
    proj = torch.rand((1, 2, 12, 12), generator=g, device=dev)
    taps = torch.rand((1, 1) + sz, generator=g, device=dev).bfloat16()
    phi = torch.rand((1, 3) + sz, generator=g, device=dev) * 2.0 - 1.0
    coefs = torch.rand((1, 8), generator=g, device=dev)
    V = torch.rand((8, 3 * 512), generator=g, device=dev).bfloat16()
    mean = torch.rand((3 * 512,), generator=g, device=dev)
    fns = {"drr_project": lambda: project_taps(vol, *fwd),
           "drr_backproject": lambda: backproject_taps(proj, *bwd),
           "pca_expand": lambda: pca_expand(coefs, V, mean),
           "warp_trilinear": lambda: warp_trilinear(
               taps, phi, False, normalized=True, scale_intensity=True)}
    out = {}
    for name, fn in fns.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e6 / calls
    return {"host_us_a_call": out}


def main(argv):
    if len(argv) == 3 and argv[1] == "--one":
        _time_tree(os.path.abspath(argv[2]))
        return 0
    if len(argv) in (2, 3) and argv[1] == "--optreg-op-turns":
        optreg_op_turns(*map(int, argv[2:]))
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
