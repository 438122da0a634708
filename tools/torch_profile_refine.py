"""Each part of one refinement step alone on the card, then the whole step;
the port of ``tools/profile_refine.py``.

The parts, as ``refine.make_refiner``'s step computes them at B = 4,
160^3, latent 56:

  * ``expand_pca`` forward, and forward + VJP (the coefficients' gradient
    of the sum of squares): the PCA kernel and its backward for a bf16
    basis, an f32 ``torch.matmul`` for ``--pca f32``
  * the warp forward, and forward + gradient with respect to phi (the warp
    kernel and its coordinate gradient; ``--taps`` its tap type)
  * NCC forward + backward on the warped and target volumes
  * ``displacement_reg`` (the regulariser's central differences) forward +
    backward
  * the identity-map add (``phi = disp + idm``)
  * ``refine.make_refiner`` at ``n_steps=1`` and ``3``, their difference
    halved as the ms of one step, beside the sum of the parts

Each part's time is the device time between CUDA events around
``--reps`` calls after a warm-up call, their mean (the refiner's over
max(3, reps // 2)); f32 products stay f32 (``device.f32_precision``, as
the refiner runs). The operands are drawn on the device from a seed. The
JAX tool's ``--fast_vjp`` is not taken: the port has one warp backward
(ROADMAP A.9).

Prints the rows as they land, then one JSON line: the card's name and
power limit, ``rows`` (name, ms, the counted kernels' launches of one
call), ``refine_per_step_ms``, ``sum_of_parts_ms`` and the gap between
them. Runs on the CUDA card; ``--device cpu`` runs the plain versions on
the host clock.

Usage:  python tools/torch_profile_refine.py [--batch 4] [--size 160]
        [--latent 56] [--taps bf16|f32] [--pca bf16|f32] [--reps 10]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import torch_timing  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402

#: the parts whose sum stands beside the step
STEP_PARTS = ("expand_pca fwd+vjp", "warp fwd+grad(phi)", "ncc fwd+grad",
              "disp_reg fwd+grad", "phi = disp + idm")
REFINE_STEPS = (1, 3)


def parts(coefs, pca, moving, target, img_sz, taps_dtype):
    """The parts of one refinement step as zero-argument functions, each
    returning what it computes (a forward's output or a gradient), on the
    given operands: coefficients (B, L), the basis, the moving and target
    volumes (B, 1, D, W, H)."""
    from liftreg_tpu_torch.coords import identity_map
    from liftreg_tpu_torch.losses.registration import displacement_reg
    from liftreg_tpu_torch.losses.similarity import ncc_loss
    from liftreg_tpu_torch.models.subspace_backproj import expand_pca
    from liftreg_tpu_torch.ops import resample

    V, mean = pca["vectors"], pca["mean"]
    idm = identity_map(img_sz, device=coefs.device)

    def grad_of(loss, x):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(loss(x), x)[0]

    def warp(p):
        return resample.warp_image(moving, p, zero_boundary=True,
                                   scale_intensity=True,
                                   taps_dtype=taps_dtype)

    with torch.no_grad():
        disp = expand_pca(coefs, V, mean, img_sz)
        phi = disp + idm[None]
        warped = warp(phi)
    return {
        "expand_pca fwd": lambda: expand_pca(coefs, V, mean, img_sz),
        "expand_pca fwd+vjp": lambda: grad_of(
            lambda z: (expand_pca(z, V, mean, img_sz) ** 2).sum(), coefs),
        "warp fwd": lambda: warp(phi),
        "warp fwd+grad(phi)": lambda: grad_of(lambda p: warp(p).sum(), phi),
        "ncc fwd+grad": lambda: grad_of(
            lambda w: ncc_loss(w, target, reduction="none").mean(), warped),
        "disp_reg fwd+grad": lambda: grad_of(
            lambda d: displacement_reg(d, reduction="none").mean(), disp),
        "phi = disp + idm": lambda: disp + idm[None],
    }


def refiners(img_sz, taps_dtype):
    """``make_refiner`` at the JAX tool's settings for each of
    REFINE_STEPS."""
    from liftreg_tpu_torch.refine import make_refiner
    return {n: make_refiner(img_sz, sim="ncc", n_steps=n, lr=0.05,
                            reg_factor=1e-3, warp_taps_dtype=taps_dtype)
            for n in REFINE_STEPS}


def operands(B, sz, L, pca_dtype, device):
    """Seeded coefficients, basis and volumes on ``device``."""
    g = torch.Generator(device=device).manual_seed(0)
    K = 3 * sz ** 3
    pca = {"vectors": (torch.randn((L, K), generator=g, device=device)
                       * 0.01).to(pca_dtype),
           "mean": torch.randn((K,), generator=g, device=device) * 0.001}
    coefs = torch.randn((B, L), generator=g, device=device)
    shape = (B, 1, sz, sz, sz)
    moving = torch.rand(shape, generator=g, device=device) * 2.0 - 1.0
    target = torch.rand(shape, generator=g, device=device) * 2.0 - 1.0
    return coefs, pca, moving, target


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--latent", type=int, default=56)
    ap.add_argument("--taps", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--pca", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--reps", type=int, default=10)
    torch_timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from liftreg_tpu_torch.device import f32_precision

    B, sz, L = args.batch, args.size, args.latent
    img_sz = (sz, sz, sz)
    taps_dtype = torch.bfloat16 if args.taps == "bf16" else None
    pca_dtype = torch.bfloat16 if args.pca == "bf16" else torch.float32
    coefs, pca, moving, target = operands(B, sz, L, pca_dtype, device)
    print(f"B={B} {sz}^3 latent={L} taps={args.taps} pca={args.pca} on "
          f"{device}", flush=True)
    rows = []

    def add(name, fn, reps):
        # each row as it lands, so that a cut run still leaves data
        _, launches = torch_timing.counted(fn, device)
        ms = torch_timing.kernel_ms(fn, device, reps)
        rows.append({"name": name, "ms": ms, "launches": launches})
        print(f"{name:<26} {ms:9.3f} ms", flush=True)

    with f32_precision():
        for name, fn in parts(coefs, pca, moving, target, img_sz,
                              taps_dtype).items():
            add(name, fn, args.reps)
        totals = {}
        for n, refine in refiners(img_sz, taps_dtype).items():
            add(f"refine total n={n}",
                lambda refine=refine: refine(coefs, pca, moving, target),
                max(3, args.reps // 2))
            totals[n] = rows[-1]["ms"]
    per_step = (totals[3] - totals[1]) / 2.0
    parts_ms = sum(r["ms"] for r in rows if r["name"] in STEP_PARTS)
    print(f"{'refine per-step (diff)':<26} {per_step:9.3f} ms\n"
          f"{'sum of parts':<26} {parts_ms:9.3f} ms  (gap to per-step: "
          f"{per_step - parts_ms:+.3f} ms)", flush=True)
    return torch_timing.emit(
        device, "torch_profile_refine", batch=B, size=sz, latent=L,
        taps=args.taps, pca=args.pca, reps=args.reps, rows=rows,
        refine_per_step_ms=per_step, sum_of_parts_ms=parts_ms,
        gap_ms=per_step - parts_ms)


if __name__ == "__main__":
    main()
