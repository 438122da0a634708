"""The port's kernels at the shapes where the JAX tool asked whether a
hand-written kernel beats the library; the port of
``tools/bench_pallas_frontier.py``:

  1. the PCA expansion (``ops/pca_kernel.py``: ``csrc/pca_expand.cu``) at
     latent 56, 128 and 256 (160^3, B = 4, bf16 basis, f32 coefficients,
     mean and output): larger latents stream proportionally more basis
     bytes. Beside it ``torch.addmm`` (bf16, ``out_dtype=f32``) and the
     kernel's plain version;
  2. the projector and the lift (``ops/drr_kernel.py``:
     ``csrc/drr_project.cu``, ``csrc/drr_backproject.cu``) at 160^3 (a
     240^2 detector) and 192^3 (288^2; ``BASELINE.json`` config 4's
     resolution-scaling shape), B = 1, 4 views; beside each the f32
     ``torch.matmul`` chain on the dense two-tap matrices
     (``drr.project_with_mats``, ``drr.backproject_with_mats``) and the
     kernel's plain version.

Each row's bound is the least time the card could take, the larger of its
bytes (each input read once, each output written once) at 3.35 TB/s and
its operations at the dense peak of their type (the PCA expansion's bf16
products at 989 TFLOP/s, the DRR's f32 at 67 TFLOP/s), as ``PERF.md`` §6
reckons its rows. Times are the device time between CUDA events around
``--reps`` calls after a warm-up, their mean (the plain versions and the
chains over 2 calls). Each kernel's largest difference from its plain
version is reported beside its time, also relative to the plain
version's largest value. Where a kernel refuses a shape (the
PCA kernel's shared memory, the DRR kernels' 32-bit indices) the row says
so and the tool goes on; nothing stands in for the kernel.

Prints a decision table (the winner of kernel and library per row), then
one JSON line: the card's name and power limit and the rows (ms of the
kernel, the library call and the plain version, bound ms and what bounds
it, the kernel's share of its bound, its launches a call). Runs on the
CUDA card; ``--device cpu`` runs the plain versions on the host clock
(small ``--size``/``--sizes`` there; the library call of the PCA
expansion is then the same product in f32, the host's ``addmm`` having
no bf16 product into f32).

Usage: python tools/torch_bench_pallas_frontier.py [--reps 10]
       [--skip_pca] [--skip_drr]
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

LATENTS = (56, 128, 256)
DRR_SIZES = (160, 192)
PCA_BATCH, DRR_BATCH, VIEWS = 4, 1, 4
#: multiply-adds x 2 of two taps, as PERF.md §6 counts the DRR kernels
DRR_OPS_PER_TWO_TAPS = 4
PLAIN_REPS = 2


def bound_ms(nbytes, ops, dtype):
    """The least ms the card could take: ``nbytes`` at the HBM rate or
    ``ops`` at the peak of ``dtype``, the larger; and which of the two."""
    t_bytes = nbytes / torch_timing.HBM_BYTES_PER_S * 1e3
    t_ops = ops / torch_timing.PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row(name, fn, plain, library, nbytes, ops, dtype, device, reps):
    """One row: the kernel (``fn``), its plain version and the library call
    timed, the kernel's error against its plain version, its bound."""
    bound, by = bound_ms(nbytes, ops, dtype)
    row = {"op": name, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "ops": ops}
    try:
        got, row["launches"] = torch_timing.counted(fn, device)
    except ValueError as err:
        # the kernel refuses this shape: say so, substitute nothing
        row.update(kernel_ms=None, refused=str(err))
    else:
        want = plain()
        row["max_abs_err"] = float((got - want).abs().max())
        row["rel_err"] = row["max_abs_err"] / float(want.abs().max())
        del got, want
        row["kernel_ms"] = torch_timing.kernel_ms(fn, device, reps)
        row["share_of_bound"] = bound / row["kernel_ms"]
    row["library_ms"] = torch_timing.kernel_ms(library, device, reps)
    row["plain_ms"] = torch_timing.kernel_ms(plain, device, PLAIN_REPS)
    print(f"{name}: kernel {row['kernel_ms']} ms, library "
          f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})",
          flush=True)
    return row


def bench_pca(device, reps, sz=160, latents=LATENTS, B=PCA_BATCH):
    from liftreg_tpu_torch.ops.pca_kernel import pca_expand, pca_expand_plain
    K = 3 * sz ** 3
    rows = []
    for L in latents:
        g = torch.Generator(device=device).manual_seed(L)
        V = (torch.randn((L, K), generator=g, device=device)
             * 0.01).bfloat16()
        mean = torch.randn((K,), generator=g, device=device) * 0.001
        z = torch.randn((B, L), generator=g, device=device)
        z16 = z.bfloat16()
        if device.type == "cuda":
            def library():
                return torch.addmm(mean, z16, V, out_dtype=torch.float32)
        else:
            # the host's addmm has no bf16 product into f32
            def library():
                return torch.addmm(mean, z16.float(), V.float())
        nbytes = z.numel() * 4 + V.numel() * 2 + mean.numel() * 4 + B * K * 4
        rows.append(_row(
            f"pca L={L} ({V.numel() * 2 / 2 ** 30:.2f} GiB basis)",
            lambda: pca_expand(z, V, mean),
            lambda: pca_expand_plain(z, V, mean),
            library, nbytes, 2 * B * L * K, "bfloat16", device, reps))
        rows[-1].update(kind="pca_expand", latent=L, size=sz, batch=B)
        del V, mean, z, z16
    return rows


def bench_drr(device, reps, sizes=DRR_SIZES, B=DRR_BATCH, n_proj=VIEWS):
    from liftreg_tpu_torch.ops import drr
    from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps,
                                                  backproject_taps_plain,
                                                  project_taps,
                                                  project_taps_plain)
    rows = []
    for sz in sizes:
        shape = (sz, sz, sz)
        res = drr.default_resolution(shape)
        poses = torch.from_numpy(drr.synthesize_poses(30.0, n_proj, sz)).to(
            device)
        spacing = (2.2, 2.2, 2.2)
        g = torch.Generator(device=device).manual_seed(sz)
        vol = torch.rand((B,) + shape, generator=g, device=device) * 0.2
        proj = torch.rand((B, n_proj) + res, generator=g, device=device) * 6
        fwd = drr.forward_geometry(poses, shape, res, spacing)
        bwd = drr.backward_geometry(poses, shape, res)
        Rx, Rz, dx = drr.forward_matrices(poses, shape, res, spacing)
        geom_bytes = sum(t.numel() * 4 for t in fwd)
        rows.append(_row(
            f"project {sz}^3", lambda: project_taps(vol, *fwd),
            lambda: project_taps_plain(vol, *fwd),
            lambda: drr.project_with_mats(vol, Rx, Rz, dx),
            vol.numel() * 4 + geom_bytes + B * n_proj * res[0] * res[1] * 4,
            DRR_OPS_PER_TWO_TAPS * B * n_proj * sz * res[0] * (sz + res[1]),
            "float32", device, reps))
        rows[-1].update(kind="drr_project", size=sz, resolution=list(res),
                        batch=B)
        del Rx, Rz
        Bu, Bv = drr.backward_matrices(poses, shape, res)
        geom_bytes = sum(t.numel() * 4 for t in bwd)
        rows.append(_row(
            f"backproject {sz}^3", lambda: backproject_taps(proj, *bwd),
            lambda: backproject_taps_plain(proj, *bwd),
            lambda: drr.backproject_with_mats(proj, Bu, Bv),
            proj.numel() * 4 + geom_bytes + B * n_proj * sz ** 3 * 4,
            DRR_OPS_PER_TWO_TAPS * B * n_proj * sz * sz * (res[1] + sz),
            "float32", device, reps))
        rows[-1].update(kind="drr_backproject", size=sz,
                        resolution=list(res), batch=B)
        del Bu, Bv, vol, proj
    return rows


def decision_table(rows):
    lines = [f"{'op':<32} {'library ms':>10} {'kernel ms':>10} "
             f"{'winner':>8} {'bound ms':>9} {'share':>6}"]
    for r in rows:
        if r["kernel_ms"] is None:
            lines.append(f"{r['op']:<32} {r['library_ms']:10.4f} "
                         f"{'refused':>10} {'library':>8} "
                         f"{r['bound_ms']:9.4f} {'--':>6}  "
                         f"({r['refused']})")
            continue
        win = "kernel" if r["kernel_ms"] < r["library_ms"] else "library"
        lines.append(f"{r['op']:<32} {r['library_ms']:10.4f} "
                     f"{r['kernel_ms']:10.4f} {win:>8} "
                     f"{r['bound_ms']:9.4f} {r['share_of_bound']:6.1%}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--skip_drr", action="store_true")
    ap.add_argument("--skip_pca", action="store_true")
    ap.add_argument("--size", type=int, default=160,
                    help="the PCA expansion's volume edge")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(DRR_SIZES),
                    help="the DRR kernels' volume edges")
    torch_timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    if not args.skip_pca:
        rows += bench_pca(device, args.reps, sz=args.size)
    if not args.skip_drr:
        rows += bench_drr(device, args.reps, sizes=args.sizes)
    print(decision_table(rows), flush=True)
    return torch_timing.emit(device, "torch_bench_pallas_frontier",
                             reps=args.reps, rows=rows)


if __name__ == "__main__":
    main()
