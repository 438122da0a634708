"""The encoder's stage-0 convolution in its layout and dtype variants on
the card; the port of ``tools/bench_stage0.py``.

Stage 0 is the first ``ConvBlock`` of ``SubspaceEncoder``
(``liftreg_tpu_torch/models/subspace_backproj.py``): 3^3, C = 5 -> 16,
stride 1, pad 1, bias, LeakyReLU(0.2), at 160^3, B = 4. Variants, each
timed as the device time between CUDA events around ``--iters`` calls
after 3 warm-ups, their mean:

  * ``cf_f32``, ``cf_bf16``: NCDHW (torch's layout) in f32 and bf16
  * ``cl_f32``, ``cl_bf16``: the same tensors in ``channels_last_3d``
    (NDHWC in memory, the JAX encoder's layout)
  * ``cl_bf16_cpad8``, ``cl_bf16_cpad16``: the input channels padded with
    zeros to 8 and 16 (is C = 5 the pathology?)
  * ``kgrad_bf16``: the forward and the weight and bias gradients (the
    encoder's input takes no gradient), NCDHW
  * ``stage1_cf_bf16_s2``: stage 1's shape for context (16 -> 32, stride 2)
  * ``pair01_convblock_bf16`` and ``pair01_s2d_bf16``: stages 0+1 as the
    two ``ConvBlock``s and as the space-to-depth pair
    (``liftreg_tpu_torch/models/s2d.py``), forward, then with the four
    parameters' gradients (``... grad``)

f32 runs without TF32 (``device.f32_precision``). Then the 6 longest
device kernels of the NCDHW bf16 forward, the bf16 weight gradient and
each pair's forward + backward under ``torch.profiler``, as
``tools/torch_s2d_stages.py`` lists them (the JAX tool's ``--dump-hlo``
has no counterpart: there is no HLO), and the stage's bounds: its bf16
input and output at 3.35 TB/s, and its multiply-adds at the bf16 peak.

Prints one JSON line: the card's name and power limit, ``ms`` per
variant, ``kernels`` and the bounds. Runs on the CUDA card; ``--device
cpu`` runs on the host clock without the profiler's kernels (small
``--size`` there).

Usage: python tools/torch_bench_stage0.py [--iters 20] [--batch 4]
       [--size 160]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_timing  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402

SLOPE = 0.2
WARMUP = 3
TOP_KERNELS = 6


def conv(x, w, b, stride=1):
    """The ConvBlock's operator: conv3d (pad 1) + bias + LeakyReLU."""
    return F.leaky_relu(F.conv3d(x, w, b, stride=stride, padding=1), SLOPE)


def channels_last(x):
    return x.contiguous(memory_format=torch.channels_last_3d)


def pad_channels(x, w, c):
    """``x`` and ``w`` with zero input channels up to ``c``."""
    extra = c - x.shape[1]
    return (torch.cat([x, x.new_zeros((x.shape[0], extra) + x.shape[2:])],
                      1),
            torch.cat([w, w.new_zeros((w.shape[0], extra) + w.shape[2:])],
                      1))


def variants(B, S, C, Fo, device):
    """``{name: fn}`` of the timed variants, on seeded operands."""
    from liftreg_tpu_torch.models import s2d

    g = torch.Generator(device=device).manual_seed(0)
    x32 = torch.randn((B, C, S, S, S), generator=g, device=device)
    w32 = torch.randn((Fo, C, 3, 3, 3), generator=g, device=device) * 0.1
    b32 = torch.randn((Fo,), generator=g, device=device) * 0.1
    x16, w16, b16 = x32.bfloat16(), w32.bfloat16(), b32.bfloat16()
    out = {
        "cf_f32": lambda: conv(x32, w32, b32),
        "cf_bf16": lambda: conv(x16, w16, b16),
    }
    xl32, xl16 = channels_last(x32), channels_last(x16)
    wl32, wl16 = channels_last(w32), channels_last(w16)
    out["cl_f32"] = lambda: conv(xl32, wl32, b32)
    out["cl_bf16"] = lambda: conv(xl16, wl16, b16)
    for c in (8, 16):
        xp, wp = pad_channels(x16, w16, c)
        xp, wp = channels_last(xp), channels_last(wp)
        out[f"cl_bf16_cpad{c}"] = lambda xp=xp, wp=wp: conv(xp, wp, b16)

    wg = w16.clone().requires_grad_(True)
    bg = b16.clone().requires_grad_(True)

    def kgrad():
        return torch.autograd.grad((conv(x16, wg, bg).float() ** 2).sum(),
                                   (wg, bg))
    out["kgrad_bf16"] = kgrad

    x1 = torch.randn((B, Fo, S, S, S), generator=g,
                     device=device).bfloat16()
    w1_32 = torch.randn((32, Fo, 3, 3, 3), generator=g, device=device) * 0.1
    b1_32 = torch.zeros((32,), device=device)
    w1, b1 = w1_32.bfloat16(), b1_32.bfloat16()
    out["stage1_cf_bf16_s2"] = lambda: conv(x1, w1, b1, stride=2)

    # stages 0+1: the ConvBlock pair in bf16, and the s2d pair (f32
    # parameters, bf16 compute) on the f32 input, as the encoder runs them
    def pair_plain(x, w0, c0, v1, c1):
        return conv(conv(x, w0, c0), v1, c1, stride=2)

    def pair_s2d(x, w0, c0, v1, c1):
        return s2d.conv_pair_s2d(x, w0, c0, v1, c1, SLOPE,
                                 dtype=torch.bfloat16)

    forms = {"pair01_convblock_bf16": (pair_plain, x16, (w16, b16, w1, b1)),
             "pair01_s2d_bf16": (pair_s2d, x32, (w32, b32, w1_32, b1_32))}
    for name, (fn, x, params) in forms.items():
        out[name] = lambda fn=fn, x=x, params=params: fn(x, *params)
        leaves = [p.clone().requires_grad_(True) for p in params]

        def grad(fn=fn, x=x, leaves=leaves):
            return torch.autograd.grad(
                (fn(x, *leaves).float() ** 2).sum(), leaves)
        out[f"{name} grad"] = grad
    return out


def top_kernels(fn, n=TOP_KERNELS):
    """The device ms and launches of ``fn()``'s ``n`` longest kernels under
    torch.profiler, and its device total."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "top": [[k[:90], round(t, 4), c] for k, t, c in rows[:n]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--cin", type=int, default=5)
    ap.add_argument("--cout", type=int, default=16)
    torch_timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from liftreg_tpu_torch.device import f32_precision

    B, S, C, Fo = args.batch, args.size, args.cin, args.cout
    ms, kernels = {}, {}
    with f32_precision():
        fns = variants(B, S, C, Fo, device)
        for name, fn in fns.items():
            ms[name] = torch_timing.kernel_ms(fn, device, args.iters,
                                              warmup=WARMUP)
            print(f"{name:32s} {ms[name]:9.3f} ms/batch "
                  f"({ms[name] / B:8.3f} ms/elem)", flush=True)
        if device.type == "cuda":
            for name in ("cf_bf16", "kgrad_bf16", "pair01_convblock_bf16 grad",
                         "pair01_s2d_bf16 grad"):
                kernels[name] = top_kernels(fns[name])
    vox = B * S ** 3
    hbm_ms = vox * (C + Fo) * 2 / torch_timing.HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * vox * 27 * C * Fo / torch_timing.PEAK_OPS["bfloat16"] * 1e3
    print(f"# HBM floor (bf16 in + out, 3.35 TB/s): {hbm_ms:.3f} ms; "
          f"tensor-core floor (27 C F multiply-adds, 989 TFLOP/s bf16): "
          f"{ops_ms:.3f} ms", flush=True)
    return torch_timing.emit(
        device, "torch_bench_stage0", batch=B, size=S, cin=C, cout=Fo,
        iters=args.iters, ms=ms, kernels=kernels,
        bound_ms={"bytes_bf16": hbm_ms, "operations_bf16": ops_ms})


if __name__ == "__main__":
    main()
