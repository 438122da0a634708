#!/usr/bin/env python3
"""The encoder's first two conv stages on the card in their two forms: the
plain ``ConvBlock`` pair (3^3, 5 -> 16 channels at stride 1, then 16 -> 32
at stride 2) and the space-to-depth pair (``liftreg_tpu_torch/models/
s2d.py``: 2^3, 40 -> 128, then 128 -> 32), from the same seeded
parameters, at 160^3.

    python3 tools/torch_s2d_stages.py [--out FILE]

For f32 and bf16 compute, B = 30 (the reference training batch) and B = 4
(the serving batch), with ``torch.backends.cudnn.benchmark`` off and then
on, it prints one JSON line: the s2d forward's largest difference from the
plain forward and each parameter's gradient's (of a seeded cotangent),
each relative to the plain result's largest value; ms of the forward
(without autograd, as serving runs it) and of forward + backward (the
parameters' gradients, not the input's, as a train step needs them) of
each form, with CUDA events after a warm-up; and each form's operations
and its bound (the larger of its operations at the card's peak for the
compute type and the bytes of its input and output at the HBM rate).
The same for each stage alone (``stages``: stage 0 from the input, stage
1 from stage 0's output, whose gradient a train step also takes), and
the device ms of the 6 longest kernels of each form's forward + backward
under ``torch.profiler`` (``kernels``). f32 runs without TF32
(``device.f32_precision``). The card's name and power limit come first.
Needs a CUDA card; imports nothing of JAX. ``chip_smoke.py``'s s2d phase
calls :func:`measure` (the pair only) and holds the differences to its
tolerances.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SZ = 160
WIDTHS = (5, 16, 32)          # input channels, stage 0's, stage 1's
BATCHES = (30, 4)
DTYPES = ("float32", "bfloat16")
# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core and f32 peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def stage_ops(batch, sz=SZ, widths=WIDTHS):
    """Multiply-adds x 2 of one forward of each stage, each form:
    ``{"plain": (stage 0, stage 1), "s2d": (stage 0, stage 1)}``. A
    forward + backward with the parameters' gradients does each stage's
    forward and weight gradient and stage 1's data gradient: 2 x stage 0
    + 3 x stage 1."""
    C, Fo, G = widths
    half = (sz // 2) ** 3
    return {"plain": (2 * batch * sz ** 3 * C * 27 * Fo,
                      2 * batch * half * Fo * 27 * G),
            "s2d": (2 * batch * half * 8 * C * 8 * 8 * Fo,
                    2 * batch * half * 8 * 8 * Fo * G)}


def stage_bytes(batch, dtype_bytes, sz=SZ, widths=WIDTHS):
    """Bytes a forward must move: the input read once, the output written
    once (the parameters are a few kB)."""
    C, _, G = widths
    return (batch * C * sz ** 3 + batch * G * (sz // 2) ** 3) * dtype_bytes


def build(torch, batch, dtype, device, sz=SZ, widths=WIDTHS, seed=0):
    """(x, blocks, cot): a seeded input in ``dtype``, the two seeded
    ``ConvBlock``s computing in ``dtype`` (f32 parameters) and a seeded
    f32 cotangent of the stage-1 output."""
    from liftreg_tpu_torch.models.blocks import ConvBlock
    C, Fo, G = widths
    torch.manual_seed(seed)
    blocks = (ConvBlock(C, Fo, stride=1, dtype=dtype).to(device),
              ConvBlock(Fo, G, stride=2, dtype=dtype).to(device))
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, C) + (sz,) * 3, generator=g,
                    device=device).to(dtype)
    cot = torch.randn((batch, G) + (sz // 2,) * 3, generator=g,
                      device=device)
    return x, blocks, cot


def forms(x, blocks, dtype):
    """The two forms' forward functions of ``x``."""
    from liftreg_tpu_torch.models import s2d
    b0, b1 = blocks

    def plain():
        return b1(b0(x))

    def fast():
        return s2d.conv_pair_s2d(x, b0.conv.weight, b0.conv.bias,
                                 b1.conv.weight, b1.conv.bias,
                                 b0.negative_slope, dtype)
    return {"plain": plain, "s2d": fast}


def stage_forms(torch, x, blocks, dtype):
    """Each stage alone in each form: ``{stage: {form: (fn, leaves)}}``,
    ``fn`` its forward and ``leaves`` what its backward differentiates
    (stage 0: its parameters; stage 1: its parameters and its input,
    stage 0's output computed once, plain or packed)."""
    from liftreg_tpu_torch.models import s2d
    b0, b1 = blocks
    w0, c0, w1, c1 = _params(blocks)
    slope = b0.negative_slope
    with torch.no_grad():
        y = b0(x).requires_grad_()
        y2 = s2d.conv0_s2d(x, w0, c0, slope, dtype).requires_grad_()
    return {
        "stage0": {"plain": (lambda: b0(x), [w0, c0]),
                   "s2d": (lambda: s2d.conv0_s2d(x, w0, c0, slope, dtype),
                           [w0, c0])},
        "stage1": {"plain": (lambda: b1(y), [w1, c1, y]),
                   "s2d": (lambda: s2d.conv1_s2d(y2, w1, c1, slope, dtype),
                           [w1, c1, y2])}}


def _params(blocks):
    return [p for b in blocks for p in (b.conv.weight, b.conv.bias)]


def grads(torch, fn, blocks, cot):
    """The output and the parameters' gradients of ``(out * cot).sum()``."""
    out = fn()
    got = torch.autograd.grad((out.float() * cot).sum(), _params(blocks))
    return out.detach(), got


def errors(torch, x, blocks, cot, dtype):
    """The s2d form against the plain form: the forward's and each
    parameter gradient's largest difference over the plain value's
    largest magnitude."""
    from liftreg_tpu_torch.device import f32_precision
    fns = forms(x, blocks, dtype)
    with f32_precision():
        want, want_g = grads(torch, fns["plain"], blocks, cot)
        got, got_g = grads(torch, fns["s2d"], blocks, cot)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {"forward": rel(got, want)}
    for name, a, b in zip(("w0", "b0", "w1", "b1"), got_g, want_g):
        out[name] = rel(a, b)
    return out


def _cuda_ms(torch, fn, iters, warmup):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def times(torch, x, blocks, cot, dtype, iters, warmup=1):
    """ms of each form's forward (without autograd) and forward +
    backward (the parameters' gradients)."""
    from liftreg_tpu_torch.device import f32_precision
    out = {}
    with f32_precision():
        for name, fn in forms(x, blocks, dtype).items():
            with torch.no_grad():
                out[f"{name}_forward_ms"] = _cuda_ms(torch, fn, iters,
                                                     warmup)
            out[f"{name}_forward_backward_ms"] = _cuda_ms(
                torch, lambda: grads(torch, fn, blocks, cot), iters, warmup)
    return out


def stage_times(torch, x, blocks, dtype, iters, warmup=1):
    """ms of each stage's forward (without autograd) and forward +
    backward in each form, beside each stage's bounds."""
    from liftreg_tpu_torch.device import f32_precision
    ops = stage_ops(x.shape[0])
    peak = PEAK_FLOPS[str(dtype).split(".")[-1]]
    C, Fo, G = WIDTHS
    vox = x.shape[0] * x[0, 0].numel()
    # each stage's input read once and output written once
    nbytes = {"stage0": (C + Fo) * vox * x.element_size(),
              "stage1": (Fo * vox + G * vox // 8) * x.element_size()}
    out = {}
    with f32_precision():
        for i, (stage, fns) in enumerate(stage_forms(torch, x, blocks,
                                                     dtype).items()):
            line = {}
            for name, (fn, leaves) in fns.items():
                with torch.no_grad():
                    line[f"{name}_forward_ms"] = _cuda_ms(torch, fn, iters,
                                                          warmup)

                def fwd_bwd(fn=fn, leaves=leaves):
                    o = fn()
                    return torch.autograd.grad(o.float().sum(), leaves)
                line[f"{name}_forward_backward_ms"] = _cuda_ms(
                    torch, fwd_bwd, iters, warmup)
                # the forward, the weight gradient, and for stage 1 the
                # data gradient
                n_ops = ops[name][i]
                line[f"{name}_bound_ms"] = {
                    "forward": max(n_ops / peak, nbytes[stage]
                                   / HBM_BYTES_PER_S) * 1e3,
                    "forward_backward": max(
                        (2 + i) * n_ops / peak,
                        2 * nbytes[stage] / HBM_BYTES_PER_S) * 1e3}
            out[stage] = line
    return out


def top_kernels(torch, x, blocks, cot, dtype, n=6):
    """Each form's forward + backward under torch.profiler: the device ms
    and launches of its ``n`` longest kernels, and its device total."""
    from torch.profiler import ProfilerActivity, profile

    from liftreg_tpu_torch.device import f32_precision
    out = {}
    with f32_precision():
        for name, fn in forms(x, blocks, dtype).items():
            grads(torch, fn, blocks, cot)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                grads(torch, fn, blocks, cot)
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0]
            rows.sort(key=lambda r: -r[1])
            out[name] = {"device_ms": sum(r[1] for r in rows),
                         "top": [[k[:90], round(t, 3), c]
                                 for k, t, c in rows[:n]]}
    return out


def bounds(batch, dtype_name):
    """Each form's operations (forward; forward + backward) and least ms:
    the larger of the operations at the compute type's peak and the bytes
    of a forward at the HBM rate."""
    ops = stage_ops(batch)
    nbytes = stage_bytes(batch, 4 if dtype_name == "float32" else 2)
    out = {}
    for name, (s0, s1) in ops.items():
        fwd, fwd_bwd = s0 + s1, 2 * s0 + 3 * s1
        out[name] = {
            "forward_ops": fwd, "forward_backward_ops": fwd_bwd,
            "forward_bound_ms": max(fwd / PEAK_FLOPS[dtype_name],
                                    nbytes / HBM_BYTES_PER_S) * 1e3,
            "forward_backward_bound_ms": max(
                fwd_bwd / PEAK_FLOPS[dtype_name],
                2 * nbytes / HBM_BYTES_PER_S) * 1e3}
    return out


def measure(torch, batch, dtype_name, device, iters=None,
            per_stage=False):
    """One JSON-ready line per ``cudnn.benchmark`` setting (off, then on)
    at ``batch`` and ``dtype_name``: the errors, the times, the bounds;
    with ``per_stage`` also each stage's times and each form's longest
    kernels."""
    dtype = getattr(torch, dtype_name)
    if iters is None:
        iters = 2 if batch * (4 if dtype_name == "float32" else 2) > 40 \
            else 5
    x, blocks, cot = build(torch, batch, dtype, device)
    lines = []
    before = torch.backends.cudnn.benchmark
    try:
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            line = {"batch": batch, "dtype": dtype_name,
                    "cudnn_benchmark": bench, "iters": iters,
                    "rel_err": errors(torch, x, blocks, cot, dtype)}
            line.update(times(torch, x, blocks, cot, dtype, iters))
            line["bounds"] = bounds(batch, dtype_name)
            if per_stage:
                line["stages"] = stage_times(torch, x, blocks, dtype, iters)
                line["kernels"] = top_kernels(torch, x, blocks, cot, dtype)
            lines.append(line)
    finally:
        torch.backends.cudnn.benchmark = before
    del x, blocks, cot
    torch.cuda.empty_cache()
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the lines to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_s2d_stages: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}]
    print(json.dumps(lines[0]), flush=True)
    dev = torch.device("cuda")
    for dtype_name in DTYPES:
        for batch in BATCHES:
            for line in measure(torch, batch, dtype_name, dev,
                                per_stage=True):
                print(json.dumps(line), flush=True)
                lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(ln) + "\n"
                                          for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
