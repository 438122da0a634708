"""Time the refinement tail and the one-file serving artifact on the card;
the port of ``tools/bench_refine.py``.

* default: ``RegistrationPipeline.register`` at the serving config (B = 4,
  160^3, 4 views on 240^2, latent 56, bf16 encoder, basis and taps) with
  ``refine_steps=0`` and with ``refine_steps=N`` (``--domain projection``
  refines against the projections through ``register_projections``),
  both pipelines from the same seeded weights::

      python tools/torch_bench_refine.py [--steps 30] [--domain image]

* ``--artifact PATH``: ``serving.ServingModel.load`` of a one-file
  artifact (``tools/torch_export_serving.py``), its first ``register``
  (or ``register_projections``) call and its steady state, the inputs
  handed over from the host each call, as a served caller hands them::

      python tools/torch_bench_refine.py --artifact flagship.liftreg

Methodology as the JAX tool's: the operands are made on the device from a
seed, the first call is timed alone (it holds the kernels' first-use
build and cuDNN's first calls), then 10 warm-up calls, then 3 chunks of 5
calls, each chunk ended by one ``torch.cuda.synchronize()``, and the best
chunk's ms a call is kept. ``--refine_fast_vjp`` is not taken: the port
has one warp backward (ROADMAP A.9).

Prints one JSON line: the card's name and power limit; per pipeline
(``calls``, by refine steps) or for the artifact, the first call's ms,
ms a call and registrations a second, and ``launches``, the counted
kernels' launches of one call; the refinement tail's ms a call and a step.
Runs on the CUDA card; ``--device cpu`` runs the plain versions on the
host clock.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import torch_timing  # noqa: E402
from liftreg_tpu_torch.device import resolve_device  # noqa: E402

WARMUP, CHUNKS, CHUNK = 10, 3, 5


def device_inputs(g, B, sz, n_proj, resolution, device):
    """Seeded HU volumes, a lung mask and normalized projections on
    ``device``, as the JAX tool draws them."""
    shape = (B, 1, sz, sz, sz)
    source_hu = torch.rand(shape, generator=g, device=device) * -1000.0
    target_hu = torch.rand(shape, generator=g, device=device) * -1000.0
    seg = (torch.rand(shape, generator=g, device=device) > 0.4).float()
    target_proj = torch.rand((B, n_proj) + tuple(resolution), generator=g,
                             device=device) * 2.0 - 1.0
    return source_hu, target_hu, seg, target_proj


def seeded_basis(g, latent, sz, device):
    """A seeded bf16 basis and f32 mean, as the JAX tool draws them."""
    n = 3 * sz ** 3
    return {"vectors": (torch.randn((latent, n), generator=g, device=device)
                        * 0.01).bfloat16(),
            "mean": torch.randn((n,), generator=g, device=device) * 0.01}


def timed_calls(call, device):
    """The first call's ms, then ms a call after the warm-up, and the
    launches of one call."""
    first_ms = torch_timing.call_ms(call, device)
    for _ in range(WARMUP):
        call()
    ms = torch_timing.stream_ms(call, device, CHUNKS, CHUNK)
    _, launches = torch_timing.counted(call, device)
    return {"first_call_ms": first_ms, "ms_per_call": ms,
            "launches": launches}


def make_pipeline(steps, domain, sz, latent, device):
    """The serving config's pipeline with ``steps`` refinement steps, its
    weights drawn from seed 0 (the same for every ``steps``)."""
    from liftreg_tpu_torch import RegistrationPipeline
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return RegistrationPipeline(
            (sz, sz, sz), latent_dim=latent, compute_dtype=torch.bfloat16,
            refine_steps=steps, refine_domain=domain, device=device)


def bench_refine(steps, domain, B, sz, latent, device):
    g = torch.Generator(device=device).manual_seed(0)
    pca = seeded_basis(g, latent, sz, device)
    calls, inputs = {}, None
    for n_steps in (0, steps):
        pipe = make_pipeline(n_steps, domain, sz, latent, device)
        if inputs is None:
            inputs = device_inputs(g, B, sz, int(pipe.poses.shape[0]),
                                   pipe.resolution, device)
        src, tgt, seg, proj = inputs
        if domain == "projection":
            def call(pipe=pipe):
                return pipe.register_projections(pca, src, proj, seg)[0]
        else:
            def call(pipe=pipe):
                return pipe.register(pca, src, tgt, seg, seg)[0]
        line = timed_calls(call, device)
        line["reg_per_s"] = B / line["ms_per_call"] * 1e3
        calls[n_steps] = line
        print(f"refine_steps={n_steps:3d} domain={domain}: first call "
              f"{line['first_call_ms']:.1f} ms, {line['ms_per_call']:.2f} "
              f"ms/call (B={B}, {line['reg_per_s']:.2f} reg/s)", flush=True)
        del pipe
    tail = calls[steps]["ms_per_call"] - calls[0]["ms_per_call"]
    return {"domain": domain, "batch": B, "size": sz, "latent": latent,
            "steps": steps, "calls": {str(k): v for k, v in calls.items()},
            "refine_tail_ms": tail,
            "refine_ms_per_step": tail / steps if steps else None}


def bench_artifact(path, device):
    from liftreg_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    model = ServingModel.load(path, device=device)
    load_ms = (time.perf_counter() - t0) * 1e3
    meta = model.meta
    B, sz = int(meta["batch_size"]), int(meta["img_sz"][0])
    g = torch.Generator(device=device).manual_seed(0)
    src, tgt, seg, proj = (t.cpu() for t in device_inputs(
        g, B, sz, int(meta.get("n_proj", 4)),
        tuple(meta.get("resolution", (240, 240))), device))
    if model.entry == "register_projections":
        def call():
            return model.register_projections(src, proj, seg)[0]
    else:
        def call():
            return model.register(src, tgt, seg, seg)[0]
    line = timed_calls(call, device)
    line["reg_per_s"] = B / line["ms_per_call"] * 1e3
    print(f"load {load_ms:.1f} ms, first {model.entry} "
          f"{line['first_call_ms']:.1f} ms, steady state "
          f"{line['ms_per_call']:.2f} ms/call (B={B}, host inputs)",
          flush=True)
    return {"artifact": path, "entry": model.entry, "batch": B, "size": sz,
            "refine_steps": int(meta["refine_steps"]), "load_ms": load_ms,
            **line}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--domain", choices=("image", "projection"),
                    default="image")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--latent", type=int, default=56)
    ap.add_argument("--artifact", default=None,
                    help="path to a .liftreg artifact: time its load and "
                         "calls instead of the refinement comparison")
    torch_timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.artifact:
        fields = bench_artifact(args.artifact, device)
    else:
        fields = bench_refine(args.steps, args.domain, args.batch, args.size,
                              args.latent, device)
    return torch_timing.emit(device, "torch_bench_refine", **fields)


if __name__ == "__main__":
    main()
