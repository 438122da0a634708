"""A/B of the space-to-depth encoder stages on the card at the serving and
training configs (160^3); the port of ``tools/bench_ab.py``:

  1. serving: ``RegistrationPipeline.register`` (bf16 encoder, basis and
     taps, latent 56, 4 views on 240^2) at B = 4 and B = 8, with
     ``s2d_encoder`` off and on, each pipeline from the same seeded
     weights; the four pipelines are timed in turns (off, on, on, off at
     each batch), each turn 2 chunks of ``--iters`` calls ended by one
     ``torch.cuda.synchronize()``, after a first call and 6 warm-ups; the
     best chunk gives registrations a second;
  2. training: one step of ``LiftRegSubspaceBackproj`` (bf16 encoder and
     taps, bf16 basis, the subspace loss with NCC, Adam at lr 1e-3) at
     B = 2 with ``s2d_encoder`` off and on: the forward, the loss, the
     gradients (``train.trainer.loss_and_grads``) and the update, timed
     as 2 chunks of ``--train_iters`` steps after a first step and 3 more.

The JAX tool's Pallas PCA rows (``pca_expand_pallas``) are not taken: the
port's PCA expansion is always its kernel (ROADMAP A.9).

Prints one JSON line: the card's name and power limit, ``serving`` (per
batch and form: the first call's ms, ms a call, registrations a second,
the counted kernels' launches of one call) and ``training`` (per form:
ms a step, pairs a second, the launches of one step). ``--skip-serve`` and
``--skip-train`` leave a part out. Runs on the CUDA card; ``--device cpu``
runs the plain versions on the host clock (small ``--size`` there).

Run:  python tools/torch_bench_ab.py [--skip-train] [--skip-serve]
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

LATENT, VIEWS = 56, 4
SERVE_BATCHES = (4, 8)
SERVE_WARMUP, CHUNKS = 6, 2
TRAIN_B, TRAIN_WARMUP = 2, 3


def seeded_basis(g, latent, sz, device):
    n = 3 * sz ** 3
    return {"vectors": (torch.randn((latent, n), generator=g, device=device)
                        * 0.01).bfloat16(),
            "mean": torch.randn((n,), generator=g, device=device) * 0.01}


def serving(sz, iters, device):
    """Each batch's pipelines off and on in turns."""
    from liftreg_tpu_torch import RegistrationPipeline

    g = torch.Generator(device=device).manual_seed(0)
    pca = seeded_basis(g, LATENT, sz, device)
    out = {}
    for B in SERVE_BATCHES:
        shape = (B, 1, sz, sz, sz)
        src = torch.rand(shape, generator=g, device=device) * -1000.0
        tgt = torch.rand(shape, generator=g, device=device) * -1000.0
        seg = (torch.rand(shape, generator=g, device=device) > 0.4).float()
        calls, lines = {}, {}
        for s2d in (False, True):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                pipe = RegistrationPipeline(
                    (sz,) * 3, latent_dim=LATENT, n_proj=VIEWS,
                    compute_dtype=torch.bfloat16, s2d_encoder=s2d,
                    device=device)

            def call(pipe=pipe):
                return pipe.register(pca, src, tgt, seg, seg)[0]
            first = torch_timing.call_ms(call, device)
            for _ in range(SERVE_WARMUP):
                call()
            _, launches = torch_timing.counted(call, device)
            calls[s2d] = call
            lines[s2d] = {"first_call_ms": first, "chunks_ms": [],
                          "launches": launches}
        for s2d in (False, True, True, False):
            lines[s2d]["chunks_ms"].append(torch_timing.stream_ms(
                calls[s2d], device, CHUNKS, iters))
        for s2d, line in lines.items():
            line["ms_per_call"] = min(line["chunks_ms"])
            line["reg_per_s"] = B / line["ms_per_call"] * 1e3
            print(f"serving s2d={s2d} B={B}: {line['reg_per_s']:.2f} reg/s "
                  f"({line['ms_per_call']:.2f} ms/batch)", flush=True)
        out[str(B)] = {"s2d_off": lines[False], "s2d_on": lines[True]}
        del calls, src, tgt, seg
    return out


def train_case(sz, device, B=TRAIN_B):
    """The JAX tool's seeded batch, basis and model parameters."""
    from liftreg_tpu_torch.ops import drr

    g = torch.Generator(device=device).manual_seed(0)
    pca = seeded_basis(g, LATENT, sz, device)
    res = drr.default_resolution((sz,) * 3)
    poses = torch.from_numpy(drr.synthesize_poses(30.0, VIEWS, sz)).to(
        device)
    shape = (B, 1, sz, sz, sz)
    batch = {
        "source": torch.rand(shape, generator=g, device=device),
        "target": torch.rand(shape, generator=g, device=device),
        "source_label": torch.ones(shape, device=device),
        "target_label": torch.ones(shape, device=device),
        "target_proj": torch.rand((B, VIEWS) + res, generator=g,
                                  device=device),
        "target_poses": poses[None].expand(B, -1, -1),
    }
    return batch, pca


def train_step_fn(s2d, sz, batch, pca, device):
    """One step of the JAX tool's training loop with ``s2d_encoder`` as
    given: a zero-argument function that runs it and returns the loss."""
    from liftreg_tpu_torch.losses.registration import get_loss
    from liftreg_tpu_torch.models import LiftRegSubspaceBackproj
    from liftreg_tpu_torch.parallel import Mesh
    from liftreg_tpu_torch.train.optim import Adam, apply_updates
    from liftreg_tpu_torch.train.trainer import loss_and_grads

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = LiftRegSubspaceBackproj(
            (sz,) * 3, latent_dim=LATENT, drr_feature_num=VIEWS,
            compute_dtype=torch.bfloat16, warp_taps_dtype=torch.bfloat16,
            s2d_encoder=s2d).to(device)
    loss = get_loss("subspace")({"sim_class": "ncc"})
    params = dict(model.named_parameters())
    opt = Adam(1e-3, eps=1e-8)              # optax.adam(1e-3)
    state = {"opt": opt.init(params)}
    mesh = Mesh(device=device)

    def step():
        losses, grads = loss_and_grads(model, loss, params, batch, pca, 0.01,
                                       None, mesh)
        with torch.no_grad():
            updates, state["opt"] = opt.update(grads, state["opt"], params)
            for k, p in apply_updates(params, updates).items():
                params[k].copy_(p)
        return losses["total_loss"]
    return step


def training(sz, iters, device):
    batch, pca = train_case(sz, device)
    out = {}
    for s2d in (False, True):
        step = train_step_fn(s2d, sz, batch, pca, device)
        first = torch_timing.call_ms(step, device)
        for _ in range(TRAIN_WARMUP):
            step()
        loss, launches = torch_timing.counted(step, device)
        ms = torch_timing.stream_ms(step, device, CHUNKS, iters)
        out["s2d_on" if s2d else "s2d_off"] = {
            "first_step_ms": first, "ms_per_step": ms,
            "pairs_per_s": TRAIN_B / ms * 1e3, "launches": launches,
            "loss_finite": bool(torch.isfinite(loss))}
        print(f"train s2d={s2d} B={TRAIN_B}: {ms:.1f} ms/step "
              f"({TRAIN_B / ms * 1e3:.2f} pairs/s)", flush=True)
        del step
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--iters", type=int, default=10,
                    help="calls in each timed serving chunk")
    ap.add_argument("--train_iters", type=int, default=5,
                    help="steps in each timed training chunk")
    torch_timing.add_device_arg(ap)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    fields = {"size": a.size}
    if not a.skip_serve:
        fields["serving"] = serving(a.size, a.iters, device)
    if not a.skip_train:
        fields["training"] = training(a.size, a.train_iters, device)
    return torch_timing.emit(device, "torch_bench_ab", **fields)


if __name__ == "__main__":
    main()
