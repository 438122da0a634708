"""The port's counterpart of ``__graft_entry__.py``: a one-forward check
of the flagship model on the card, and a dry run of the production
trainer and refined serving on a data mesh of CPU ranks.

    from liftreg_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()            # LiftRegSubspaceBackproj at 160^3
    out = fn(*args)
    dryrun_multichip(8)           # prints "dryrun_multichip(8) ok: ..."

The JAX version also points XLA at a persistent compile cache; the port
has none (the kernels are built once into ``build/``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .device import f32_precision, resolve_device
from .models import LiftRegSubspaceBackproj
from .ops import drr

REPO = Path(__file__).resolve().parent.parent

#: the dry run's synthetic set: 16^3, 2 views, latent 4
DRYRUN_SZ, DRYRUN_VIEWS, DRYRUN_LATENT = 16, 2, 4
_CHILD_ENV = "_LIFTREG_TORCH_DRYRUN_CHILD"


def _example_inputs(sz=160, n_proj=4, latent=56, batch=1, proj_res=None,
                    rng_seed=0, device=None):
    """The seeded inputs and f32 basis of ``__graft_entry__._example_inputs``
    (the same numpy draws in the same order) as tensors on ``device``
    (None: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    proj_res = proj_res or int(sz * 1.5)
    vol = (batch, 1, sz, sz, sz)
    inputs = {
        "source": rng.uniform(-1, 1, vol).astype(np.float32),
        "target": rng.uniform(-1, 1, vol).astype(np.float32),
        "source_label": (rng.uniform(size=vol) > 0.5).astype(np.float32),
        "target_label": (rng.uniform(size=vol) > 0.5).astype(np.float32),
        "target_proj": rng.uniform(-1, 1, (batch, n_proj, proj_res, proj_res))
        .astype(np.float32),
        "target_poses": np.tile(drr.synthesize_poses(30.0, n_proj, sz),
                                (batch, 1, 1)),
        "spacing": np.tile([2.2, 2.2, 2.2], (batch, 1)).astype(np.float32),
    }
    pca = {
        "vectors": rng.normal(size=(latent, 3 * sz ** 3)).astype(np.float32)
        * 0.01,
        "mean": rng.normal(size=(3 * sz ** 3,)).astype(np.float32) * 0.01,
    }
    return ({k: torch.from_numpy(v).to(device) for k, v in inputs.items()},
            {k: torch.from_numpy(v).to(device) for k, v in pca.items()})


def entry(device=None, sz=160, n_proj=4, latent=56, batch=1):
    """``(fn, example_args)``: ``fn(*example_args)`` is one forward of
    ``LiftRegSubspaceBackproj`` (f32, as the JAX entry builds it) at
    ``sz``^3 with ``n_proj`` views and latent ``latent``, its parameters
    drawn from seed 0, on the seeded inputs of :func:`_example_inputs`.
    ``device`` None is the card and raises without one; ``"cpu"`` runs the
    kernels' plain versions."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = LiftRegSubspaceBackproj((sz, sz, sz), latent_dim=latent,
                                        drr_feature_num=n_proj)
    model = model.to(dev).eval()
    inputs, pca = _example_inputs(sz=sz, n_proj=n_proj, latent=latent,
                                  batch=batch, device=dev)

    def fn(model_or_params, inputs, pca):
        """One forward: ``model_or_params`` is the model or a state dict
        for its structure (``torch.func.functional_call``, as JAX's
        ``model.apply`` takes its parameters); f32 products and
        convolutions stay f32."""
        with f32_precision():
            if isinstance(model_or_params, torch.nn.Module):
                return model_or_params(inputs, pca)
            return torch.func.functional_call(model, model_or_params,
                                              (inputs, pca))

    return fn, (model, inputs, pca)


def _dryrun_setting(data, exp, batch, n_train, epochs, resume_from=""):
    """The dry run's task setting: the canonical one with the JAX dry
    run's overrides."""
    from .utils.settings import default_task_setting
    return default_task_setting(data, exp, DRYRUN_SZ, overrides={
        "dataset": {"max_num_for_loading": [n_train, 3, 2, 2]},
        "train": {
            "dataloader": {"batch_size": batch},
            "continue_train": bool(resume_from),
            "continue_from": resume_from,
            "epoch": epochs,
            "loss": {"initial_reg_factor": 0.01, "min_reg_factor": 0.01,
                     "reg_factor_decay_from": 2},
            "model": {"drr_feature_num": DRYRUN_VIEWS,
                      "latent_dim": DRYRUN_LATENT,
                      "pca_path": os.path.join(data, "pca")},
            "step_timeout_s": 300,
        },
    })


def _dryrun_rank(mesh, job):
    """One rank of the dry run: two epochs of the trainer, a resumed third,
    then a refined ``register`` of one row a rank from the trained
    checkpoint. Returns what the checks need."""
    from .pca import load_pca
    from .pipeline import RegistrationPipeline
    from .train import RegistrationTrainer
    from .utils.checkpoint import load_checkpoint

    torch.set_num_threads(job["threads"])
    data, exp, batch, n_train = (job["data"], job["exp"], job["batch"],
                                 job["n_train"])
    trainer = RegistrationTrainer(
        _dryrun_setting(data, exp, batch, n_train, epochs=1), mesh=mesh)
    trainer.run()                     # epochs 0 and 1
    ckpt = os.path.join(exp, "checkpoints", "latest_checkpoint.ckpt")
    resumed = RegistrationTrainer(
        _dryrun_setting(data, exp, batch, n_train, epochs=2,
                        resume_from=ckpt), mesh=mesh)
    start_epoch = resumed.start_epoch
    resumed.run()                     # epoch 2
    mesh.barrier()                    # rank 0 has written its checkpoint

    sz = DRYRUN_SZ
    pipe = RegistrationPipeline((sz, sz, sz), latent_dim=DRYRUN_LATENT,
                                n_proj=DRYRUN_VIEWS, mesh=mesh,
                                refine_steps=2)
    pipe.model.load_state_dict(load_checkpoint(ckpt)["params"])
    pca = load_pca(os.path.join(data, "pca"), device=mesh.device)
    rows = mesh.rows(mesh.size)
    ids = [f"syn{i:03d}" for i in range(mesh.size)][rows]
    pre = os.path.join(data, "preprocessed")

    def stack(suffix):
        return torch.from_numpy(np.stack([
            np.load(os.path.join(pre, f"{c}_{suffix}.npy")) for c in ids])
            [:, None].astype(np.float32)).to(mesh.device)

    warped, phi = pipe.register(pca, stack("source"), stack("target"),
                                stack("source_seg"), stack("target_seg"))
    warped, phi = mesh.gather_rows(warped), mesh.gather_rows(phi)
    return {"start_epoch": start_epoch,
            "mesh_size": trainer.mesh.size,
            "devices": str(mesh.device),
            "warped_shape": tuple(warped.shape),
            "phi_shape": tuple(phi.shape),
            "finite": bool(torch.isfinite(warped).all()
                           and torch.isfinite(phi).all())}


def _dryrun(n_devices):
    """The dry run itself, in a process that sees no card."""
    from tools.torch_make_synthetic_dataset import generate

    from .parallel import launch

    n = int(n_devices)
    # a global batch that does not divide the mesh: every step pads it to
    # the next multiple of the ranks and weights the pad rows 0; with
    # 2 * batch + 3 train cases an epoch takes two full batches and drops
    # the partial third
    batch = n + 1
    n_train = 2 * batch + 3
    os.environ.setdefault("LIFTREG_NO_TB", "1")
    with tempfile.TemporaryDirectory(prefix="liftreg_torch_dryrun_") as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        os.makedirs(exp)
        generate(data, n_train=n_train, n_val=3, n_test=2, sz=DRYRUN_SZ,
                 n_proj=DRYRUN_VIEWS, latent=DRYRUN_LATENT, seed=0,
                 deformation_rank=2, device="cpu")
        job = {"data": data, "exp": exp, "batch": batch, "n_train": n_train,
               "threads": max(1, (os.cpu_count() or 1) // n)}
        ranks = launch(_dryrun_rank, n, device="cpu", args=(job,))
        for name in ("latest_checkpoint.ckpt", "model_best.ckpt"):
            path = os.path.join(exp, "checkpoints", name)
            if not os.path.isfile(path):
                raise RuntimeError(f"the trainer wrote no {path}")
        with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
    losses = [r["value"] for r in lines if r["tag"] == "Train/total_loss"]
    scores = [r["value"] for r in lines if r["tag"] == "Val_metrics/score"]
    sz = DRYRUN_SZ
    checks = {
        "losses finite": bool(losses) and all(np.isfinite(losses)),
        "scores finite": bool(scores) and all(np.isfinite(scores)),
        # 3 epochs of 2 full batches, each padded on the mesh
        "at least 6 train steps": len(losses) >= 6,
        "resumed at epoch 2": all(r["start_epoch"] == 2 for r in ranks),
        "mesh of n ranks": all(r["mesh_size"] == n for r in ranks),
        "warped and phi shapes": all(
            r["warped_shape"][0] == n
            and r["phi_shape"] == (n, 3, sz, sz, sz) for r in ranks),
        "warped and phi finite": all(r["finite"] for r in ranks),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n}) failed: {failed}; "
                           f"losses={losses}, scores={scores}, "
                           f"ranks={ranks}")
    print(f"dryrun_multichip({n}) ok: production trainer, {len(losses)} "
          f"train steps (batch {batch} padded on the {n}-rank mesh), "
          f"losses={losses[0]:.4f}->{losses[-1]:.4f}, val scores="
          f"{[round(s, 4) for s in scores]}, resumed from epoch "
          f"{ranks[0]['start_epoch']}, mesh-sharded refined serving B={n} "
          f"(refine_steps=2) ok, "
          f"devices={[r['devices'] for r in ranks]}", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """The production training path on a data mesh of ``n_devices`` gloo
    ranks on the CPU (:func:`.parallel.launch`): a 16^3 synthetic set
    (``tools/torch_make_synthetic_dataset.py``, 2 views, latent 4) drives
    ``RegistrationTrainer`` (the card-resident cache on the CPU, padded and
    sharded batches, validation, checkpoints) at a global batch of
    ``n_devices + 1`` for two epochs; a second trainer resumes from the
    written checkpoint for a third; then a refined ``register``
    (``refine_steps=2``) runs sharded over the same ranks from the trained
    checkpoint. Raises where a loss or score is not finite, a checkpoint
    is missing or an output has the wrong shape; prints one
    ``dryrun_multichip(n) ok: ...`` line.

    It forces its platform whatever the caller set up: it runs in a child
    process that sees no CUDA card (``CUDA_VISIBLE_DEVICES`` empty), with
    the repository on its path, and that ends with its caller."""
    if os.environ.get(_CHILD_ENV) == "1":
        from .parallel.mesh import _die_with_parent
        _die_with_parent()
        _dryrun(n_devices)
        return
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **{_CHILD_ENV: "1"})
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    code = ("from liftreg_tpu_torch.entry import dryrun_multichip; "
            f"dryrun_multichip({int(n_devices)})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(REPO), timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun_multichip({n_devices}) child failed "
                           f"(rc={proc.returncode})")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
