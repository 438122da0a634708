"""Build a PCA deformation-subspace basis with the PyTorch port
(``liftreg_tpu_torch``), from displacement fields taken from

* a directory of saved ``(3, D, W, H)`` displacement or [0, 1] phi
  ``.npy`` files (``--disp_dir``; phi maps become displacements against
  the identity),
* a trained dense model (e.g. RegNet2D3D) run over the training split in
  test mode (``--from_experiment``), or
* per-pair optimization of the training split's CT pairs
  (``--from_optreg``, :class:`liftreg_tpu_torch.optreg.DenseRegisterer`),
  which needs no trained model.

It writes ``pca_vectors.npy``/``pca_mean.npy`` under ``--out``, the
layout the models load. Runs on the CUDA card; ``--device cpu`` runs the
kernels' plain versions.

    python tools/torch_build_pca.py --from_optreg --data_path DATA -o OUT
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch import pca as pca_lib  # noqa: E402
from liftreg_tpu_torch.coords import identity_map_np  # noqa: E402


def load_disp_fields(disp_dir):
    """The ``.npy`` fields of ``disp_dir``, sorted by name, flattened into
    an (N, 3*D*W*H) f32 array; a field within [0, 1] is a stored phi and
    becomes ``phi * 2 - 1 - identity``."""
    files = sorted(glob.glob(os.path.join(disp_dir, "*.npy")))
    assert files, f"no .npy files in {disp_dir}"
    fields = []
    idm = None
    for f in files:
        arr = np.load(f).astype(np.float32)
        assert arr.ndim == 4 and arr.shape[0] == 3, (f, arr.shape)
        if arr.min() >= 0.0 and arr.max() <= 1.0:
            if idm is None:
                idm = identity_map_np(arr.shape[1:])
            arr = (arr * 2.0 - 1.0) - idm
        fields.append(arr.reshape(-1))
    return np.stack(fields)


def disp_from_experiment(data_path, exp_setting, phase="train",
                         device=None):
    """Run a trained model (its ``model_best.ckpt``) over a split in test
    mode through the port's ``RegistrationTrainer`` and collect its
    predicted displacement fields, (N, 3*D*W*H)."""
    from liftreg_tpu_torch.data.dataset import DataLoader, get_dataset
    from liftreg_tpu_torch.train import RegistrationTrainer
    from liftreg_tpu_torch.utils.config import ParameterDict

    setting = ParameterDict()
    setting.load_JSON(exp_setting)
    setting["train"]["mode"] = "test"
    setting["train"]["test_from"] = os.path.join(
        setting["train"]["output_path"], "checkpoints", "model_best.ckpt")
    setting["dataset"]["data_path"] = data_path
    trainer = RegistrationTrainer(setting, device=device)
    # the test-mode trainer builds only a 'test' loader; the requested
    # split gets one with the same dataset options
    ds_opt = setting["dataset"].as_dict()
    ds = get_dataset(ds_opt["dataset_class"])(data_path, phase=phase,
                                              option=ds_opt)
    fields = []
    for data in DataLoader(ds, batch_size=trainer.batch_size):
        batch, names = trainer.set_input(data, 0)
        _, out = trainer._eval_step(batch)
        params = out["params"]
        if isinstance(params, (list, tuple)):
            params = params[0]
        fields.extend(params.float().cpu().numpy().reshape(
            params.shape[0], -1)[:len(names)])
    return np.stack(fields)


def disp_from_optreg(data_path, phase="train", levels=None, sim="ncc",
                     batch=2, verbose=True, device=None, record=None):
    """Register each (source, target) CT pair of a split by
    :class:`liftreg_tpu_torch.optreg.DenseRegisterer` with bf16 taps, and
    return the displacement fields, (N, 3*D*W*H) f32.

    The volumes are read as the training dataset reads them (axis-1 flip,
    linear HU clip [-1000, 0] -> [-1, 1]); the last chunk is padded to
    ``batch`` with its own first pairs. ``record``, a list, receives each
    call's ``sim_history`` and ``total_history`` (numpy)."""
    import torch

    from liftreg_tpu_torch.data.dataset import normalize_intensity
    from liftreg_tpu_torch.device import resolve_device
    from liftreg_tpu_torch.optreg import DenseRegisterer

    device = resolve_device(device)
    ids = np.load(os.path.join(data_path, phase, "data_id.npy"),
                  allow_pickle=True)
    pre = os.path.join(data_path, "preprocessed")

    def _vol(case_id, side):
        v = np.flip(np.load(os.path.join(pre, f"{case_id}_{side}.npy"))
                    .astype(np.float32), axis=1)
        return normalize_intensity(v, linear_clip=True,
                                   clip_range=(-1000, 0))[None, None]

    img_sz = _vol(ids[0], "source").shape[2:]
    kw = {} if levels is None else {"levels": levels}
    reg = DenseRegisterer(img_sz, sim=sim, warp_taps_dtype=torch.bfloat16,
                          **kw)
    fields = []
    for i in range(0, len(ids), batch):
        chunk = ids[i:i + batch]
        moving = np.concatenate([_vol(c, "source") for c in chunk])
        target = np.concatenate([_vol(c, "target") for c in chunk])
        if len(chunk) < batch:                    # pad to the batch
            pad = batch - len(chunk)
            moving = np.concatenate([moving, moving[:pad]])
            target = np.concatenate([target, target[:pad]])
        out = reg(torch.from_numpy(moving).to(device),
                  torch.from_numpy(target).to(device))
        disp = out["disp"][:len(chunk)].float().cpu().numpy()
        sims = out["sim_history"].cpu().numpy()
        if record is not None:
            record.append({"sim_history": sims,
                           "total_history": out["total_history"].cpu()
                           .numpy()})
        if verbose:
            print(f"  [{i + len(chunk):>3}/{len(ids)}] sim "
                  f"{sims[0]:.4f} -> {sims[-1]:.4f}", flush=True)
        fields.extend(disp.reshape(len(chunk), -1))
    return np.stack(fields)


def parse_levels(text):
    """``"grid:steps:lr,..."`` -> ((grid, steps, lr), ...), or None."""
    if not text:
        return None
    return tuple(tuple(float(x) if i == 2 else int(x)
                       for i, x in enumerate(lv.split(":")))
                 for lv in text.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--disp_dir", type=str, default="",
                    help="directory of (3,D,W,H) displacement/phi .npy files")
    ap.add_argument("--from_experiment", type=str, default="",
                    help="cur_task_setting.json of a trained dense model")
    ap.add_argument("--from_optreg", action="store_true",
                    help="register train pairs by per-pair optimization "
                         "(liftreg_tpu_torch.optreg) instead of a model")
    ap.add_argument("--optreg_batch", type=int, default=2)
    ap.add_argument("--optreg_sim", type=str, default="ncc")
    ap.add_argument("--optreg_levels", type=str, default="",
                    help="grid:steps:lr,... e.g. 10:80:0.04,20:60:0.02")
    ap.add_argument("--data_path", type=str, default="")
    ap.add_argument("--out", "-o", required=True,
                    help="output folder for pca_vectors.npy / pca_mean.npy")
    ap.add_argument("--latent", "-l", type=int, default=56)
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)

    if args.disp_dir:
        X = load_disp_fields(args.disp_dir)
    elif args.from_experiment:
        X = disp_from_experiment(args.data_path, args.from_experiment,
                                 device=args.device)
    elif args.from_optreg:
        X = disp_from_optreg(args.data_path or ".",
                             levels=parse_levels(args.optreg_levels),
                             sim=args.optreg_sim, batch=args.optreg_batch,
                             device=args.device)
    else:
        ap.error("one of --disp_dir / --from_experiment / --from_optreg "
                 "is required")

    latent = min(args.latent, X.shape[0])
    vectors, mean = pca_lib.fit_pca(X, latent)
    pca_lib.save_pca(args.out, vectors, mean)
    ratio = pca_lib.explained_variance_ratio(X, vectors, mean)
    print(f"PCA basis ({latent} components over {X.shape[0]} fields) "
          f"written to {args.out}; explained variance {ratio:.4f}")
    return ratio


if __name__ == "__main__":
    main()
