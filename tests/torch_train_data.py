"""A small on-disk dataset in the layout of the registration datasets, for
the trainer tests of the port: volumes, segmentations, DRR-like
projections, poses and a PCA basis, all from one numpy seed."""
import json
import os

import numpy as np


def smooth(rng, shape, low=4):
    """A smooth field in [-1, 1]: noise on a low^3 grid, repeated and
    box-blurred up to ``shape``."""
    coarse = rng.standard_normal((low,) * 3)
    reps = [-(-s // low) for s in shape]
    field = np.kron(coarse, np.ones(reps))[:shape[0], :shape[1], :shape[2]]
    for axis in range(3):
        field = (np.roll(field, 1, axis) + field + np.roll(field, -1, axis)) / 3
    return (field / np.abs(field).max()).astype(np.float32)


def write_dataset(root, sz=16, n_train=6, n_val=3, n_test=2, views=2,
                  latent=4, seed=0):
    """Write the dataset under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    det = (int(sz * 1.5), int(sz * 1.5))
    os.makedirs(os.path.join(root, "preprocessed"), exist_ok=True)
    drr = os.path.join(root, "drr", "drr", "drr")
    os.makedirs(drr, exist_ok=True)
    names = {"train": [f"tr{i}" for i in range(n_train)],
             "val": [f"va{i}" for i in range(n_val)],
             "test": [f"te{i}" for i in range(n_test)]}
    for phase, ids in names.items():
        os.makedirs(os.path.join(root, phase), exist_ok=True)
        np.save(os.path.join(root, phase, "data_id.npy"), np.array(ids))
        for name in ids:
            base = smooth(rng, (sz,) * 3)
            for side, shift in (("source", 0), ("target", 1)):
                hu = np.roll(base, shift, axis=0) * 450.0 - 500.0
                np.save(os.path.join(root, "preprocessed",
                                     f"{name}_{side}.npy"), hu)
                seg = (np.roll(base, shift, axis=0) > -0.3)
                np.save(os.path.join(root, "preprocessed",
                                     f"{name}_{side}_seg.npy"),
                        seg.astype(np.float32))
                proj = rng.uniform(0.0, 6.5, (views,) + det)
                np.save(os.path.join(drr, f"{name}_{side}_proj.npy"),
                        proj.astype(np.float32))
    poses = np.stack([np.tan(np.linspace(-0.26, 0.26, views)) * 3.0,
                      np.full(views, 3.5), np.linspace(-0.2, 0.2, views)],
                     axis=1) * sz
    np.save(os.path.join(drr, "poses.npy"), poses.astype(np.float32))
    pca = os.path.join(root, "pca")
    os.makedirs(pca, exist_ok=True)
    vectors = np.stack([np.concatenate([smooth(rng, (sz,) * 3).ravel()
                                        for _ in range(3)]) * 0.05
                        for _ in range(latent)])
    np.save(os.path.join(pca, "pca_vectors.npy"), vectors.astype(np.float32))
    np.save(os.path.join(pca, "pca_mean.npy"),
            np.zeros(3 * sz ** 3, np.float32))
    return root


def setting(data_path, out_path, sz=16, views=2, latent=4, batch_size=2,
            epochs=1, **train):
    """The trainer setting of the dataset: the reference config's schema at
    a small size."""
    cfg = {
        "dataset": {
            "apply_hu_clip": True, "data_path": data_path,
            "dataset_class": "registration2d3d", "drr_folder_name": "drr",
            "img_after_resize": [sz] * 3, "load_projection_interval": 1,
            "max_num_for_loading": [-1, -1, -1, -1],
            "spacing_to_refer": [2.2, 2.2, 2.2],
            "use_segmentation_map": True,
        },
        "train": {
            "dataloader": {"batch_size": batch_size,
                           "shuffle": [True, True, False, False]},
            "debug_on": False, "epoch": epochs,
            "loss": {"initial_reg_factor": 0.01, "min_reg_factor": 0.01,
                     "reg_factor_decay_from": 2, "sim_class": "ncc"},
            "loss_class": "subspace", "mode": "train",
            "model": {"drr_feature_num": views, "latent_dim": latent,
                      "pca_path": os.path.join(data_path, "pca")},
            "model_class": "subspace_backproj",
            "optim": {"adam": {"beta": [0.9, 0.999]}, "lr": 1e-3,
                      "lr_scheduler": {"custom": {"gamma": 0.8,
                                                  "step_size": 30},
                                       "type": "custom"},
                      "optim_type": "adam"},
            "output_path": out_path, "save_3d_img": False, "save_fig": False,
            "save_fig_frequency": 100, "save_model_frequency": 1,
            "val_frequency": 1,
        },
    }
    cfg["train"].update(train)
    return json.loads(json.dumps(cfg))


def read_metrics(exp):
    """{tag: {step: value}} of an experiment's metrics.jsonl."""
    out = {}
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out
