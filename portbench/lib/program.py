"""The system under test, built from a configuration and a traffic mix:
``liftreg_tpu_torch``'s ``RegistrationPipeline`` for serving and its
``RegistrationTrainer`` for training, holding the benchmark's weights and
basis; and the port's launch counters, by the names of its kernels.
"""
from __future__ import annotations

import copy

import numpy as np

from portbench.lib import inputs

#: the device dataset's name in the port's dataset registry
DEVICE_DATASET = "portbench_device"


def counters():
    """The port's kernel wrappers whose ``.launches`` count launches."""
    from liftreg_tpu_torch.ops import drr_kernel, pca_kernel, warp_kernel
    return {"pca_expand": pca_kernel.pca_expand,
            "pca_grad": pca_kernel.pca_grad,
            "warp_trilinear": warp_kernel.warp_trilinear,
            "warp_coord_grad": warp_kernel.warp_coord_grad,
            "warp_image_grad": warp_kernel.warp_image_grad,
            "drr_project": drr_kernel.project_taps,
            "drr_project_adjoint": drr_kernel.project_adjoint_taps,
            "drr_adjoint_plan": drr_kernel.project_adjoint_plan,
            "drr_backproject": drr_kernel.backproject_taps}


def zero_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: int(fn.launches) for k, fn in counters().items()}


class Server:
    """A ``RegistrationPipeline`` for ``cfg`` with the traffic's
    refinement, and one call of the traffic's entry on a pool batch."""

    def __init__(self, cfg, traffic, w, pca, device):
        from liftreg_tpu_torch.pipeline import RegistrationPipeline
        self.pipe = RegistrationPipeline(
            cfg["img_sz"], latent_dim=cfg["latent_dim"],
            n_proj=cfg["n_proj"], scan_range_deg=cfg["scan_range_deg"],
            spacing=cfg["spacing"], resolution=cfg["resolution"],
            compute_dtype=cfg["compute_dtype"],
            s2d_encoder=cfg["s2d_encoder"], mask_ct=cfg["mask_ct"],
            warp_taps_dtype=cfg["warp_taps_dtype"],
            refine_steps=traffic.get("refine_steps", 0),
            refine_lr=traffic.get("refine_lr", 0.05),
            refine_sim=traffic.get("refine_sim", "ncc"),
            refine_reg_factor=traffic.get("refine_reg_factor", 1e-3),
            refine_domain=traffic.get("refine_domain", "image"),
            device=device)
        self.pipe.model.load_state_dict(inputs.state_dict(w), strict=True)
        self.pca = {"vectors": pca[0], "mean": pca[1]}
        self.entry = traffic["entry"]

    def __call__(self, item):
        """The entry on one pool batch: a dict of its ``phi``, ``warped``
        and, when it refines, the refined ``coefs``, the objective of
        the unrefined ones, ``start`` (the batch mean), and the objective
        history, ``history``."""
        pipe = self.pipe
        if self.entry == "register":
            warped, phi = pipe.register(
                self.pca, item["source_hu"], item["target_hu"],
                item["source_seg"], item["target_seg"])
        else:
            warped, phi = pipe.register_projections(
                self.pca, item["source_hu"], item["target_proj"],
                item["source_seg"])
        out = {"phi": phi, "warped": warped}
        if pipe.refiner is not None:
            out["coefs"] = pipe.last_refine["coefs"]
            out["start"] = pipe.last_refine["total_history"][0]
            out["history"] = pipe.last_refine["total_history"]
        return out

    def unrefined(self, item):
        """The amortized prediction alone on one pool batch (the call that
        the entry refines)."""
        import torch
        with torch.no_grad():
            return self.pipe.predict_projections(
                self.pipe.constants(), self.pca, item["source_hu"],
                item["target_proj"], item["source_seg"])[0]["phi"]


class DeviceBatches:
    """The port's dataset interface over one small stand-in case: the
    benchmark feeds the trainer's step with its own device batches, so
    that its loaders read nothing from disk."""

    def __init__(self, data_path, phase=None, transform=None, option=None):
        del data_path, transform, option
        self.phase = phase

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        vol = np.zeros((1, 2, 2, 2), np.float32)
        return ({"source": vol, "target": vol, "source_label": vol,
                 "target_label": vol,
                 "target_proj": np.zeros((1, 2, 2), np.float32),
                 "target_poses": np.zeros((1, 3), np.float32)},
                f"{self.phase}{idx}")


class Trainer:
    """A ``RegistrationTrainer`` for ``cfg["setting"]`` with the
    benchmark's weights and basis; one call is one train step."""

    def __init__(self, cfg, w, pca, device, out_dir):
        import torch
        from liftreg_tpu_torch.data import dataset
        from liftreg_tpu_torch.train.trainer import RegistrationTrainer
        dataset.DATASET_REGISTRY.setdefault(DEVICE_DATASET, DeviceBatches)
        setting = copy.deepcopy(cfg["setting"])
        setting["dataset"]["data_path"] = str(out_dir)
        setting["train"]["output_path"] = str(out_dir)
        self.trainer = RegistrationTrainer(setting, device=device)
        with torch.no_grad():
            self.trainer.model.load_state_dict(inputs.state_dict(w),
                                               strict=True)
        self.trainer.pca = {"vectors": pca[0], "mean": pca[1]}
        self.leaf_names = list(inputs.state_dict(w))

    def __call__(self, batch):
        names = [f"r{i}" for i in range(batch["source"].shape[0])]
        return self.trainer.step(batch, names)

    def checked_steps(self, batches, w):
        """Train on ``batches`` from the weights ``w`` and return what the
        check compares: each step's ``losses``, the first gradient's norm
        by leaf as Adam's first moment holds it after one step
        (``grads``), and the norm of each leaf's change (``change``)."""
        tr = self.trainer
        b1 = tr.opt_state["hyperparams"]["b1"]
        losses, grads = [], None
        for batch in batches:
            losses.append(self(batch)["total_loss"])
            if grads is None:
                grads = [float((tr.opt_state["mu"][k] / (1 - b1)).norm())
                         for k in self.leaf_names]
        start = inputs.state_dict(w)
        return {"losses": [float(v) for v in losses], "grads": grads,
                "change": [float((tr.params[k].detach() - start[k]).norm())
                           for k in self.leaf_names]}
