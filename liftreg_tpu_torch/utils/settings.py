"""The canonical task-setting builder of the workflow tools, the port's
copy of ``liftreg_tpu/utils/settings.py``: one default
``cur_task_setting.json`` tree, deep-merged with a caller's overrides.
:class:`.config.ParameterDict` and ``train.RegistrationTrainer`` consume
the result."""
from __future__ import annotations

import copy


def deep_update(base: dict, overrides: dict) -> dict:
    """Recursively merge ``overrides`` into ``base`` (in place; returns
    ``base``). Dicts merge; every other value replaces."""
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


_DEFAULT = {
    "dataset": {
        "apply_hu_clip": True,
        "data_path": "",
        "dataset_class": "registration2d3d",
        "drr_folder_name": "drr",
        "img_after_resize": [160, 160, 160],
        "load_projection_interval": 1,
        "max_num_for_loading": [-1, -1, -1, -1],
        "spacing_to_refer": [2.2, 2.2, 2.2],
        "use_segmentation_map": True,
    },
    "train": {
        "dataloader": {"batch_size": 2,
                       "shuffle": [True, True, False, False]},
        "debug_on": False,
        "epoch": 1,
        "loss": {"initial_reg_factor": 0.1, "min_reg_factor": 1e-3,
                 "reg_factor_decay_from": 10, "sim_class": "ncc"},
        "loss_class": "subspace",
        "mode": "train",
        "model": {"drr_feature_num": 4, "latent_dim": 56, "pca_path": ""},
        "model_class": "subspace_backproj",
        "optim": {"adam": {"beta": [0.9, 0.999]}, "lr": 1e-3,
                  "lr_scheduler": {"custom": {"gamma": 0.8,
                                              "step_size": 30},
                                   "type": "custom"},
                  "optim_type": "adam"},
        "output_path": "",
        "save_3d_img": False,
        "save_fig": False,
        "save_fig_frequency": 100,
        "save_model_frequency": 1,
        "val_frequency": 1,
    },
}


def default_task_setting(data_path: str, output_path: str, size: int = 160,
                         overrides: dict | None = None) -> dict:
    """The canonical ``cur_task_setting.json``-schema dict, deep-merged
    with ``overrides``. ``size`` sets ``img_after_resize`` cubically."""
    s = copy.deepcopy(_DEFAULT)
    s["dataset"]["data_path"] = data_path
    s["dataset"]["img_after_resize"] = [int(size)] * 3
    s["train"]["output_path"] = output_path
    return deep_update(s, overrides or {})
