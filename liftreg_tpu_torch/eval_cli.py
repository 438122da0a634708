"""Evaluation CLI of the port, with the arguments of the JAX package's
``eval_cli.py``: loads an experiment's saved config, forces test mode from
its best checkpoint (the port's format or the JAX package's msgpack) with
figures and 3D outputs on, runs the trainer, then scores the saved maps
with the DirLab landmark TRE and the lung Dice::

    python -m liftreg_tpu_torch.eval_cli -s OUT/.../cur_task_setting.json

``-g N`` selects ``cuda:N``; ``--device cpu`` runs the kernels' plain
versions on the CPU instead. Where matplotlib is absent the 2D figures are
skipped, with one line saying so; every other output is written.
"""
from __future__ import annotations

import argparse
import os

from .train import get_network
from .utils.config import ParameterDict
from .utils.tre import eval_copd_highres


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="An easy interface for evaluating registration models")
    parser.add_argument("-s", "--setting_path", required=True, type=str,
                        help="path to the experiment's cur_task_setting.json")
    parser.add_argument("-g", "--gpu_id", required=False, type=int, default=0,
                        help="the CUDA card to evaluate on (cuda:N)")
    parser.add_argument("--device", required=False, type=str, default=None,
                        help="'cpu' to evaluate on the CPU (the kernels' "
                             "plain versions); default the CUDA card of -g")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(args)
    device = args.device or f"cuda:{args.gpu_id}"
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to evaluate on the CPU")
    setting = ParameterDict()
    setting.load_JSON(args.setting_path)

    setting["train"]["mode"] = "test"
    setting["train"]["test_from"] = os.path.join(
        setting["train"]["output_path"], "checkpoints", "model_best.ckpt")
    setting["train"]["save_fig"] = True
    setting["train"]["save_3d_img"] = True

    trainer = get_network(setting["train"][("network_class", "")])(
        setting, device=device)
    trainer.run()

    return eval_copd_highres(setting["dataset"]["data_path"],
                             setting["train"]["output_path"],
                             dim=tuple(setting["dataset"]["img_after_resize"]),
                             device=device)


if __name__ == "__main__":
    main()
