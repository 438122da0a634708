"""Training CLI of the port, with the arguments of the JAX package's
``main.py``: creates a timestamped experiment folder under
``output/{dataset}/{exp}/``, loads, overrides and freezes the JSON config,
and runs the trainer on one CUDA card::

    python -m liftreg_tpu_torch.main -o OUT -d DATA -e EXP -s SETTING_DIR

``-g N`` selects ``cuda:N``; ``--device cpu`` runs the kernels' plain
versions on the CPU instead (small shapes; the tests use it).
``--n_devices`` other than 1 raises: the port does not shard batches.
"""
from __future__ import annotations

import argparse

import numpy as np

from .train import get_network
from .utils.experiment import prepare_experiment


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="An easy interface for training registration models")
    parser.add_argument("-o", "--output_path", required=True, type=str,
                        help="the path of output folder")
    parser.add_argument("-d", "--data_path", required=True, type=str,
                        help="the path to the data folder")
    parser.add_argument("-e", "--exp_name", required=True, type=str,
                        help="the name of the experiment")
    parser.add_argument("-s", "--setting_path", required=True, type=str,
                        help="folder containing cur_task_setting.json")
    parser.add_argument("--continue_from", required=False, type=str,
                        help="checkpoint to continue training from")
    parser.add_argument("-g", "--gpu_id", required=False, type=int, default=0,
                        help="the CUDA card to train on (cuda:N)")
    parser.add_argument("--n_devices", required=False, type=int, default=None,
                        help="accepted for compatibility; only 1 is "
                             "supported (no sharding)")
    parser.add_argument("--device", required=False, type=str, default=None,
                        help="'cpu' to train on the CPU (the kernels' plain "
                             "versions); default the CUDA card of -g")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(args)
    if args.n_devices not in (None, 1):
        raise SystemExit(f"--n_devices {args.n_devices}: liftreg_tpu_torch "
                         "trains on one card and does not shard batches")
    device = args.device or f"cuda:{args.gpu_id}"
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to train on the CPU")
    np.random.seed(2021)
    setting, _ = prepare_experiment(
        args.output_path, args.data_path, args.exp_name, args.setting_path,
        continue_from=args.continue_from)
    # string DI as in the reference: train.network_class names the trainer
    network_cls = get_network(setting["train"][("network_class", "")])
    trainer = network_cls(setting, device=device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
