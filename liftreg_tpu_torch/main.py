"""Training CLI of the port, with the arguments of the JAX package's
``main.py``: creates a timestamped experiment folder under
``output/{dataset}/{exp}/``, loads, overrides and freezes the JSON config,
and runs the trainer on one CUDA card::

    python -m liftreg_tpu_torch.main -o OUT -d DATA -e EXP -s SETTING_DIR

``-g N`` selects ``cuda:N``; ``--device cpu`` runs the kernels' plain
versions on the CPU instead (small shapes; the tests use it).
``--n_devices N`` trains on a data mesh of N ranks, one process each
(:mod:`.parallel.mesh`): on ``cuda:0`` .. ``cuda:N-1`` over NCCL (fewer
visible cards raise), or with ``--device cpu`` on the CPU over gloo. The
experiment folder is made once, before the ranks start; rank 0 writes
its logs and checkpoints.
"""
from __future__ import annotations

import argparse

import numpy as np

from .parallel import launch
from .parallel.mesh import check_cards
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
                        help="the CUDA card to train on (cuda:N); with "
                             "--n_devices the ranks take cuda:0..N-1")
    parser.add_argument("--n_devices", required=False, type=int, default=None,
                        help="ranks of the data mesh, one card (or with "
                             "--device cpu one process) each (default 1)")
    parser.add_argument("--device", required=False, type=str, default=None,
                        help="'cpu' to train on the CPU (the kernels' plain "
                             "versions); default the CUDA card of -g")
    return parser.parse_args(argv)


def _train_rank(mesh, setting):
    """One rank of ``main --n_devices N``: its trainer, run; returns the
    experiment's checkpoint folder and the steps taken."""
    network_cls = get_network(setting["train"][("network_class", "")])
    trainer = network_cls(setting, mesh=mesh)
    trainer.run()
    return {"check_point_path": trainer.check_point_path,
            "global_step": dict(trainer.global_step)}


def main(argv=None):
    """Returns the trainer, or with ``--n_devices`` N > 1 what
    :func:`_train_rank` returned on rank 0."""
    args = parse_args(argv)
    print(args)
    n_ranks = args.n_devices or 1
    device = args.device or f"cuda:{args.gpu_id}"
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to train on the CPU")
        if n_ranks > 1:
            check_cards(n_ranks)
    np.random.seed(2021)
    setting, _ = prepare_experiment(
        args.output_path, args.data_path, args.exp_name, args.setting_path,
        continue_from=args.continue_from)
    if n_ranks > 1:
        return launch(_train_rank, n_ranks,
                      device="cpu" if device == "cpu" else "cuda",
                      args=(setting,))[0]
    # string DI as in the reference: train.network_class names the trainer
    network_cls = get_network(setting["train"][("network_class", "")])
    trainer = network_cls(setting, device=device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
