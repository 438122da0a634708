"""Landmark TRE evaluation of an experiment's saved maps, the port's
counterpart of ``tools/evaluate_dir_lab.py``: per-case TRE (and its x, y
and z means), the lung Dice, the GFR and percentiles, and
``evaluate_result.csv`` in the experiment (``utils/tre.eval_copd_highres``)::

    python tools/torch_evaluate_dir_lab.py -d DATA -s EXP/cur_task_setting.json

The TRE is host math; the Dice's nearest warp runs on the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Show registration result")
    parser.add_argument("--data_path", "-d", required=True, type=str)
    parser.add_argument("--setting", "-s", metavar="SETTING", default="",
                        help="path to the experiment's cur_task_setting.json")
    parser.add_argument("--exp_path", default="",
                        help="experiment folder (alternative to --setting)")
    parser.add_argument("--dim", type=int, default=160,
                        help="volume size the maps were computed at")
    parser.add_argument("--device", default=None,
                        help="'cpu' for the Dice's warp; default the CUDA "
                             "card")
    args = parser.parse_args(argv)

    from liftreg_tpu_torch.utils.tre import eval_copd_highres

    exp_path = args.exp_path or os.path.dirname(args.setting)
    return eval_copd_highres(args.data_path, exp_path, dim=(args.dim,) * 3,
                             device=args.device)


if __name__ == "__main__":
    main()
