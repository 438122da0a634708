"""Experiment directory management: the port's copy of
``liftreg_tpu/utils/experiment.py``.

Reproduces ``main.py:14-74``: timestamped experiment folder
``output/{dataset}/{exp}/{timestamp}/`` with ``checkpoints/ records/ logs/
tests/``, config loaded from ``cur_task_setting.json``, overridden from the
command line, stamped with the git hash and argv, written read-only.
"""
from __future__ import annotations

import os
import stat
import subprocess
import sys
from datetime import datetime

from .config import ParameterDict
from .io_utils import make_dir


def get_git_revision_hash():
    try:
        return [subprocess.check_output(["git", "rev-parse", "HEAD"])
                .strip().decode("ascii")]
    except Exception:  # noqa: BLE001 — not a git checkout
        return ["unknown"]


def prepare_experiment(output_path, data_path, exp_name, setting_path,
                       continue_from=None, timestamp=None):
    """Create the experiment dir and the frozen config; returns the setting."""
    dataset_name = os.path.basename(os.path.normpath(data_path))
    timestamp = timestamp or "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
    exp_folder = os.path.join(output_path, dataset_name, exp_name, timestamp)
    for sub in ("checkpoints", "records", "logs", "tests"):
        make_dir(os.path.join(exp_folder, sub))

    setting_file = os.path.join(setting_path, "cur_task_setting.json") \
        if os.path.isdir(setting_path) else setting_path
    assert os.path.isfile(setting_file), "Setting file is not found."
    setting = ParameterDict()
    setting.load_JSON(setting_file)

    setting["dataset"]["data_path"] = data_path
    setting["train"]["output_path"] = exp_folder
    if continue_from is not None:
        setting["train"]["continue_train"] = True
        setting["train"]["continue_from"] = continue_from
    setting["exp"]["git_commit"] = get_git_revision_hash()
    setting["exp"]["command_line"] = " ".join(sys.argv)

    frozen = os.path.join(exp_folder, "cur_task_setting.json")
    setting.write_ext_JSON(frozen)
    os.chmod(frozen, stat.S_IREAD)
    return setting, exp_folder
