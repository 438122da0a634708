"""Abstract trainer interface, PyTorch port of ``liftreg_tpu/train/base.py``:
``run()`` dispatches ``_train_model`` / ``_test_model`` on ``mode``; the
mode switches only track the flag (the model has no dropout or batch-norm
state in its ported configuration)."""
from __future__ import annotations

from abc import ABC, abstractmethod


class TrainerBase(ABC):
    PHASES = ["train", "val", "debug"]

    mode: str = "train"

    def run(self):
        if self.mode == "train":
            self._train_model()
        elif self.mode == "test":
            self._test_model()

    @abstractmethod
    def _train_model(self):
        ...

    @abstractmethod
    def _test_model(self):
        ...

    def set_train(self):
        self.is_train = True

    def set_val(self):
        self.is_train = False

    set_debug = set_val
    set_test = set_val
