"""The checkout's root on the import path, so that the tests import the
harness as ``portbench`` and the port as ``liftreg_tpu_torch``."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
