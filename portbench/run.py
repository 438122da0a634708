"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It sets up the cell named in ``BENCHMARK.json`` (its configuration and
traffic from ``portbench/configs/`` and ``portbench/traffic/``), measures
for ``--seconds`` (or, with ``--trace 1``, traces the traffic's traced
window), checks the window's results against the plain reference, and
prints one JSON line last. It exits 3 without a result where the cell's
CUDA devices are missing or a forbidden module (JAX, the JAX package) was
loaded. The port's kernels build into ``build/`` of the checkout at the
first run there, and PyTorch's runtime-compiled kernels are cached under
``build/portbench/``.
"""
import os
import sys
import time

T_START = time.perf_counter()
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(
    CHECKOUT, "build", "portbench", "torch_kernels")
sys.path.insert(0, CHECKOUT)

from portbench.lib import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main(sys.argv[1:], T_START))
