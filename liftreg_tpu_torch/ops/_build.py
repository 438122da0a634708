"""Build the port's CUDA kernels and load them.

One ``nvcc`` call compiles every source under ``liftreg_tpu_torch/csrc/``
for ``sm_90a`` into one shared library with a plain ``extern "C"``
interface, which is loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library goes to
``build/liftreg_tpu_torch/<hash of the sources and flags>/`` beside the
package, at first use, and is reused while the sources are unchanged.
The compiler's output goes to ``build.log`` in that directory.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name
                for name in ("pca_expand.cu", "warp_trilinear.cu"))
BUILD_ROOT = _PKG.parent / "build" / "liftreg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libliftreg_kernels.so"


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin``, else under
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "liftreg_tpu_torch needs nvcc to build its CUDA kernels: none on "
        "PATH, under $CUDA_HOME/bin or under /usr/local/cuda/bin")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the kernels unless this version is built; return the
    library's path. Raises with the end of the compiler log on failure."""
    lib = library_path()
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    log = lib.parent / "build.log"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in SOURCES)]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.flush()
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        tail = log.read_text(errors="replace").splitlines()[-40:]
        print("\n".join(tail), file=sys.stderr)
        raise RuntimeError(f"nvcc failed with exit code {rc} after "
                           f"{seconds:.1f} s; full log: {log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    print(f"liftreg_tpu_torch: nvcc built {len(SOURCES)} sources in "
          f"{seconds:.1f} s -> {lib}", file=sys.stderr)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.liftreg_pca_expand.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64,
                                       i32, ptr]
    lib.liftreg_pca_expand.restype = i32
    lib.liftreg_warp_trilinear.argtypes = [ptr, i32, ptr, ptr, i64, i64, i64,
                                           i64, i64, i64, i32, ptr]
    lib.liftreg_warp_trilinear.restype = i32
    lib.liftreg_error_string.argtypes = [i32]
    lib.liftreg_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().liftreg_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
