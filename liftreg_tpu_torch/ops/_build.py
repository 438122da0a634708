"""Build the port's CUDA kernels and load them.

Every source under ``liftreg_tpu_torch/csrc/`` is compiled for ``sm_90a``
by its own ``nvcc`` process, all started together, and one more ``nvcc``
links the objects into one shared library with a plain ``extern "C"``
interface, which is loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library goes to
``build/liftreg_tpu_torch/<hash of the sources and flags>/`` beside the
package, at first use, and is reused while the sources are unchanged.
The compilers' output goes to ``build.log`` in that directory.
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
                for name in ("pca_expand.cu", "warp_trilinear.cu",
                             "drr_project.cu", "drr_backproject.cu"))
BUILD_ROOT = _PKG.parent / "build" / "liftreg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
    tag = os.getpid()
    tmp = lib.with_name(f"{_LIB_NAME}.{tag}.tmp")
    objs = [lib.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    logs = [lib.with_name(f"{src.stem}.{tag}.log") for src in SOURCES]
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(SOURCES, objs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=f, stderr=subprocess.STDOUT))
    rcs = [p.wait() for p in procs]
    if not any(rcs):
        with open(logs[0], "a") as f:
            rcs.append(subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)],
                stdout=f, stderr=subprocess.STDOUT).returncode)
    seconds = time.perf_counter() - t0
    log = lib.parent / "build.log"
    log.write_text("".join(f"== {src.name}\n{lg.read_text(errors='replace')}"
                           for src, lg in zip(SOURCES, logs)))
    for path in (*objs, *logs):
        path.unlink(missing_ok=True)
    if any(rcs):
        tail = log.read_text(errors="replace").splitlines()[-40:]
        print("\n".join(tail), file=sys.stderr)
        raise RuntimeError(f"nvcc failed (exit codes {rcs}) after "
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
    lib.liftreg_pca_grad.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i32,
                                     i64, ptr]
    lib.liftreg_pca_grad.restype = i32
    lib.liftreg_warp_coord_grad.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i64,
                                            i64, i64, i64, i64, i32, ptr]
    lib.liftreg_warp_coord_grad.restype = i32
    lib.liftreg_drr_project.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                        i64, i64, i64, i64, i64, ptr]
    lib.liftreg_drr_project.restype = i32
    lib.liftreg_drr_backproject.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64,
                                            i64, i64, i64, i64, ptr]
    lib.liftreg_drr_backproject.restype = i32
    lib.liftreg_error_string.argtypes = [i32]
    lib.liftreg_error_string.restype = ctypes.c_char_p
    return lib


def inputs_device(name: str, tensors: dict, cuda_dtypes: dict):
    """The one device that a wrapper's ``tensors`` (``{label: tensor}``) lie
    on, which must be the CPU or a CUDA card. On CUDA each tensor must also
    be contiguous, with a dtype in ``cuda_dtypes[label]`` (a tuple)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    if device.type == "cuda":
        for label, t in tensors.items():
            if t.dtype not in cuda_dtypes[label]:
                raise TypeError(f"{name}: {label} must be one of "
                                f"{cuda_dtypes[label]}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {label} is not contiguous")
    return device


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().liftreg_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
