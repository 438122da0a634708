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
                             "drr_project.cu", "drr_project_adjoint.cu",
                             "drr_backproject.cu"))
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


def compile_library(sources, lib: Path, defines=()) -> float:
    """Compile ``sources`` (one ``nvcc -c`` each, all started together,
    with ``-D`` for each of ``defines``) and link them into the shared
    library ``lib``; return the seconds taken. Raises with the end of the
    compiler log on failure; the whole log goes to ``build.log`` beside
    ``lib``."""
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    tag = os.getpid()
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    objs = [lib.with_name(f"{src.stem}.{tag}.o") for src in sources]
    logs = [lib.with_name(f"{src.stem}.{tag}.log") for src in sources]
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(sources, objs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-c", "-o", str(obj), str(src)],
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
                           for src, lg in zip(sources, logs)))
    for path in (*objs, *logs):
        path.unlink(missing_ok=True)
    if any(rcs):
        tail = log.read_text(errors="replace").splitlines()[-40:]
        print("\n".join(tail), file=sys.stderr)
        raise RuntimeError(f"nvcc failed (exit codes {rcs}) after "
                           f"{seconds:.1f} s; full log: {log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return seconds


def build() -> Path:
    """Compile the kernels unless this version is built; return the
    library's path."""
    lib = library_path()
    if lib.is_file():
        return lib
    seconds = compile_library(SOURCES, lib)
    print(f"liftreg_tpu_torch: nvcc built {len(SOURCES)} sources in "
          f"{seconds:.1f} s -> {lib}", file=sys.stderr)
    return lib


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: argument types of each entry point; every one returns an int
SIGNATURES = {
    "liftreg_pca_expand": [_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I32,
                           _PTR],
    "liftreg_warp_trilinear": [_PTR, _I32, _PTR, _PTR, _I64, _I64, _I64,
                               _I64, _I64, _I64, _I32, _I32, _PTR],
    "liftreg_warp_trilinear_phi": [_PTR, _I32, _PTR, _PTR, _I64, _I64, _I64,
                                   _I64, _I64, _I64, _I32, _I32, _I32, _PTR],
    "liftreg_pca_grad": [_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I32,
                         _I64, _PTR],
    "liftreg_warp_coord_grad": [_PTR, _I32, _PTR, _PTR, _PTR, _I64, _I64,
                                _I64, _I64, _I64, _I64, _I32, _I32, _PTR],
    "liftreg_warp_coord_grad_phi": [_PTR, _I32, _PTR, _PTR, _PTR, _I64,
                                    _I64, _I64, _I64, _I64, _I64, _I32, _I32,
                                    _I32, _PTR],
    "liftreg_drr_project": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64,
                            _I64, _I64, _I64, _I64, _I64, _I64, _PTR],
    "liftreg_drr_project_adjoint": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                    _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                                    _PTR],
    "liftreg_drr_adjoint_plan": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _I64,
                                 _I64, _I64, _PTR],
    "liftreg_drr_backproject": [_PTR, _PTR, _PTR, _PTR, _I32, _I64, _I64,
                                _I64, _I64, _I64, _I64, _I64, _I64, _PTR],
}


def load(path) -> ctypes.CDLL:
    """Load a library built from some of the sources and declare the
    entry points it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I32
    if hasattr(lib, "liftreg_error_string"):
        lib.liftreg_error_string.argtypes = [_I32]
        lib.liftreg_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    return load(build())


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
