"""The in-RAM compression codec of the datasets (``compress_in_memory``),
the port's copy of ``liftreg_tpu/native``: a byte shuffle (the bytes of
each element grouped by position, so that the slowly varying sign and
exponent bytes lie together) and then deflate.

The C++ version (``codec.cpp``, the port's own copy of the source) is
built with ``g++`` at first use into
``build/liftreg_tpu_torch_native/<hash of the source>/`` beside the package,
never beside its source, and loaded with ``ctypes``. Where it cannot be
built (no compiler or no zlib headers), numpy and ``zlib`` write and read
the same format: the shuffle is a transpose of the (elements, bytes)
array. :func:`native_available` says which path runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import zlib
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "codec.cpp"
BUILD_ROOT = _SRC.parent.parent.parent / "build" / "liftreg_tpu_torch_native"
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB = None


def library_path() -> Path:
    """Where the built codec lives: a directory named by the hash of the
    source and the compiler flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libliftregcodec.so"


def _build(lib: Path):
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp), "-lz"],
                   check=True, capture_output=True)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def _load():
    """The loaded C++ codec, built first if needed; None (the numpy/zlib
    path) when it cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_path = library_path()
    try:
        if not lib_path.is_file():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.lrc_max_compressed_size.restype = ctypes.c_size_t
    lib.lrc_max_compressed_size.argtypes = [ctypes.c_size_t]
    lib.lrc_compress.restype = ctypes.c_size_t
    lib.lrc_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.lrc_decompress.restype = ctypes.c_size_t
    lib.lrc_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_size_t]
    _LIB = lib
    return lib


def native_available():
    """True when the C++ codec is built and loaded."""
    return _load() is not None


def pack_array(arr, level=5):
    """Compress a numpy array -> (header dict, bytes)."""
    arr = np.ascontiguousarray(arr)
    meta = {"shape": arr.shape, "dtype": str(arr.dtype)}
    raw = arr.tobytes()
    elem = arr.dtype.itemsize
    lib = _load()
    if lib is not None:
        cap = lib.lrc_max_compressed_size(len(raw))
        out = ctypes.create_string_buffer(cap)
        n = lib.lrc_compress(raw, len(raw), elem, level, out, cap)
        if n:
            return meta, out.raw[:n]
    # numpy byte shuffle + zlib: the same format
    view = np.frombuffer(raw, np.uint8).reshape(-1, elem)
    shuffled = np.ascontiguousarray(view.T).tobytes()
    return meta, zlib.compress(shuffled, level)


def unpack_array(meta, payload):
    """(header dict, bytes) from :func:`pack_array` -> the numpy array."""
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    nbytes = int(np.prod(shape)) * dtype.itemsize
    elem = dtype.itemsize
    lib = _load()
    if lib is not None:
        out = ctypes.create_string_buffer(nbytes)
        n = lib.lrc_decompress(payload, len(payload), out, nbytes, elem)
        if n == nbytes:
            return np.frombuffer(out.raw, dtype).reshape(shape).copy()
    shuffled = np.frombuffer(zlib.decompress(payload), np.uint8)
    view = shuffled.reshape(elem, -1).T
    return np.ascontiguousarray(view).view(dtype).reshape(shape).copy()
