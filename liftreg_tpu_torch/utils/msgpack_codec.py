"""msgpack as flax writes it, by hand, and arrays by dtype name.

The JAX package stores its checkpoints and its serving artifacts with
flax's ``msgpack_serialize`` (arrays as an ext type holding ``(shape,
dtype name, raw bytes)``; arrays over 2^30 bytes split into chunks) and
names array types as numpy does. The card's machine has no ``msgpack`` and
no ``ml_dtypes`` (numpy's ``bfloat16``), so this module reads and writes
that subset itself and maps dtype names to torch dtypes:
:func:`torch_dtype` and :func:`dtype_name` translate, :func:`from_bytes`
reads an array of any named dtype, ``"bfloat16"`` as 16-bit integers
viewed as ``torch.bfloat16`` (the same bits), and :func:`to_bytes` is its
mirror. :func:`read_msgpack` decodes; :func:`write_msgpack` encodes to a
file, streaming large arrays.
"""
from __future__ import annotations

import math
import struct
import warnings

import numpy as np
import torch

from ..device import resolve_dtype

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
#: flax's ``MAX_CHUNK_SIZE``: an array of more bytes is written in chunks
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


def torch_dtype(name) -> torch.dtype:
    """A dtype's numpy name (``"float32"``, ``"bfloat16"``, ``"bool"``) ->
    the torch dtype; an unknown name raises ``ValueError``."""
    return resolve_dtype(str(name), "array dtype")


def dtype_name(dtype: torch.dtype) -> str:
    """The inverse of :func:`torch_dtype`: numpy's name of a torch dtype."""
    return str(dtype).rsplit(".", 1)[-1]


def from_bytes(buf, name, shape, offset=0) -> torch.Tensor:
    """The array of dtype ``name`` and ``shape`` whose C-order bytes start
    at ``offset`` of ``buf`` (bytes, a memoryview or a writable mmap), as a
    torch tensor that shares ``buf``'s memory. ``"bfloat16"`` is read as
    16-bit integers viewed as ``torch.bfloat16``, so no numpy type for it is
    needed."""
    dtype = torch_dtype(name)
    shape = tuple(int(s) for s in shape)
    count = math.prod(shape)
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    read_as = torch.int16 if dtype == torch.bfloat16 else dtype
    with warnings.catch_warnings():
        # a read-only buffer gives a read-only tensor; callers copy it
        # before they write
        warnings.filterwarnings("ignore", message=".*not writable.*")
        flat = torch.frombuffer(buf, dtype=read_as, count=count,
                                offset=offset)
    return flat.view(dtype).reshape(shape)


def to_bytes(t) -> memoryview:
    """The C-order bytes of a tensor or numpy array (bf16 as its 16-bit
    patterns), for a writer; a view where the array is contiguous."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.detach().cpu().contiguous().reshape(-1)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


# -- reading ------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
                 0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map"),
                 0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixed = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xd4 <= b <= 0xd8:               # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xd4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if out.get(_CHUNKED):
            return _unchunk(out)
        return out

    def ext(self, n):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, dtype, buf = _Reader(data).obj()
        arr = from_bytes(buf, dtype, shape).clone()
        # numpy where numpy has the type; bf16 stays a torch tensor
        if arr.dtype != torch.bfloat16:
            arr = arr.numpy()
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(node):
    """flax's chunked form of a large array -> the array."""
    def ordered(d):
        return [d[k] for k in sorted(d, key=int)] if isinstance(d, dict) \
            else list(d)

    shape = tuple(int(s) for s in ordered(node["shape"]))
    chunks = ordered(node["chunks"])
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1)
                           for c in chunks]).reshape(shape)


def read_msgpack(data):
    """Decode one msgpack object (flax ``msgpack_serialize`` output) into
    dicts, lists, arrays and Python scalars; arrays are numpy arrays, except
    bf16 ones, which are ``torch.bfloat16`` tensors (numpy has no such type
    without ``ml_dtypes``). Chunked large arrays are joined."""
    reader = _Reader(memoryview(data))
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# -- writing ------------------------------------------------------------------

def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray))


def _sized(sizes, n):
    """The prefix of a sized msgpack item of length ``n``: ``sizes`` lists
    the largest length of each form with its type byte and struct
    format."""
    for limit, (prefix, fmt) in sizes:
        if n <= limit:
            return bytes([prefix]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of {n} exceeds 2^32 - 1")


def _len_prefix(kind, n):
    if kind == "str":
        if n < 32:
            return bytes([0xa0 | n])
        return _sized([(0xff, (0xd9, ">B")), (0xffff, (0xda, ">H")),
                           (0xffffffff, (0xdb, ">I"))], n)
    if kind == "bin":
        return _sized([(0xff, (0xc4, ">B")), (0xffff, (0xc5, ">H")),
                           (0xffffffff, (0xc6, ">I"))], n)
    if kind in ("array", "map"):
        if n < 16:
            return bytes([(0x90 if kind == "array" else 0x80) | n])
        big = (0xdc, 0xdd) if kind == "array" else (0xde, 0xdf)
        return _sized([(0xffff, (big[0], ">H")),
                           (0xffffffff, (big[1], ">I"))], n)
    raise ValueError(kind)


def _int(v):
    if 0 <= v <= 0x7f:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for limit, prefix, fmt in ((0xff, 0xcc, ">B"), (0xffff, 0xcd, ">H"),
                                   (0xffffffff, 0xce, ">I"),
                                   (2 ** 64 - 1, 0xcf, ">Q")):
            if v <= limit:
                return bytes([prefix]) + struct.pack(fmt, v)
    for limit, prefix, fmt in ((2 ** 7, 0xd0, ">b"), (2 ** 15, 0xd1, ">h"),
                               (2 ** 31, 0xd2, ">i"), (2 ** 63, 0xd3, ">q")):
        if v >= -limit:
            return bytes([prefix]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _chunked(arr):
    """flax's ``_chunk``: a large array as a dict of 1-D chunks."""
    flat = arr.reshape(-1)
    itemsize = flat.element_size() if isinstance(flat, torch.Tensor) \
        else flat.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _write(obj, write):
    if obj is None:
        write(b"\xc0")
    elif isinstance(obj, bool):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        write(_len_prefix("str", len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        write(_len_prefix("bin", raw.nbytes))
        write(raw)
    elif isinstance(obj, (list, tuple)):
        write(_len_prefix("array", len(obj)))
        for v in obj:
            _write(v, write)
    elif isinstance(obj, dict):
        write(_len_prefix("map", len(obj)))
        for k, v in obj.items():
            _write(k, write)
            _write(v, write)
    elif _is_array(obj):
        raw = to_bytes(obj)
        if raw.nbytes > MAX_CHUNK_SIZE:
            _write(_chunked(obj), write)
            return
        name = dtype_name(obj.dtype) if isinstance(obj, torch.Tensor) \
            else obj.dtype.name
        # flax's ndarray ext: msgpack of (shape, dtype name, bytes)
        head = (_len_prefix("array", 3)
                + _packb([int(s) for s in obj.shape]) + _packb(name)
                + _len_prefix("bin", raw.nbytes))
        n = len(head) + raw.nbytes
        write(_sized([(0xff, (0xc7, ">B")), (0xffff, (0xc8, ">H")),
                          (0xffffffff, (0xc9, ">I"))], n)
              + struct.pack(">b", EXT_NDARRAY))
        write(head)
        write(raw)
    elif isinstance(obj, np.generic):
        _write(obj.item(), write)
    else:
        raise TypeError(f"msgpack cannot encode {type(obj).__name__}")


def _packb(obj):
    out = bytearray()
    _write(obj, out.extend)
    return bytes(out)


def pack(obj) -> bytes:
    """msgpack bytes of dicts, lists, strings, bytes, numbers, None and
    arrays (torch tensors or numpy arrays, as flax's ndarray ext type)."""
    return _packb(obj)


def write_msgpack(obj, f):
    """Write :func:`pack`'s encoding of ``obj`` to the binary file ``f``,
    an array's bytes straight from its memory."""
    _write(obj, f.write)
