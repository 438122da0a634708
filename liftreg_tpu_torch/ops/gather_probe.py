"""The gather probes: Hopper shared-memory kernels and their plain PyTorch
versions.

The JAX package measured whether a locality warp (the source kept in fast
on-chip memory, the taps gathered there instead of from device memory)
could pay on its TPU with five small Pallas kernels, which this module
ports (``csrc/gather_probe.cu``); each takes one (M, L) tile ``x`` and,
where it gathers, an int32 index tile ``idx`` of the same shape:

* :func:`gather_rows` replaces ``tools/bench_mosaic_gather.py:94``
  ``gather_sub_kernel``: ``out = sum_k x[(idx + k) mod M, j]`` over
  ``k < inner`` (``take_along_axis`` along axis 0);
* :func:`gather_lanes` replaces ``:103`` ``gather_lane_kernel``: the same
  along axis 1, ``x[i, (idx + k) mod L]``;
* :func:`roll_sum` replaces ``:112`` ``roll_kernel``:
  ``out = sum_k roll(x, k + 1, axis=1)`` (``np.roll``'s direction);
* :func:`warp_step` replaces ``:120`` ``warp_step_kernel``: with
  ``w = 0.25 x``, ``acc += where(idx mod 7 == k mod 7,
  x[(idx + k) mod M, j] * w, 0)``;
* ``tools/repro_mosaic_gather_500.py:41``'s one ``take_along_axis`` is
  :func:`gather_sum` at ``inner=1``: the same two kernels.

:func:`gather_sum` takes ``axis`` and calls the first or the second. The
sums run over k = 0, 1, ... in order in the tile's type: a bf16 tile's
sum is rounded to bf16 after every add, as the JAX kernels' ``acc``
(``zeros_like(x)``) is, and the warp step's product ``g * w`` is rounded
before it is added (the kernel uses no fused multiply-add). The modulo is
a floor modulo for any int32 (``jnp.remainder``, ``torch.remainder``),
``idx + k`` wrapping in 32 bits as it does in JAX.

``grid`` keeps the JAX tool's meaning: the whole tile is processed
``grid`` times, each pass writing the same output. The TPU ran those
passes one after another on one core; the card runs them in parallel.

Each wrapper launches its kernel for CUDA tensors and runs its ``*_plain``
version (``torch.gather``, ``torch.roll``, ``torch.where``) for CPU
tensors; it never falls back from one to the other. Each counts its
launches in ``.launches``.
"""
from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
_IDX = (torch.int32,)
#: the kernel entries of csrc/gather_probe.cu
ROWS, LANES, ROLL, WARP_STEP = 0, 1, 2, 3
#: columns of an axis-0 block's band (a bf16 band is twice as wide where
#: it fits, :func:`band_columns`) and rows of an axis-1 block's band at
#: most (``kMaxRowBand`` in the source)
BAND_COLUMNS, BAND_ROWS = 32, 8
#: shared memory a block may use on an H100 (232,448 bytes)
SMEM_BYTES = 232448
MAX_GRID = 65535


def _check(name, x, idx, inner, grid):
    tensors = {"x": x} if idx is None else {"x": x, "idx": idx}
    device = _build.inputs_device(name, tensors, {"x": DTYPES, "idx": _IDX})
    if x.dtype not in DTYPES or (idx is not None
                                 and idx.dtype != torch.int32):
        raise TypeError(f"{name}: want an f32 or bf16 tile and int32 "
                        f"indices; got {x.dtype}"
                        + ("" if idx is None else f", {idx.dtype}"))
    if x.dim() != 2 or (idx is not None and idx.shape != x.shape):
        raise ValueError(f"{name}: want a 2-D tile and indices of its "
                         f"shape; got {tuple(x.shape)}"
                         + ("" if idx is None else f", {tuple(idx.shape)}"))
    if min(x.shape) < 1 or x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: tile {tuple(x.shape)} is empty or past "
                         "32-bit offsets")
    if not 1 <= int(inner) < 2 ** 31 or not 1 <= int(grid) <= MAX_GRID:
        raise ValueError(f"{name}: want 1 <= inner < 2^31 and 1 <= grid <= "
                         f"{MAX_GRID}; got {inner}, {grid}")
    return device


def band_columns(M, dtype):
    """Columns of an axis-0 band of an M-row tile of ``dtype``: 32, or 64
    for bf16 where those fit a block (M <= 1816), so that the lanes of a
    warp read 32 banks whatever rows they gather."""
    if dtype == torch.bfloat16 and M * 2 * BAND_COLUMNS * 2 <= SMEM_BYTES:
        return 2 * BAND_COLUMNS
    return BAND_COLUMNS


def band_bytes(op, shape, dtype):
    """Shared-memory bytes of the tile's elements that one block of kernel
    ``op`` stages from an (M, L) tile of ``dtype``: all M rows of an
    axis-0 band (:func:`band_columns`), or 8 whole rows (axis 1 and the
    roll). The kernel adds up to 7 wrapped copies of rows (axis 0) or
    columns (axis 1) where they fit, and stages fewer axis-1 rows where
    one pass would leave the card empty."""
    M, L = shape
    size = torch.empty((), dtype=dtype).element_size()
    if op in (ROWS, WARP_STEP):
        return M * band_columns(M, dtype) * size
    return min(BAND_ROWS, M) * L * size


def _launch(op, name, x, idx, inner, grid):
    nbytes = band_bytes(op, x.shape, x.dtype)
    if nbytes > SMEM_BYTES:
        raise ValueError(f"{name}: a block's band of the {tuple(x.shape)} "
                         f"{x.dtype} tile takes {nbytes} bytes of shared "
                         f"memory, past the {SMEM_BYTES} a block has")
    out = torch.empty_like(x)
    M, L = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liftreg_gather_probe(
            op, x.data_ptr(), int(x.dtype == torch.bfloat16),
            0 if idx is None else idx.data_ptr(), out.data_ptr(), M, L,
            int(inner), int(grid), stream)
    _build.check(rc, name)
    return out


def _passes(grid, one_pass):
    """``one_pass()`` ``grid`` times, as the JAX tool's grid steps each
    write the same output; the last pass's output."""
    for _ in range(int(grid)):
        out = one_pass()
    return out


def gather_sum_plain(x, idx, inner, axis, grid=1):
    """``sum_k take_along_axis(x, (idx + k) mod n, axis)`` over
    ``k < inner`` (n = x.shape[axis]), in x's type, ``grid`` times."""
    n = x.shape[axis]

    def one_pass():
        acc = torch.zeros_like(x)
        for k in range(int(inner)):
            acc = acc + torch.gather(x, axis, torch.remainder(
                idx + k, n).long())
        return acc
    return _passes(grid, one_pass)


def roll_sum_plain(x, inner, grid=1):
    """``sum_k roll(x, k + 1, axis=1)`` over ``k < inner``, ``grid``
    times."""
    def one_pass():
        acc = torch.zeros_like(x)
        for k in range(int(inner)):
            acc = acc + torch.roll(x, k + 1, dims=1)
        return acc
    return _passes(grid, one_pass)


def warp_step_plain(x, idx, inner, grid=1):
    """The warp kernel's inner step the JAX tool probed: ``w = 0.25 x``;
    ``acc += where(idx mod 7 == k mod 7, x[(idx + k) mod M, j] * w, 0)``
    over ``k < inner``, ``grid`` times."""
    M = x.shape[0]

    def one_pass():
        acc = torch.zeros_like(x)
        w = x * 0.25
        phase = torch.remainder(idx, 7)
        for k in range(int(inner)):
            g = torch.gather(x, 0, torch.remainder(idx + k, M).long())
            acc = acc + torch.where(phase == k % 7, g * w, 0.0)
        return acc
    return _passes(grid, one_pass)


def plain_version(probe, x, idx, inner, grid=1):
    """The plain version of wrapper ``probe`` (``"gather_rows"``,
    ``"gather_lanes"``, ``"roll_sum"`` or ``"warp_step"``) on ``x`` and
    ``idx`` (which the roll does not read), on any device."""
    if probe == "roll_sum":
        return roll_sum_plain(x, inner, grid)
    if probe == "warp_step":
        return warp_step_plain(x, idx, inner, grid)
    axis = {"gather_rows": 0, "gather_lanes": 1}[probe]
    return gather_sum_plain(x, idx, inner, axis, grid)


def gather_rows(x, idx, inner, grid=1):
    """:func:`gather_sum_plain` along axis 0: the kernel on CUDA tensors
    (a block stages all M rows of a 32- or 64-column band in shared
    memory), the plain version on CPU tensors."""
    if _check("gather_rows", x, idx, inner, grid).type == "cpu":
        return gather_sum_plain(x, idx, inner, 0, grid)
    out = _launch(ROWS, "gather_rows", x, idx, inner, grid)
    gather_rows.launches += 1
    return out


def gather_lanes(x, idx, inner, grid=1):
    """:func:`gather_sum_plain` along axis 1: the kernel on CUDA tensors
    (a block stages up to 8 whole rows in shared memory), the plain
    version on CPU tensors."""
    if _check("gather_lanes", x, idx, inner, grid).type == "cpu":
        return gather_sum_plain(x, idx, inner, 1, grid)
    out = _launch(LANES, "gather_lanes", x, idx, inner, grid)
    gather_lanes.launches += 1
    return out


def gather_sum(x, idx, inner, axis, grid=1):
    """:func:`gather_rows` (``axis`` 0) or :func:`gather_lanes` (1)."""
    if axis not in (0, 1):
        raise ValueError(f"gather_sum: axis must be 0 or 1, got {axis}")
    return (gather_rows if axis == 0 else gather_lanes)(x, idx, inner, grid)


def roll_sum(x, inner, grid=1):
    """:func:`roll_sum_plain`: the kernel on CUDA tensors (up to 8 whole
    rows a block), the plain version on CPU tensors."""
    if _check("roll_sum", x, None, inner, grid).type == "cpu":
        return roll_sum_plain(x, inner, grid)
    out = _launch(ROLL, "roll_sum", x, None, inner, grid)
    roll_sum.launches += 1
    return out


def warp_step(x, idx, inner, grid=1):
    """:func:`warp_step_plain`: the kernel on CUDA tensors (all M rows of a
    32- or 64-column band a block), the plain version on CPU tensors."""
    if _check("warp_step", x, idx, inner, grid).type == "cpu":
        return warp_step_plain(x, idx, inner, grid)
    out = _launch(WARP_STEP, "warp_step", x, idx, inner, grid)
    warp_step.launches += 1
    return out


gather_rows.launches = gather_lanes.launches = 0
roll_sum.launches = warp_step.launches = 0
