"""The gather probes (``liftreg_tpu_torch/ops/gather_probe.py``) against the
JAX tools' Pallas kernels themselves, in interpret mode on the CPU, and the
port's two probe tools on the CPU.

``tools/bench_mosaic_gather.py`` runs with ``timed_ms`` in its namespace
replaced by a function that calls the kernel once and keeps its inputs and
output, and ``pl.pallas_call`` wrapped to record each kernel's name:
its 17 rows at two settings of ``--grid``/``--inner``, and once more with
``jax.random.randint`` drawing the indices from the whole int32 range (the
floor modulo at negative indices, and ``idx + k`` wrapping in 32 bits).
``tools/repro_mosaic_gather_500.py`` runs with ``pl.pallas_call`` in
interpret mode and capturing, each kernel also called on seeded random
indices, and ``jax.jit`` the identity: its 10 shapes. No file of the JAX
package or its tools changes.

Tolerance: bit-equal, f32 and bf16 alike (the same sums in the same order,
bf16 rounded after every add, as the JAX kernels' bf16 ``acc`` is)."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from liftreg_tpu_torch.ops import gather_probe as gp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_bench_mosaic_gather as tbench  # noqa: E402
import torch_repro_mosaic_gather_500 as trepro  # noqa: E402
from tools import bench_mosaic_gather, repro_mosaic_gather_500  # noqa: E402

#: the port's wrapper of each JAX kernel body
PROBES = {"gather_sub_kernel": "gather_rows",
          "gather_lane_kernel": "gather_lanes",
          "roll_kernel": "roll_sum", "warp_step_kernel": "warp_step"}
#: (--grid, --inner, indices from the whole int32 range)
BENCH_SETTINGS = {"grid1_inner2": (1, 2, False),
                  "grid2_inner8": (2, 8, False),
                  "int32_range_inner3": (1, 3, True)}


def _torch(a):
    """A numpy array from JAX (bf16 through ml_dtypes) as a torch tensor of
    the same type and values."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _bits(t):
    """The int32 bits of a tensor's values widened to f32 (exact for bf16;
    tells -0 from +0)."""
    return t.float().numpy().view(np.int32)


def _assert_bit_equal(got, want_np):
    want = _torch(want_np)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def bench_runs():
    """{setting: [(kernel name, x, idx, out), ...]} of the JAX bench tool's
    rows in interpret mode."""
    runs = {}
    orig_call, orig_randint = pl.pallas_call, jax.random.randint
    for name, (grid, inner, full_range) in BENCH_SETTINGS.items():
        rows, names = [], []

        def pallas_call(kernel, **kw):
            names.append(kernel.__name__)
            return orig_call(kernel, **kw)

        def timed_ms(fn, *xs, reps, warmup=1):
            out = fn(*xs)
            rows.append(tuple(np.asarray(a) for a in (*xs, out)))
            return 1.0

        def randint(key, shape, minval, maxval, dtype):
            return orig_randint(key, shape, -2 ** 31, 2 ** 31 - 1, dtype)

        mp = pytest.MonkeyPatch()
        mp.setattr(pl, "pallas_call", pallas_call)
        mp.setattr(bench_mosaic_gather, "timed_ms", timed_ms)
        if full_range:
            mp.setattr(jax.random, "randint", randint)
        try:
            bench_mosaic_gather.main(["--interpret", "--reps", "1", "--grid",
                                      str(grid), "--inner", str(inner)])
        finally:
            mp.undo()
        runs[name] = [(n, *r) for n, r in zip(names, rows)]
    return runs


def test_bench_rows_match_the_port_tool(bench_runs):
    """The JAX tool's 17 rows, in order, are the port tool's rows: the
    same probe, tile shape and type."""
    for runs in bench_runs.values():
        assert len(runs) == len(tbench.ROWS) == 17
        assert [(PROBES[n], *x.shape, x.dtype.name) for n, x, _, _ in runs] \
            == [(p, M, L, dt) for _, p, M, L, dt in tbench.ROWS]
    full = bench_runs["int32_range_inner3"]
    assert all(int(i.min()) < 0 for _, _, i, _ in full)


@pytest.mark.parametrize("row", range(17))
@pytest.mark.parametrize("setting", sorted(BENCH_SETTINGS))
def test_probe_matches_bench_kernel(bench_runs, setting, row):
    """Each row of the JAX bench tool, kernel against the port's wrapper on
    CPU tensors (its plain version) and ``plain_version``, bit for bit."""
    grid, inner, _ = BENCH_SETTINGS[setting]
    name, x, idx, out = bench_runs[setting][row]
    probe = getattr(gp, PROBES[name])
    launches = probe.launches
    if name == "roll_kernel":
        got = probe(_torch(x), inner, grid)
    else:
        got = probe(_torch(x), _torch(idx), inner, grid)
    assert probe.launches == launches
    _assert_bit_equal(got, out)
    _assert_bit_equal(gp.plain_version(PROBES[name], _torch(x), _torch(idx),
                                       inner, grid), out)


@pytest.fixture(scope="module")
def repro_runs():
    """[(axis, src, idx, out), ...] of the JAX repro tool's kernel in
    interpret mode: on the tool's inputs, then on seeded random indices."""
    runs = []
    orig = pl.pallas_call
    rng = np.random.default_rng(0)

    def pallas_call(kernel, **kw):
        f = orig(kernel, interpret=True, **kw)
        axis = kernel.keywords["axis"]

        def call(src, idx):
            out = f(src, idx)
            runs.append((axis, *(np.asarray(a) for a in (src, idx, out))))
            rand = rng.integers(0, src.shape[axis], src.shape,
                                dtype=np.int32)
            out2 = f(src, jax.numpy.asarray(rand))
            runs.append((axis, np.asarray(src), rand, np.asarray(out2)))
            return out
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", pallas_call)
    mp.setattr(jax, "jit", lambda f, *a, **kw: f)
    try:
        repro_mosaic_gather_500.main()
    finally:
        mp.undo()
    return runs


def test_repro_shapes_match_the_port_tool(repro_runs):
    assert len(repro_runs) == 2 * len(trepro.SHAPES) == 20
    got = [(axis, *src.shape, src.dtype.name)
           for axis, src, _, _ in repro_runs[::2]]
    assert got == [(axis, rows, lanes, dt)
                   for _, rows, lanes, axis, dt in trepro.SHAPES]


@pytest.mark.parametrize("case", range(10))
def test_gather_sum_matches_repro_kernel(repro_runs, case):
    """Each shape of the JAX repro tool, on its inputs and on random
    indices: ``gather_sum(inner=1)`` bit for bit, and the port tool's own
    inputs equal to the JAX tool's."""
    for axis, src, idx, out in repro_runs[2 * case:2 * case + 2]:
        _assert_bit_equal(gp.gather_sum(_torch(src), _torch(idx), 1, axis),
                          out)
    axis, src, idx, _ = repro_runs[2 * case]
    _, rows, lanes, _, dtype = trepro.SHAPES[case]
    port_src, (zeros, rand) = trepro.shape_inputs(rows, lanes, axis, dtype,
                                                  torch.device("cpu"))
    _assert_bit_equal(port_src, src)
    assert torch.equal(zeros, _torch(idx))
    assert int(rand.min()) >= 0 and int(rand.max()) < src.shape[axis]


def test_floor_modulo_at_negative_and_extreme_indices():
    """``(idx + k) mod n`` is a floor modulo and ``idx + k`` wraps in 32
    bits, as in the JAX kernels' ``jnp.remainder(idx + k, n)``."""
    jnp = jax.numpy
    idx = np.array([[-1, -7, -8, 2 ** 31 - 1, -2 ** 31, 0, 5, -13]] * 3,
                   np.int32)
    x = np.arange(idx.size, dtype=np.float32).reshape(idx.shape)
    for axis in (0, 1):
        n = x.shape[axis]
        want = sum(np.asarray(jnp.take_along_axis(
            jnp.asarray(x), jnp.remainder(jnp.asarray(idx) + k, n),
            axis=axis)) for k in range(3))
        got = gp.gather_sum(torch.from_numpy(x), torch.from_numpy(idx), 3,
                            axis)
        np.testing.assert_array_equal(got.numpy(), want)


#: rows of the JAX bench tool run at inner 64 and grid 1 (the (8, 128) row
#: gather runs past n = 8) on indices where the port's index walk turns
WALK_ROWS = (0, 2, 7, 10, 12, 14)
WALK_INNER = 64


def _walk_indices(kind, shape, n, rng):
    """``wrap``: indices picked from INT32_MAX - 63 .. INT32_MAX (where
    idx + k wraps to INT32_MIN inside 64 taps), INT32_MIN, INT32_MIN + 1,
    -1, -n and n - 1; ``int32``: the whole int32 range."""
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int32)
    special = np.array([2 ** 31 - 1 - t for t in range(WALK_INNER)]
                       + [-2 ** 31, -2 ** 31 + 1, -1, -n, n - 1], np.int32)
    return special[rng.integers(0, len(special), shape)]


@pytest.fixture(scope="module")
def walk_runs():
    """{kind: {row: (kernel name, x, idx, out)}} of the JAX bench tool's
    WALK_ROWS in interpret mode at inner 64 and grid 1, its indices drawn
    by :func:`_walk_indices` (the other rows are not run)."""
    runs = {}
    orig_call = pl.pallas_call
    for kind in ("wrap", "int32"):
        rng = np.random.default_rng(11)
        names, got = [], {}

        def pallas_call(kernel, **kw):
            names.append(kernel.__name__)
            return orig_call(kernel, **kw)

        def timed_ms(fn, *xs, reps, warmup=1):
            row = len(names) - 1
            if row in WALK_ROWS:
                out = fn(*xs)
                got[row] = (names[row], *(np.asarray(a)
                                          for a in (*xs, out)))
            return 1.0

        def randint(key, shape, minval, maxval, dtype):
            return jax.numpy.asarray(_walk_indices(kind, shape, maxval, rng))

        mp = pytest.MonkeyPatch()
        mp.setattr(pl, "pallas_call", pallas_call)
        mp.setattr(bench_mosaic_gather, "timed_ms", timed_ms)
        mp.setattr(jax.random, "randint", randint)
        try:
            bench_mosaic_gather.main(["--interpret", "--reps", "1", "--grid",
                                      "1", "--inner", str(WALK_INNER)])
        finally:
            mp.undo()
        runs[kind] = got
    return runs


@pytest.mark.parametrize("row", WALK_ROWS)
@pytest.mark.parametrize("kind", ["wrap", "int32"])
def test_probe_matches_bench_kernel_where_the_walk_turns(walk_runs, kind,
                                                         row):
    """The plain versions (which the card's kernels are held to, bit for
    bit) against the JAX tool's kernels at inner 64, past n for the
    (8, 128) row gather, on indices where ``idx + k`` wraps past INT32_MAX
    and at INT32_MIN, -1, -n and n - 1, and over the whole int32 range."""
    name, x, idx, out = walk_runs[kind][row]
    _, probe, M, L, dtype = tbench.ROWS[row]
    assert PROBES[name] == probe and x.shape == (M, L)
    if kind == "wrap" and probe != "roll_sum":
        n = L if probe == "gather_lanes" else M
        assert int(idx.max()) == 2 ** 31 - 1 and int(idx.min()) == -2 ** 31
        assert {-1, -n, n - 1} <= set(np.unique(idx).tolist())
    _assert_bit_equal(gp.plain_version(probe, _torch(x), _torch(idx),
                                       WALK_INNER), out)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 128))
    idx = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        gp.gather_rows(x, idx.long(), 1)
    with pytest.raises(ValueError):
        gp.gather_lanes(x, idx[:4], 1)
    with pytest.raises(ValueError):
        gp.warp_step(x, idx, 0)
    with pytest.raises(ValueError):
        gp.roll_sum(x, 1, grid=0)
    with pytest.raises(ValueError):
        gp.gather_sum(x, idx, 1, axis=2)
    with pytest.raises(TypeError):
        gp.roll_sum(x.double(), 1)


def test_band_bytes_of_the_probe_tiles():
    """Every tile of both tools fits a block's shared memory; a tile whose
    axis-0 band would not is found before any launch."""
    for _, probe, M, L, dtype in tbench.ROWS:
        op = {"gather_rows": gp.ROWS, "gather_lanes": gp.LANES,
              "roll_sum": gp.ROLL, "warp_step": gp.WARP_STEP}[probe]
        assert gp.band_bytes(op, (M, L), getattr(torch, dtype)) \
            <= gp.SMEM_BYTES
    assert gp.band_bytes(gp.ROWS, (1280, 128), torch.float32) == 163840
    assert gp.band_bytes(gp.LANES, (160, 256), torch.float32) == 8192
    assert gp.band_bytes(gp.ROWS, (2048, 128), torch.float32) \
        > gp.SMEM_BYTES


@pytest.mark.parametrize("M,dtype,columns", [
    (1280, torch.bfloat16, 64), (1816, torch.bfloat16, 64),
    (1817, torch.bfloat16, 32), (3632, torch.bfloat16, 32),
    (160, torch.float32, 32), (1816, torch.float32, 32)])
def test_band_columns(M, dtype, columns):
    """An axis-0 bf16 band is 64 columns wide (lane l reads bank l for any
    row) where that fits a block, else 32, which every accepted tile
    fits; f32 bands are 32 wide."""
    assert gp.band_columns(M, dtype) == columns
    assert gp.band_bytes(gp.ROWS, (M, 64), dtype) \
        == M * columns * torch.empty((), dtype=dtype).element_size() \
        <= gp.SMEM_BYTES


def test_bench_tool_on_the_cpu(capsys):
    """``tools/torch_bench_mosaic_gather.py --device cpu``: the header, the
    17 rows and the decision line with the warp's ns per tap and window."""
    record = {}
    rows = tbench.main(["--device", "cpu", "--reps", "1", "--grid", "2",
                        "--inner", "3", "--warp_size", "12"], record=record)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cpu")
    assert len(rows) == 17 and all(r["grid"] == 2 and r["inner"] == 3
                                   for r in rows)
    assert [r["label"] for r in rows] == [r[0] for r in tbench.ROWS]
    assert record["best_ns_per_elem"] == min(r["ns_per_elem"] for r in rows)
    warp = record["warp"]
    assert warp["size"] == 12 and warp["batch"] == 4
    assert warp["ns_per_tap"] == pytest.approx(
        warp["ms"] * 1e6 / (4 * 12 ** 3 * 8))
    assert all(0 <= w <= 12 for w in warp["window"] + warp["window_smooth"])
    assert out[-1].startswith("best ns/elem")
    assert "ns/tap" in out[-1] and "window" in out[-1]


def test_repro_tool_on_the_cpu(capsys, monkeypatch):
    """``tools/torch_repro_mosaic_gather_500.py --device cpu``: 10 OK rows
    and exit 0; a wrong gather gives FAIL rows and exit 1."""
    assert trepro.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("  OK    dynamic_gather") == 10 and "FAIL" not in out
    monkeypatch.setattr(trepro, "gather_sum", lambda x, idx, inner, axis:
                        gp.gather_sum(x, idx, inner + 1, axis))
    assert trepro.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("  FAIL  dynamic_gather") == 10
