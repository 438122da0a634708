"""The port's viewers (``liftreg_tpu_torch/utils/viewers.py``) against the
JAX package's under matplotlib's Agg backend: the same slices, quiver
arrays and contours for the same volume (the port given torch tensors),
the same index after the same key events; and the module imports where
matplotlib is absent."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from liftreg_tpu.utils import viewers as jviewers  # noqa: E402
from liftreg_tpu_torch.utils import viewers  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _data():
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(12, 13, 14)).astype(np.float32)
    field = (rng.normal(size=(3, 12, 13, 14)) * 0.1).astype(np.float32)
    return vol, field


def _pair(kind, axis):
    """The JAX package's viewer and the port's, on two axes of one
    figure."""
    vol, field = _data()
    fig, (ax_j, ax_t) = plt.subplots(1, 2)
    make = {"plain": lambda m, ax, v, f: m.ImageViewer3D_Sliced(
                ax, v, axis, "t"),
            "flow": lambda m, ax, v, f: m.ImageViewer3D_Sliced_Flow(
                ax, v, f, axis, "t", stride=4),
            "contour": lambda m, ax, v, f: m.ImageViewer3D_Sliced_Contour(
                ax, v, f, axis, "t", n_lines=5)}[kind]
    jv = make(jviewers, ax_j, vol, field)
    tv = make(viewers, ax_t, torch.from_numpy(vol), torch.from_numpy(field))
    return fig, jv, tv


def _assert_same(jv, tv, kind):
    assert jv.index == tv.index
    assert jv.ax.get_title() == tv.ax.get_title()
    np.testing.assert_array_equal(np.asarray(jv.image.get_array()),
                                  np.asarray(tv.image.get_array()))
    if kind == "flow":
        for a in ("X", "Y", "U", "V"):
            np.testing.assert_array_equal(getattr(jv.quiver, a),
                                          getattr(tv.quiver, a))
    if kind == "contour":
        assert len(jv.contours) == len(tv.contours)
        for cj, ct in zip(jv.contours, tv.contours):
            np.testing.assert_array_equal(cj.levels, ct.levels)
            for pj, pt in zip(cj.get_paths(), ct.get_paths()):
                np.testing.assert_array_equal(pj.vertices, pt.vertices)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("kind", ["plain", "flow", "contour"])
def test_viewers_match_jax(kind, axis):
    fig, jv, tv = _pair(kind, axis)
    try:
        _assert_same(jv, tv, kind)
        for idx in (3, 999, -5):        # clipped at both ends
            jv.set_index(idx)
            tv.set_index(idx)
            _assert_same(jv, tv, kind)
    finally:
        plt.close(fig)


def test_key_events_step_alike():
    fig, jv, tv = _pair("flow", 1)
    try:
        for key in ("up", "up", "k", "down", "j", "j", "x"):
            for v in (jv, tv):
                v.on_key(SimpleNamespace(inaxes=v.ax, key=key))
            _assert_same(jv, tv, "flow")
        # an event over another axes leaves a viewer alone
        start = tv.index
        tv.on_key(SimpleNamespace(inaxes=jv.ax, key="up"))
        assert tv.index == start
        # the figure's dispatcher calls what is registered for its axes
        seen = []
        for module, v in ((jviewers, jv), (viewers, tv)):
            handler = module.FigureEventHandler(fig)
            handler.add_axes_event("key_press_event", v.ax,
                                   lambda e, tag: seen.append((tag, e.key)),
                                   module.__name__)
            handler.on_key_press(SimpleNamespace(inaxes=v.ax, key="up"))
            handler.remove_axes_event("key_press_event", v.ax)
            handler.on_key_press(SimpleNamespace(inaxes=v.ax, key="down"))
        assert seen == [(jviewers.__name__, "up"), (viewers.__name__, "up")]
    finally:
        plt.close(fig)


def test_view_volume_matches_jax():
    vol, field = _data()
    for kw in ({}, {"flow": field}, {"phi": field}):
        fig_j, vj = jviewers.view_volume(vol, block=False, **kw)
        fig_t, vt = viewers.view_volume(
            torch.from_numpy(vol), block=False,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        kind = "flow" if "flow" in kw else "contour" if kw else "plain"
        for a, b in zip(vj, vt):
            _assert_same(a, b, kind)
        plt.close(fig_j)
        plt.close(fig_t)


def test_imports_without_matplotlib():
    script = f"""
import sys
sys.modules["matplotlib"] = None
sys.path.insert(0, {str(ROOT)!r})
from liftreg_tpu_torch.utils import viewers
try:
    viewers.view_volume([[[0.0]]], block=False)
except ImportError:
    pass
else:
    raise SystemExit("view_volume drew without matplotlib")
"""
    subprocess.run([sys.executable, "-c", script], check=True, timeout=60,
                   env=dict(os.environ))
