"""Interactive 3D slice viewers, the port's copy of
``liftreg_tpu/utils/viewers.py``: matplotlib slicers that scroll through a
volume's planes, with optical-flow quiver and map contour overlays and a
shared key-event dispatcher. Volumes, flows and maps may be torch tensors
(on any device) or numpy arrays. Headless-safe: all drawing works under
the 'Agg' backend; interactivity activates where a GUI backend is present.

The viewers draw on axes the caller passes; only :func:`view_volume`
imports matplotlib, inside the call, so the module imports where
matplotlib is absent (the card's machine).
"""
from __future__ import annotations

import numpy as np


def _array(x):
    """A tensor (any device, any float type) or an array -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class FigureEventHandler:
    """Dispatches key events to registered axes."""

    def __init__(self, fig):
        self.fig = fig
        self.ax_events = {}
        fig.canvas.mpl_connect("key_press_event", self.on_key_press)

    def add_axes_event(self, event_name, ax, fn, *args):
        self.ax_events.setdefault(event_name, []).append((ax, fn, args))

    def remove_axes_event(self, event_name, ax):
        if event_name in self.ax_events:
            self.ax_events[event_name] = [
                (a, f, g) for (a, f, g) in self.ax_events[event_name]
                if a is not ax]

    def on_key_press(self, event):
        for ax, fn, args in self.ax_events.get("key_press_event", []):
            if event.inaxes is ax or event.inaxes is None:
                fn(event, *args)
        self.fig.canvas.draw_idle()


class ImageViewer3D_Sliced:
    """Scrollable single-plane view of a 3D volume.

    Keys: up/down (or j/k) move through slices along ``slice_axis``.
    """

    def __init__(self, ax, data, slice_axis=0, title="", show_colorbar=False):
        self.ax = ax
        self.data = _array(data)
        self.slice_axis = slice_axis
        self.index = self.data.shape[slice_axis] // 2
        self.title = title
        self.image = ax.imshow(self._slice(), cmap="gray")
        if show_colorbar:
            ax.figure.colorbar(self.image, ax=ax)
        self._label()
        ax.figure.canvas.mpl_connect("key_press_event", self.on_key)

    def _slice(self):
        return np.take(self.data, self.index, axis=self.slice_axis)

    def _label(self):
        n = self.data.shape[self.slice_axis]
        self.ax.set_title(f"{self.title} [{self.index}/{n - 1}]")

    def set_index(self, idx):
        n = self.data.shape[self.slice_axis]
        self.index = int(np.clip(idx, 0, n - 1))
        self.image.set_data(self._slice())
        self._label()

    def on_key(self, event):
        if event.inaxes is not self.ax:
            return
        if event.key in ("up", "k"):
            self.set_index(self.index + 1)
        elif event.key in ("down", "j"):
            self.set_index(self.index - 1)
        self.ax.figure.canvas.draw_idle()


class ImageViewer3D_Sliced_Flow(ImageViewer3D_Sliced):
    """Slice viewer with an optical-flow quiver overlay. ``flow``: (3, D,
    W, H) displacement."""

    def __init__(self, ax, data, flow, slice_axis=0, title="", stride=8):
        self.flow = _array(flow)
        self.stride = stride
        self.quiver = None
        super().__init__(ax, data, slice_axis, title)
        self._draw_flow()

    def _draw_flow(self):
        if self.quiver is not None:
            self.quiver.remove()
        axes2d = [a for a in range(3) if a != self.slice_axis]
        u = np.take(self.flow[axes2d[1]], self.index, axis=self.slice_axis)
        v = np.take(self.flow[axes2d[0]], self.index, axis=self.slice_axis)
        s = self.stride
        yy, xx = np.mgrid[0:u.shape[0]:s, 0:u.shape[1]:s]
        self.quiver = self.ax.quiver(xx, yy, u[::s, ::s], v[::s, ::s],
                                     color="r", angles="xy")

    def set_index(self, idx):
        super().set_index(idx)
        self._draw_flow()


class ImageViewer3D_Sliced_Contour(ImageViewer3D_Sliced):
    """Slice viewer with map iso-contours. ``phi``: (3, D, W, H) in
    [-1, 1]."""

    def __init__(self, ax, data, phi, slice_axis=0, title="", n_lines=20):
        self.phi = _array(phi)
        self.n_lines = n_lines
        self.contours = []
        super().__init__(ax, data, slice_axis, title)
        self._draw_contours()

    def _draw_contours(self):
        for c in self.contours:
            c.remove()
        self.contours = []
        axes2d = [a for a in range(3) if a != self.slice_axis]
        for a in axes2d:
            comp = np.take(self.phi[a], self.index, axis=self.slice_axis)
            cs = self.ax.contour(comp, levels=self.n_lines,
                                 colors="g", linewidths=0.5)
            self.contours.append(cs)

    def set_index(self, idx):
        super().set_index(idx)
        self._draw_contours()


def view_volume(data, flow=None, phi=None, block=True):
    """Open a 3-pane axial/coronal/sagittal viewer for a volume."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    viewers = []
    for ax, axis, name in zip(axes, (0, 1, 2),
                              ("axial", "coronal", "sagittal")):
        if flow is not None:
            viewers.append(ImageViewer3D_Sliced_Flow(ax, data, flow, axis,
                                                     name))
        elif phi is not None:
            viewers.append(ImageViewer3D_Sliced_Contour(ax, data, phi, axis,
                                                        name))
        else:
            viewers.append(ImageViewer3D_Sliced(ax, data, axis, name))
    FigureEventHandler(fig)
    if block:
        plt.show()
    return fig, viewers
