"""Spans of the port's layers on ``torch.profiler``'s timeline.

``span(name)`` is ``torch.profiler.record_function("liftreg." + name)``
while a profiler runs and one shared no-op context otherwise, so that a
span costs one flag check when nothing traces. A profiler that traces the
card (``train.profile_dir``'s, a benchmark's) then holds the spans in its
trace beside the kernels, on one clock; ``spanned(name)`` wraps a
function in its span::

    with span("refine.step"):
        ...

    @spanned("loss.regulariser")
    def displacement_reg(disp, ...):
        ...

The spans, by layer: ``entry.register``, ``entry.register_projections``;
``model.lift``, ``.encoder``, ``.pca``, ``.warp``; ``refine`` and inside
it ``refine.taps``, ``refine.step`` (with ``refine.forward``,
``.backward``, ``.update``) and ``refine.select``; ``loss.similarity``,
``loss.regulariser``; ``train.step`` (with ``train.forward``,
``.backward``, ``.update``) and ``train.flush``.
"""
from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "liftreg."
_OFF = contextlib.nullcontext()


def span(name):
    """The profiler's span ``liftreg.<name>`` while one runs, else a no-op
    context (the same object every time)."""
    if _profiler._is_profiler_enabled:
        return record_function(PREFIX + name)
    return _OFF


def spanned(name):
    """A decorator: each call of the function inside :func:`span`
    ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap
