"""% of the traced window in which the card was idle while the host was
inside the port: a ``liftreg.`` span holds the gap's midpoint. The
benchmark's trace keeps no runtime calls, so a gap in which the host was
blocked in one inside a span counts in (``portbench/span_table.py``
labels those ``blocked``)."""
from portbench.lib.spans import dispatch_idle_share as read  # noqa: F401
