"""Host ms of one refinement step: a ``liftreg.refine.step`` span's
length on the host, the mean over the traced window. The benchmark's
trace keeps no runtime calls, so a blocking call inside a step counts in
(``portbench/span_table.py`` reads them from the whole trace)."""
from portbench.lib.spans import host_ms


def read(run):
    return host_ms(run, "liftreg.refine.step")
