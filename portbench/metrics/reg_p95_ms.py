"""95th percentile of every call's dispatch-to-result time in the window,
in ms."""
from portbench.lib.readers import percentile


def read(run):
    return percentile(run.window["latencies"], 95) * 1e3
