"""Device ms a refinement step: the device time of a refined call, less
that of an unrefined call on the same inputs, over the steps."""


def read(run):
    if run.trace is None or "unrefined" not in run.phases:
        return None
    start, end = run.traced
    refined = run.trace.busy_s(start, end) / run.window["calls"]
    busy, calls = run.phases["unrefined"]
    return (refined - busy / calls) / int(run.traffic["refine_steps"]) * 1e3
