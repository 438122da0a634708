"""The window's whole train steps over their count, in ms: from the
first dispatch to the completion of the last step."""


def read(run):
    return run.per_call_s() * 1e3
