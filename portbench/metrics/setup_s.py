"""Seconds from the start of the process to the first timed call:
imports, the kernels' build or load, inputs, weights, warm-up."""


def read(run):
    return run.setup_s
