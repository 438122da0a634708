"""Device ms a call in cuDNN's and cuBLAS's kernels, their layout
conversions included (the encoder's convolutions and its head)."""
from portbench.lib.readers import class_ms


def read(run):
    return class_ms(run, "conv")
