"""Device ms a call in every operation that is neither the port's own
kernel nor cuDNN's or cuBLAS's: ATen's elementwise kernels, copies and
fills."""
from portbench.lib.readers import class_ms


def read(run):
    return class_ms(run, "glue")
