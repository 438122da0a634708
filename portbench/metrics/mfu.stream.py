"""% of the bf16 peak that the declared model's operations make over the
time a call."""
from portbench.lib.readers import mfu


def read(run):
    return mfu(run, train=False)
