"""% of the f32 peak that the declared model's forward and backward
operations make over the time a step."""
from portbench.lib.readers import mfu


def read(run):
    return mfu(run, train=True)
