"""Device ms a call in the regulariser's index kernels (the central
differences' index_select and, in the backward, index_add)."""
from portbench.lib.readers import pattern_ms


def read(run):
    return pattern_ms(run, ("index",))
