"""% of the port's kernels' bound time (each operation's bytes at the HBM
rate or operations at the peak, from rooflines/) over their device time."""
from portbench.lib.readers import roofline_share as read  # noqa: F401
