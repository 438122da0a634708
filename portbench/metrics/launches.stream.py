"""Launches a call of the port's counted kernels (each wrapper's
``.launches``)."""
from portbench.lib.readers import launches_per_call as read  # noqa: F401
