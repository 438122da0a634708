"""Registrations completed a second over the whole window, from the first
dispatch to the last completion."""
from portbench.lib.readers import registrations_per_s as read  # noqa: F401
