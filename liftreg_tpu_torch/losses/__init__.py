"""Losses of the port: similarity measures and the displacement
regulariser."""
