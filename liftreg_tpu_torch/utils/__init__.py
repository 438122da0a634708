"""Utilities of the port: configs, checkpoints, metrics, artifact IO."""
