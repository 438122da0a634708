"""Datasets and loaders of the port."""
