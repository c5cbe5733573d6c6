"""Datasets and window loaders of the port."""
