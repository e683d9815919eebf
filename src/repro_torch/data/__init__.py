"""Synthetic data of the port (rectangle detection)."""
