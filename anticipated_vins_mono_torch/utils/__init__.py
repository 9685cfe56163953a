"""Synthetic problems and container conversion for the port."""
