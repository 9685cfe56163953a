"""Rank meshes, feature-sharded solves and selection, process-group init."""
