"""Anticipation pipeline and feature selection of the port."""
