"""Labeled grids and the data processor (numpy)."""
