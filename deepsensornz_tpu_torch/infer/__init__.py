"""Gridded prediction."""
