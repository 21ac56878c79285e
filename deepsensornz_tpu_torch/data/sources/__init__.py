"""Data sources (numpy); only what the pipeline needs is ported."""
