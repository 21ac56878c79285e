"""Parameter import from JAX checkpoints."""
