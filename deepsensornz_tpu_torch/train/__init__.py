"""Training: the AdamW trainer, checkpoints and JAX parameter conversion."""
