"""Fixed-shape task batches of tensors."""
