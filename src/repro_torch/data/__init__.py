"""Synthetic training data (numpy; the same batches as the reference's)."""
