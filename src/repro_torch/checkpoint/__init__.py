"""Checkpoints in the reference's npz + manifest layout."""
