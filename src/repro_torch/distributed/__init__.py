"""Distributed-optimisation helpers (one device: gradient transforms)."""
