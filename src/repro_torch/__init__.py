"""PyTorch + CUDA port of the Raptor scheduler (arXiv:2403.16457).

The JAX package :mod:`repro` is the reference this package is held
against; nothing here imports it or JAX.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
