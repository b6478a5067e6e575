"""Operators of the PyTorch port; hand kernels live in csrc/."""
