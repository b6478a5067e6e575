"""Evaluators of the PyTorch port (numpy only)."""
