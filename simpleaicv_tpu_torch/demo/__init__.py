"""Serving layer of the PyTorch port."""
