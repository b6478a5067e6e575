"""Registries and weight loading of the PyTorch port."""
