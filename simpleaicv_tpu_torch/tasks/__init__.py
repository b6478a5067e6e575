"""Task adapters of the PyTorch port."""
